"""NDT registration: Gauss-Newton on the Mahalanobis objective (counterpart
of ``point_cloud_registration_tpu/models/ndt.py``).

Objective ``sum_i (T p_i - mu_i)^T Sigma_i^{-1} (T p_i - mu_i)`` against the
nearest voxel Gaussian, the reference solver at ndt.py:12-57 (plain GN on
the Mahalanobis cost, not Magnusson's exponential-likelihood NDT). On a
dense map (also after ``update_target``) the stats kernel takes the whitened
form: ``U (T p - mu)`` with ``U^T U = icov`` read from the winner's row of
the cell index; on a hashed map (a box over the dense budget) the hashed
stats kernel takes the icov form, as the JAX package's hashed path does.
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core.config import NDTConfig
from point_cloud_registration_tpu_torch.models._fused import (
    fused_voxel_align,
    fused_voxel_stats,
)
from point_cloud_registration_tpu_torch.models.base import AlignResult, Registration
from point_cloud_registration_tpu_torch.ops.voxelize import (
    VoxelMap,
    build_voxel_map,
    update_voxel_map,
)
from point_cloud_registration_tpu_torch.utils.diagnostics import span

__all__ = ["NDT", "build_ndt_target", "ndt_align", "ndt_solver_stats"]


def build_ndt_target(points, cfg: NDTConfig, *, device=None) -> VoxelMap:
    """Voxel map with inverse covariances and the NDT table
    (``NDT.set_target``, ndt.py:18-22)."""
    return build_voxel_map(points, cfg.voxel_size, min_points=cfg.min_points,
                           with_icov=True, rich="sqrt_icov", device=device)


def ndt_solver_stats(vmap_: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                     T: torch.Tensor, cfg: NDTConfig):
    """Nearest-voxel correspondence + whitened Mahalanobis linearization at
    ``T`` -> GNStats on the host (ndt.py:24-57)."""
    return fused_voxel_stats(vmap_, source, src_weight, T, cfg, kind="ndt")


def ndt_align(vmap_: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
              init_T, cfg: NDTConfig) -> AlignResult:
    T, diag = fused_voxel_align(vmap_, source, src_weight, init_T, cfg, kind="ndt")
    return AlignResult(T=T, diagnostics=diag)


class NDT(Registration):
    """Reference-compatible shim (constructor of ndt.py:13-16)."""

    def __init__(
        self,
        voxel_size: float = 1.0,
        max_iter: int = 30,
        max_dist: float = 2,
        tol: float = 1e-3,
        huber_delta: float | None = None,
        *,
        device=None,
    ):
        super().__init__(max_iter=max_iter, tol=tol, device=device)
        self.voxel_size = voxel_size
        self.max_dist = max_dist
        self.cfg = NDTConfig(
            voxel_size=voxel_size,
            max_iter=max_iter,
            max_dist=max_dist,
            tol=tol,
            huber_delta=huber_delta,
        )

    def set_target(self, target) -> None:
        """Under a profiler the span ``pcr.set_target``, the whole build
        (the host box, the copy, the voxel statistics, the sqrt-icov table)
        ``pcr.build.index``."""
        with span("pcr.set_target"), span("pcr.build.index"):
            self._target = build_ndt_target(target, self.cfg, device=self.device)

    def update_target(self, target) -> None:
        """Merge ``target``'s points into the map (the reference's declared
        ``update_target``, registration.py:36-43; ``models/ndt.py:132`` of the
        JAX package):
        ``ops.voxelize.update_voxel_map`` on a dense map, whose cell index
        is rebuilt for the next align's kernel. Points outside the map's
        box are dropped; a hashed map raises ``NotImplementedError``. With
        no target yet it sets one."""
        if self._target is None:
            self.set_target(target)
            return
        self._target = update_voxel_map(self._target, target, min_points=self.cfg.min_points)

    @property
    def voxels(self) -> VoxelMap:
        """Attribute parity with the reference (ndt.py:19)."""
        return self._target

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        return ndt_align(target, source, src_weight, init_T, self.cfg)

    def _stats_fn(self, target, source, src_weight, T):
        return ndt_solver_stats(target, source, src_weight, T, self.cfg)
