"""Voxelized point-to-plane ICP, the flagship solver (counterpart of
``point_cloud_registration_tpu/models/voxelized_plane_icp.py``).

Correspondences are the nearest *voxel Gaussian* (mean + normal) of a voxel
map, the reference solver at voxelized_plane_icp.py:12-64. The nearest voxel
is found in a window of cells that provably covers ``max_dist``: inside the
fused stats kernel on a dense map (also after ``update_target``), inside
the hashed stats kernel on a hashed one (a box over the dense budget).
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core.config import VPlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import GNStats, LoopSlot
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

__all__ = ["VPlaneICP", "build_vplane_target", "vplane_align", "vplane_stats"]


def build_vplane_target(points, cfg: VPlaneICPConfig, *, device=None) -> VoxelMap:
    """Voxel map with Gaussian stats, normals and the kernel's cell table
    (``VPlaneICP.set_target``, voxelized_plane_icp.py:18-21)."""
    return build_voxel_map(points, cfg.voxel_size, min_points=cfg.min_points,
                           device=device)


def vplane_stats(vmap_: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor, T,
                 cfg: VPlaneICPConfig) -> GNStats:
    """One point-to-plane linearization at ``T`` on the host
    (voxelized_plane_icp.py:64): ``models._fused.fused_voxel_stats`` of kind
    ``"plane"``."""
    return fused_voxel_stats(vmap_, source, src_weight, T, cfg)


def vplane_align(vmap_: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                 init_T, cfg: VPlaneICPConfig, *, slot: LoopSlot | None = None) -> AlignResult:
    """``models._fused.fused_voxel_align`` of kind ``"plane"``; ``slot``
    keeps the solver's prepared loop."""
    T, diag = fused_voxel_align(vmap_, source, src_weight, init_T, cfg, slot=slot)
    return AlignResult(T=T, diagnostics=diag)


class VPlaneICP(Registration):
    """Reference-compatible shim (constructor of voxelized_plane_icp.py:13-16)."""

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
        self.cfg = VPlaneICPConfig(
            voxel_size=voxel_size,
            max_iter=max_iter,
            max_dist=max_dist,
            tol=tol,
            huber_delta=huber_delta,
        )

    def set_target(self, target) -> None:
        """Under a profiler the span ``pcr.set_target``, the whole build
        (the host box, the copy, the voxel statistics) ``pcr.build.index``."""
        with span("pcr.set_target"), span("pcr.build.index"):
            self._target = build_vplane_target(target, self.cfg, device=self.device)

    def update_target(self, target) -> None:
        """Merge ``target``'s points into the map (the reference's declared
        ``update_target``, registration.py:36-43; ``models/voxelized_plane_icp.py:134`` of the
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
        """Attribute parity with the reference (voxelized_plane_icp.py:19)."""
        return self._target

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        return vplane_align(target, source, src_weight, init_T, self.cfg, slot=self._loop)

    def _stats_fn(self, target, source, src_weight, T):
        return vplane_stats(target, source, src_weight, T, self.cfg)
