"""Point-to-point ICP (counterpart of ``point_cloud_registration_tpu/models/icp.py``).

Objective ``sum_i || T p_i - q_i ||^2`` with gated nearest-neighbour
correspondences, the reference solver at icp.py:12-57. A target of 50k
points and more is indexed by the packed point grid with its proxy voxel
map, and each Gauss-Newton iteration is one launch of the point stats
kernel; a smaller one by the CSR grid, with one launch of the grid point
stats kernel (``models/_point_corr.py``, ``models/_point_fused.py``).
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core.config import ICPConfig
from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.core.gn import LoopSlot
from point_cloud_registration_tpu_torch.models._point_corr import (
    PointCorrTarget,
    build_point_corr,
)
from point_cloud_registration_tpu_torch.models._point_fused import (
    fused_point_align,
    fused_point_stats,
)
from point_cloud_registration_tpu_torch.models.base import AlignResult, Registration
from point_cloud_registration_tpu_torch.utils.diagnostics import span

__all__ = ["ICP", "ICPTarget", "build_icp_target", "icp_align", "icp_stats"]

# The ICP target is the generic raw-point correspondence target.
ICPTarget = PointCorrTarget


def build_icp_target(points, cfg: ICPConfig, *, device=None) -> ICPTarget:
    """Index the target cloud (``ICP.set_target``, icp.py:17-22). Under a
    profiler the map's copy and the index are the spans
    ``pcr.build.upload`` and ``pcr.build.index``."""
    device = resolve_device(points, device)
    with span("pcr.build.upload"):
        points = torch.as_tensor(points).to(device=device, dtype=torch.float32)
    with span("pcr.build.index"):
        return build_point_corr(points, cfg.corr, cfg.max_dist)


def icp_stats(target: ICPTarget, source: torch.Tensor, src_weight: torch.Tensor,
              T: torch.Tensor, cfg: ICPConfig):
    """Correspondence + linearization + reduction for one GN iteration
    (icp.py:32-56) -> GNStats on the host."""
    return fused_point_stats(target, source, src_weight, T, cfg)


def icp_align(target: ICPTarget, source: torch.Tensor, src_weight: torch.Tensor,
              init_T, cfg: ICPConfig, *, slot: LoopSlot | None = None) -> AlignResult:
    """``models._point_fused.fused_point_align`` of kind ``"point"``;
    ``slot`` keeps the solver's prepared loop."""
    T, diag = fused_point_align(target, source, src_weight, init_T, cfg, slot=slot)
    return AlignResult(T=T, diagnostics=diag)


class ICP(Registration):
    """Reference-compatible shim (constructor signature of icp.py:13-15).

    The default correspondence engine (``cfg.corr``) resolves to the packed
    method for targets of at least 50k points and to the CSR grid method
    below that; a ``cfg`` whose ``corr`` names a method keeps it at any size.
    """

    def __init__(self, max_iter: int = 30, max_dist: float = 2, tol: float = 1e-3,
                 huber_delta: float | None = None, *, device=None):
        super().__init__(max_iter=max_iter, tol=tol, device=device)
        self.max_dist = max_dist
        self.cfg = ICPConfig(
            max_iter=max_iter, max_dist=max_dist, tol=tol, huber_delta=huber_delta
        )

    def set_target(self, target) -> None:
        """Under a profiler the span ``pcr.set_target`` holds the build's
        two phases (:func:`build_icp_target`)."""
        with span("pcr.set_target"):
            self._target = build_icp_target(target, self.cfg, device=self.device)

    def _align_fn(self, target, source, src_weight, init_T) -> AlignResult:
        return icp_align(target, source, src_weight, init_T, self.cfg, slot=self._loop)

    def _stats_fn(self, target, source, src_weight, T):
        return icp_stats(target, source, src_weight, T, self.cfg)
