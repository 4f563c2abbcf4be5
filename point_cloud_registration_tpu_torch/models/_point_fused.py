"""Gauss-Newton align over the point stats kernel (counterpart of
``point_cloud_registration_tpu/models/_point_fused.py``, kind "point").

Each iteration is one launch of ``ops/kernels/point_align.point_stats`` over
the whole scan and one copy of its 29 stat values to the host. The kernel
resolves every query itself (tier 1 or the proxy voxel), so the TPU align's
Morton layout, tile key lists, dense fused rows and fallback tiers
(_point_fused.py:38-66, :110-167), which serve its VMEM tiles, have no
counterpart.
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core.config import ICPConfig
from point_cloud_registration_tpu_torch.core.gn import GNDiagnostics, GNStats, gauss_newton
from point_cloud_registration_tpu_torch.core.se3 import makeRt
from point_cloud_registration_tpu_torch.models._point_corr import (
    PointCorrTarget,
    proxy_radius,
)
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import stats_from_packed
from point_cloud_registration_tpu_torch.ops.kernels.point_align import point_stats


def fused_point_stats(target: PointCorrTarget, source: torch.Tensor,
                      src_weight: torch.Tensor, T: torch.Tensor,
                      cfg: ICPConfig) -> GNStats:
    """Packed correspondence + point-to-point linearization at ``T`` (host
    float32 (4, 4)) -> GNStats on the host, with one device sync."""
    R, t = makeRt(T)
    packed = point_stats(
        target.packed, target.proxy, source, src_weight, R, t, cfg.max_dist,
        proxy_radius(cfg.corr, cfg.max_dist), cfg.huber_delta,
    )
    return stats_from_packed(packed.cpu())


def fused_point_align(target: PointCorrTarget, source: torch.Tensor,
                      src_weight: torch.Tensor, init_T,
                      cfg: ICPConfig) -> tuple[torch.Tensor, GNDiagnostics]:
    """``align`` with the point kernel: returns ``(T, GNDiagnostics)``."""

    def stats_fn(T):
        return fused_point_stats(target, source, src_weight, T, cfg)

    return gauss_newton(stats_fn, init_T, cfg.max_iter, cfg.tol)
