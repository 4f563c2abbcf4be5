"""Gauss-Newton align over the fused stats kernels (counterpart of
``point_cloud_registration_tpu/models/_fused.py``): one GN loop serves
VPlaneICP (kind "plane") and NDT (kind "ndt").

Each iteration is one kernel launch over the whole scan and one copy of its
29 stat values to the host. The TPU align's band layout, tile scaling and
straggler fallback tiers (_fused.py:136-163) serve its region clamp; the
CUDA kernel reads every window from global memory, so no query is ever
left unresolved and none of them is needed.
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core.config import NDTConfig, VPlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import GNDiagnostics, GNStats, gauss_newton
from point_cloud_registration_tpu_torch.core.se3 import makeRt
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    fused_ndt_stats,
    fused_plane_stats,
    stats_from_packed,
)
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap

_STATS = {"plane": fused_plane_stats, "ndt": fused_ndt_stats}


def fused_voxel_stats(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                      T: torch.Tensor, cfg: VPlaneICPConfig | NDTConfig,
                      kind: str = "plane") -> GNStats:
    """Nearest-voxel correspondence + the ``kind``'s linearization at ``T``
    (host float32 (4, 4)) -> GNStats on the host, with one device sync."""
    R, t = makeRt(T)
    packed = _STATS[kind](
        vm.cells, vm.origin_cell, vm.dims, vm.cell_size, source, src_weight,
        R, t, cfg.max_dist, cfg.huber_delta,
    )
    return stats_from_packed(packed.cpu())


def fused_voxel_align(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                      init_T, cfg: VPlaneICPConfig | NDTConfig,
                      kind: str = "plane") -> tuple[torch.Tensor, GNDiagnostics]:
    """``align`` with the fused kernel: returns ``(T, GNDiagnostics)``."""

    def stats_fn(T):
        return fused_voxel_stats(vm, source, src_weight, T, cfg, kind)

    return gauss_newton(stats_fn, init_T, cfg.max_iter, cfg.tol)
