"""Gauss-Newton align of VPlaneICP (kind "plane") and NDT (kind "ndt")
(counterpart of ``point_cloud_registration_tpu/models/_fused.py`` and of the
plain ``vplane_stats`` / ``ndt_solver_stats``).

The map's layout picks the stats, as in the JAX package:

* a dense-direct map: each iteration is one launch of the fused stats
  kernel over the whole scan. The TPU align's band layout, tile scaling and
  straggler fallback tiers (_fused.py:136-163) serve its region clamp; the
  CUDA kernel reads every window from global memory, so no query is ever
  left unresolved and none of them is needed;
* a hashed map (over the dense budget): ``query_nearest_voxel`` and the
  plain reductions of ``ops/reduce.py`` (voxelized_plane_icp.py:64,
  ndt.py:64), which the JAX package also runs without a Pallas kernel
  (``voxel_fused_spec`` returns None without dense blocks).

Either way one copy of the 29 stat values reaches the host per iteration.
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core.config import NDTConfig, VPlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import GNDiagnostics, GNStats, gauss_newton
from point_cloud_registration_tpu_torch.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    fused_ndt_stats,
    fused_plane_stats,
    packed_from_stats,
    stats_from_packed,
)
from point_cloud_registration_tpu_torch.ops.reduce import ndt_stats, plane_stats
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap, query_nearest_voxel

_STATS = {"plane": fused_plane_stats, "ndt": fused_ndt_stats}


def hashed_voxel_stats(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                       T: torch.Tensor, cfg: VPlaneICPConfig | NDTConfig,
                       kind: str = "plane") -> GNStats:
    """The plain stats of a hashed map at ``T`` (host float32 (4, 4)):
    the nearest valid voxel in the ``search_offsets`` window, gated on
    ``dist < max_dist``; point-to-plane, or NDT's Mahalanobis form with the
    cell's inverse covariance. -> GNStats on the host, with one device sync."""
    Td = T.to(source.device)
    R, _ = makeRt(Td)
    src_trans = transform_points(Td, source)
    nn = query_nearest_voxel(vm, src_trans, voxel_size=cfg.voxel_size, max_dist=cfg.max_dist)
    w = src_weight * (nn.dist < cfg.max_dist) * (nn.idx >= 0)
    safe = nn.idx.clamp(0, vm.means.shape[0] - 1).to(torch.int64)
    if kind == "plane":
        stats = plane_stats(source, src_trans, vm.means[safe], vm.normals[safe], w, R,
                            huber_delta=cfg.huber_delta)
    else:
        stats = ndt_stats(source, src_trans, vm.means[safe], vm.icovs[safe], w, R,
                          huber_delta=cfg.huber_delta)
    return stats_from_packed(packed_from_stats(stats).cpu())


def fused_voxel_stats(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                      T: torch.Tensor, cfg: VPlaneICPConfig | NDTConfig,
                      kind: str = "plane") -> GNStats:
    """Nearest-voxel correspondence + the ``kind``'s linearization at ``T``
    (host float32 (4, 4)) -> GNStats on the host, with one device sync: the
    fused kernel on a dense map, :func:`hashed_voxel_stats` on a hashed one."""
    if vm.hashed:
        return hashed_voxel_stats(vm, source, src_weight, T, cfg, kind)
    R, t = makeRt(T)
    packed = _STATS[kind](
        vm.cells, vm.origin_cell, vm.dims, vm.cell_size, source, src_weight,
        R, t, cfg.max_dist, cfg.huber_delta,
    )
    return stats_from_packed(packed.cpu())


def fused_voxel_align(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                      init_T, cfg: VPlaneICPConfig | NDTConfig,
                      kind: str = "plane") -> tuple[torch.Tensor, GNDiagnostics]:
    """``align`` over :func:`fused_voxel_stats`: returns ``(T, GNDiagnostics)``."""

    def stats_fn(T):
        return fused_voxel_stats(vm, source, src_weight, T, cfg, kind)

    return gauss_newton(stats_fn, init_T, cfg.max_iter, cfg.tol)
