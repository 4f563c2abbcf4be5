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

:func:`fused_voxel_align_batched` aligns B scans against one dense map with
one launch of the batched kernel per Gauss-Newton iteration, driven by
:func:`batched_gauss_newton`, the host loop of all B problems (shared with
``models/_point_fused.fused_point_align_batched``).
"""

from __future__ import annotations

from typing import Callable

import torch

from point_cloud_registration_tpu_torch.core.config import NDTConfig, VPlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import (
    GNDiagnostics,
    GNStats,
    gauss_newton,
    solve_6x6_batched,
)
from point_cloud_registration_tpu_torch.core.se3 import makeRt, plus, transform_points
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    fused_ndt_stats,
    fused_ndt_stats_batched,
    fused_plane_stats,
    fused_plane_stats_batched,
    packed_from_stats,
    stats_from_packed,
)
from point_cloud_registration_tpu_torch.ops.reduce import ndt_stats, plane_stats
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap, query_nearest_voxel

_STATS = {"plane": fused_plane_stats, "ndt": fused_ndt_stats}
_BATCHED_STATS = {"plane": fused_plane_stats_batched, "ndt": fused_ndt_stats_batched}


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


def fused_voxel_align_batched(vm: VoxelMap, sources, src_weights, init_Ts,
                              cfg: VPlaneICPConfig | NDTConfig, kind: str = "plane",
                              ) -> tuple[torch.Tensor, GNDiagnostics]:
    """Batched multi-scan ``align`` of ``kind`` against one dense map, one
    launch of the batched fused kernel per Gauss-Newton iteration
    (``models/_fused.py::fused_voxel_align_batched`` of the JAX package).

    ``sources`` (B, n, 3), ``src_weights`` (B, n) and ``init_Ts`` (B, 4, 4).
    Every iteration computes every problem's stats, as the JAX package does;
    :func:`batched_gauss_newton` keeps each problem's single-align
    semantics. Returns ``(Ts (B, 4, 4), GNDiagnostics with leading dim B)``.
    The TPU's band layout, scatter and straggler tiers have no counterpart
    (see the module's docstring). A hashed map raises ``ValueError``: it has
    no cell index for the kernel, as the JAX function needs a fused spec.
    """
    if vm.hashed:
        raise ValueError("a hashed voxel map has no cell index for the batched fused kernel; "
                         "align its scans one by one")
    dev = vm.cells.centers.device
    src = torch.as_tensor(sources, dtype=torch.float32).to(dev).contiguous()
    w = torch.as_tensor(src_weights, dtype=torch.float32).to(dev).contiguous()
    stats_fn = _BATCHED_STATS[kind]

    def stats_all(Ts):
        R, t = makeRt(Ts)
        packed = stats_fn(vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src, w, R, t,
                          cfg.max_dist, cfg.huber_delta)
        return stats_from_packed(packed.cpu())

    return batched_gauss_newton(stats_all, init_Ts, cfg.max_iter, cfg.tol)


def batched_gauss_newton(stats_all: Callable[[torch.Tensor], GNStats], init_Ts,
                         max_iter: int, tol: float) -> tuple[torch.Tensor, GNDiagnostics]:
    """The Gauss-Newton loop of B problems at once, on the host
    (``batched_gauss_newton`` of the JAX package, models/_fused.py:288-355).

    ``stats_all(Ts)`` takes the (B, 4, 4) float32 CPU transforms and returns
    GNStats with leading dim B on the host, from one transfer. Per
    iteration: every problem's stats, the batched solve, then for each
    problem the check and the update, with each problem's semantics of
    :func:`core.gn.gauss_newton`: T frozen on its breaking step and once it
    is done; its iteration count advancing while it is active; done when it
    converges, fails or reaches ``max_iter``; its flags, histories (written
    at ``clip(it, 0, max_iter - 1)``) and ``final_e2`` changed only while it
    is active. The loop ends when every problem is done. A problem's solve,
    step norm and update are those of its single loop, bit for bit.

    Returns ``(Ts (B, 4, 4) f32 CPU tensor, GNDiagnostics)``: the same
    fields as a single align's, each with a leading dim B as CPU tensors:
    ``iterations`` (B,) int32, ``converged`` and ``solver_failed`` (B,)
    bool, the histories (B, max_iter), ``final_e2`` (B,) float32.
    """
    T = torch.as_tensor(init_Ts).to("cpu", torch.float32).clone()
    B = T.shape[0]
    rows = torch.arange(B)
    it = torch.zeros(B, dtype=torch.int32)
    done = torch.full((B,), max_iter <= 0)
    failed = torch.zeros(B, dtype=torch.bool)
    converged = torch.zeros(B, dtype=torch.bool)
    e2_hist = torch.zeros((B, max_iter), dtype=torch.float32)
    dxn_hist = torch.zeros((B, max_iter), dtype=torch.float32)
    inl_hist = torch.zeros((B, max_iter), dtype=torch.int32)
    final_e2 = torch.zeros(B, dtype=torch.float32)
    while not bool(done.all()):
        active = ~done
        stats = stats_all(T)
        dx = torch.from_numpy(solve_6x6_batched(stats.H, stats.g))
        dx_norm = torch.stack([torch.linalg.norm(d) for d in dx])
        bad = ~torch.isfinite(dx_norm)
        conv_now = dx_norm < tol
        done_now = conv_now | bad
        # the transform is NOT updated on the breaking step, nor once done
        for b in torch.nonzero(~(done | done_now)).flatten().tolist():
            T[b] = plus(T[b], dx[b])
        e2 = stats.e2.to(torch.float32)
        at = it.clamp(0, max_iter - 1).long()
        for hist, v in ((e2_hist, e2), (dxn_hist, dx_norm),
                        (inl_hist, stats.n_inliers.to(torch.int32))):
            hist[rows[active], at[active]] = v[active]
        it = it + active.to(torch.int32)
        failed |= active & bad
        converged |= active & conv_now
        final_e2 = torch.where(active, e2, final_e2)
        done = done | (active & done_now) | (it >= max_iter)
    diag = GNDiagnostics(
        iterations=it,
        converged=converged,
        solver_failed=failed,
        e2_history=e2_hist,
        dx_norm_history=dxn_hist,
        inlier_history=inl_hist,
        final_e2=final_e2,
    )
    return T, diag
