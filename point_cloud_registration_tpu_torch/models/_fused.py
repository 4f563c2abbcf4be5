"""Gauss-Newton align of VPlaneICP (kind "plane") and NDT (kind "ndt")
(counterpart of ``point_cloud_registration_tpu/models/_fused.py`` and of the
plain ``vplane_stats`` / ``ndt_solver_stats``).

The map's layout picks the stats, as in the JAX package:

* a dense-direct map: each iteration's stats are the fused stats kernel's
  over the whole scan. The TPU align's band layout, tile scaling and
  straggler fallback tiers (_fused.py:136-163) serve its region clamp; the
  CUDA kernel reads every window from global memory, so no query is ever
  left unresolved and none of them is needed;
* a hashed map (over the dense budget): each iteration's stats are those
  of ``ops/kernels/grid_align.hashed_plane_stats`` or ``hashed_ndt_stats``,
  ``query_nearest_voxel``'s binary searches and the reductions of
  ``ops/reduce.py`` (voxelized_plane_icp.py:64, ndt.py:64; NDT in the
  Mahalanobis form) in one kernel; the JAX package leaves them to XLA
  (``voxel_fused_spec`` returns None without dense blocks).

Either way the whole Gauss-Newton loop of an align is one launch of a loop
kernel (``ops/kernels/gn_loop.fused_loop`` on a dense map, ``grid_loop`` on
a hashed one: the stats, the row sum and the update of every iteration, on
the card), and the host reads the state once, as the JAX package compiles
the loop into one dispatch. The two-launch resident loop
(``core.gn.gauss_newton_device`` over :func:`fused_voxel_stats_resident`: a
stats launch that reads the pose and the done flag from the loop's state on
the card, then ``gn_step``) computes the same state and is the plain
two-launch reference the loop kernels are held to.

:func:`fused_voxel_align_batched` aligns B scans against one dense map in
one launch of the batched loop kernel (``gn_loop.fused_loop_batched``: every
iteration of all B problems, a done problem left as it is), the
counterpart of the JAX ``batched_gauss_newton`` around the batched fused
stats; its two-launch reference is the resident loop of all B problems
(``core.gn.batched_gauss_newton_device`` over
:func:`fused_voxel_stats_packed_batched`: one launch of the batched stats
kernel, then ``gn_step``, an iteration).
"""

from __future__ import annotations

import functools

import torch

from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.core.config import NDTConfig, VPlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import GNDiagnostics, GNStats, ResidentStats
from point_cloud_registration_tpu_torch.core.se3 import makeRt
from point_cloud_registration_tpu_torch.ops.hashgrid import search_offsets
from point_cloud_registration_tpu_torch.ops.kernels import gn_loop, grid_align
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    fused_ndt_stats,
    fused_plane_stats,
    resident_stats,
    stats_from_packed,
)
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap

_STATS = {"plane": fused_plane_stats, "ndt": fused_ndt_stats}
_HASHED_STATS = {"plane": grid_align.hashed_plane_stats, "ndt": grid_align.hashed_ndt_stats}


def hashed_operands(vm: VoxelMap, cfg: VPlaneICPConfig | NDTConfig, kind: str = "plane") -> tuple:
    """``(grid, table, offsets)`` of a hashed map for the hashed stats
    kernels (``ops/kernels/grid_align``): the slots' centroids, valid flags
    and normals (``"plane"``) or inverse covariances (``"ndt"``), and the
    window of ``query_nearest_voxel`` (``search_offsets`` of the voxel)."""
    feats = vm.normals if kind == "plane" else vm.icovs
    return (vm.grid, grid_align.voxel_table(vm.means, vm.valid, feats),
            search_offsets(cfg.max_dist, cfg.voxel_size))


def hashed_voxel_stats_packed(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                              T: torch.Tensor, cfg: VPlaneICPConfig | NDTConfig,
                              kind: str = "plane") -> torch.Tensor:
    """The stats of a hashed map at ``T`` (float32 (4, 4), on the host or
    the data's device): the nearest valid voxel in the ``search_offsets``
    window, gated on ``dist < max_dist``; point-to-plane, or NDT's
    Mahalanobis form with the cell's inverse covariance. One launch of the
    hashed stats kernel of the kind on CUDA tensors, its plain version on CPU
    ones. -> the (29,) packed stats on the data's device
    (``ops/kernels/fused_align.packed_from_stats``)."""
    grid, table, offsets = hashed_operands(vm, cfg, kind)
    R, t = makeRt(T)
    return _HASHED_STATS[kind](grid, table, source, src_weight, R, t, offsets, cfg.max_dist,
                               cfg.huber_delta)


def fused_voxel_stats_packed(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                             T: torch.Tensor, cfg: VPlaneICPConfig | NDTConfig,
                             kind: str = "plane") -> torch.Tensor:
    """Nearest-voxel correspondence + the ``kind``'s linearization at ``T``
    (host float32 (4, 4)) -> the (29,) packed stats on the data's device:
    the fused kernel on a dense map, :func:`hashed_voxel_stats_packed` on a
    hashed one."""
    if vm.hashed:
        return hashed_voxel_stats_packed(vm, source, src_weight, T, cfg, kind)
    R, t = makeRt(T)
    return _STATS[kind](
        vm.cells, vm.origin_cell, vm.dims, vm.cell_size, source, src_weight,
        R, t, cfg.max_dist, cfg.huber_delta,
    )


def fused_voxel_stats(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                      T: torch.Tensor, cfg: VPlaneICPConfig | NDTConfig,
                      kind: str = "plane") -> GNStats:
    """:func:`fused_voxel_stats_packed` -> GNStats on the host, with one
    device sync."""
    return stats_from_packed(fused_voxel_stats_packed(vm, source, src_weight, T, cfg, kind).cpu())


def fused_voxel_stats_resident(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                               cfg: VPlaneICPConfig | NDTConfig,
                               kind: str = "plane") -> ResidentStats:
    """The stats of one scan as a resident loop binds them (``core.gn.
    ResidentStats``): at the state's ``(poses (1, 12), done (1,))`` on the
    data's device, a launch per iteration of a kernel that reads the pose
    and the flag on the card: the fused kernel (``fused_align``) on a dense
    map, the hashed stats kernel (``grid_align``) on a hashed one (its
    operands made when the stats are bound: an align through the loop
    kernel binds none)."""
    if vm.hashed:
        def bind(poses, done):
            grid, table, offsets = hashed_operands(vm, cfg, kind)
            return grid_align.resident_stats(kind, grid, table, source, src_weight, offsets,
                                             cfg.max_dist, cfg.huber_delta, poses, done)
        return bind
    return lambda poses, done: resident_stats(kind, vm.cells, vm.origin_cell, vm.dims,
                                              vm.cell_size, source, src_weight, cfg.max_dist,
                                              cfg.huber_delta, poses, done)


def fused_voxel_align(vm: VoxelMap, source: torch.Tensor, src_weight: torch.Tensor,
                      init_T, cfg: VPlaneICPConfig | NDTConfig, kind: str = "plane",
                      slot: gn.LoopSlot | None = None) -> tuple[torch.Tensor, GNDiagnostics]:
    """``align`` over :func:`fused_voxel_stats_resident` on the scan's
    device: returns ``(T, GNDiagnostics)`` on the host. The whole loop is
    one launch of a loop kernel (its plain version on the CPU) and one read
    of the state: ``gn_loop.fused_loop`` on a dense map, ``gn_loop.grid_loop``
    on a hashed one. With a solver's ``slot`` the loop is its prepared loop
    (``core.gn.PreparedLoop``), made for ``vm`` once and kept while the map
    and the scan's length stay: the same launch and the same result."""
    settings = dict(max_dist=cfg.max_dist, huber_delta=cfg.huber_delta, tol=cfg.tol,
                    max_iter=cfg.max_iter)

    def looper(state, src, w):
        if vm.hashed:
            grid, table, offsets = hashed_operands(vm, cfg, kind)
            return gn_loop.grid_looper(kind, grid, table, src, w, offsets, state, **settings)
        return gn_loop.fused_looper(kind, vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src,
                                    w, state, **settings)

    if slot is not None:
        loop = gn.LoopRequest(slot, (kind, cfg), (vm,), source, src_weight, looper)
    else:
        loop = lambda state: looper(state, source, src_weight)()  # noqa: E731
    return gn.gauss_newton_device(fused_voxel_stats_resident(vm, source, src_weight, cfg, kind),
                                  init_T, cfg.max_iter, cfg.tol, source.device, loop=loop)


def fused_voxel_align_batched(vm: VoxelMap, sources, src_weights, init_Ts,
                              cfg: VPlaneICPConfig | NDTConfig, kind: str = "plane",
                              ) -> tuple[torch.Tensor, GNDiagnostics]:
    """Batched multi-scan ``align`` of ``kind`` against one dense map, the
    whole loop of the B problems in one launch of the batched loop kernel
    (``gn_loop.fused_loop_batched``; its plain version on the CPU) and one
    read of the state (``models/_fused.py::fused_voxel_align_batched`` of the
    JAX package).

    ``sources`` (B, n, 3), ``src_weights`` (B, n) and ``init_Ts`` (B, 4, 4).
    The loop (``core.gn.batched_gauss_newton_device``) keeps each problem's
    single-align semantics; a problem that is done is left as it is.
    Returns ``(Ts (B, 4, 4), GNDiagnostics with leading dim B)``.
    The TPU's band layout, scatter and straggler tiers have no counterpart
    (see the module's docstring). A hashed map raises ``ValueError``: it has
    no cell index for the kernel, as the JAX function needs a fused spec.
    """
    stats_all = fused_voxel_stats_packed_batched(vm, sources, src_weights, cfg, kind)
    src, w = batch_on(vm.cells.centers.device, sources, src_weights)
    loop = functools.partial(gn_loop.fused_loop_batched, kind, vm.cells, vm.origin_cell, vm.dims,
                             vm.cell_size, src, w, max_dist=cfg.max_dist,
                             huber_delta=cfg.huber_delta, tol=cfg.tol, max_iter=cfg.max_iter)
    return gn.batched_gauss_newton_device(stats_all, init_Ts, cfg.max_iter, cfg.tol,
                                          vm.cells.centers.device, loop=loop)


def fused_voxel_stats_packed_batched(vm: VoxelMap, sources, src_weights,
                                     cfg: VPlaneICPConfig | NDTConfig, kind: str = "plane",
                                     ) -> ResidentStats:
    """The stats of B scans against one dense map as a resident loop binds
    them (``core.gn.ResidentStats``): at ``(poses (B, 12), done (B,) or
    None)`` on the map's device, ``launch() -> (B, 29)`` there, one launch
    of the batched fused kernel per call (``core.gn.pose_rows_of``
    makes pose rows of transforms). ``sources`` (B, n, 3) and ``src_weights`` (B, n) go to the
    map's device once. A hashed map raises ``ValueError``: it has no cell
    index for the kernel, as the JAX function needs a fused spec."""
    if vm.hashed:
        raise ValueError("a hashed voxel map has no cell index for the batched fused kernel; "
                         "align its scans one by one")
    src, w = batch_on(vm.cells.centers.device, sources, src_weights)
    return lambda poses, done=None: resident_stats(kind, vm.cells, vm.origin_cell, vm.dims,
                                                   vm.cell_size, src, w, cfg.max_dist,
                                                   cfg.huber_delta, poses, done)


def batch_on(device, sources, src_weights) -> tuple:
    """``(src, w)``: B scans (B, n, 3) and their weights (B, n) as contiguous
    float32 tensors on ``device`` (no copy when they are already)."""
    return tuple(torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()
                 for x in (sources, src_weights))
