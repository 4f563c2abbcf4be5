"""Gauss-Newton align of ICP and PlaneICP (counterpart of
``point_cloud_registration_tpu/models/_point_fused.py``, kinds "point" for ICP
and "plane_pt" for PlaneICP, and of the plain ``icp_stats`` /
``plane_icp_stats``).

The target's layout picks the stats, as in the JAX package:

* a packed target: each iteration's stats are those of
  ``ops/kernels/point_align.point_stats`` or ``plane_point_stats`` over the
  whole scan. The kernel resolves every query itself (tier 1 or the proxy
  voxel), so the TPU align's Morton layout, tile key lists, dense fused rows
  and fallback tiers (_point_fused.py:38-66, :110-167), which serve its VMEM
  tiles, have no counterpart;
* a grid target (small targets, ``"grid"`` correspondence): each
  iteration's stats are those of ``ops/kernels/grid_align.grid_point_stats`` or
  ``grid_plane_point_stats``, the CSR bucket scan of ``match_points`` and
  the reductions of ``ops/reduce.py`` (icp.py:48-56, plane_icp.py:60-85) in
  one kernel; the JAX package leaves them to XLA (``point_fused_spec``
  needs a packed target).

Either way the whole Gauss-Newton loop of an align is one launch of a loop
kernel (``ops/kernels/gn_loop.point_loop`` on a packed target, ``grid_loop``
on a grid target: the stats, the row sum and the update of every iteration,
on the card), and the host reads the state once, as the JAX package
compiles the loop into one dispatch. The two-launch resident loop
(``core.gn.gauss_newton_device`` over :func:`fused_point_stats_resident`:
a stats launch that reads the pose and the done flag from the loop's state
on the card, then ``gn_step``) computes the same state and is the plain
two-launch reference the loop kernels are held to.

:func:`fused_point_align_batched` aligns B scans against one packed target
in one launch of the batched loop kernel (``gn_loop.point_loop_batched``),
the counterpart of the JAX ``batched_gauss_newton`` around the batched
packed-point stats; its two-launch reference is the resident loop of all B
problems (``core.gn.batched_gauss_newton_device`` over
:func:`fused_point_stats_packed_batched`).
"""

from __future__ import annotations

import functools

import torch

from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.core.config import ICPConfig, PlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import GNDiagnostics, GNStats, ResidentStats
from point_cloud_registration_tpu_torch.core.se3 import makeRt
from point_cloud_registration_tpu_torch.models._fused import batch_on
from point_cloud_registration_tpu_torch.models._point_corr import (
    PointCorrTarget,
    grid_cell_of,
    proxy_radius,
)
from point_cloud_registration_tpu_torch.ops.hashgrid import search_offsets
from point_cloud_registration_tpu_torch.ops.kernels import gn_loop, grid_align
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import stats_from_packed
from point_cloud_registration_tpu_torch.ops.kernels.point_align import (
    plane_point_stats,
    point_stats,
    resident_stats,
)

_STATS_FN = {"point": point_stats, "plane_pt": plane_point_stats}
_GRID_STATS = {"point": grid_align.grid_point_stats,
               "plane_pt": grid_align.grid_plane_point_stats}


def grid_operands(target: PointCorrTarget, cfg: ICPConfig | PlaneICPConfig,
                  normals: torch.Tensor | None = None) -> tuple:
    """``(grid, table, offsets)`` of a grid target for the grid stats kernels
    (``ops/kernels/grid_align``): the CSR buckets scanned up to
    ``cell_cap``, the points in bucket order that the target keeps,
    ``normals`` (PlaneICP's) in the table, and the window of
    ``match_points`` (``search_offsets`` of the bucket cell)."""
    table = grid_align.point_table(target.points, target.buckets, cfg.corr.cell_cap, normals,
                                   rows=target.rows)
    return target.grid, table, search_offsets(cfg.max_dist, grid_cell_of(cfg.corr, cfg.max_dist))


def grid_point_stats_packed(target: PointCorrTarget, source: torch.Tensor,
                            src_weight: torch.Tensor, T: torch.Tensor,
                            cfg: ICPConfig | PlaneICPConfig,
                            normals: torch.Tensor | None = None) -> torch.Tensor:
    """Grid correspondence + the point (``normals`` None) or point-to-plane
    linearization at ``T`` (float32 (4, 4), on the host or the data's
    device), as ``icp_stats`` and ``plane_icp_stats`` of the JAX package: a
    raw match takes ``normals[point_idx]``. One launch of the grid stats
    kernel of the kind on CUDA tensors, its plain version on CPU ones. ->
    the (29,) packed stats on the data's device
    (``ops/kernels/fused_align.packed_from_stats``)."""
    grid, table, offsets = grid_operands(target, cfg, normals)
    R, t = makeRt(T)
    kind = "point" if normals is None else "plane_pt"
    return _GRID_STATS[kind](grid, table, source, src_weight, R, t, offsets, cfg.max_dist,
                             cfg.huber_delta)


def fused_point_stats_packed(target: PointCorrTarget, source: torch.Tensor,
                             src_weight: torch.Tensor, T: torch.Tensor,
                             cfg: ICPConfig | PlaneICPConfig, kind: str = "point",
                             normals: torch.Tensor | None = None) -> torch.Tensor:
    """Correspondence + linearization of ``kind`` at ``T`` (host float32
    (4, 4)) -> the (29,) packed stats on the data's device: the kernel of
    ``kind`` on a packed target, :func:`grid_point_stats_packed` on a grid
    target (``normals``: PlaneICP's per-point normals)."""
    if target.packed is None:
        return grid_point_stats_packed(target, source, src_weight, T, cfg,
                                       normals if kind == "plane_pt" else None)
    R, t = makeRt(T)
    return _STATS_FN[kind](
        target.packed, target.proxy, source, src_weight, R, t, cfg.max_dist,
        proxy_radius(cfg.corr, cfg.max_dist), cfg.huber_delta,
    )


def fused_point_stats(target: PointCorrTarget, source: torch.Tensor,
                      src_weight: torch.Tensor, T: torch.Tensor,
                      cfg: ICPConfig | PlaneICPConfig, kind: str = "point",
                      normals: torch.Tensor | None = None) -> GNStats:
    """:func:`fused_point_stats_packed` -> GNStats on the host, with one
    device sync."""
    return stats_from_packed(
        fused_point_stats_packed(target, source, src_weight, T, cfg, kind, normals).cpu())


def fused_point_stats_resident(target: PointCorrTarget, source: torch.Tensor,
                               src_weight: torch.Tensor, cfg: ICPConfig | PlaneICPConfig,
                               kind: str = "point",
                               normals: torch.Tensor | None = None) -> ResidentStats:
    """The stats of one scan as a resident loop binds them (``core.gn.
    ResidentStats``): at the state's ``(poses (1, 12), done (1,))`` on the
    data's device, a launch per iteration of the kernel of ``kind``, which
    reads the pose and the flag on the card: the packed-grid kernel
    (``point_align``) on a packed target, the grid stats kernel
    (``grid_align``) on a grid target (its operands made when the stats are
    bound: an align through the loop kernel binds none)."""
    if target.packed is None:
        def bind(poses, done):
            grid, table, offsets = grid_operands(target, cfg,
                                                 normals if kind == "plane_pt" else None)
            return grid_align.resident_stats(kind, grid, table, source, src_weight, offsets,
                                             cfg.max_dist, cfg.huber_delta, poses, done)
        return bind
    radius = proxy_radius(cfg.corr, cfg.max_dist)
    return lambda poses, done: resident_stats(kind, target.packed, target.proxy, source,
                                              src_weight, cfg.max_dist, radius,
                                              cfg.huber_delta, poses, done)


def fused_point_align(target: PointCorrTarget, source: torch.Tensor,
                      src_weight: torch.Tensor, init_T, cfg: ICPConfig | PlaneICPConfig,
                      kind: str = "point", normals: torch.Tensor | None = None,
                      slot: gn.LoopSlot | None = None) -> tuple[torch.Tensor, GNDiagnostics]:
    """``align`` over :func:`fused_point_stats_resident` on the scan's
    device: returns ``(T, GNDiagnostics)`` on the host. The whole loop is
    one launch of a loop kernel (its plain version on the CPU) and one read
    of the state: ``gn_loop.point_loop`` on a packed target,
    ``gn_loop.grid_loop`` on a grid target. With a solver's ``slot`` the
    loop is its prepared loop (``core.gn.PreparedLoop``), made for ``target``
    and ``normals`` once and kept while they and the scan's length stay: the
    same launch and the same result."""
    settings = dict(max_dist=cfg.max_dist, huber_delta=cfg.huber_delta, tol=cfg.tol,
                    max_iter=cfg.max_iter)
    grid_normals = normals if kind == "plane_pt" else None

    def looper(state, src, w):
        if target.packed is None:
            grid, table, offsets = grid_operands(target, cfg, grid_normals)
            return gn_loop.grid_looper(kind, grid, table, src, w, offsets, state, **settings)
        return gn_loop.point_looper(kind, target.packed, target.proxy, src, w, state,
                                    proxy_radius=proxy_radius(cfg.corr, cfg.max_dist),
                                    **settings)

    if slot is not None:
        loop = gn.LoopRequest(slot, (kind, cfg), (target, grid_normals), source,
                              src_weight, looper)
    else:
        loop = lambda state: looper(state, source, src_weight)()  # noqa: E731
    stats_fn = fused_point_stats_resident(target, source, src_weight, cfg, kind, normals)
    return gn.gauss_newton_device(stats_fn, init_T, cfg.max_iter, cfg.tol, source.device,
                                  loop=loop)


def fused_point_align_batched(target: PointCorrTarget, normals: torch.Tensor | None, sources,
                              src_weights, init_Ts, cfg: ICPConfig | PlaneICPConfig,
                              kind: str = "point") -> tuple[torch.Tensor, GNDiagnostics]:
    """Batched multi-scan ``align`` of ``kind`` against one packed target, the
    whole loop of the B problems in one launch of the batched loop kernel
    (``gn_loop.point_loop_batched``; its plain version on the CPU) and one
    read of the state (``models/_point_fused.py::fused_point_align_batched``
    of the JAX package).

    ``sources`` (B, n, 3), ``src_weights`` (B, n) and ``init_Ts`` (B, 4, 4).
    Kind ``"plane_pt"`` takes the target that ``PlaneICP.set_target`` builds,
    whose packed slots carry the normals; ``normals``, the JAX function's
    operand for its fallback tiers, is not read: the kernel resolves every
    query itself. Returns ``(Ts (B, 4, 4), GNDiagnostics with leading dim
    B)``, as ``core.gn.batched_gauss_newton_device``.
    A grid target (no packed grid) raises ``ValueError``, as the JAX
    function needs a packed spec.
    """
    stats_all = fused_point_stats_packed_batched(target, sources, src_weights, cfg, kind)
    src, w = batch_on(target.packed.pts_packed.device, sources, src_weights)
    loop = functools.partial(gn_loop.point_loop_batched, kind, target.packed, target.proxy, src,
                             w, max_dist=cfg.max_dist,
                             proxy_radius=proxy_radius(cfg.corr, cfg.max_dist),
                             huber_delta=cfg.huber_delta, tol=cfg.tol, max_iter=cfg.max_iter)
    return gn.batched_gauss_newton_device(stats_all, init_Ts, cfg.max_iter, cfg.tol,
                                          target.packed.pts_packed.device, loop=loop)


def fused_point_stats_packed_batched(target: PointCorrTarget, sources, src_weights,
                                     cfg: ICPConfig | PlaneICPConfig, kind: str = "point",
                                     ) -> ResidentStats:
    """The stats of B scans against one packed target as a resident loop
    binds them (``core.gn.ResidentStats``): at ``(poses (B, 12), done (B,)
    or None)`` on the target's device, ``launch() -> (B, 29)`` there, one
    launch of the batched point kernel per call.
    ``sources`` (B, n, 3) and ``src_weights`` (B, n) go to the target's
    device once. A grid target (no packed grid) raises ``ValueError``, as
    the JAX function needs a packed spec."""
    if target.packed is None:
        raise ValueError("a grid target has no packed grid for the batched point kernel; "
                         "align its scans one by one")
    src, w = batch_on(target.packed.pts_packed.device, sources, src_weights)
    radius = proxy_radius(cfg.corr, cfg.max_dist)
    return lambda poses, done=None: resident_stats(kind, target.packed, target.proxy, src, w,
                                                   cfg.max_dist, radius, cfg.huber_delta,
                                                   poses, done)
