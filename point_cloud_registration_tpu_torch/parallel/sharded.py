"""Sharded and batched alignment on ``torch.distributed`` (counterpart of
``point_cloud_registration_tpu/parallel/sharded.py``).

* **data parallel** (:func:`align_sharded`): the scan's points are split
  over the mesh's ``data`` axis. Every solver's per-iteration stats (H, g,
  e2, n) are sums over the points, so one SUM all-reduce of each rank's 29
  values gives the single-device normal equations; every rank then runs the
  same host Gauss-Newton loop (``core/gn.py::gauss_newton``: the all-reduce
  runs through the host each iteration) on the same bits and holds the
  same T. A rank's stats come from the stats kernel of its kind on its
  shard: Q2-1 (``fused_align.cu``, plane / ndt) on a dense voxel map, Q2-2
  (``point_align.cu``, point / plane_pt) on a packed target, and
  ``grid_align.cu`` on a hashed map or a grid target, as on one device.
* **batch parallel** (:func:`align_batched_sharded`): problems over
  ``batch``, each problem's points over ``data``; one batched launch per
  iteration for a rank's problems, an all-reduce over ``data``, and the
  results gathered over ``batch`` at the end.
* **the fused batched streams** (:func:`align_batched_fused_sharded`):
  problems over the ranks, each rank running the batched align of
  ``models/_fused.py`` / ``_point_fused.py`` on its own problems in the
  resident loop on its card; no collective in the loop, one gather at the
  end.

The arguments are the global arrays, as in JAX; each rank takes its part.
The target map is replicated: every rank builds or holds it on its compute
device, whose kernels then run there. JAX's ``fixed_tiers`` override of the
batched path has no counterpart: the port has no tiers.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from point_cloud_registration_tpu_torch.core.gn import (
    GNDiagnostics,
    batched_gauss_newton,
    gauss_newton,
    pose_rows_of,
)
from point_cloud_registration_tpu_torch.models._fused import (
    fused_voxel_align_batched,
    fused_voxel_stats_packed,
    fused_voxel_stats_packed_batched,
)
from point_cloud_registration_tpu_torch.models._point_fused import (
    fused_point_align_batched,
    fused_point_stats_packed,
    fused_point_stats_packed_batched,
)
from point_cloud_registration_tpu_torch.models.base import AlignResult
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import stats_from_packed
from point_cloud_registration_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce,
    axes_rank,
    axes_size,
    axis_size,
)


def _icp_stats(target, source, src_weight, T, cfg) -> torch.Tensor:
    return fused_point_stats_packed(target, source, src_weight, T, cfg, "point")


def _plane_icp_stats(target, source, src_weight, T, cfg) -> torch.Tensor:
    return fused_point_stats_packed(target.corr, source, src_weight, T, cfg, "plane_pt",
                                    target.normals)


def _vplane_stats(target, source, src_weight, T, cfg) -> torch.Tensor:
    return fused_voxel_stats_packed(target, source, src_weight, T, cfg, "plane")


def _ndt_stats(target, source, src_weight, T, cfg) -> torch.Tensor:
    return fused_voxel_stats_packed(target, source, src_weight, T, cfg, "ndt")


# Solver registry: kind -> stats(target, source, src_weight, T, cfg) -> the
# (29,) packed stats on the target's device.
STATS_FNS: dict[str, Callable] = {
    "icp": _icp_stats,
    "plane_icp": _plane_icp_stats,
    "vplane_icp": _vplane_stats,
    "ndt": _ndt_stats,
}
_VOXEL_KINDS = {"vplane_icp": "plane", "ndt": "ndt"}
_POINT_KINDS = {"icp": "point", "plane_icp": "plane_pt"}
FUSED_KINDS = ("plane", "ndt", "point", "plane_pt")


def target_device(target) -> torch.device:
    """The compute device of a solver's target: a voxel map, a raw-point
    correspondence target or PlaneICP's target."""
    target = getattr(target, "corr", target)
    return (target.means if hasattr(target, "means") else target.points).device


def part(x, parts: int, index: int, dim: int = 0, what: str = "data") -> torch.Tensor:
    """Part ``index`` of ``parts`` equal parts of ``x`` along ``dim``; the
    length must divide (``ValueError`` otherwise: pad with
    ``models.base.pad_points``, whose padding weighs 0)."""
    x = torch.as_tensor(x)
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"length {n} does not divide over {parts} {what} shards "
                         "(pad with models.base.pad_points)")
    k = n // parts
    return x.narrow(dim, index * k, k)


def _local(x, dev) -> torch.Tensor:
    return x.to(device=dev, dtype=torch.float32).contiguous()


def align_sharded(kind: str, target, source, src_weight, init_T, cfg,
                  mesh: DeviceMesh) -> AlignResult:
    """One alignment with the scan's points split over the mesh's ``data``
    axis: per iteration, the stats of this rank's shard and one SUM
    all-reduce of the 29 values over ``data``.

    ``source`` (N, 3) / ``src_weight`` (N,) are the whole scan; N must
    divide by the data size (``models.base.pad_points``: padding weighs 0).
    Returns the same ``AlignResult`` on every rank.
    """
    stats_fn_kind = STATS_FNS[kind]
    dev = target_device(target)
    nd, r = axis_size(mesh, "data"), axes_rank(mesh, ("data",))
    src = _local(part(source, nd, r), dev)
    w = _local(part(src_weight, nd, r), dev)

    def stats_fn(T):
        packed = stats_fn_kind(target, src, w, T, cfg)
        return stats_from_packed(all_reduce(packed, mesh, ("data",)).cpu())

    T, diag = gauss_newton(stats_fn, init_T, cfg.max_iter, cfg.tol)
    return AlignResult(T=T, diagnostics=diag)


def _batched_stats(kind: str, target, sources: torch.Tensor, src_weights: torch.Tensor,
                   cfg) -> Callable[[torch.Tensor], torch.Tensor]:
    """``Ts`` (b, 4, 4) -> (b, 29) packed stats of b problems: one batched
    launch where the target has a cell index or a packed grid, the plain
    per-problem stats otherwise."""
    if kind in _VOXEL_KINDS and not target.hashed:
        at_poses = fused_voxel_stats_packed_batched(target, sources, src_weights, cfg,
                                                    _VOXEL_KINDS[kind])
        return lambda Ts: at_poses(pose_rows_of(Ts).to(sources.device))()
    if kind in _POINT_KINDS and getattr(target, "corr", target).packed is not None:
        at_poses = fused_point_stats_packed_batched(getattr(target, "corr", target), sources,
                                                    src_weights, cfg, _POINT_KINDS[kind])
        return lambda Ts: at_poses(pose_rows_of(Ts).to(sources.device))()
    stats = STATS_FNS[kind]
    return lambda Ts: torch.stack([stats(target, sources[b], src_weights[b], Ts[b], cfg)
                                   for b in range(Ts.shape[0])])


def align_batched_sharded(kind: str, target, sources, src_weights, init_Ts, cfg,
                          mesh: DeviceMesh) -> AlignResult:
    """Batched multi-scan registration: problems over ``batch``, each
    problem's points over ``data``.

    ``sources`` (B, N, 3), ``src_weights`` (B, N) and ``init_Ts`` (B, 4, 4):
    B must divide by the batch size and N by the data size. Per iteration,
    the stats of this rank's problems on its points (one batched launch of
    the kind's kernel, ``models/_fused.py`` / ``_point_fused.py``) and one
    SUM all-reduce over ``data``; ``core.gn.batched_gauss_newton``
    runs the loop. Returns every problem's result on every rank: T
    (B, 4, 4) and diagnostics with leading dim B, gathered over ``batch``.
    """
    dev = target_device(target)
    nb, nd = axis_size(mesh, "batch"), axis_size(mesh, "data")
    bi, di = axes_rank(mesh, ("batch",)), axes_rank(mesh, ("data",))
    src = _local(part(part(sources, nb, bi, 0, "batch"), nd, di, 1), dev)
    w = _local(part(part(src_weights, nb, bi, 0, "batch"), nd, di, 1), dev)
    T0 = part(init_Ts, nb, bi, 0, "batch")
    stats_all = _batched_stats(kind, target, src, w, cfg)

    def stats_fn(Ts):
        return stats_from_packed(all_reduce(stats_all(Ts), mesh, ("data",)).cpu())

    Ts, diag = batched_gauss_newton(stats_fn, T0, cfg.max_iter, cfg.tol)
    return gather_results(Ts, diag, mesh, ("batch",))


def align_batched_fused_sharded(target, normals, sources, src_weights, init_Ts, cfg,
                                kind: str, mesh: DeviceMesh) -> AlignResult:
    """Batched registration on the fused streams, problems split over ranks.

    The multi-rank twin of ``models._fused.fused_voxel_align_batched``
    (``kind`` ``"plane"`` / ``"ndt"``: ``target`` a dense voxel map,
    ``normals`` ignored) and ``models._point_fused.fused_point_align_batched``
    (``"point"`` / ``"plane_pt"``: ``target`` a packed
    ``PointCorrTarget``, ``normals`` its normal field or None). Each rank
    runs the whole batched align, one launch per iteration in the resident
    loop, on its own problems: no collective in the loop, one gather at the
    end.

    ``sources`` (B, n, 3) / ``src_weights`` (B, n) / ``init_Ts`` (B, 4, 4).
    When B divides the whole mesh (batch x data), problems go over every
    rank; otherwise over ``batch`` alone, the ``data`` ranks of a batch
    row doing the same work. B must divide at least the batch size. Returns
    stacked results with leading dim B on every rank.
    """
    if kind not in FUSED_KINDS:
        raise ValueError(f"unknown fused kind {kind!r}; expected one of {FUSED_KINDS}")
    nb, nd = axis_size(mesh, "batch"), axis_size(mesh, "data")
    n_all = nb * nd
    B = torch.as_tensor(sources).shape[0]
    if nd > 1 and B % n_all == 0:
        axes = ("batch", "data")
    elif B % nb == 0:
        axes = ("batch",)
    else:
        raise ValueError(f"batch {B} does not divide over {nb} batch shards "
                         f"(nor over all {n_all} devices)")
    parts, i = axes_size(mesh, axes), axes_rank(mesh, axes)
    s, w, T0 = (part(x, parts, i, 0, "batch") for x in (sources, src_weights, init_Ts))
    if kind in ("plane", "ndt"):
        Ts, diag = fused_voxel_align_batched(target, s, w, T0, cfg, kind)
    else:
        Ts, diag = fused_point_align_batched(target, normals, s, w, T0, cfg, kind)
    return gather_results(Ts, diag, mesh, axes)


def gather_results(Ts: torch.Tensor, diag: GNDiagnostics, mesh: DeviceMesh,
                   axes: tuple) -> AlignResult:
    """The batched results of every rank over ``axes``, stacked in problem
    order: one all-gather of one float64 row per problem (T, the counts,
    flags and histories; float64 holds each float32 and int32 exactly)."""
    m = diag.e2_history.shape[1]
    cols = [Ts.reshape(-1, 16), diag.iterations[:, None], diag.converged[:, None],
            diag.solver_failed[:, None], diag.final_e2[:, None], diag.e2_history,
            diag.dx_norm_history, diag.inlier_history]
    rows = all_gather_rows(torch.cat([c.to(torch.float64) for c in cols], dim=1), mesh, axes)
    T, it, conv, failed, final_e2, e2h, dxh, inl = torch.split(rows, [16, 1, 1, 1, 1, m, m, m],
                                                               dim=1)
    out = GNDiagnostics(
        iterations=it[:, 0].to(torch.int32),
        converged=conv[:, 0].to(torch.bool),
        solver_failed=failed[:, 0].to(torch.bool),
        e2_history=e2h.to(torch.float32),
        dx_norm_history=dxh.to(torch.float32),
        inlier_history=inl.to(torch.int32),
        final_e2=final_e2[:, 0].to(torch.float32),
    )
    return AlignResult(T=T.to(torch.float32).reshape(-1, 4, 4), diagnostics=out)
