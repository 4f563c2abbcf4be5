"""Gauss-Newton align of ICP and PlaneICP (counterpart of
``point_cloud_registration_tpu/models/_point_fused.py``, kinds "point" for ICP
and "plane_pt" for PlaneICP, and of the plain ``icp_stats`` /
``plane_icp_stats``).

The target's layout picks the stats, as in the JAX package:

* a packed target: each iteration is one launch of
  ``ops/kernels/point_align.point_stats`` or ``plane_point_stats`` over the
  whole scan. The kernel resolves every query itself (tier 1 or the proxy
  voxel), so the TPU align's Morton layout, tile key lists, dense fused rows
  and fallback tiers (_point_fused.py:38-66, :110-167), which serve its VMEM
  tiles, have no counterpart;
* a grid target (small targets, ``"grid"`` correspondence): the CSR scan of
  ``match_points`` and the plain reductions of ``ops/reduce.py``
  (icp.py:48-56, plane_icp.py:60-85), which the JAX package also runs
  without a Pallas kernel (``point_fused_spec`` needs a packed target).

Either way the align runs the resident Gauss-Newton loop
(``core.gn.gauss_newton_device``): the stats read the pose from the loop's
state on the data's device and ``gn_step`` updates it there.

:func:`fused_point_align_batched` aligns B scans against one packed target
with one launch of the batched kernel per Gauss-Newton iteration, in the
resident loop of all B problems (``core.gn.batched_gauss_newton_device``).
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.core.config import ICPConfig, PlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import (
    GNDiagnostics,
    GNStats,
    ResidentStats,
    transforms_of,
)
from point_cloud_registration_tpu_torch.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu_torch.models._point_corr import (
    PointCorrTarget,
    match_points,
    proxy_radius,
)
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    packed_from_stats,
    stats_from_packed,
)
from point_cloud_registration_tpu_torch.ops.kernels.point_align import (
    plane_point_stats,
    point_stats,
    resident_stats,
)
from point_cloud_registration_tpu_torch.ops.reduce import plane_stats
from point_cloud_registration_tpu_torch.ops.reduce import point_stats as reduce_point_stats

_STATS_FN = {"point": point_stats, "plane_pt": plane_point_stats}


def grid_point_stats_packed(target: PointCorrTarget, source: torch.Tensor,
                            src_weight: torch.Tensor, T: torch.Tensor,
                            cfg: ICPConfig | PlaneICPConfig,
                            normals: torch.Tensor | None = None) -> torch.Tensor:
    """Grid correspondence + the point (``normals`` None) or point-to-plane
    linearization at ``T`` (float32 (4, 4), on the host or the data's
    device), as ``icp_stats`` and
    ``plane_icp_stats`` of the JAX package: a raw match takes
    ``normals[point_idx]``. -> the (29,) packed stats on the data's device
    (``ops/kernels/fused_align.packed_from_stats``)."""
    Td = T.to(source.device)
    R, _ = makeRt(Td)
    src_trans = transform_points(Td, source)
    m = match_points(target, src_trans, cfg.corr, cfg.max_dist)
    w = src_weight * m.weight
    if normals is None:
        stats = reduce_point_stats(source, src_trans, m.target, w, R,
                                   huber_delta=cfg.huber_delta)
    else:
        safe = m.point_idx.clamp(0, normals.shape[0] - 1)
        stats = plane_stats(source, src_trans, m.target, normals[safe], w, R,
                            huber_delta=cfg.huber_delta)
    return packed_from_stats(stats)


def grid_point_stats(target: PointCorrTarget, source: torch.Tensor, src_weight: torch.Tensor,
                     T: torch.Tensor, cfg: ICPConfig | PlaneICPConfig,
                     normals: torch.Tensor | None = None) -> GNStats:
    """:func:`grid_point_stats_packed` -> GNStats on the host, with one
    device sync."""
    return stats_from_packed(
        grid_point_stats_packed(target, source, src_weight, T, cfg, normals).cpu())


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
    reads the pose and the flag on the card, on a packed target; on a grid
    target :func:`grid_point_stats_packed` at the pose's transform (plain
    torch ops, skipped once the flag is set: ``core.gn.plain_launch``)."""
    if target.packed is None:
        nrm = normals if kind == "plane_pt" else None
        return lambda poses, done: gn.plain_launch(lambda: grid_point_stats_packed(
            target, source, src_weight, transforms_of(poses)[0], cfg, nrm), done)
    radius = proxy_radius(cfg.corr, cfg.max_dist)
    return lambda poses, done: resident_stats(kind, target.packed, target.proxy, source,
                                              src_weight, cfg.max_dist, radius,
                                              cfg.huber_delta, poses, done)


def fused_point_align(target: PointCorrTarget, source: torch.Tensor,
                      src_weight: torch.Tensor, init_T, cfg: ICPConfig | PlaneICPConfig,
                      kind: str = "point", normals: torch.Tensor | None = None,
                      ) -> tuple[torch.Tensor, GNDiagnostics]:
    """``align`` over :func:`fused_point_stats_resident` in the resident
    loop on the scan's device: returns ``(T, GNDiagnostics)`` on the host."""
    stats_fn = fused_point_stats_resident(target, source, src_weight, cfg, kind, normals)
    return gn.gauss_newton_device(stats_fn, init_T, cfg.max_iter, cfg.tol, source.device)


def fused_point_align_batched(target: PointCorrTarget, normals: torch.Tensor | None, sources,
                              src_weights, init_Ts, cfg: ICPConfig | PlaneICPConfig,
                              kind: str = "point") -> tuple[torch.Tensor, GNDiagnostics]:
    """Batched multi-scan ``align`` of ``kind`` against one packed target, one
    launch of the batched point kernel per Gauss-Newton iteration
    (``models/_point_fused.py::fused_point_align_batched`` of the JAX package).

    ``sources`` (B, n, 3), ``src_weights`` (B, n) and ``init_Ts`` (B, 4, 4).
    Kind ``"plane_pt"`` takes the target that ``PlaneICP.set_target`` builds,
    whose packed slots carry the normals; ``normals``, the JAX function's
    operand for its fallback tiers, is not read: the kernel resolves every
    query itself. Returns ``(Ts (B, 4, 4), GNDiagnostics with leading dim
    B)`` from the resident loop, as ``core.gn.batched_gauss_newton_device``.
    A grid target (no packed grid) raises ``ValueError``, as the JAX
    function needs a packed spec.
    """
    stats_all = fused_point_stats_packed_batched(target, sources, src_weights, cfg, kind)
    return gn.batched_gauss_newton_device(stats_all, init_Ts, cfg.max_iter, cfg.tol,
                                          target.packed.pts_packed.device)


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
    dev = target.packed.pts_packed.device
    src = torch.as_tensor(sources, dtype=torch.float32).to(dev).contiguous()
    w = torch.as_tensor(src_weights, dtype=torch.float32).to(dev).contiguous()
    radius = proxy_radius(cfg.corr, cfg.max_dist)
    return lambda poses, done=None: resident_stats(kind, target.packed, target.proxy, src, w,
                                                   cfg.max_dist, radius, cfg.huber_delta,
                                                   poses, done)
