"""Raw-point correspondence engine of ICP and PlaneICP (counterpart of
``point_cloud_registration_tpu/models/_point_corr.py``).

Two backends behind one target, as in the JAX package; ``"auto"`` picks
``"packed"`` from ``CorrespondenceConfig.auto_threshold`` target points on:

* ``packed`` (``ops/pointgrid.py``): provably exact within ``cell_fine``;
  queries it leaves unresolved take the nearest centroid of the proxy voxel
  map built from the same packed rows. The point stats kernels read it.
* ``grid``: the CSR bucket scan (``hashgrid.build_grid`` with buckets and
  ``knn.nearest_point``, cells of ``cell_size`` or ``max_dist / 2``), exact
  within the covering window up to the per-cell cap ``cell_cap``. Plain
  torch ops, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from point_cloud_registration_tpu_torch.core.config import CorrespondenceConfig
from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.ops.hashgrid import (
    Buckets,
    Grid,
    build_grid,
    search_offsets,
)
from point_cloud_registration_tpu_torch.ops.knn import nearest_point, window_radius
from point_cloud_registration_tpu_torch.ops.pointgrid import (
    PackedPointGrid,
    PointMatch,
    ProxyMap,
    build_packed_grid_and_proxy,
    match_packed,
)

__all__ = ["PointCorrTarget", "PointMatch", "build_point_corr", "cell_fine_of",
           "grid_cell_of", "match_points", "proxy_radius"]


class PointCorrTarget(NamedTuple):
    """Indexed target cloud; one backend's fields are set, the other's None."""

    points: torch.Tensor  # (N, 3) f32
    packed: PackedPointGrid | None
    proxy: ProxyMap | None  # coarse voxel map for unresolved queries
    grid: Grid | None = None
    buckets: Buckets | None = None


def cell_fine_of(corr: CorrespondenceConfig, max_dist: float) -> float:
    """The packed method's fine-cell size: ``cell_fine`` or max_dist / 4."""
    return corr.cell_fine if corr.cell_fine is not None else max_dist / 4


def grid_cell_of(corr: CorrespondenceConfig, max_dist: float) -> float:
    """The grid method's bucket cell: ``cell_size`` or max_dist / 2."""
    return corr.cell_size if corr.cell_size is not None else max_dist / 2


def proxy_radius(corr: CorrespondenceConfig, max_dist: float) -> int:
    """Proxy window radius in proxy cells (``2 * cell_fine``) that covers
    ``max_dist`` (_point_corr.py:160-184)."""
    return window_radius(max_dist, float(2 * cell_fine_of(corr, max_dist)))


def build_point_corr(points, corr: CorrespondenceConfig, max_dist: float, *,
                     proxy_min_points: int = 1, proxy_normals: bool = False, feats=None,
                     device=None) -> PointCorrTarget:
    """Index ``points`` (N, 3), a NumPy array or a tensor, on ``device``
    (default: the tensor's device, or ``core.device.default_device()`` for
    NumPy input). ``feats`` (N, F) ride inside the packed rows (PlaneICP's
    normals); ``proxy_normals`` forms the proxy voxels' plane normals."""
    device = resolve_device(points, device)
    points = torch.as_tensor(points).to(device=device, dtype=torch.float32)
    if feats is not None:
        feats = torch.as_tensor(feats).to(device=device, dtype=torch.float32)
    method = corr.resolved_method(points.shape[0])
    if method == "grid":
        grid, _, buckets = build_grid(points, grid_cell_of(corr, max_dist), with_buckets=True)
        return PointCorrTarget(points=points, packed=None, proxy=None, grid=grid,
                               buckets=buckets)
    pg, proxy = build_packed_grid_and_proxy(
        points, cell_fine_of(corr, max_dist), cap=corr.packed_cap,
        min_points=proxy_min_points, with_normals=proxy_normals, feats=feats,
    )
    return PointCorrTarget(points=points, packed=pg, proxy=proxy)


def match_points(target: PointCorrTarget, query: torch.Tensor,
                 corr: CorrespondenceConfig, max_dist: float) -> PointMatch:
    """Gated nearest-target lookup for transformed source points. On a grid
    target (_point_corr.py:135-148) the match is a raw point or none:
    ``proxy_slot`` is -1 and ``feat`` empty."""
    if target.packed is None:
        nn = nearest_point(target.grid, target.buckets, target.points, query,
                           search_offsets(max_dist, grid_cell_of(corr, max_dist)),
                           cap=corr.cell_cap)
        idx = nn.idx.to(torch.int64)
        w = ((nn.dist < max_dist) & (idx >= 0)).to(torch.float32)
        safe = idx.clamp(0, target.points.shape[0] - 1)
        return PointMatch(target=target.points[safe], weight=w, point_idx=idx,
                          proxy_slot=torch.full_like(idx, -1),
                          feat=query.new_zeros((query.shape[0], 0)))
    return match_packed(target.packed, target.proxy, query, max_dist,
                        proxy_radius(corr, max_dist))
