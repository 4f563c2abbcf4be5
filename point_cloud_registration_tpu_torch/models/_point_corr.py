"""Raw-point correspondence engine of ICP and PlaneICP (counterpart of
``point_cloud_registration_tpu/models/_point_corr.py``, its packed backend).

The packed backend (``ops/pointgrid.py``) is provably exact within
``cell_fine``; queries it leaves unresolved take the nearest centroid of the
proxy voxel map built from the same packed rows. The JAX package's other
backend, ``"grid"`` (the CSR bucket scan of ``hashgrid.build_grid`` and
``knn.nearest_point``), is not ported: asking for it raises
``NotImplementedError``, and ``"auto"`` asks for it below
``CorrespondenceConfig.auto_threshold`` target points.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from point_cloud_registration_tpu_torch.core.config import CorrespondenceConfig
from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.ops.knn import window_radius
from point_cloud_registration_tpu_torch.ops.pointgrid import (
    PackedPointGrid,
    PointMatch,
    ProxyMap,
    build_packed_grid_and_proxy,
    match_packed,
)

__all__ = ["PointCorrTarget", "PointMatch", "build_point_corr", "cell_fine_of",
           "match_points", "proxy_radius"]


class PointCorrTarget(NamedTuple):
    """Indexed target cloud of the packed backend."""

    points: torch.Tensor  # (N, 3) f32
    packed: PackedPointGrid
    proxy: ProxyMap  # coarse voxel map for unresolved queries


def cell_fine_of(corr: CorrespondenceConfig, max_dist: float) -> float:
    """The packed method's fine-cell size: ``cell_fine`` or max_dist / 4."""
    return corr.cell_fine if corr.cell_fine is not None else max_dist / 4


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
    if method != "packed":
        raise NotImplementedError(
            f"correspondence method {method!r} (the CSR grid scan) is not ported; "
            'use CorrespondenceConfig(method="packed")'
        )
    pg, proxy = build_packed_grid_and_proxy(
        points, cell_fine_of(corr, max_dist), cap=corr.packed_cap,
        min_points=proxy_min_points, with_normals=proxy_normals, feats=feats,
    )
    return PointCorrTarget(points=points, packed=pg, proxy=proxy)


def match_points(target: PointCorrTarget, query: torch.Tensor,
                 corr: CorrespondenceConfig, max_dist: float) -> PointMatch:
    """Gated nearest-target lookup for transformed source points."""
    return match_packed(target.packed, target.proxy, query, max_dist,
                        proxy_radius(corr, max_dist))
