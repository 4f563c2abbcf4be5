"""Object wrappers matching the reference's non-solver classes (counterpart
of ``point_cloud_registration_tpu/compat.py``).

``KDTree`` (``NeighborIndex``) keeps the reference's ``query(points, k) ->
(dist, idx)`` contract (kdtree.py:18-68) on the hashed grid, with exact
escapes; ``VoxelGrid`` the surface of voxel.py:52-179 on a
:class:`~point_cloud_registration_tpu_torch.ops.voxelize.VoxelMap`. Both take
NumPy or tensors and return NumPy, as the reference does; the work runs on
the points' device (a NumPy input goes to ``core.device.default_device()``,
the card, and raises without one unless ``device="cpu"`` is named).
"""

from __future__ import annotations

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.ops import knn as knn_ops
from point_cloud_registration_tpu_torch.ops.eigh3 import unpack_sym3
from point_cloud_registration_tpu_torch.ops.hashgrid import build_grid, search_offsets
from point_cloud_registration_tpu_torch.ops.kernels.exact_nn import exact_nn
from point_cloud_registration_tpu_torch.ops.normals import sample_knn_radius
from point_cloud_registration_tpu_torch.ops.voxelize import (
    VoxelMap,
    build_voxel_map,
    invert_cov_packed,
    query_nearest_voxel,
    sqrt_icov_packed,
    update_voxel_map,
)

# Distances per chunk of the brute-force k-NN escape: (queries x references).
KNN_ESCAPE_BUDGET = 1 << 26


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


class NeighborIndex:
    """Grid-backed neighbour index with the reference ``KDTree`` contract.

    ``query(points, k=1) -> (dist, idx)`` as pykdtree / scipy give it
    (kdtree.py:18-68), exact: candidates come from the 3^3 window of cells of
    the sampled k-NN radius (``radius_k``), and queries that the window
    cannot prove exact escape to exhaustive search (compat.py:59-104):

    * ``k = 1``: a best match no closer than one cell, none at all, or a
      window with a cell of more than ``cell_cap`` points; on the card the
      escapes go through the exact 1-NN kernel (``exact_nn``), on the CPU
      through its plain version (``ops.knn.brute_force_nn``): both give the
      minimum distance and the first index on ties;
    * ``k > radius_k`` or a target of at most ``exact_threshold`` points: all
      queries; ``k > 1`` escapes take ``ops.knn.brute_force_knn``.
    """

    def __init__(self, points, cell_size: float | None = None, cell_cap: int = 32,
                 radius_k: int = 8, exact_threshold: int = 20_000, *, device=None):
        dev = resolve_device(points, device)
        self.points = torch.as_tensor(points).to(device=dev, dtype=torch.float32).contiguous()
        if cell_size is None:
            cell_size = max(sample_knn_radius(self.points, radius_k), 1e-3)
        self.cell_size = float(cell_size)
        self.cell_cap = cell_cap
        self.radius_k = radius_k
        self.exact_threshold = exact_threshold
        self.grid, _, self.buckets = build_grid(self.points, self.cell_size, with_buckets=True)
        self._offsets = search_offsets(self.cell_size, self.cell_size)

    def _exact_1nn(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return exact_nn(q.contiguous(), self.points)

    def _exact_knn(self, q: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        chunk = max(1, min(2048, KNN_ESCAPE_BUDGET // max(1, self.points.shape[0])))
        return knn_ops.brute_force_knn(q, self.points, k=k, chunk=chunk)

    def query(self, points, k: int = 1):
        q = torch.as_tensor(points).to(device=self.points.device, dtype=torch.float32)
        small = self.points.shape[0] <= self.exact_threshold
        if k == 1:
            if small:
                d, i = self._exact_1nn(q)
                return _numpy(d), _numpy(i)
            res, over = knn_ops.nearest_point(self.grid, self.buckets, self.points, q,
                                              self._offsets, cap=self.cell_cap,
                                              with_overflow=True)
            dist, idx = res.dist.clone(), res.idx.clone()
            # A match no closer than one cell is not provably the nearest
            # (the window covers one cell), and neither is one whose window
            # held a cell of more than cell_cap points.
            rows = torch.nonzero(~(dist < self.cell_size) | over)[:, 0]
            if rows.numel():
                dist[rows], idx[rows] = self._exact_1nn(q[rows])
            return _numpy(dist), _numpy(idx)
        if small or k > self.radius_k:
            d, i = self._exact_knn(q, k)
            return _numpy(d), _numpy(i)
        d, i, over = knn_ops.knn_points(self.grid, self.buckets, self.points, q, self._offsets,
                                        cap=self.cell_cap, k=k, with_overflow=True)
        # the k-th neighbour beyond one cell, or a window cell over the cap
        rows = torch.nonzero(~(d[:, k - 1] < self.cell_size) | over)[:, 0]
        if rows.numel():
            d[rows], i[rows] = self._exact_knn(q[rows], k)
        return _numpy(d), _numpy(i)


# Name parity with the reference export (kdtree.py, __init__.py:7).
KDTree = NeighborIndex


class VoxelGrid:
    """Stateful wrapper over a :class:`VoxelMap` (the reference's
    voxel.py:52-179 surface).

    ``mean`` / ``cov`` / ``norm`` / ``icov`` are the valid voxels' fields,
    compacted, as NumPy; ``query`` gives the nearest *valid* voxel of each
    point with the requested fields and ``dist``.
    """

    def __init__(self, voxel_size: float, min_points: int = 10,
                 query_max_dist: float | None = None, *, device=None):
        self.voxel_size = voxel_size
        self.min_points = min_points
        # Radius of query()'s window search; beyond it the exact brute-force
        # search takes over, so any distance gets the true nearest voxel.
        self.query_max_dist = (
            query_max_dist if query_max_dist is not None else max(2.0, voxel_size)
        )
        self.device = device
        self._map: VoxelMap | None = None
        self._compact: dict[str, np.ndarray] = {}

    @property
    def voxel_map(self) -> VoxelMap:
        if self._map is None:
            raise ValueError("set_points has not been called")
        return self._map

    def set_points(self, points) -> None:
        """Per-voxel Gaussian statistics (voxel.py:104-169)."""
        self._map = build_voxel_map(points, self.voxel_size, min_points=self.min_points,
                                    device=resolve_device(points, self.device))
        self._compact = {}

    def update_points(self, points) -> None:
        """Merge points into the voxel statistics (``update_voxel_map``)."""
        self._map = update_voxel_map(self.voxel_map, points, min_points=self.min_points)
        self._compact = {}

    def calc_icov(self) -> None:
        """Attach the analytic inverse covariances (voxel.py:69-102)."""
        m = self.voxel_map
        self._map = m._replace(icovs=invert_cov_packed(m.covs))
        self._compact.pop("icov", None)

    def calc_sqrt_icov(self) -> None:
        """Attach the upper-triangular square roots of the inverse
        covariances as ``sqrt_icov`` (valid voxels, NumPy; voxel.py:61-67)."""
        if self.voxel_map.icovs is None:
            self.calc_icov()
        self.sqrt_icov = _numpy(sqrt_icov_packed(self.voxel_map.icovs))[self._valid_order()]

    def _valid_order(self) -> np.ndarray:
        return np.flatnonzero(_numpy(self.voxel_map.valid))

    def _field(self, name: str) -> torch.Tensor:
        m = self.voxel_map
        if name == "mean":
            return m.means
        if name == "norm":
            return m.normals
        if name == "cov":
            return unpack_sym3(m.covs)
        if name == "icov":
            if m.icovs is None:
                raise ValueError("call calc_icov() first")
            return unpack_sym3(m.icovs)
        if name == "count":
            return m.counts
        raise KeyError(name)

    def _compacted(self, name: str) -> np.ndarray:
        if name not in self._compact:
            self._compact[name] = _numpy(self._field(name))[self._valid_order()]
        return self._compact[name]

    mean = property(lambda self: self._compacted("mean"))
    norm = property(lambda self: self._compacted("norm"))
    cov = property(lambda self: self._compacted("cov"))
    icov = property(lambda self: self._compacted("icov"))

    def query(self, points, names, max_dist: float | None = None):
        """Nearest-valid-voxel fields of each point (voxel.py:171-179):
        ``{name: (N, ...) field, 'dist': (N,)}``.

        The window search covers ``max_dist`` (default ``query_max_dist``,
        at least one voxel); a query without a valid voxel closer than that
        is searched exhaustively over the valid centroids, so every query
        gets its true nearest voxel at any distance, as the reference's
        kd-tree over the means gives it.
        """
        m = self.voxel_map
        q = torch.as_tensor(points).to(device=m.means.device, dtype=torch.float32)
        md = float(max_dist) if max_dist is not None else self.query_max_dist
        md_eff = max(md, self.voxel_size)
        res = query_nearest_voxel(m, q, voxel_size=self.voxel_size, max_dist=md_eff)
        dist, idx = res.dist.clone(), res.idx.clone()
        rows = torch.nonzero(~(dist < md_eff))[:, 0]
        if rows.numel():
            # exhaustive over the valid centroids, in slot order: the first
            # valid slot wins a tie, as with the JAX package's valid mask
            valid_slots = torch.nonzero(m.valid)[:, 0]
            d, i = knn_ops.brute_force_nn(q[rows], m.means[valid_slots])
            found = i >= 0
            dist[rows] = d
            idx[rows] = torch.where(found, valid_slots[i.clamp(min=0).long()].to(torch.int32), -1)
        slot = idx.clamp(0, m.means.shape[0] - 1).to(torch.int64)
        out = {"dist": _numpy(dist)}
        for name in names:
            if name == "count":
                raise KeyError(name)
            out[name] = _numpy(self._field(name)[slot])
        return out
