"""The voxel grid as a spatial index (counterpart of
``point_cloud_registration_tpu/ops/hashgrid.py``).

Cells are absolute integer coordinates ``floor(p / cell_size)``, the grouping
of the reference hash (voxel.py:16). A map keys its cells by position inside
its bounding box (``x + nx * (y + ny * z)``), which is collision free and fits
int32. :func:`build_grid` indexes the occupied cells of a point set:

* their keys, sorted and padded with :data:`INVALID_KEY` to a capacity, so a
  lookup is a binary search (``torch.searchsorted``); below a budget of cells
  also a dense key -> slot table, so a lookup is one gather;
* optionally the points bucketed CSR-style by cell (a stable sort by slot,
  then a start and a count per slot), so a nearest-neighbour query scans the
  candidates of a fixed window of cells.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.device import resolve_device

# Padding key for unoccupied slots: sorts after every real key.
INVALID_KEY = np.iinfo(np.int32).max
# Ceiling for a dense per-cell table (cells); larger boxes are indexed by
# their sorted keys alone.
DENSE_CELL_BUDGET = 1 << 26
# Query cells are clamped to +-CELL_CLAMP before the integer conversion, so a
# far query lands outside every grid instead of overflowing int32; the
# kernels clamp alike (gn_accumulate.cuh clamped_cell).
CELL_CLAMP = 1e9


class Grid(NamedTuple):
    """Index over the occupied cells of one point set."""

    origin_cell: tuple[int, int, int]  # minimum absolute cell coordinate
    cell_size: float
    dims: tuple[int, int, int]  # cells per axis inside the bounding box
    keys: torch.Tensor  # (C,) i32: sorted unique linear keys, INVALID_KEY padded
    n_cells: int  # occupied cells (<= C)
    dense: torch.Tensor | None  # (D,) i32: key -> slot, -1 if empty; None over the budget


class Buckets(NamedTuple):
    """CSR point buckets: the points of slot ``s`` are
    ``perm[starts[s] : starts[s] + counts[s]]``, in their input order."""

    perm: torch.Tensor  # (N,) i32: point indices sorted by slot
    starts: torch.Tensor  # (C,) i32
    counts: torch.Tensor  # (C,) i32


def cell_coords(points: torch.Tensor, cell_size) -> torch.Tensor:
    """Absolute integer cell coordinates ``floor(p / cell_size)`` -> (..., 3) i32.

    True float32 division, as in the JAX package. The divisor is a tensor on
    the points' device: divided by a Python scalar, CUDA tensors are
    multiplied by the scalar's reciprocal instead, which can move a point
    that lies within an ulp of a cell border into the neighbouring cell.
    """
    div = torch.as_tensor(cell_size, dtype=points.dtype, device=points.device)
    return torch.floor(points / div).to(torch.int32)


def query_cells(points: torch.Tensor, cell_size) -> torch.Tensor:
    """:func:`cell_coords` as int64, clamped to ``+-CELL_CLAMP`` first, for
    queries that may lie anywhere."""
    div = torch.as_tensor(cell_size, dtype=points.dtype, device=points.device)
    return torch.floor(points / div).clamp(-CELL_CLAMP, CELL_CLAMP).to(torch.int64)


def coords_to_key(coords: torch.Tensor, origin_cell, dims) -> torch.Tensor:
    """Linear bounding-box key of (..., 3) cell coordinates, -1 out of range
    (hashgrid.py:67). Queries outside the box find no neighbour, the
    ``max_dist`` gate of every solver. Returns int32."""
    dev = coords.device
    rel = coords.to(torch.int64) - torch.tensor(origin_cell, dtype=torch.int64, device=dev)
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)
    in_range = ((rel >= 0) & (rel < dims_t)).all(dim=-1)
    key = rel[..., 0] + dims_t[0] * (rel[..., 1] + dims_t[1] * rel[..., 2])
    return torch.where(in_range, key, torch.full_like(key, -1)).to(torch.int32)


def lookup_slots(grid: Grid, query_keys: torch.Tensor) -> torch.Tensor:
    """Linear cell keys -> slots, -1 where the cell is empty (hashgrid.py:80).

    With a dense table one gather; without, a binary search over the sorted
    keys."""
    q = query_keys.to(torch.int32)
    miss = torch.full_like(q, -1)
    if grid.dense is not None:
        slots = grid.dense[q.clamp(0, grid.dense.shape[0] - 1).to(torch.int64)]
        return torch.where(q >= 0, slots, miss)
    pos = torch.searchsorted(grid.keys, q.contiguous()).clamp(max=grid.keys.shape[0] - 1)
    hit = (grid.keys[pos] == q) & (q >= 0)
    return torch.where(hit, pos.to(torch.int32), miss)


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _bbox_cells(points, cell_size: float) -> tuple[np.ndarray, np.ndarray]:
    """Host-side bounding box in cell units: ``(lo_cell, hi_cell)`` int64.

    NumPy inputs are reduced on the host; tensors cost one device-to-host
    copy of the two corners. Both reduce in float32, so the cells are
    identical wherever the input lives.
    """
    if points.shape[0] == 0:
        raise ValueError("empty point cloud: at least one point is required")
    if isinstance(points, np.ndarray):
        pts32 = points if points.dtype == np.float32 else points.astype(np.float32)
        lo = pts32.min(axis=0).astype(np.float64)
        hi = pts32.max(axis=0).astype(np.float64)
    else:
        p32 = points.to(torch.float32)
        corners = torch.stack([p32.amin(dim=0), p32.amax(dim=0)]).cpu().numpy()
        lo = corners[0].astype(np.float64)
        hi = corners[1].astype(np.float64)
    lo_cell = np.floor(lo / cell_size).astype(np.int64)
    hi_cell = np.floor(hi / cell_size).astype(np.int64)
    return lo_cell, hi_cell


def build_grid(
    points,
    cell_size: float,
    *,
    capacity: int | None = None,
    with_buckets: bool = False,
    dense_budget: int = DENSE_CELL_BUDGET,
    device=None,
) -> tuple[Grid, torch.Tensor, Buckets | None]:
    """Index ``points`` (N, 3), a NumPy array or a tensor, on ``device``
    (default: the tensor's device, or ``core.device.default_device()``)
    (hashgrid.py:124-216).

    Returns ``(grid, inverse, buckets)``: ``inverse[i]`` (int32) is the slot
    of point i's cell, ``buckets`` the CSR layout (``with_buckets`` only).
    ``capacity`` (slots) defaults to min(N, cells of the box) rounded up to a
    power of two; the dense table is built when the box holds at most
    ``dense_budget`` cells. A point whose float32 cell falls one past the
    host's float64 box (an ulp from a border) gets :data:`INVALID_KEY`: it
    joins the padding slot, which no lookup returns.
    """
    lo_cell, hi_cell = _bbox_cells(points, cell_size)
    dev = resolve_device(points, device)
    points = torch.as_tensor(points).to(device=dev, dtype=torch.float32)
    n = points.shape[0]
    dims = tuple(int(x) for x in hi_cell - lo_cell + 1)
    total_cells = int(np.prod([float(d) for d in dims]))
    if total_cells >= np.iinfo(np.int32).max:
        raise ValueError(
            f"grid of {dims} cells ({total_cells}) exceeds int32 keyspace; "
            "increase cell_size"
        )
    if capacity is None:
        capacity = _round_up_pow2(min(n, total_cells))
    origin = tuple(int(x) for x in lo_cell)
    cell_size = float(np.float32(cell_size))

    keys = coords_to_key(cell_coords(points, cell_size), origin, dims)
    keys = torch.where(keys < 0, torch.full_like(keys, INVALID_KEY), keys)
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    if uniq.shape[0] > capacity:
        raise ValueError(f"{uniq.shape[0]} occupied cells exceed the capacity {capacity}")
    unique_keys = torch.full((capacity,), INVALID_KEY, dtype=torch.int32, device=dev)
    unique_keys[:uniq.shape[0]] = uniq
    inverse = inverse.to(torch.int32)
    n_cells = int((uniq != INVALID_KEY).sum())

    dense = None
    if total_cells <= dense_budget:
        dense = torch.full((_round_up_pow2(total_cells),), -1, dtype=torch.int32, device=dev)
        real = uniq[:n_cells].to(torch.int64)
        dense[real] = torch.arange(n_cells, dtype=torch.int32, device=dev)

    buckets = None
    if with_buckets:
        counts = torch.bincount(inverse.to(torch.int64), minlength=capacity).to(torch.int32)
        starts = (torch.cumsum(counts, dim=0) - counts).to(torch.int32)
        perm = torch.argsort(inverse, stable=True).to(torch.int32)
        buckets = Buckets(perm=perm, starts=starts, counts=counts)

    grid = Grid(origin_cell=origin, cell_size=cell_size, dims=dims, keys=unique_keys,
                n_cells=n_cells, dense=dense)
    return grid, inverse, buckets


def search_offsets(max_dist: float, cell_size: float) -> np.ndarray:
    """(K, 3) int32 neighbour-cell offsets that exactly cover a
    ``dist < max_dist`` gated nearest-neighbour query (hashgrid.py:218-238).

    A cell at per-axis offset ``k`` can hold a point closer than ``max_dist``
    iff the per-axis gaps ``max(0, |k| - 1) * cell_size`` satisfy
    ``sum(gap^2) < max_dist^2``; others are pruned. Ordered by ``|k|^2``
    (stable), the likeliest-nearest cells first: the probe order in which the
    first minimum wins.
    """
    k_max = int(np.ceil(max_dist / cell_size - 1e-9))
    rng = np.arange(-k_max, k_max + 1)
    ox, oy, oz = np.meshgrid(rng, rng, rng, indexing="ij")
    offs = np.stack([ox.ravel(), oy.ravel(), oz.ravel()], axis=-1)
    gap = np.maximum(0, np.abs(offs) - 1) * cell_size
    keep = np.sum(gap * gap, axis=-1) < max_dist * max_dist
    offs = offs[keep]
    order = np.argsort(np.sum(offs * offs, axis=-1), kind="stable")
    return offs[order].astype(np.int32)
