"""Voxel-map construction: per-voxel Gaussian statistics (counterpart of
``point_cloud_registration_tpu/ops/voxelize.py``).

The reference ``VoxelGrid.set_points`` pipeline (voxel.py:104-169) becomes:

* grouping by the bounding-box cell key (``ops.hashgrid``). Below
  ``DENSE_CELL_BUDGET`` cells the voxel slot is the linear cell key (the
  dense-direct build); above it, or when a ``capacity`` is given, the slots
  are the sorted occupied keys of ``hashgrid.build_grid`` (the hashed build,
  which carries its :class:`~point_cloud_registration_tpu_torch.ops.hashgrid.Grid`);
* per-voxel count/mean/covariance from moments accumulated in *cell-local*
  coordinates, so float32 keeps full precision for maps hundreds of meters
  across; the covariance divisor is n - 1 (voxel.py:140-148);
* the min_points filter (voxel.py:56) as a validity mask;
* normals from the closed-form symmetric 3x3 eigensolver (``ops.eigh3``),
  zero on invalid cells;
* for NDT, the inverse covariances (``invert_cov_packed``) and their upper
  Cholesky factors (``sqrt_icov_u6``). A build with icovs takes its moments'
  products and the statistics in float64 (``_local_sums(exact=True)``) and
  inverts in float64 before the one rounding to float32: a thin cell's icov
  (eigenvalues up to 1 / sigma**2, 1e3-1e4 on 2-3 cm surfaces) would carry
  the float32 cancellation of ``E[ll^T] - mu mu^T`` a thousandfold;
* for a dense map, the query layout the align kernel reads
  (``ops.knn.cell_index``: an occupancy bitmap with ranks and the valid
  cells' rows, with normals for VPlaneICP, ``U`` for NDT). A hashed map has
  none: the JAX package's fused kernel needs the dense blocks. Its queries
  are plain torch ops (:func:`query_nearest_voxel`); the align's run inside
  the hashed stats kernel (``ops/kernels/grid_align``).

The per-cell sums are exact integer sums of the moments in fixed point
(``_segment_sum_fixed``), so their order does not matter: a build gives the
same bits on every run and for any order of the input points, although
``index_add_`` on CUDA adds in whatever order its atomics land. The same
holds for :func:`update_voxel_map` (the new points' moments) and
:func:`voxel_filter_device`, where the JAX package adds float32 in scatter
order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.ops.eigh3 import smallest_eigvec_sym3
from point_cloud_registration_tpu_torch.ops.hashgrid import (
    DENSE_CELL_BUDGET,
    Grid,
    _bbox_cells,
    _round_up_pow2,
    build_grid,
    cell_coords,
    query_cells,
    search_offsets,
)
from point_cloud_registration_tpu_torch.ops.knn import (
    FEAT_WIDTHS,
    CellIndex,
    NNResult,
    cell_index,
    nearest_valid_cell,
    nearest_voxel,
    window_radius,
)

RICH_KINDS = ("normals", "sqrt_icov")


class VoxelMap(NamedTuple):
    """Target map for VPlaneICP and NDT. Dense-direct: one slot per cell of
    the bounding box, in linear-key order ``x + nx * (y + ny * z)``, with the
    kernels' ``cells``. Hashed: one slot per entry of ``grid.keys`` (C slots,
    the occupied cells first, in key order), ``cells`` None."""

    origin_cell: tuple[int, int, int]  # minimum absolute cell coordinate
    dims: tuple[int, int, int]  # cells per axis (nx, ny, nz)
    cell_size: float
    means: torch.Tensor  # (D, 3) f32
    covs: torch.Tensor  # (D, 6) f32 packed [xx, yy, zz, xy, xz, yz]
    normals: torch.Tensor  # (D, 3) f32, zero on invalid cells
    counts: torch.Tensor  # (D,) i32
    valid: torch.Tensor  # (D,) bool, counts >= min_points
    icovs: torch.Tensor | None  # (D, 6) f32, present after with_icov builds
    cells: CellIndex | None  # ops.knn.cell_index (feats 4 or 8 wide); None when hashed
    grid: Grid | None = None  # the hashed map's index; None when dense-direct

    @property
    def num_voxels(self) -> int:
        return int(self.valid.sum())

    @property
    def hashed(self) -> bool:
        return self.cells is None


def invert_cov_packed(covs: torch.Tensor) -> torch.Tensor:
    """Analytic symmetric 3x3 inverse, packed->packed, with the reference's
    singular-determinant guard (voxel.py:69-102: ``det == 0 -> 1e6``)."""
    a, b, c, d, e, f = covs.unbind(-1)
    det = a * b * c + 2 * d * e * f - a * f * f - b * e * e - c * d * d
    det = torch.where(det == 0, torch.full_like(det, 1e6), det)
    c0 = (b * c - f * f) / det
    c1 = -(d * c - e * f) / det
    c2 = (d * f - e * b) / det
    c3 = (a * c - e * e) / det
    c4 = -(a * f - d * e) / det
    c5 = (a * b - d * d) / det
    return torch.stack([c0, c3, c5, c1, c2, c4], dim=-1)


def sqrt_icov_packed(icovs: torch.Tensor) -> torch.Tensor:
    """Upper-triangular square roots ``U = L^T`` with ``icov = L L^T``:
    (..., 6) packed ``[xx, yy, zz, xy, xz, yz]`` -> (..., 3, 3).

    Closed-form 3x3 Cholesky with every pivot clamped to at least ``1e-20``
    (voxelize.py:627-653).
    """
    a, b, c, d, e, f = icovs.unbind(-1)
    eps = torch.tensor(1e-20, dtype=icovs.dtype, device=icovs.device)
    l11 = torch.sqrt(torch.maximum(a, eps))
    l21 = d / l11
    l31 = e / l11
    l22 = torch.sqrt(torch.maximum(b - l21 * l21, eps))
    l32 = (f - l31 * l21) / l22
    l33 = torch.sqrt(torch.maximum(c - l31 * l31 - l32 * l32, eps))
    zero = torch.zeros_like(a)
    return torch.stack(
        [
            torch.stack([l11, l21, l31], dim=-1),
            torch.stack([zero, l22, l32], dim=-1),
            torch.stack([zero, zero, l33], dim=-1),
        ],
        dim=-2,
    )


def sqrt_icov_u6(icovs: torch.Tensor) -> torch.Tensor:
    """(..., 6) packed icov -> (..., 6) ``[u00, u01, u02, u11, u12, u22]``
    of :func:`sqrt_icov_packed`, the features of NDT's cell rows
    (voxelize.py:422-431)."""
    U = sqrt_icov_packed(icovs)
    return torch.stack(
        [U[..., 0, 0], U[..., 0, 1], U[..., 0, 2], U[..., 1, 1], U[..., 1, 2], U[..., 2, 2]],
        dim=-1,
    )


def build_voxel_map(
    points,
    voxel_size: float,
    *,
    min_points: int = 10,
    with_icov: bool = False,
    with_normals: bool = True,
    capacity: int | None = None,
    rich: str | None = None,
    device: torch.device | str | None = None,
) -> VoxelMap:
    """Build the voxel map of ``points`` (N, 3) (reference ``set_points``)
    on ``device``.

    ``points`` is a NumPy array or a tensor; ``device`` defaults to the
    tensor's device, or ``core.device.default_device()`` (the card, or an
    error without one) for NumPy input. The bounding box is read on the host
    once. A box of at most ``DENSE_CELL_BUDGET`` cells, with no
    ``capacity``, gets the dense-direct build; otherwise the map is hashed
    (voxelize.py:316-346): ``build_grid`` with ``capacity`` slots (default:
    N or the box's cells, rounded up to a power of two). ``rich`` picks the
    dense map's query rows' features, as in the JAX package: ``"normals"``
    for VPlaneICP, ``"sqrt_icov"`` (which needs ``with_icov``) for NDT;
    None, the JAX default, builds the ``"normals"`` rows (the JAX package
    then builds a centroid-only table, which its fused kernel does not
    read). ``with_normals=False`` (without ``with_icov``) gives a dense map's
    covariances and normals as zeros, the JAX package's centroid-only map;
    a hashed map has them either way, as in the JAX package.
    """
    rich = "normals" if rich is None else rich
    if rich not in RICH_KINDS:
        raise ValueError(f"unknown rich kind {rich!r}; expected one of {RICH_KINDS}")
    if rich == "sqrt_icov" and not with_icov:
        raise ValueError('rich="sqrt_icov" needs with_icov=True')
    lo_cell, hi_cell = _bbox_cells(points, voxel_size)
    dims = tuple(int(x) for x in (hi_cell - lo_cell + 1))
    total_cells = int(np.prod([float(d) for d in dims]))
    points = torch.as_tensor(points).to(device=resolve_device(points, device),
                                        dtype=torch.float32)
    if capacity is not None or total_cells > DENSE_CELL_BUDGET:
        grid, inverse, _ = build_grid(points, voxel_size, capacity=capacity,
                                      dense_budget=DENSE_CELL_BUDGET)
        return _finish_voxel_map(points, grid, inverse, min_points=min_points,
                                 with_icov=with_icov)
    return _build_voxel_map_dense(
        points,
        tuple(int(x) for x in lo_cell),
        float(np.float32(voxel_size)),
        dims,
        min_points=min_points,
        with_icov=with_icov,
        with_normals=with_normals or with_icov,
        rich=rich,
    )


def _segment_sum_fixed(key: torch.Tensor, vals: torch.Tensor, d_total: int,
                       bound: float) -> torch.Tensor:
    """Per-key sums of ``vals`` (N, W), ``|vals| <= bound``, over keys
    ``key`` (N,) in ``[0, d_total]`` -> (d_total, W) float64; key
    ``d_total`` is dropped.

    Each value is rounded to a multiple of ``2**-frac`` (far below float32
    resolution: 2**-40 for a 1.2M-point map of 1 m cells) and summed as
    int64, where addition is exact and associative. A float sum would round
    differently for each order of the atomic adds.
    """
    frac = int(np.floor(62 - np.log2(max(vals.shape[0], 1) * bound)))
    scale = 2.0 ** frac
    fixed = torch.round(vals.to(torch.float64) * scale).to(torch.int64)
    acc = torch.zeros((d_total + 1, vals.shape[1]), dtype=torch.int64,
                      device=vals.device)
    acc.index_add_(0, key, fixed)
    return acc[:d_total].to(torch.float64) / scale


def _dense_keys(points, origin_cell, cell_size, dims):
    """``(key, coords, in_range)`` of ``points`` in the dense grid: the
    linear key, ``d_total`` for a point outside the box (dropped)."""
    dev = points.device
    nx, ny, nz = dims
    coords = cell_coords(points, cell_size)
    rel = coords - torch.tensor(origin_cell, dtype=torch.int32, device=dev)
    # In-range guard: the bbox comes from host float64 division while the
    # cells use float32, which can disagree by one cell when p / cell_size
    # lands within an ulp of an integer. Such points go to the dropped key
    # instead of aliasing into another cell.
    in_range = ((rel >= 0) & (rel < torch.tensor(dims, dtype=torch.int32, device=dev))).all(dim=-1)
    rel = rel.to(torch.int64)
    key = rel[:, 0] + nx * (rel[:, 1] + ny * rel[:, 2])
    return torch.where(in_range, key, torch.full_like(key, nx * ny * nz)), coords, in_range


def _local_sums(points, coords, cell_size, key, n_slots, with_covs=True,
                exact=False) -> torch.Tensor:
    """Exact per-slot sums (float32 of the exact sums) of the one-pass
    moments ``[1, l, l (x) l]`` (with_covs) or ``[1, l]`` of the cell-local
    coordinates ``l = p - corner``, ``corner`` the point's own cell corner:
    every term is O(cell_size), so the E[ll^T] - mu mu^T cancellation stays
    benign. Columns ``[n, lx, ly, lz, xx, xy, xz, yy, yz, zz]``. With
    ``exact`` ``l`` and its products are taken in float64, where both are
    exact (``p - corner`` of float32 values is not below a negative corner),
    and the sums come back in float64."""
    corner = coords.to(torch.float32) * np.float32(cell_size)
    local = points.to(torch.float64) - corner.to(torch.float64) if exact else points - corner
    lx, ly, lz = local.unbind(-1)
    parts = [torch.ones_like(lx), lx, ly, lz]
    if with_covs:
        parts += [lx * lx, lx * ly, lx * lz, ly * ly, ly * lz, lz * lz]
    # |local| <= cell_size (twice that, for float32 rounding at the borders)
    bound = 2.0 * max(1.0, cell_size) ** 2
    sums = _segment_sum_fixed(key, torch.stack(parts, dim=-1), n_slots, bound)
    return sums if exact else sums.to(torch.float32)


def _outer6(v: torch.Tensor) -> torch.Tensor:
    """Packed outer product ``v v^T``: (..., 3) -> (..., 6) ``[xx, yy, zz, xy, xz, yz]``."""
    x, y, z = v.unbind(-1)
    return torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], dim=-1)


def _moments(acc: torch.Tensor):
    """``(counts_f, mean_local, M2)`` from :func:`_local_sums`' columns:
    ``M2 = sum ll^T - n mu mu^T``, the raw second central moment, packed
    ``[xx, yy, zz, xy, xz, yz]``."""
    counts_f = acc[:, 0]
    mean_local = acc[:, 1:4] / torch.clamp(counts_f, min=1.0)[:, None]
    sq = acc[:, [4, 7, 9, 5, 6, 8]]
    return counts_f, mean_local, sq - counts_f[:, None] * _outer6(mean_local)


def _stats(acc: torch.Tensor):
    """``(counts_f, mean_local, covs)``: covs ``M2 / max(n - 1, 1)``
    (reference divisor, voxel.py:140-148)."""
    counts_f, mean_local, M2 = _moments(acc)
    return counts_f, mean_local, M2 / torch.clamp(counts_f - 1.0, min=1.0)[:, None]


def _key_corners(keys: torch.Tensor, origin_cell, dims, cell_size) -> torch.Tensor:
    """Corner of the cell of each linear key (int64): (K, 3) f32. A key
    outside the grid (the hashed padding) takes the origin's corner, as
    ``_slot_corners`` (voxelize.py:76) gives it."""
    nx, ny, nz = dims
    safe = torch.where((keys >= 0) & (keys < nx * ny * nz), keys, torch.zeros_like(keys))
    cell = torch.stack([safe % nx, (safe // nx) % ny, safe // (nx * ny)], dim=-1)
    origin = torch.tensor(origin_cell, dtype=torch.int64, device=keys.device)
    return (cell + origin).to(torch.float32) * np.float32(cell_size)


def _finish(means, covs, counts_f, min_points, with_icov):
    """``(means, covs, counts, valid, normals, icovs)`` in float32 from the
    statistics in float32, or in float64 (an icov build's exact moments):
    the icovs are inverted in the statistics' precision, then rounded."""
    icovs = invert_cov_packed(covs).to(torch.float32) if with_icov else None
    means, covs = means.to(torch.float32), covs.to(torch.float32)
    counts = counts_f.to(torch.int32)
    valid = counts >= min_points
    normals = torch.where(valid[:, None], smallest_eigvec_sym3(covs), torch.zeros_like(means))
    return means, covs, counts, valid, normals, icovs


def _build_voxel_map_dense(points, origin_cell, cell_size, dims, *,
                           min_points, with_icov, rich, with_normals=True):
    """Stats, normals and query layout of the dense-direct map
    (``_build_voxel_map_dense`` of the JAX package, voxelize.py:437-570)."""
    d_total = int(np.prod(dims))
    key, coords, _ = _dense_keys(points, origin_cell, cell_size, dims)
    counts_f, mean_local, covs = _stats(_local_sums(points, coords, cell_size, key, d_total,
                                                    exact=with_icov))
    slot = torch.arange(d_total, dtype=torch.int64, device=points.device)
    means = mean_local + _key_corners(slot, origin_cell, dims, cell_size)
    means, covs, counts, valid, normals, icovs = _finish(means, covs, counts_f, min_points,
                                                         with_icov)
    if not with_normals:  # the centroid-only map: no second moments
        covs, normals = torch.zeros_like(covs), torch.zeros_like(normals)
    feats = sqrt_icov_u6(icovs) if rich == "sqrt_icov" else normals
    return VoxelMap(
        origin_cell=tuple(origin_cell),
        dims=tuple(dims),
        cell_size=float(cell_size),
        means=means,
        covs=covs,
        normals=normals,
        counts=counts,
        valid=valid,
        icovs=icovs,
        cells=cell_index(means, valid, feats),
    )


def _finish_voxel_map(points, grid: Grid, inverse, *, min_points, with_icov) -> VoxelMap:
    """Stats and normals of the hashed map, one slot per entry of
    ``grid.keys`` (voxelize.py:574). Points of the ``INVALID_KEY`` slot
    (the boundary guard's) are summed there, where no lookup reaches them."""
    capacity = grid.keys.shape[0]
    coords = cell_coords(points, grid.cell_size)
    counts_f, mean_local, covs = _stats(
        _local_sums(points, coords, grid.cell_size, inverse.to(torch.int64), capacity,
                    exact=with_icov))
    means = mean_local + _key_corners(grid.keys.to(torch.int64), grid.origin_cell, grid.dims,
                                      grid.cell_size)
    means, covs, counts, valid, normals, icovs = _finish(means, covs, counts_f, min_points,
                                                         with_icov)
    return VoxelMap(
        origin_cell=grid.origin_cell,
        dims=grid.dims,
        cell_size=grid.cell_size,
        means=means,
        covs=covs,
        normals=normals,
        counts=counts,
        valid=valid,
        icovs=icovs,
        cells=None,
        grid=grid,
    )


def query_nearest_voxel(vmap_: VoxelMap, query: torch.Tensor, *, voxel_size: float,
                        max_dist: float, fixed_tiers: bool = False,
                        full_window: bool = False) -> NNResult:
    """Nearest valid voxel of each query -> ``(dist, slot)`` (voxelize.py:596),
    ``inf`` and -1 where the window holds none. ``fixed_tiers`` and
    ``full_window`` choose the JAX package's TPU search tiers; the search
    here is exact either way, so they change nothing.

    A hashed map probes the cells of ``search_offsets(max_dist, voxel_size)``
    in their order (``knn.nearest_voxel``); a dense map the cube of
    ``ceil(max_dist / voxel_size)`` cells through its cell index, x fastest
    and z slowest, as its kernels do. The first minimum wins in both; both
    windows hold every valid centroid closer than ``max_dist``.
    """
    vm = vmap_
    if vm.hashed:
        return nearest_voxel(vm.grid, vm.means, vm.valid, query,
                             search_offsets(max_dist, voxel_size))
    origin = torch.tensor(vm.origin_cell, dtype=torch.int64, device=query.device)
    best_d2, row = nearest_valid_cell(vm.cells.centers, vm.dims,
                                      query_cells(query, vm.cell_size) - origin, query,
                                      window_radius(max_dist, voxel_size), occ=vm.cells.occ)
    # the slot of each row of the cell index, and -1 for its sentinel row
    valid_slots = torch.nonzero(vm.valid)[:, 0]
    slot_of_row = torch.cat([valid_slots, valid_slots.new_full((1,), -1)])
    slot = torch.where(best_d2 < float("inf"), slot_of_row[row], -1)
    return NNResult(dist=torch.sqrt(best_d2), idx=slot.to(torch.int32))


def update_voxel_map(vm: VoxelMap, new_points, min_points: int = 10,
                     return_dropped: bool = False):
    """Merge ``new_points`` into a dense-direct map (voxelize.py:656), the
    reference's declared ``update_target`` (registration.py:36-43).

    Per cell, the new points' count, mean and second central moment (from
    exact fixed-point sums) merge with the map's by the parallel-axis (Chan)
    formulas in float32, as the JAX package writes them
    (``_update_voxel_map_dense``, voxelize.py:715); normals, inverse
    covariances and the cell index are derived again. Points outside the
    map's box cannot extend a dense grid and are dropped:
    ``return_dropped=True`` returns ``(map, n_dropped)``, and a caller whose
    scene grows rebuilds with :func:`build_voxel_map` when it is nonzero.
    A hashed map raises ``NotImplementedError``, as in the JAX package.
    """
    if vm.hashed:
        raise NotImplementedError("update_voxel_map requires a dense-direct map")
    dev = vm.means.device
    pts = torch.as_tensor(new_points).to(device=dev, dtype=torch.float32)
    d_total = vm.means.shape[0]
    key, coords, in_range = _dense_keys(pts, vm.origin_cell, vm.cell_size, vm.dims)
    m, mean_b, M2_b = _moments(_local_sums(pts, coords, vm.cell_size, key, d_total))

    slot_corner = _key_corners(torch.arange(d_total, dtype=torch.int64, device=dev),
                               vm.origin_cell, vm.dims, vm.cell_size)
    n = vm.counts.to(torch.float32)
    mean_a = vm.means - slot_corner
    M2_a = vm.covs * torch.clamp(n - 1.0, min=1.0)[:, None]
    tot = n + m
    tot_safe = torch.clamp(tot, min=1.0)
    delta = mean_b - mean_a
    mean_local = mean_a + delta * (m / tot_safe)[:, None]
    M2 = M2_a + M2_b + _outer6(delta) * (n * m / tot_safe)[:, None]
    covs = M2 / torch.clamp(tot - 1.0, min=1.0)[:, None]
    covs = torch.where(((n > 0) | (m > 0))[:, None], covs, torch.zeros_like(covs))
    mean_local = torch.where((tot > 0)[:, None], mean_local, torch.zeros_like(mean_local))
    means = mean_local + slot_corner
    means, covs, counts, valid, normals, icovs = _finish(means, covs, tot, min_points,
                                                         vm.icovs is not None)
    # the cell index keeps its kind of features: normals, or NDT's U
    feats = sqrt_icov_u6(icovs) if vm.cells.feats.shape[1] == FEAT_WIDTHS[6] else normals
    out = vm._replace(means=means, covs=covs, normals=normals, counts=counts, valid=valid,
                      icovs=icovs, cells=cell_index(means, valid, feats))
    return (out, int((~in_range).sum())) if return_dropped else out


def voxel_filter_device(points, voxel_size: float, *, device=None) -> tuple[torch.Tensor, int]:
    """Voxel downsampling on the device: ``(means (C, 3) f32, n_cells)``,
    the centroids of the occupied cells in key order, rows past ``n_cells``
    ``+inf`` (voxelize.py:842).

    A box of at most ``DENSE_CELL_BUDGET`` cells sums into dense cell rows
    (``_voxel_filter_dense``, voxelize.py:800), a larger one into the slots of
    ``build_grid`` (voxelize.py:871-878). The sums are exact fixed-point sums
    where the JAX package adds float32 in scatter order, so a call repeats
    its bits.
    """
    lo_cell, hi_cell = _bbox_cells(points, voxel_size)
    dev = resolve_device(points, device)
    pts = torch.as_tensor(points).to(device=dev, dtype=torch.float32)
    dims = tuple(int(x) for x in (hi_cell - lo_cell + 1))
    total_cells = int(np.prod([float(d) for d in dims]))
    cell = float(np.float32(voxel_size))
    if total_cells <= DENSE_CELL_BUDGET:
        origin = tuple(int(x) for x in lo_cell)
        key, coords, _ = _dense_keys(pts, origin, cell, dims)
        acc = _local_sums(pts, coords, cell, key, total_cells, with_covs=False)
        occupied = torch.nonzero(acc[:, 0] > 0)[:, 0]
        acc = acc[occupied]
        corners = _key_corners(occupied, origin, dims, cell)
        capacity = _round_up_pow2(min(pts.shape[0], total_cells))
    else:
        grid, inverse, _ = build_grid(pts, voxel_size, dense_budget=DENSE_CELL_BUDGET)
        capacity = grid.keys.shape[0]
        acc = _local_sums(pts, cell_coords(pts, grid.cell_size), grid.cell_size,
                          inverse.to(torch.int64), capacity, with_covs=False)[:grid.n_cells]
        corners = _key_corners(grid.keys[:grid.n_cells].to(torch.int64), grid.origin_cell,
                               grid.dims, grid.cell_size)
    n_cells = acc.shape[0]
    out = torch.full((capacity, 3), float("inf"), dtype=torch.float32, device=dev)
    out[:n_cells] = acc[:, 1:4] / torch.clamp(acc[:, 0], min=1.0)[:, None] + corners
    return out, n_cells


def voxel_filter(points, voxel_size: float, *, device=None) -> np.ndarray:
    """Voxel downsampling: per-voxel centroid, float32 NumPy (voxel.py:209-241,
    voxelize.py:904). The content matches the reference; the order is the
    cells' keys (the reference orders by its modular hash)."""
    means, n_cells = voxel_filter_device(points, voxel_size, device=device)
    return means[:n_cells].cpu().numpy()


def color_by_voxel(points, voxel_size: float, *, device=None) -> np.recarray:
    """Random per-voxel RGB colouring for a viewer (voxel.py:183-206,
    voxelize.py:926): the reference's ``[('xyz', '<f4', (3,)), ('irgb', '<u4')]``
    records and its seed-42 palette, one colour per occupied cell in key
    order (the reference enumerates cells by its hash, so single hues
    differ)."""
    points_np = np.asarray(points, dtype=np.float32)
    grid, inverse, _ = build_grid(points_np, voxel_size, device=device)
    inverse = inverse.cpu().numpy()
    rng = np.random.RandomState(42)
    colors = rng.randint(0, 256, size=(grid.n_cells, 3)).astype(np.uint8)
    point_colors = colors[inverse]
    rgb = (
        point_colors[:, 0].astype(np.uint32) << 16
        | point_colors[:, 1].astype(np.uint32) << 8
        | point_colors[:, 2].astype(np.uint32)
    )
    data_type = [("xyz", "<f4", (3,)), ("irgb", "<u4")]
    return np.rec.fromarrays([points_np, rgb], dtype=data_type)
