"""Voxel-map construction: per-voxel Gaussian statistics (counterpart of the
dense-direct branch of ``point_cloud_registration_tpu/ops/voxelize.py``).

The reference ``VoxelGrid.set_points`` pipeline (voxel.py:104-169) becomes:

* grouping by the bounding-box cell key (``ops.hashgrid``), voxel slot ==
  linear cell key (the dense-direct build);
* per-voxel count/mean/covariance from moments accumulated in *cell-local*
  coordinates, so float32 keeps full precision for maps hundreds of meters
  across; the covariance divisor is n - 1 (voxel.py:140-148);
* the min_points filter (voxel.py:56) as a validity mask;
* normals from the closed-form symmetric 3x3 eigensolver (``ops.eigh3``),
  zero on invalid cells;
* for NDT, the inverse covariances (``invert_cov_packed``) and their upper
  Cholesky factors (``sqrt_icov_u6``);
* the query layout the align kernel reads (``ops.knn.cell_index``: an
  occupancy bitmap with ranks and the valid cells' rows, with normals for
  VPlaneICP, ``U`` for NDT).

The per-cell sums are exact integer sums of the moments in fixed point
(``_segment_sum_fixed``), so their order does not matter: a build gives the
same bits on every run and for any order of the input points, although
``index_add_`` on CUDA adds in whatever order its atomics land.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.ops.eigh3 import smallest_eigvec_sym3
from point_cloud_registration_tpu_torch.ops.hashgrid import (
    DENSE_CELL_BUDGET,
    _bbox_cells,
    cell_coords,
)
from point_cloud_registration_tpu_torch.ops.knn import CellIndex, cell_index

RICH_KINDS = ("normals", "sqrt_icov")


class VoxelMap(NamedTuple):
    """Dense-direct target map for VPlaneICP and NDT: one slot per cell of
    the bounding box, in linear-key order ``x + nx * (y + ny * z)``."""

    origin_cell: tuple[int, int, int]  # minimum absolute cell coordinate
    dims: tuple[int, int, int]  # cells per axis (nx, ny, nz)
    cell_size: float
    means: torch.Tensor  # (D, 3) f32
    covs: torch.Tensor  # (D, 6) f32 packed [xx, yy, zz, xy, xz, yz]
    normals: torch.Tensor  # (D, 3) f32, zero on invalid cells
    counts: torch.Tensor  # (D,) i32
    valid: torch.Tensor  # (D,) bool, counts >= min_points
    icovs: torch.Tensor | None  # (D, 6) f32, present after with_icov builds
    cells: CellIndex  # ops.knn.cell_index: rows (V + 1, 8), or (V + 1, 12) for rich="sqrt_icov"

    @property
    def num_voxels(self) -> int:
        return int(self.valid.sum())


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
    rich: str = "normals",
    device: torch.device | str | None = None,
) -> VoxelMap:
    """Build the dense-direct voxel map of ``points`` (N, 3) (reference
    ``set_points``) on ``device``.

    ``points`` is a NumPy array or a tensor; ``device`` defaults to the
    tensor's device, or ``core.device.default_device()`` (the card when
    there is one) for NumPy input. The bounding box is read
    on the host once. A bounding box of more than ``DENSE_CELL_BUDGET``
    cells needs the sparse build, which is not ported yet. ``rich`` picks
    the query rows' features, as in the JAX package: ``"normals"`` for
    VPlaneICP, ``"sqrt_icov"`` (which needs ``with_icov``) for NDT.
    """
    if rich not in RICH_KINDS:
        raise ValueError(f"unknown rich kind {rich!r}; expected one of {RICH_KINDS}")
    if rich == "sqrt_icov" and not with_icov:
        raise ValueError('rich="sqrt_icov" needs with_icov=True')
    lo_cell, hi_cell = _bbox_cells(points, voxel_size)
    dims = tuple(int(x) for x in (hi_cell - lo_cell + 1))
    total_cells = int(np.prod([float(d) for d in dims]))
    if total_cells > DENSE_CELL_BUDGET:
        raise NotImplementedError(
            f"map of {dims} cells ({total_cells}) exceeds the dense budget "
            f"{DENSE_CELL_BUDGET}; the sparse build is not ported"
        )
    points = torch.as_tensor(points).to(device=resolve_device(points, device),
                                        dtype=torch.float32)
    return _build_voxel_map_dense(
        points,
        tuple(int(x) for x in lo_cell),
        float(np.float32(voxel_size)),
        dims,
        min_points=min_points,
        with_icov=with_icov,
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


def _build_voxel_map_dense(points, origin_cell, cell_size, dims, *,
                           min_points, with_icov, rich):
    """Stats, normals and query layout of the dense-direct map
    (``_build_voxel_map_dense`` of the JAX package, voxelize.py:437-570)."""
    dev = points.device
    nx, ny, nz = dims
    d_total = nx * ny * nz
    origin = torch.tensor(origin_cell, dtype=torch.int32, device=dev)
    coords = cell_coords(points, cell_size)
    rel = coords - origin
    # In-range guard: the bbox comes from host float64 division while the
    # cells use float32, which can disagree by one cell when p / cell_size
    # lands within an ulp of an integer. Such points go to the dropped key
    # instead of aliasing into another cell.
    dims_t = torch.tensor(dims, dtype=torch.int32, device=dev)
    in_range = ((rel >= 0) & (rel < dims_t)).all(dim=-1)
    rel = rel.to(torch.int64)
    key = rel[:, 0] + nx * (rel[:, 1] + ny * rel[:, 2])
    key = torch.where(in_range, key, torch.full_like(key, d_total))

    corner = coords.to(torch.float32) * np.float32(cell_size)
    # One-pass moments [1, p, p (x) p] in cell-local coordinates: every term
    # is O(cell_size), so the E[pp^T] - mu mu^T cancellation stays benign.
    local = points - corner
    lx, ly, lz = local.unbind(-1)
    vals = torch.stack(
        [torch.ones_like(lx), lx, ly, lz,
         lx * lx, lx * ly, lx * lz, ly * ly, ly * lz, lz * lz],
        dim=-1,
    )
    # |local| <= cell_size (twice that, for float32 rounding at the borders)
    bound = 2.0 * max(1.0, cell_size) ** 2
    acc = _segment_sum_fixed(key, vals, d_total, bound).to(torch.float32)
    counts_f = acc[:, 0]
    counts = counts_f.to(torch.int32)
    mean_local = acc[:, 1:4] / torch.clamp(counts_f, min=1.0)[:, None]
    # packed [xx, yy, zz, xy, xz, yz] from accumulated [xx, xy, xz, yy, yz, zz]
    sq = acc[:, [4, 7, 9, 5, 6, 8]]
    mx, my, mz = mean_local.unbind(-1)
    mu_outer = torch.stack([mx * mx, my * my, mz * mz, mx * my, mx * mz, my * mz], dim=-1)
    # (sum pp^T - n mu mu^T) / max(n - 1, 1)  (reference divisor, voxel.py:140-148)
    covs = (sq - counts_f[:, None] * mu_outer) / torch.clamp(counts_f - 1.0, min=1.0)[:, None]

    # Per-slot cell corner from the slot index.
    slot = torch.arange(d_total, dtype=torch.int64, device=dev)
    slot_cell = torch.stack([slot % nx, (slot // nx) % ny, slot // (nx * ny)], dim=-1)
    slot_corner = (slot_cell + origin).to(torch.float32) * np.float32(cell_size)
    means = mean_local + slot_corner

    valid = counts >= min_points
    normals = torch.where(
        valid[:, None], smallest_eigvec_sym3(covs), torch.zeros_like(mean_local)
    )
    icovs = invert_cov_packed(covs) if with_icov else None
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
