"""Carry state between the JAX package and the port.

A target index plays the part of a model's weights: with these functions the
same voxel map (dense or hashed), packed point grid, hashed grid with its
buckets or PlaneICP target, built once by the JAX package, drives both
aligners.
"""

from __future__ import annotations

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.models._point_corr import PointCorrTarget
from point_cloud_registration_tpu_torch.models.plane_icp import PlaneICPTarget
from point_cloud_registration_tpu_torch.ops.hashgrid import Buckets, Grid
from point_cloud_registration_tpu_torch.ops.knn import cell_index
from point_cloud_registration_tpu_torch.ops.pointgrid import (
    PackedPointGrid,
    ProxyMap,
    proxy_map,
)
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap


def _to_dev(a, dtype, device):
    # a copy: arrays handed out by JAX are read-only
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def voxel_map_from_numpy(
    means,
    covs,
    normals,
    counts,
    valid,
    origin_cell,
    dims,
    cell_size,
    device=None,
    icovs=None,
) -> VoxelMap:
    """Port :class:`VoxelMap` (with its cell index) on ``device`` from the
    arrays of a dense-direct map of the JAX package, given as NumPy arrays
    (``vm.means``, ``vm.covs``, ``vm.normals``, ``vm.counts``, ``vm.valid``,
    ``vm.grid.origin_cell``, ``vm.grid.dims``, ``vm.grid.cell_size``).
    ``device`` defaults to ``core.device.default_device()`` (the card, or an
    error without one), here and in the functions below."""
    device = resolve_device(None, device)
    dims = tuple(int(x) for x in np.asarray(dims))
    d_total = int(np.prod(dims))
    means = np.asarray(means, np.float32)
    if means.shape != (d_total, 3):
        raise ValueError(
            f"means of shape {means.shape} is not a dense-direct map of dims {dims}"
        )

    means_t = _to_dev(means, torch.float32, device)
    normals_t = _to_dev(normals, torch.float32, device)
    valid_t = _to_dev(valid, torch.bool, device)
    return VoxelMap(
        origin_cell=tuple(int(x) for x in np.asarray(origin_cell)),
        dims=dims,
        cell_size=float(np.float32(cell_size)),
        means=means_t,
        covs=_to_dev(covs, torch.float32, device),
        normals=normals_t,
        counts=_to_dev(counts, torch.int32, device),
        valid=valid_t,
        icovs=None if icovs is None else _to_dev(icovs, torch.float32, device),
        cells=cell_index(means_t, valid_t, normals_t),
    )


def ndt_map_from_numpy(
    means,
    covs,
    normals,
    counts,
    valid,
    origin_cell,
    dims,
    cell_size,
    icovs,
    u6,
    device=None,
) -> VoxelMap:
    """Port NDT map (with the 12-wide rows of its cell index) from the arrays of a
    dense-direct JAX ``VoxelMap`` built ``with_icov=True``, as for
    :func:`voxel_map_from_numpy` plus ``vm.icovs`` and the rows' Cholesky
    features ``u6`` (the JAX package's ``sqrt_icov_u6(vm.icovs)``)."""
    device = resolve_device(None, device)
    vm = voxel_map_from_numpy(means, covs, normals, counts, valid, origin_cell, dims,
                              cell_size, device=device, icovs=icovs)
    return vm._replace(cells=cell_index(vm.means, vm.valid, _to_dev(u6, torch.float32, device)))


def packed_grid_from_numpy(
    origin_fine,
    cell_fine,
    nb_dims,
    block_row,
    row_key,
    pts_packed,
    idx_packed,
    row_over,
    proxy_means,
    proxy_counts,
    proxy_valid,
    device=None,
    proxy_normals=None,
) -> tuple[PackedPointGrid, ProxyMap]:
    """Port packed grid and proxy map from the arrays of a JAX
    ``PackedPointGrid`` (``pg.origin_fine`` ... ``pg.row_over``; rows of any
    slot width) and of its proxy ``VoxelMap`` (``proxy.means``, ``.counts``,
    ``.valid`` and, for PlaneICP, ``.normals``). The JAX rows are padded to
    a power of two; the port keeps the occupied rows and one sentinel row."""
    device = resolve_device(None, device)
    row_key = np.asarray(row_key, np.int32)
    n_occ = int((row_key >= 0).sum())
    cap = np.asarray(idx_packed).shape[1]
    width = np.asarray(pts_packed).shape[1] // cap

    def rows(a, dtype, fill):
        a = np.asarray(a)
        live = np.concatenate([a[:n_occ], np.full((1,) + a.shape[1:], fill, a.dtype)])
        return _to_dev(live, dtype, device)

    pts = rows(pts_packed, torch.float32, np.inf)
    pg = PackedPointGrid(
        origin_fine=tuple(int(x) for x in np.asarray(origin_fine)),
        cell_fine=float(np.float32(cell_fine)),
        nb_dims=tuple(int(x) for x in np.asarray(nb_dims)),
        block_row=_to_dev(block_row, torch.int32, device),
        row_key=rows(row_key, torch.int32, -1),
        pts_packed=pts,
        idx_packed=rows(idx_packed, torch.int32, -1),
        row_over=rows(row_over, torch.bool, False),
        row_count=torch.isfinite(pts.reshape(n_occ + 1, cap, width)[..., 0]).sum(dim=1)
        .to(torch.int32),
    )
    proxy = proxy_map(pg, rows(proxy_means, torch.float32, 0.0),
                      rows(proxy_counts, torch.int32, 0), rows(proxy_valid, torch.bool, False),
                      None if proxy_normals is None else rows(proxy_normals, torch.float32, 0.0))
    return pg, proxy


def plane_icp_target_from_numpy(points, normals, *packed_args, device=None,
                                proxy_normals) -> PlaneICPTarget:
    """Port :class:`PlaneICPTarget` from the arrays of the JAX package's
    (``target.corr.points``, ``target.normals``, then the arguments of
    :func:`packed_grid_from_numpy` for ``target.corr.packed``, whose rows
    are 6 wide, and ``target.corr.proxy`` with its normals), so that both
    packages align against one target."""
    device = resolve_device(None, device)
    pg, proxy = packed_grid_from_numpy(*packed_args, device=device, proxy_normals=proxy_normals)
    if pg.width != 6:
        raise ValueError(f"a PlaneICP target packs xyz + normal (width 6), got {pg.width}")
    corr = PointCorrTarget(points=_to_dev(points, torch.float32, device), packed=pg, proxy=proxy)
    return PlaneICPTarget(corr=corr, normals=_to_dev(normals, torch.float32, device))


def grid_from_numpy(origin_cell, cell_size, dims, keys, n_cells, dense=None,
                    device=None) -> Grid:
    """Port :class:`~point_cloud_registration_tpu_torch.ops.hashgrid.Grid` from
    the arrays of a JAX ``Grid`` (``grid.origin_cell``, ``.cell_size``,
    ``.dims``, ``.keys``, ``.n_cells`` and ``.dense``, None over the budget)."""
    device = resolve_device(None, device)
    return Grid(
        origin_cell=tuple(int(x) for x in np.asarray(origin_cell)),
        cell_size=float(np.float32(cell_size)),
        dims=tuple(int(x) for x in np.asarray(dims)),
        keys=_to_dev(keys, torch.int32, device),
        n_cells=int(n_cells),
        dense=None if dense is None else _to_dev(dense, torch.int32, device),
    )


def buckets_from_numpy(perm, starts, counts, device=None) -> Buckets:
    """Port CSR :class:`~point_cloud_registration_tpu_torch.ops.hashgrid.Buckets`
    from the arrays of a JAX ``Buckets``."""
    device = resolve_device(None, device)
    return Buckets(perm=_to_dev(perm, torch.int32, device),
                   starts=_to_dev(starts, torch.int32, device),
                   counts=_to_dev(counts, torch.int32, device))


def hashed_voxel_map_from_numpy(grid: Grid, means, covs, normals, counts, valid,
                                icovs=None, device=None) -> VoxelMap:
    """Port hashed :class:`VoxelMap` on ``grid`` (:func:`grid_from_numpy`)
    from the per-slot arrays of a JAX ``VoxelMap`` built by ``build_grid``
    (``vm.means`` ... ``vm.valid``, ``vm.icovs`` for NDT). The port keeps
    the normals of invalid slots at zero."""
    device = resolve_device(None, device)
    valid_t = _to_dev(valid, torch.bool, device)
    normals_t = _to_dev(normals, torch.float32, device)
    return VoxelMap(
        origin_cell=grid.origin_cell,
        dims=grid.dims,
        cell_size=grid.cell_size,
        means=_to_dev(means, torch.float32, device),
        covs=_to_dev(covs, torch.float32, device),
        normals=torch.where(valid_t[:, None], normals_t, torch.zeros_like(normals_t)),
        counts=_to_dev(counts, torch.int32, device),
        valid=valid_t,
        icovs=None if icovs is None else _to_dev(icovs, torch.float32, device),
        cells=None,
        grid=grid,
    )
