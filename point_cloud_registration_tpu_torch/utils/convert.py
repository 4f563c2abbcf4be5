"""Carry state between the JAX package and the port.

A target index plays the part of a model's weights: with these functions the
same voxel map or packed point grid, built once by the JAX package, drives
both aligners.
"""

from __future__ import annotations

import numpy as np
import torch

from point_cloud_registration_tpu_torch.ops.knn import cell_table
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
    device="cpu",
    icovs=None,
) -> VoxelMap:
    """Port :class:`VoxelMap` (with its cell table) on ``device`` from the
    arrays of a dense-direct map of the JAX package, given as NumPy arrays
    (``vm.means``, ``vm.covs``, ``vm.normals``, ``vm.counts``, ``vm.valid``,
    ``vm.grid.origin_cell``, ``vm.grid.dims``, ``vm.grid.cell_size``)."""
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
        table=cell_table(means_t, valid_t, normals_t),
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
    device="cpu",
) -> VoxelMap:
    """Port NDT map (with its (D, 12) NDT table) from the arrays of a
    dense-direct JAX ``VoxelMap`` built ``with_icov=True``, as for
    :func:`voxel_map_from_numpy` plus ``vm.icovs`` and the table's Cholesky
    features ``u6`` (the JAX package's ``sqrt_icov_u6(vm.icovs)``)."""
    vm = voxel_map_from_numpy(means, covs, normals, counts, valid, origin_cell, dims,
                              cell_size, device=device, icovs=icovs)
    return vm._replace(table=cell_table(vm.means, vm.valid, _to_dev(u6, torch.float32, device)))


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
    device="cpu",
) -> tuple[PackedPointGrid, ProxyMap]:
    """Port packed grid and proxy map from the arrays of a JAX
    ``PackedPointGrid`` (``pg.origin_fine`` ... ``pg.row_over``, xyz rows
    only) and of its proxy ``VoxelMap`` (``proxy.means``, ``.counts``,
    ``.valid``). The JAX rows are padded to a power of two; the port keeps
    the occupied rows and one sentinel row."""
    row_key = np.asarray(row_key, np.int32)
    n_occ = int((row_key >= 0).sum())
    cap = np.asarray(idx_packed).shape[1]
    if np.asarray(pts_packed).shape[1] != 3 * cap:
        raise ValueError("pts_packed carries per-point features; the port takes xyz rows")

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
        row_count=torch.isfinite(pts.reshape(n_occ + 1, cap, 3)[..., 0]).sum(dim=1)
        .to(torch.int32),
    )
    proxy = proxy_map(pg, rows(proxy_means, torch.float32, 0.0),
                      rows(proxy_counts, torch.int32, 0), rows(proxy_valid, torch.bool, False))
    return pg, proxy
