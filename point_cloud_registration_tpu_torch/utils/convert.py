"""Carry state between the JAX package and the port.

A voxel map plays the part of a model's weights: with
:func:`voxel_map_from_numpy` the same map, built once by either package,
drives both aligners.
"""

from __future__ import annotations

import numpy as np
import torch

from point_cloud_registration_tpu_torch.ops.knn import cell_table
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap


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

    def to_dev(a, dtype):
        # a copy: arrays handed out by JAX are read-only
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    means_t = to_dev(means, torch.float32)
    normals_t = to_dev(normals, torch.float32)
    valid_t = to_dev(valid, torch.bool)
    return VoxelMap(
        origin_cell=tuple(int(x) for x in np.asarray(origin_cell)),
        dims=dims,
        cell_size=float(np.float32(cell_size)),
        means=means_t,
        covs=to_dev(covs, torch.float32),
        normals=normals_t,
        counts=to_dev(counts, torch.int32),
        valid=valid_t,
        icovs=None if icovs is None else to_dev(icovs, torch.float32),
        table=cell_table(means_t, valid_t, normals_t),
    )
