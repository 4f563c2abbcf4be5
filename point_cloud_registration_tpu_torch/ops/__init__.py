"""Voxel grid, neighbour queries, eigensolver, voxel-map build and reductions
on torch tensors (the names of ``point_cloud_registration_tpu/ops``)."""

from point_cloud_registration_tpu_torch.ops.eigh3 import (
    eigh_sym3,
    eigvals_sym3,
    pack_sym3,
    smallest_eigvec_sym3,
    unpack_sym3,
)
from point_cloud_registration_tpu_torch.ops.hashgrid import (
    Buckets,
    Grid,
    build_grid,
    cell_coords,
    coords_to_key,
    lookup_slots,
    search_offsets,
)
from point_cloud_registration_tpu_torch.ops.knn import (
    NNResult,
    brute_force_knn,
    brute_force_nn,
    knn_points,
    nearest_point,
    nearest_voxel,
)
from point_cloud_registration_tpu_torch.ops.reduce import (
    ndt_stats,
    plane_stats,
    point_stats,
    reduce_H_g_e2,
)
from point_cloud_registration_tpu_torch.ops.voxelize import (
    VoxelMap,
    build_voxel_map,
    color_by_voxel,
    invert_cov_packed,
    query_nearest_voxel,
    update_voxel_map,
    voxel_filter,
)
