"""PyTorch and CUDA port of point_cloud_registration_tpu.

Imports ``torch`` and never ``jax``. Ported: VPlaneICP and NDT (the dense
voxel-map build with the fused correspondence + linearization + reduction
kernel, kinds "plane" and "ndt"; the hashed build for boxes over the dense
budget, with plain stats; ``update_target``), ICP and PlaneICP (the packed
point grid with its proxy voxel map and the point stats kernel, kinds
"point" and "plane_pt", from 50k target points; the CSR grid with plain
stats below that), each with the host Gauss-Newton loop, k-NN PCA normals
(the k-NN moments kernel) and the exact 1-NN kernel (the exact escapes of
``KDTree``); FastVPlaneICP (the fused plane kernel, the float64 coreset
lift, the coreset phase); the batched multi-scan aligns of all four kinds
against one map, one batched kernel launch per Gauss-Newton iteration
(``models._fused.fused_voxel_align_batched``,
``models._point_fused.fused_point_align_batched``); the reference's
utilities ``KDTree`` / ``VoxelGrid``, ``voxel_filter``, ``color_by_voxel``,
the Caratheodory coresets and PCD IO; the multi-device paths
(``parallel``). The package's module names and its subpackages' exports
mirror the JAX package's, so each counterpart is easy to find. The
command-line entry points are ``demos/*_torch.py``.
"""

import numpy as np
import torch

from point_cloud_registration_tpu_torch.compat import KDTree, NeighborIndex, VoxelGrid
from point_cloud_registration_tpu_torch.core.config import (
    CorrespondenceConfig,
    ICPConfig,
    NDTConfig,
    PlaneICPConfig,
    VPlaneICPConfig,
)
from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.core.gn import (
    GNDiagnostics,
    GNStats,
    gauss_newton,
    solve_6x6,
)
from point_cloud_registration_tpu_torch.core.se3 import (
    expSO3,
    huber_weight,
    logSO3,
    makeRt,
    makeT,
    numerical_derivative,
    plus,
    skew,
    skew2,
    skew_time_vector,
    skews,
    transform_points,
)
from point_cloud_registration_tpu_torch.models.base import AlignResult, Registration
from point_cloud_registration_tpu_torch.models.coreset import (
    caratheodory,
    create_gn_set,
    fast_caratheodory,
)
from point_cloud_registration_tpu_torch.models.fast_vplane_icp import FastVPlaneICP
from point_cloud_registration_tpu_torch.models.icp import ICP
from point_cloud_registration_tpu_torch.models.ndt import NDT
from point_cloud_registration_tpu_torch.models.plane_icp import PlaneICP
from point_cloud_registration_tpu_torch.models.voxelized_plane_icp import VPlaneICP
from point_cloud_registration_tpu_torch.ops import normals as _normals
from point_cloud_registration_tpu_torch.ops.normals import get_norm_lines
from point_cloud_registration_tpu_torch.ops.voxelize import (
    VoxelMap,
    build_voxel_map,
    color_by_voxel,
    voxel_filter,
)


def estimate_normals(points, k: int = 15, *, device=None) -> np.ndarray:
    """k-NN PCA normals, NumPy in and out (reference
    estimate_normals.py:11-24), computed on ``device``: by default the
    tensor's device, or the card for NumPy input (an error without one;
    ``device="cpu"`` runs on the CPU)."""
    return _normals.estimate_normals(points, k=k, device=device).cpu().numpy()


def estimate_norm_with_tree(points, kdtree=None, k: int = 15, *, device=None) -> np.ndarray:
    """k-NN PCA normals against a prebuilt neighbour index (reference
    estimate_normals.py:27-87), NumPy in and out, on ``device`` as
    :func:`estimate_normals`.

    ``kdtree`` is any object with ``.query(points, k)``: the neighbour
    indices come from it and, as in the reference, the moments gather from
    ``points`` at those indices. ``None`` derives the grid index from
    ``points``."""
    if kdtree is None:
        return estimate_normals(points, k=k, device=device)
    _, idx = kdtree.query(points, k=k)
    dev = resolve_device(points, device)
    pts = torch.as_tensor(np.asarray(points, np.float32)).to(dev)
    idx = torch.as_tensor(np.asarray(idx).astype(np.int64)).to(dev)
    return _normals.normals_from_neighbors(pts, idx, pts).cpu().numpy()


__all__ = [
    "AlignResult",
    "CorrespondenceConfig",
    "FastVPlaneICP",
    "GNDiagnostics",
    "GNStats",
    "ICP",
    "ICPConfig",
    "KDTree",
    "NDT",
    "NDTConfig",
    "NeighborIndex",
    "PlaneICP",
    "PlaneICPConfig",
    "Registration",
    "VPlaneICP",
    "VPlaneICPConfig",
    "VoxelGrid",
    "VoxelMap",
    "build_voxel_map",
    "caratheodory",
    "color_by_voxel",
    "create_gn_set",
    "estimate_norm_with_tree",
    "estimate_normals",
    "expSO3",
    "fast_caratheodory",
    "gauss_newton",
    "get_norm_lines",
    "huber_weight",
    "logSO3",
    "makeRt",
    "makeT",
    "numerical_derivative",
    "plus",
    "skew",
    "skew2",
    "skew_time_vector",
    "skews",
    "solve_6x6",
    "transform_points",
    "voxel_filter",
]
