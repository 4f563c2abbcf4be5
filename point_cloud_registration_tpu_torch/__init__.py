"""PyTorch and CUDA port of point_cloud_registration_tpu.

Imports ``torch`` and never ``jax``. Ported so far: VPlaneICP and NDT (the
dense voxel-map build and the fused correspondence + linearization +
reduction kernel, kinds "plane" and "ndt"), ICP and PlaneICP (the packed
point grid with its proxy voxel map and the point stats kernel, kinds
"point" and "plane_pt"), each with the host Gauss-Newton loop, k-NN PCA
normals (the k-NN moments kernel) and the exact 1-NN oracle kernel. The package's module names mirror the JAX package's, so
each counterpart is easy to find.
"""

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.config import (
    CorrespondenceConfig,
    ICPConfig,
    NDTConfig,
    PlaneICPConfig,
    VPlaneICPConfig,
)
from point_cloud_registration_tpu_torch.core.device import default_device
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
from point_cloud_registration_tpu_torch.models.icp import ICP
from point_cloud_registration_tpu_torch.models.ndt import NDT
from point_cloud_registration_tpu_torch.models.plane_icp import PlaneICP
from point_cloud_registration_tpu_torch.models.voxelized_plane_icp import VPlaneICP
from point_cloud_registration_tpu_torch.ops import normals as _normals
from point_cloud_registration_tpu_torch.ops.normals import get_norm_lines
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap, build_voxel_map



def estimate_normals(points, k: int = 15) -> np.ndarray:
    """k-NN PCA normals, NumPy in and out (reference
    estimate_normals.py:11-24); computed on the card when there is one."""
    return _normals.estimate_normals(points, k=k).cpu().numpy()


def estimate_norm_with_tree(points, kdtree=None, k: int = 15) -> np.ndarray:
    """k-NN PCA normals against a prebuilt neighbour index (reference
    estimate_normals.py:27-87), NumPy in and out.

    ``kdtree`` is any object with ``.query(points, k)``: the neighbour
    indices come from it and, as in the reference, the moments gather from
    ``points`` at those indices. ``None`` derives the grid index from
    ``points``."""
    if kdtree is None:
        return estimate_normals(points, k=k)
    _, idx = kdtree.query(points, k=k)
    dev = default_device()
    pts = torch.as_tensor(np.asarray(points, np.float32)).to(dev)
    idx = torch.as_tensor(np.asarray(idx).astype(np.int64)).to(dev)
    return _normals.normals_from_neighbors(pts, idx, pts).cpu().numpy()


__all__ = [
    "AlignResult",
    "CorrespondenceConfig",
    "GNDiagnostics",
    "GNStats",
    "ICP",
    "ICPConfig",
    "NDT",
    "NDTConfig",
    "PlaneICP",
    "PlaneICPConfig",
    "Registration",
    "VPlaneICP",
    "VPlaneICPConfig",
    "VoxelMap",
    "build_voxel_map",
    "estimate_norm_with_tree",
    "estimate_normals",
    "expSO3",
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
]
