"""PyTorch and CUDA port of point_cloud_registration_tpu.

Imports ``torch`` and never ``jax``. Ported so far: the VPlaneICP main path
(voxel-map build, the fused correspondence + linearization + reduction
kernel for CUDA, and the host Gauss-Newton loop). The package's module
names mirror the JAX package's, so each counterpart is easy to find.
"""

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
from point_cloud_registration_tpu_torch.models.voxelized_plane_icp import VPlaneICP
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap, build_voxel_map

__all__ = [
    "AlignResult",
    "GNDiagnostics",
    "GNStats",
    "Registration",
    "VPlaneICP",
    "VoxelMap",
    "build_voxel_map",
    "expSO3",
    "gauss_newton",
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
