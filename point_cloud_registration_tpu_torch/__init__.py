"""PyTorch and CUDA port of point_cloud_registration_tpu.

Imports ``torch`` and never ``jax``. Ported so far: VPlaneICP and NDT (the
dense voxel-map build and the fused correspondence + linearization +
reduction kernel, kinds "plane" and "ndt") and ICP (the packed point grid
with its proxy voxel map and the point stats kernel), each with the host
Gauss-Newton loop. The package's module names mirror the JAX package's, so
each counterpart is easy to find.
"""

from point_cloud_registration_tpu_torch.core.config import (
    CorrespondenceConfig,
    ICPConfig,
    NDTConfig,
    VPlaneICPConfig,
)
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
from point_cloud_registration_tpu_torch.models.voxelized_plane_icp import VPlaneICP
from point_cloud_registration_tpu_torch.ops.voxelize import VoxelMap, build_voxel_map

__all__ = [
    "AlignResult",
    "CorrespondenceConfig",
    "GNDiagnostics",
    "GNStats",
    "ICP",
    "ICPConfig",
    "NDT",
    "NDTConfig",
    "Registration",
    "VPlaneICP",
    "VPlaneICPConfig",
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
