"""Solvers: the reference-compatible class API over the functional core."""

from point_cloud_registration_tpu_torch.models.base import AlignResult, Registration, pad_points
from point_cloud_registration_tpu_torch.models.coreset import (
    caratheodory,
    create_gn_set,
    fast_caratheodory,
)
from point_cloud_registration_tpu_torch.models.voxelized_plane_icp import (
    VPlaneICP,
    build_vplane_target,
    vplane_align,
    vplane_stats,
)
from point_cloud_registration_tpu_torch.models.icp import (
    ICP,
    ICPTarget,
    build_icp_target,
    icp_align,
    icp_stats,
)
from point_cloud_registration_tpu_torch.models.ndt import (
    NDT,
    build_ndt_target,
    ndt_align,
    ndt_solver_stats,
)
from point_cloud_registration_tpu_torch.models.fast_vplane_icp import FastVPlaneICP
from point_cloud_registration_tpu_torch.models.plane_icp import (
    PlaneICP,
    PlaneICPTarget,
    build_plane_icp_target,
    plane_icp_align,
    plane_icp_stats,
)
