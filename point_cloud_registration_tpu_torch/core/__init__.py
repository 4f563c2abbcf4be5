"""Math kernel + optimizer core (SE(3) Lie algebra, Gauss-Newton loop)."""

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
