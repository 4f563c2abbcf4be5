"""Weighted H / g / e^2 reductions (counterpart of the point-to-plane part of
``point_cloud_registration_tpu/ops/reduce.py``).

The reference compacts correspondences with a boolean mask (a dynamic
shape). Dropping a row equals giving it weight 0 in the sums, so every
function here takes a dense ``weights`` vector.
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core.gn import GNStats
from point_cloud_registration_tpu_torch.core.se3 import huber_weight, skew_time_vector


def _pin_full_fp32() -> None:
    """Full float32 matrix products. TF32 keeps about three decimal digits,
    which stalls the GN loop near tol; the JAX package pins HIGHEST
    precision for the same reason (reduce.py:29-32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def plane_stats(
    source: torch.Tensor,
    src_trans: torch.Tensor,
    means: torch.Tensor,
    normals: torch.Tensor,
    weights: torch.Tensor,
    R: torch.Tensor,
    huber_delta: float | None = None,
) -> GNStats:
    """Point-to-plane scalar-residual form (reference plane_icp.py:30-69, weighted).

    ``r = n^T (T p - mu)``, ``J = [n^T | (skew(p) R^T n)^T]``.
    """
    _pin_full_fp32()
    diff = src_trans - means
    rs = torch.sum(normals * diff, dim=-1)  # (N,)
    if huber_delta is not None:
        weights = weights * huber_weight(rs.abs(), huber_delta)
    Jr = skew_time_vector(source, normals @ R)  # skew(p) @ (R^T n)
    J6 = torch.cat([normals, Jr], dim=-1)  # (N, 6)
    Jw = J6 * weights[:, None]
    H = Jw.T @ J6
    g = torch.sum(Jw * rs[:, None], dim=0)
    e2 = torch.sum(rs * rs * weights)
    return GNStats(H=H, g=g, e2=e2, n_inliers=torch.sum(weights))
