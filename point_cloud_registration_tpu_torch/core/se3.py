"""SE(3)/SO(3) Lie-group math on torch tensors (counterpart of
``point_cloud_registration_tpu/core/se3.py``).

Every function is batched over leading axes and keeps the dtype and device
of its input. The formulas, including the order of the float32 operations,
follow the JAX package, so both give the same numbers up to rounding.

Conventions
-----------
* Transforms ``T`` are (4, 4) row-major homogeneous matrices.
* A GN update ``dx`` is a 6-vector ``[t(3), omega(3)]``: translation first,
  rotation second (math_tools.py:101-108).
"""

from __future__ import annotations

import numpy as np
import torch

# Small-angle cutoff for the SO(3) exponential, compared against theta**2
# (math_tools.py:12).
_SO3_EPS = 1e-5


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (cross-product) matrix of ``v``: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


# Alias kept for API parity with the reference export list (__init__.py:2).
skews = skew


def skew_time_vector(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Fused ``skew(v1) @ v2`` for batches: (..., 3), (..., 3) -> (..., 3)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    a, b, c = v2[..., 0], v2[..., 1], v2[..., 2]
    return torch.stack([-z * b + y * c, z * a - x * c, -y * a + x * b], dim=-1)


def skew2(v: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted ``sum_i w_i * skew(v_i).T @ skew(v_i)`` -> (3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if weights is not None:
        wx, wy, wz = x * weights, y * weights, z * weights
    else:
        wx, wy, wz = x, y, z
    x2 = torch.sum(wx * x)
    y2 = torch.sum(wy * y)
    z2 = torch.sum(wz * z)
    xy = torch.sum(wx * y)
    xz = torch.sum(wx * z)
    yz = torch.sum(wy * z)
    return torch.stack(
        [
            torch.stack([z2 + y2, -xy, -xz]),
            torch.stack([-xy, x2 + z2, -yz]),
            torch.stack([-xz, -yz, x2 + y2]),
        ]
    )


def huber_weight(r: torch.Tensor, d: float = 1.0) -> torch.Tensor:
    """IRLS Huber weights: 1 where ``r <= d`` else ``d / r`` (math_tools.py:15-19)."""
    safe_r = torch.where(r > d, r, torch.ones_like(r))
    return torch.where(r > d, d / safe_r, torch.ones_like(r))


def expSO3(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map, batched: (..., 3) -> (..., 3, 3).

    Rodrigues formula with the reference's small-angle branch
    (math_tools.py:80-98: ``theta2 <= 1e-5`` -> ``I + W``).
    """
    theta2 = torch.sum(omega * omega, dim=-1)
    near_zero = theta2 <= _SO3_EPS
    # Clamp so that sin/theta is well defined on the branch not taken.
    theta2_safe = torch.where(near_zero, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = skew(omega)
    WW = W @ W
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    k1 = (torch.sin(theta) / theta)[..., None, None]
    k2 = ((1.0 - torch.cos(theta)) / theta2_safe)[..., None, None]
    exact = eye + k1 * W + k2 * WW
    taylor = eye + W
    return torch.where(near_zero[..., None, None], taylor, exact)


def logSO3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm, batched: (..., 3, 3) -> (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = theta < 1e-4
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    scale = torch.where(
        small, torch.full_like(theta, 0.5), 0.5 * theta_safe / torch.sin(theta_safe)
    )
    return w * scale[..., None]


def makeT(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble homogeneous transform(s) from (..., 3, 3) and (..., 3)."""
    batch = R.shape[:-2]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def makeRt(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split (..., 4, 4) -> ((..., 3, 3), (..., 3))."""
    return T[..., :3, :3], T[..., :3, 3]


def plus(T: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """SE(3) boxplus: ``T ⊞ dx = T @ makeT(expSO3(dx[3:]), dx[:3])``
    (math_tools.py:101-108)."""
    return T @ makeT(expSO3(dx[..., 3:]), dx[..., :3])


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 4, 4) transform to (..., N, 3) points (math_tools.py:111-113).

    Written as broadcast multiplies and adds, in the JAX package's order, so
    that both packages round alike.
    """
    R, t = makeRt(T)
    x = points[..., 0:1] * R[..., None, :, 0]
    y = points[..., 1:2] * R[..., None, :, 1]
    z = points[..., 2:3] * R[..., None, :, 2]
    return x + y + z + t[..., None, :]


def numerical_derivative(func, param, idx, plus_op=None, minus_op=None, delta=1e-5):
    """Finite-difference Jacobian checker (math_tools.py:116-127).

    Host-side NumPy utility for tests and debugging. ``func(*param)`` must
    return a 1-D array; the Jacobian is taken w.r.t. ``param[idx]``
    perturbed through ``plus_op``.
    """
    if plus_op is None:
        plus_op = lambda a, b: a + b
    if minus_op is None:
        minus_op = lambda a, b: a - b
    r = np.asarray(func(*param))
    m = r.shape[0]
    n = np.asarray(param[idx]).shape[0]
    J = np.zeros([m, n])
    for j in range(n):
        dx = np.zeros(n)
        dx[j] = delta
        param_delta = list(param).copy()
        param_delta[idx] = plus_op(param[idx], dx)
        J[:, j] = minus_op(np.asarray(func(*param_delta)), r) / delta
    return J
