"""Weighted H / g / e^2 reductions for the three residual families
(counterpart of ``point_cloud_registration_tpu/ops/reduce.py``).

The reference compacts correspondences with a boolean mask (a dynamic
shape). Dropping a row equals giving it weight 0 in the sums, so every
function here takes a dense ``weights`` vector.
"""

from __future__ import annotations

import torch

from point_cloud_registration_tpu_torch.core.gn import GNStats
from point_cloud_registration_tpu_torch.core.se3 import (
    huber_weight,
    skew,
    skew2,
    skew_time_vector,
)
from point_cloud_registration_tpu_torch.ops.eigh3 import unpack_sym3


def _pin_full_fp32() -> None:
    """Full float32 matrix products. TF32 keeps about three decimal digits,
    which stalls the GN loop near tol; the JAX package pins HIGHEST
    precision for the same reason (reduce.py:29-32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _sym_block(H_ll, H_lr, H_rr) -> torch.Tensor:
    top = torch.cat([H_ll, H_lr], dim=1)
    bot = torch.cat([H_lr.T, H_rr], dim=1)
    return torch.cat([top, bot], dim=0)


def point_stats(
    source: torch.Tensor,
    src_trans: torch.Tensor,
    targets: torch.Tensor,
    weights: torch.Tensor,
    R: torch.Tensor,
    huber_delta: float | None = None,
) -> GNStats:
    """Point-to-point closed form (reference icp.py:24-57, weighted).

    ``J = [I | -R skew(p)]`` gives ``H_ll = (sum w) I``,
    ``H_lr = -R skew(sum w p)``, ``H_rr = sum w skew(p)^T skew(p)`` and
    ``g = [sum w r ; sum w skew(p) R^T r]``; Huber, when set, weighs by
    ``|r|``.
    """
    _pin_full_fp32()
    rs = src_trans - targets
    if huber_delta is not None:
        weights = weights * huber_weight(torch.sqrt(torch.sum(rs * rs, dim=-1)), huber_delta)
    w = weights[:, None]
    n = torch.sum(weights)
    p_sum = torch.sum(source * w, dim=0)
    H_ll = n * torch.eye(3, dtype=source.dtype, device=source.device)
    H_lr = -(R @ skew(p_sum))
    H_rr = skew2(source, weights)
    g0 = torch.sum(rs * w, dim=0)
    g1 = torch.sum(skew_time_vector(source, rs @ R) * w, dim=0)  # skew(p) R^T r
    e2 = torch.sum(rs * rs * w)
    return GNStats(H=_sym_block(H_ll, H_lr, H_rr), g=torch.cat([g0, g1]), e2=e2,
                   n_inliers=n)


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


def _minus_R_skew(R: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """``K = -R skew(p)`` for every point: (N, 3, 3)."""
    return -torch.einsum("ij,njk->nik", R, skew(source))


def ndt_stats(
    source: torch.Tensor,
    src_trans: torch.Tensor,
    means: torch.Tensor,
    icov_packed: torch.Tensor,
    weights: torch.Tensor,
    R: torch.Tensor,
    huber_delta: float | None = None,
) -> GNStats:
    """Mahalanobis form (reference ndt.py:24-57, weighted).

    ``d = T p - mu``, metric ``S = Sigma^{-1}``, ``J1 = -R skew(p)``:
    ``H = sum w [I | J1]^T S [I | J1]``, ``g = sum w [I | J1]^T S d``,
    ``e2 = sum w d^T S d``. Huber, when set, weighs by the Mahalanobis
    distance.
    """
    _pin_full_fp32()
    icov = unpack_sym3(icov_packed)  # (N, 3, 3)
    diff = src_trans - means
    icov_d = torch.einsum("nij,nj->ni", icov, diff)
    if huber_delta is not None:
        mah = torch.sqrt(torch.clamp(torch.sum(diff * icov_d, dim=-1), min=0.0))
        weights = weights * huber_weight(mah, huber_delta)
    w = weights[:, None, None]
    J1 = _minus_R_skew(R, source)
    icov_J1 = torch.einsum("nij,njk->nik", icov, J1)
    H_ll = torch.sum(icov * w, dim=0)
    H_lr = torch.sum(icov_J1 * w, dim=0)
    H_rr = torch.einsum("nji,njk,n->ik", J1, icov_J1, weights)
    g0 = torch.sum(icov_d * weights[:, None], dim=0)
    g1 = torch.einsum("nji,nj,n->i", J1, icov_d, weights)
    e2 = torch.einsum("ni,ni,n->", diff, icov_d, weights)
    return GNStats(H=_sym_block(H_ll, H_lr, H_rr), g=torch.cat([g0, g1]), e2=e2,
                   n_inliers=torch.sum(weights))


def unpack_u6(u6: torch.Tensor) -> torch.Tensor:
    """(N, 6) ``[u00, u01, u02, u11, u12, u22]`` -> (N, 3, 3) upper ``U``."""
    zero = torch.zeros_like(u6[:, 0])
    return torch.stack(
        [
            torch.stack([u6[:, 0], u6[:, 1], u6[:, 2]], dim=-1),
            torch.stack([zero, u6[:, 3], u6[:, 4]], dim=-1),
            torch.stack([zero, zero, u6[:, 5]], dim=-1),
        ],
        dim=-2,
    )


def whitened_stats(
    source: torch.Tensor,
    src_trans: torch.Tensor,
    means: torch.Tensor,
    u6: torch.Tensor,
    weights: torch.Tensor,
    R: torch.Tensor,
    huber_delta: float | None = None,
) -> GNStats:
    """Mahalanobis form through upper-triangular square roots ``U^T U = icov``
    (reduce.py:161-202): the whitened residual ``r~ = U d`` and Jacobian
    ``J~ = U [I | -R skew(p)]``, three rows per point, the weight counted
    once. Equal to :func:`ndt_stats` in exact arithmetic; the NDT kernel
    computes this form.
    """
    _pin_full_fp32()
    U = unpack_u6(u6)
    rt = torch.einsum("nij,nj->ni", U, src_trans - means)  # whitened residual
    if huber_delta is not None:
        weights = weights * huber_weight(
            torch.sqrt(torch.clamp(torch.sum(rt * rt, dim=-1), min=0.0)), huber_delta
        )
    Jt = torch.cat([U, torch.einsum("nij,njk->nik", U, _minus_R_skew(R, source))], dim=-1)
    H = torch.einsum("nmi,nmj,n->ij", Jt, Jt, weights)
    g = torch.einsum("nmi,nm,n->i", Jt, rt, weights)
    e2 = torch.einsum("nm,nm,n->", rt, rt, weights)
    return GNStats(H=H, g=g, e2=e2, n_inliers=torch.sum(weights))


def reduce_H_g_e2(Js: torch.Tensor, rs: torch.Tensor, weights: torch.Tensor):
    """Weighted reduction of explicit Jacobians (reduce.py:205, the reference
    base class's einsum path, registration.py:55-68): ``H = sum w J^T J``,
    ``g = sum w J^T r``, ``e2 = sum w r^T r`` over (N, m, 6) ``Js`` and
    (N, m) ``rs``, or (N, 6) and (N,) for a scalar residual."""
    _pin_full_fp32()
    if Js.ndim == 2:
        Js = Js[:, None, :]
        rs = rs[:, None]
    H = torch.einsum("nmi,nmj,n->ij", Js, Js, weights)
    g = torch.einsum("nmi,nm,n->i", Js, rs, weights)
    e2 = torch.einsum("nm,nm,n->", rs, rs, weights)
    return H, g, e2
