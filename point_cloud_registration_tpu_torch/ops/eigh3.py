"""Closed-form batched symmetric 3x3 eigendecomposition (counterpart of
``point_cloud_registration_tpu/ops/eigh3.py``).

Eigenvalues come from the trigonometric solution of the characteristic
cubic, eigenvectors from spectral projectors: elementwise math batched over
any leading shape, with the same formulas and fallbacks as the JAX package,
so near-degenerate cells pick the same vector in both. ``torch.linalg.eigh``
would pick another basis there.

Packed symmetric layout: ``(..., 6)`` ordered ``[a00, a11, a22, a01, a02, a12]``.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-20


def pack_sym3(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> packed (..., 6)."""
    return torch.stack(
        [A[..., 0, 0], A[..., 1, 1], A[..., 2, 2], A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]],
        dim=-1,
    )


def unpack_sym3(s: torch.Tensor) -> torch.Tensor:
    """Packed (..., 6) -> full (..., 3, 3)."""
    a00, a11, a22, a01, a02, a12 = s.unbind(-1)
    return torch.stack(
        [
            torch.stack([a00, a01, a02], dim=-1),
            torch.stack([a01, a11, a12], dim=-1),
            torch.stack([a02, a12, a22], dim=-1),
        ],
        dim=-2,
    )


def _scaled6(c):
    """Scale the components by their largest magnitude (float32 conditioning
    for the tiny covariances of a voxel grid): (components, scale)."""
    a = [x.abs() for x in c]
    scale = torch.maximum(
        torch.maximum(torch.maximum(a[0], a[1]), torch.maximum(a[2], a[3])),
        torch.maximum(a[4], torch.clamp(a[5], min=_EPS)),
    )
    return tuple(x / scale for x in c), scale


def _eigvals_c(c):
    """Eigenvalues from scaled components, ascending 3-tuple.

    Exactly diagonal inputs (p1 == 0) take the sorted-diagonal path.
    """
    a00, a11, a22, a01, a02, a12 = c
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    # det(B) / 2 with B = (A - q I) / p
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + two_pi_3)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    d_lo = torch.minimum(torch.minimum(a00, a11), a22)
    d_hi = torch.maximum(torch.maximum(a00, a11), a22)
    d_mid = a00 + a11 + a22 - d_lo - d_hi
    diag = p1 <= _EPS
    return (
        torch.where(diag, d_lo, lam_lo),
        torch.where(diag, d_mid, lam_mid),
        torch.where(diag, d_hi, lam_hi),
    )


def eigvals_sym3(s: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of packed symmetric 3x3, ascending: (..., 6) -> (..., 3)."""
    c, scale = _scaled6(s.unbind(-1))
    lam_lo, lam_mid, lam_hi = _eigvals_c(c)
    return torch.stack([lam_lo, lam_mid, lam_hi], dim=-1) * scale[..., None]


def _projector_column_c(c, lam_a, lam_b):
    """Largest column of ``(A - lam_a I)(A - lam_b I)``: for distinct
    eigenvalues it is proportional to the remaining eigenvector.
    Returns the (vx, vy, vz) component tuple."""
    a00, a11, a22, a01, a02, a12 = c
    t = lam_a + lam_b
    d = lam_a * lam_b
    s00 = a00 * a00 + a01 * a01 + a02 * a02
    s11 = a01 * a01 + a11 * a11 + a12 * a12
    s22 = a02 * a02 + a12 * a12 + a22 * a22
    s01 = a00 * a01 + a01 * a11 + a02 * a12
    s02 = a00 * a02 + a01 * a12 + a02 * a22
    s12 = a01 * a02 + a11 * a12 + a12 * a22
    m00 = s00 - t * a00 + d
    m11 = s11 - t * a11 + d
    m22 = s22 - t * a22 + d
    m01 = s01 - t * a01
    m02 = s02 - t * a02
    m12 = s12 - t * a12
    n0 = m00 * m00 + m01 * m01 + m02 * m02
    n1 = m01 * m01 + m11 * m11 + m12 * m12
    n2 = m02 * m02 + m12 * m12 + m22 * m22
    use1 = (n1 >= n0) & (n1 >= n2)
    use2 = (n2 >= n0) & (n2 > n1)
    vx = torch.where(use2, m02, torch.where(use1, m01, m00))
    vy = torch.where(use2, m12, torch.where(use1, m11, m01))
    vz = torch.where(use2, m22, torch.where(use1, m12, m02))
    return vx, vy, vz


def _normalize_c(vx, vy, vz, fb_x, fb_y, fb_z):
    n2 = vx * vx + vy * vy + vz * vz
    ok = n2 > _EPS
    r = torch.rsqrt(torch.where(ok, n2, torch.ones_like(n2)))
    return (
        torch.where(ok, vx * r, fb_x),
        torch.where(ok, vy * r, fb_y),
        torch.where(ok, vz * r, fb_z),
    )


def smallest_eigvec_sym3(s: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue: (..., 6) -> (..., 3).

    The voxel normal (replaces ``np.linalg.eigh(covs)[1][:, :, 0]``,
    voxel.py:157-158). The sign is arbitrary, as in the reference.
    Near-degenerate (isotropic) inputs fall back to +z.
    """
    c, _ = _scaled6(s.unbind(-1))
    _, lam_mid, lam_hi = _eigvals_c(c)
    vx, vy, vz = _projector_column_c(c, lam_hi, lam_mid)
    zero = torch.zeros_like(vx)
    vx, vy, vz = _normalize_c(vx, vy, vz, zero, zero, torch.ones_like(vx))
    return torch.stack([vx, vy, vz], dim=-1)


def eigh_sym3(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full decomposition of packed symmetric 3x3: ascending eigenvalues and
    an orthonormal eigenvector matrix with columns ``V[..., :, i]``, as
    ``np.linalg.eigh`` returns them: (..., 6) -> ((..., 3), (..., 3, 3))."""
    c, scale = _scaled6(s.unbind(-1))
    lam_lo, lam_mid, lam_hi = _eigvals_c(c)
    lams = torch.stack([lam_lo, lam_mid, lam_hi], dim=-1) * scale[..., None]
    zero = torch.zeros_like(lam_lo)
    one = torch.ones_like(lam_lo)
    lx, ly, lz = _projector_column_c(c, lam_hi, lam_mid)
    lx, ly, lz = _normalize_c(lx, ly, lz, zero, zero, one)
    hx, hy, hz = _projector_column_c(c, lam_lo, lam_mid)
    hx, hy, hz = _normalize_c(hx, hy, hz, one, zero, zero)
    # Re-orthogonalize v_hi against v_lo, then complete the right-handed frame.
    dot = hx * lx + hy * ly + hz * lz
    hx, hy, hz = _normalize_c(
        hx - dot * lx, hy - dot * ly, hz - dot * lz, one, zero, zero
    )
    mx = hy * lz - hz * ly
    my = hz * lx - hx * lz
    mz = hx * ly - hy * lx
    v_lo = torch.stack([lx, ly, lz], dim=-1)
    v_mid = torch.stack([mx, my, mz], dim=-1)
    v_hi = torch.stack([hx, hy, hz], dim=-1)
    return lams, torch.stack([v_lo, v_mid, v_hi], dim=-1)
