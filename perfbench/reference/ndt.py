"""Plain reference of NDT (upstream ndt.py:12-57 over voxel.py:69-102): plain
Gauss-Newton on the Mahalanobis cost ``sum (T p - mu)^T icov (T p - mu)``
against the nearest voxel Gaussian.

The map: the points grouped by the cell ``floor(p / voxel_size)``; per cell
the count, mean and covariance (divisor n - 1); a cell with at least
``MIN_POINTS`` points is valid. Its ``icov`` is upstream ``calc_icov``: the
adjugate over the determinant, a determinant of exactly 0 taken as 1e6. A
scan point ``q = T p`` matches the nearest valid mean closer than
``max_dist``; with ``d = q - mu`` and ``J = [I | J1]``, ``J1 = -R skew(p)``,
the linearization is upstream ``calc_H_g_e2`` in its icov form::

    H = sum J^T icov J = [[sum icov, sum icov J1], [., sum J1^T icov J1]]
    g = sum J^T icov d = [sum icov d, sum J1^T icov d]
    e2 = sum d^T icov d

Departures from upstream, none of which changes the answer:

- the nearest mean is found in the window of ``ceil(max_dist / voxel_size)``
  cells around the query's cell, in chunks that fit the card, in place of
  upstream's k-d tree over the means; under the ``max_dist`` gate both find
  the same nearest mean (ties aside), since every mean closer than
  ``max_dist`` lies in that window;
- the trajectory runs two updates past the loop's end, ungated and
  uncounted, for the harness's ``pose_gap`` (``_common.gauss_newton``);
- the matrix products are written as ``@`` so that TF32 rounds them in the
  lower-precision control.

``counts`` hold the loop's work in the units that
``perfbench/metrics/_roofline.py::loop_bound_ms`` reads: ``distances``,
the candidates looked at; ``linearizations``, three per inlier: each row k
of the whitened form ``U d`` (``U^T U = icov``) is a point-to-plane row with
``n = u_k`` (residual ``u_k . d``, Jacobian ``[u_k | p x R^T u_k]``), so it
costs ``FLOPS_PLANE_ROW``; ``bytes``, each input once: 16 B a scan point
(the point and its weight), 12 B the mean of each valid cell in some
query's window, 24 B of ``U`` (six floats) for each cell that won an
inlier, and the 29 sums of 4 B.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference._common import (
    CellIndex,
    cell_of,
    gauss_newton,
    nearest_in_window,
    transform,
)

MIN_POINTS = 10  # voxel validity (voxel.py:56)
SINGULAR_DET = 1e6  # calc_icov's stand-in for a zero determinant (voxel.py:69-102)


@dataclass
class NDTTarget:
    means: torch.Tensor  # (V, 3) valid cells only
    icovs: torch.Tensor  # (V, 3, 3)
    index: CellIndex  # over the valid cells' coordinates
    voxel: float


def calc_icov(cov: torch.Tensor) -> torch.Tensor:
    """Upstream ``calc_icov`` of (..., 3, 3) covariances: the adjugate over
    the determinant, ``det == 0 -> 1e6``; no eigensolver, no Cholesky."""
    a, b, c = cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2]
    d, e, f = cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2]
    det = a * b * c + 2 * d * e * f - a * f * f - b * e * e - c * d * d
    det = torch.where(det == 0, torch.full_like(det, SINGULAR_DET), det)
    adj = torch.stack([
        torch.stack([b * c - f * f, e * f - d * c, d * f - e * b], dim=-1),
        torch.stack([e * f - d * c, a * c - e * e, d * e - a * f], dim=-1),
        torch.stack([d * f - e * b, d * e - a * f, a * b - d * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def build(points: np.ndarray, params: dict, device, dtype) -> NDTTarget:
    voxel = float(params["voxel_size"])
    p = torch.as_tensor(points, device=device).to(dtype)
    key_index = CellIndex(cell_of(p, voxel))
    n_cells = key_index.cell_keys.numel()
    seg = torch.repeat_interleave(torch.arange(n_cells, device=device), key_index.counts)
    ps = p[key_index.order]
    count = key_index.counts.to(dtype)
    mean = torch.zeros((n_cells, 3), dtype=dtype, device=device).index_add_(0, seg, ps)
    mean = mean / count[:, None]
    c = ps - mean[seg]
    outer = (c[:, :, None] * c[:, None, :]).reshape(-1, 9)
    cov = torch.zeros((n_cells, 9), dtype=dtype, device=device).index_add_(0, seg, outer)
    cov = (cov / torch.clamp(count - 1, min=1)[:, None]).reshape(-1, 3, 3)
    valid = key_index.counts >= MIN_POINTS
    means = mean[valid]
    return NDTTarget(means=means, icovs=calc_icov(cov[valid]),
                     index=CellIndex(cell_of(means, voxel)), voxel=voxel)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(K, 3) -> (K, 3, 3) with ``skew(v) w = v x w``."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], dim=-1), torch.stack([z, o, -x], dim=-1),
                        torch.stack([-y, x, o], dim=-1)], dim=-2)


def ndt_system(src, q, means, icovs, inlier, R):
    """The icov-form normal equations over the inliers -> ``(H, g, e2, n)``."""
    src, d, icov = src[inlier], q[inlier] - means[inlier], icovs[inlier]
    k = src.shape[0]
    J = torch.cat([torch.eye(3, dtype=src.dtype, device=src.device).expand(k, 3, 3),
                   -(R @ skew(src))], dim=2)  # (K, 3, 6) = [I | -R skew(p)]
    icov_J = (icov @ J).reshape(-1, 6)
    icov_d = (icov @ d[:, :, None]).reshape(-1)
    J_rows = J.reshape(-1, 6)
    return J_rows.T @ icov_J, J_rows.T @ icov_d, torch.dot(d.reshape(-1), icov_d), k


def register(target: NDTTarget, scan: np.ndarray, init_T: np.ndarray, params: dict,
             device, dtype):
    """The align from ``init_T`` -> ``_common.GNResult`` (its trajectory
    two updates past its end), with the work the loop needs in ``counts``
    (see the module's docstring)."""
    src = torch.as_tensor(scan, device=device).to(dtype)
    max_dist = float(params["max_dist"])
    radius = int(math.ceil(max_dist / target.voxel - 1e-9))
    touched = torch.zeros(target.means.shape[0], dtype=torch.bool, device=device)
    winners = torch.zeros_like(touched)
    work = []  # (distances, inliers) of each linearization

    def linearize(T):
        q = transform(src, T)
        d2, row, n_cand = nearest_in_window(target.index, target.means, q, target.voxel, radius,
                                            touched)
        inlier = d2 < max_dist * max_dist
        safe = row.clamp(min=0)
        work.append((int(n_cand.sum()), int(inlier.sum())))
        winners[safe[inlier]] = True
        return ndt_system(src, q, target.means[safe], target.icovs[safe], inlier, T[:3, :3])

    out = gauss_newton(linearize, torch.as_tensor(init_T, device=device).to(dtype),
                       int(params["max_iter"]), float(params["tol"]), extra=2)
    own = work[:out.iterations]  # the loop's own linearizations
    out.counts = dict(distances=sum(w[0] for w in own), linearizations=3 * sum(w[1] for w in own),
                      bytes=16 * src.shape[0] + 12 * int(touched.sum())
                      + 24 * int(winners.sum()) + 29 * 4)
    return out
