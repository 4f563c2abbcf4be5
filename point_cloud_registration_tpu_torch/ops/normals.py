"""k-NN PCA normal estimation (counterpart of
``point_cloud_registration_tpu/ops/normals.py``).

The point's own k-neighbourhood (itself included) defines the tangent plane
(reference estimate_normals.py:11-87): the covariance of the neighbours,
centred on the query point (exact algebra, and float32-stable at any
range) with divisor k, and its smallest eigenvector in closed form
(``ops/eigh3.py``).

Backends of :func:`estimate_normals`:

* ``"auto"``: the fused k-NN moments kernel
  (``ops/kernels/knn_normals.py``) in two tiers, a radius-2 pass over every
  point and a radius-4 pass over the tail it could not certify, then a plain
  wide search for the few points whose window held fewer than k candidates
  (the JAX package's ``"pallas"`` path). It certifies, per point, that the
  neighbourhood is the exact k-NN (``return_info``). On the card the steps
  around the kernel (the radius sampler, the tiers' lists, the eigensolve,
  the fallback) are the launches of ``ops/kernels/normals_chain.py``, and
  the host reads nothing after the cell size but the packed grid's geometry.
* ``"gather"``: ``ops.pointgrid.knn_packed`` followed by
  :func:`normals_from_neighbors` (the JAX package's ``"xla"`` path); it does
  not track exactness.
"""

from __future__ import annotations

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.ops.eigh3 import smallest_eigvec_sym3
from point_cloud_registration_tpu_torch.ops.kernels import normals_chain
from point_cloud_registration_tpu_torch.ops.kernels.knn_normals import (
    knn_moments_into,
    knn_moments_out,
)
from point_cloud_registration_tpu_torch.ops.pointgrid import build_packed_grid, knn_packed

BACKENDS = ("auto", "gather")
# Kernel tiers: a radius-2 pass over every point, then a radius-4 pass over
# the tail that the first could not certify (normals.py:175-176).
BASE_RADIUS = 2
WIDE_RADIUS = 4


def sample_draws(n: int, k: int, n_sample: int = 256, seed: int = 0, *,
                 rng: np.random.RandomState | None = None):
    """The host's draws of :func:`sample_knn_radius` (normals.py:38-56):
    ``(sel, ref, k_eff)``, the sampled queries, the reference subsample
    (None: all points) and the neighbour rank taken in it."""
    if rng is None:
        rng = np.random.RandomState(seed)
    m_sub = 1 << 17
    if n > 2 * m_sub:
        sel = rng.randint(0, n, size=min(n_sample, n))
        return sel, rng.randint(0, n, size=m_sub), max(2, int(np.ceil(k * m_sub / n)))
    return rng.choice(n, size=min(n_sample, n), replace=False), None, k


def sample_knn_radius(points: torch.Tensor, k: int, n_sample: int = 256, seed: int = 0, *,
                      rng: np.random.RandomState | None = None) -> float:
    """Median k-th-NN distance of a random sample (host float); it sizes the
    k-NN grid's cells. ``rng`` (default ``np.random.RandomState(seed)``)
    makes the draws of normals.py:38-56 (:func:`sample_draws`), so both
    packages pick the same sample: ``n_sample`` queries and, above 2**18
    points, a reference subsample of 2**17 points with k scaled down in
    proportion. The median of an even count is the mean of the two middle
    values. The draws go to the device in one copy;
    ``ops/kernels/normals_chain.sampled_median`` does the rest (on the card
    one launch, and the result is the one value read back)."""
    sel, ref, k_eff = sample_draws(points.shape[0], k, n_sample, seed, rng=rng)
    draws = torch.as_tensor(sel if ref is None else np.concatenate([sel, ref]),
                            device=points.device)
    m = len(sel)
    return normals_chain.sampled_median(points, draws[:m], None if ref is None else draws[m:],
                                        k_eff)


def normals_from_neighbors(points: torch.Tensor, neighbor_idx: torch.Tensor,
                           query: torch.Tensor) -> torch.Tensor:
    """PCA normals from (N, k) neighbour indices into ``points``, centred on
    ``query`` (N, 3). Slots with index < 0 are left out; the divisor is the
    number of neighbours present (k when all are)."""
    safe = torch.clamp(neighbor_idx, 0, points.shape[0] - 1).to(torch.int64)
    w = (neighbor_idx >= 0).to(points.dtype)[..., None]  # (N, k, 1)
    c = (points[safe] - query[:, None, :]) * w
    denom = torch.clamp(w.sum(dim=1), min=1.0)  # (N, 1)
    mean = c.sum(dim=1) / denom
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    m2 = torch.stack([(x * x).sum(1), (y * y).sum(1), (z * z).sum(1), (x * y).sum(1),
                      (x * z).sum(1), (y * z).sum(1)], dim=-1) / denom
    mm = torch.stack([mean[:, 0] * mean[:, 0], mean[:, 1] * mean[:, 1],
                      mean[:, 2] * mean[:, 2], mean[:, 0] * mean[:, 1],
                      mean[:, 0] * mean[:, 2], mean[:, 1] * mean[:, 2]], dim=-1)
    return smallest_eigvec_sym3(m2 - mm)


def _fused_normals(points: torch.Tensor, k: int, cell_size: float, cell_cap: int | None,
                   exact_tail: bool, return_info: bool):
    """The two kernel tiers and the fallback (normals.py:179-344):
    ``(normals, info)``. The capacities of the wide tier and of the fallback
    are the JAX package's: they decide which points are certified.

    On the card the steps after the packed grid's build are launches that
    leave their sizes on the card: the base tier, the lists of the wide
    tier's queries and of the fallback's points (at most ``cap_t`` and
    ``cap_q``), the wide tier over its list, the eigensolve and the
    fallback. The host reads the lists' counts only for ``return_info``
    (``info["n_wide"]``, ``info["n_unresolved"]``)."""
    n = points.shape[0]
    pg = build_packed_grid(points, cell_size, cap=cell_cap or 32, auto_cap=cell_cap is None)
    out = knn_moments_out(pg, points, None, k, BASE_RADIUS)  # (10, n)
    # The wide tier certifies only below 4 * cell; a base k-th distance
    # beyond 6 * cell cannot plausibly come back under it.
    cert = float(np.float32((6.0 * pg.cell_fine) ** 2)) if exact_tail else None
    cap_t = max(min(n // 4, 1 << 18), min(n, 256))
    cap_q = max(min(n // 16, 8192), min(n, 64))
    tail, un, totals = normals_chain.tail_lists(out, cert, cap_t, cap_q)
    if exact_tail:
        knn_moments_into(pg, points, tail, totals[0:1], k, WIDE_RADIUS, out)
    normals = normals_chain.eig_normals(out)
    # Points whose window held fewer than k candidates: a plain search at
    # twice the base radius.
    normals_chain.fallback_normals(pg, points, un, totals[1:2], k, 2 * BASE_RADIUS, normals)
    info = {"cell_size": pg.cell_fine, "cap": pg.cap, "n_base": n}
    if return_info:
        n_tail, n_un = totals.tolist()
        info.update(n_wide=min(n_tail, cap_t), n_unresolved=n_un, exact=out[9] > 0)
    return normals, info


def estimate_normals(
    points,
    k: int = 15,
    *,
    cell_size: float | None = None,
    cell_cap: int | None = None,
    backend: str = "auto",
    exact_tail: bool = True,
    return_info: bool = False,
    device=None,
):
    """Estimate unit normals for every point of a cloud (N, 3) -> (N, 3)
    tensor on ``device`` (default: the tensor's device, or
    ``core.device.default_device()`` for NumPy input: the card, or an error
    without one).

    ``cell_size`` defaults to the sampled median k-th-NN distance (at least
    1e-3). With ``exact_tail`` the kernel path searches the tail it could
    not certify again at twice the radius (provable exactness to
    ``4 * cell``); the gather path always searches its tail at radius 2
    (``2 * cell``), as in the JAX package. ``return_info`` -> ``(normals, info)`` with
    ``info["exact"]`` the per-point certificate (``None`` on the gather
    path) and, on the kernel path, the cell size, the packed cap and the
    tiers' query counts.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not supported; expected one of {BACKENDS}")
    points = torch.as_tensor(points).to(device=resolve_device(points, device),
                                        dtype=torch.float32).contiguous()
    if cell_size is None:
        cell_size = max(sample_knn_radius(points, k), 1e-3)
    if backend == "gather":
        pg = build_packed_grid(points, cell_size, cap=cell_cap or max(32, 3 * k))
        _, idx = knn_packed(pg, points, k)
        normals, info = normals_from_neighbors(points, idx, points), {"exact": None}
    else:
        normals, info = _fused_normals(points, k, cell_size, cell_cap, exact_tail, return_info)
    return (normals, info) if return_info else normals


def get_norm_lines(points, normals, length: float = 0.1) -> np.ndarray:
    """Interleave points with offset tips for normal visualization
    (estimate_normals.py:91-105): (N, 3) -> (2N, 3)."""
    points = np.asarray(points)
    normals = np.asarray(normals)
    lines = np.empty((2 * points.shape[0], points.shape[1]), dtype=points.dtype)
    lines[::2] = points
    lines[1::2] = points + normals * length
    return lines
