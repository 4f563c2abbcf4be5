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
  neighbourhood is the exact k-NN (``return_info``).
* ``"gather"``: ``ops.pointgrid.knn_packed`` followed by
  :func:`normals_from_neighbors` (the JAX package's ``"xla"`` path); it does
  not track exactness.
"""

from __future__ import annotations

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.ops.eigh3 import smallest_eigvec_sym3
from point_cloud_registration_tpu_torch.ops.kernels.knn_normals import knn_moments
from point_cloud_registration_tpu_torch.ops.pointgrid import (
    _knn_window_pass,
    build_packed_grid,
    knn_packed,
)

BACKENDS = ("auto", "gather")
# Kernel tiers: a radius-2 pass over every point, then a radius-4 pass over
# the tail that the first could not certify (normals.py:175-176).
BASE_RADIUS = 2
WIDE_RADIUS = 4


def _sampled_knn(queries: torch.Tensor, points: torch.Tensor, k: int,
                 tile: int = 16384) -> torch.Tensor:
    """Exact k smallest distances of a few queries against a big cloud, one
    reference tile at a time: (nq, k) ascending."""
    best_d2 = torch.full((queries.shape[0], k), float("inf"), dtype=torch.float32,
                         device=queries.device)
    for s in range(0, points.shape[0], tile):
        diff = queries[:, None, :] - points[None, s:s + tile, :]
        d2 = torch.sum(diff * diff, dim=-1)
        best_d2 = torch.topk(torch.cat([best_d2, d2], dim=1), k, dim=1, largest=False,
                             sorted=True).values
    return torch.sqrt(best_d2)


def sample_knn_radius(points: torch.Tensor, k: int, n_sample: int = 256, seed: int = 0, *,
                      rng: np.random.RandomState | None = None) -> float:
    """Median k-th-NN distance of a random sample (host float); it sizes the
    k-NN grid's cells. ``rng`` (default ``np.random.RandomState(seed)``)
    makes the draws of normals.py:38-56, so both packages pick the same sample:
    ``n_sample`` queries and, above 2**18 points, a reference subsample of
    2**17 points with k scaled down in proportion. The median of an even
    count is the mean of the two middle values."""
    if rng is None:
        rng = np.random.RandomState(seed)
    n = points.shape[0]
    m_sub = 1 << 17
    big = n > 2 * m_sub
    if big:
        sel = rng.randint(0, n, size=min(n_sample, n))
        refs = points[torch.as_tensor(rng.randint(0, n, size=m_sub), device=points.device)]
        k_eff = max(2, int(np.ceil(k * m_sub / n)))
    else:
        sel = rng.choice(n, size=min(n_sample, n), replace=False)
        refs, k_eff = points, k
    queries = points[torch.as_tensor(sel, device=points.device)]
    kth = torch.sort(_sampled_knn(queries, refs, k_eff)[:, -1]).values
    m = kth.shape[0]
    return float((kth[(m - 1) // 2] + kth[m // 2]) * 0.5)


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
                   exact_tail: bool):
    """The two kernel tiers and the fallback (normals.py:179-344):
    ``(normals, info)``. The capacities of the wide tier and of the fallback
    are the JAX package's: they decide which points are certified."""
    n = points.shape[0]
    dev = points.device
    pg = build_packed_grid(points, cell_size, cap=cell_cap or 32, auto_cap=cell_cap is None)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    cov6, _, rk2, unres, exact = knn_moments(pg, points, ones, k, BASE_RADIUS)
    info = {"cell_size": pg.cell_fine, "cap": pg.cap, "n_base": n, "n_wide": 0}

    if exact_tail:
        # The wide tier certifies only below 4 * cell; a base k-th distance
        # beyond 6 * cell cannot plausibly come back under it.
        certifiable = rk2 < float(np.float32((6.0 * pg.cell_fine) ** 2))
        cap_t = max(min(n // 4, 1 << 18), min(n, 256))
        tail = torch.nonzero(~exact & ~unres & certifiable)[:, 0][:cap_t]
        info["n_wide"] = int(tail.numel())
        if info["n_wide"]:
            q_w = points[tail]
            cov_w, _, _, unres_w, exact_w = knn_moments(pg, q_w, ones[:q_w.shape[0]], k,
                                                        WIDE_RADIUS)
            upd = tail[~unres_w]
            cov6[upd] = cov_w[~unres_w]
            exact[upd] = exact_w[~unres_w]

    normals = smallest_eigvec_sym3(cov6)

    # Points whose window held fewer than k candidates: a plain search at
    # twice the base radius.
    cap_q = max(min(n // 16, 8192), min(n, 64))
    un = torch.nonzero(unres)[:, 0]
    info["n_unresolved"] = int(un.numel())
    un = un[:cap_q]
    if un.numel():
        _, wi = _knn_window_pass(pg, points[un], k, radius=2 * BASE_RADIUS,
                                 chunk=min(cap_q, 2048))
        normals[un] = normals_from_neighbors(points, wi, points[un])
    info["exact"] = exact
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
        normals, info = _fused_normals(points, k, cell_size, cell_cap, exact_tail)
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
