"""Exact Gauss-Newton coresets via Caratheodory's theorem.

Re-implementation of the reference's coreset machinery
(the reference's point_cloud_registration/caratheodory.py:24-138), which
follows K. Koide, "Exact Point Cloud Downsampling for Fast and Accurate
Global Trajectory Optimization" (arXiv:2307.02948): lift each per-point
(J_i, r_i) into a 28-D moment vector so that any weighted subset preserving
the lifted mean preserves H, g and e^2 *exactly*; Caratheodory's theorem
guarantees such a subset of <= 29 points exists, and the clustered variant
finds <= N_target points fast.

This is deliberately host-side float64 NumPy: the elimination loop is
inherently sequential tiny-SVD work (28 x 64 per step) where exactness — the
whole point of the method (reference tests demand 1e-10) — requires double
precision. It is a copy of ``point_cloud_registration_tpu/models/coreset.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np


def _null_direction(P: np.ndarray, tol: float = 1e-12) -> np.ndarray:
    """A nonzero v with ``P @ v = 0`` and ``sum(v) = 0`` (caratheodory.py:24-34).

    Subtracting the first column reduces the affine condition to a plain
    null-space problem of an (M, m-1) matrix; the direction belonging to the
    smallest singular value is returned.
    """
    A = P[:, 1:] - P[:, :1]
    _, s, Vh = np.linalg.svd(A)
    n_rows = Vh.shape[0]
    null_mask = np.concatenate([s <= tol, np.ones(n_rows - len(s), dtype=bool)])
    if not null_mask.any():
        # Fall back to the weakest singular direction (numerically null).
        null_mask[-1] = True
    v_tail = Vh[null_mask][-1]
    return np.concatenate([[-v_tail.sum()], v_tail])


def caratheodory(P: np.ndarray, u: np.ndarray, n_target: int):
    """Exact Caratheodory elimination (caratheodory.py:36-60).

    ``P`` is (M, m) — m weighted points in M dims with weights ``u`` — and
    points are removed one per step (zeroing one weight along a null
    direction) until ``m <= n_target``, preserving ``P @ u`` and ``sum(u)``
    exactly. Returns ``(P_sub, u_sub, kept_indices)``.
    """
    m = P.shape[1]
    if m <= n_target:
        return P, u, np.arange(m)
    keep = np.arange(m)
    P = P.copy()
    u = np.asarray(u, dtype=np.float64).copy()
    while P.shape[1] > n_target:
        v = _null_direction(P)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratios = u / v
        drop = int(np.argmin(np.abs(ratios)))
        u = u - ratios[drop] * v
        P = np.delete(P, drop, axis=1)
        u = np.delete(u, drop)
        keep = np.delete(keep, drop)
    return P, u, keep


def fast_caratheodory(P: np.ndarray, u: np.ndarray, k: int, n_target: int):
    """Clustered (fast) Caratheodory (caratheodory.py:62-116).

    Repeatedly: split the surviving columns into ``k`` contiguous clusters,
    run exact elimination on the weighted cluster means (dimension+1 of them
    survive), keep only points of surviving clusters with rescaled weights.
    Preserves the lifted moments exactly at every step. Returns
    ``(P_sub, u_sub, kept_indices)`` with ``len(u_sub) <= n_target``.
    """
    P = np.asarray(P, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    m = P.shape[1]
    if m <= n_target:
        return P, u, np.arange(m)
    keep = np.arange(m)
    while P.shape[1] > n_target:
        m = P.shape[1]
        kk = min(k, m)
        bounds = np.linspace(0, m, kk + 1, dtype=int)
        starts, ends = bounds[:-1], bounds[1:]
        sizes = ends - starts
        u_cluster = np.array([u[b:e].sum() for b, e in zip(starts, ends)])
        means = np.stack(
            [P[:, b:e] @ u[b:e] / uc for b, e, uc in zip(starts, ends, u_cluster)],
            axis=1,
        )
        # At least dim+1 clusters must survive to span the moment vector;
        # allow more when clusters are small so each pass lands near n_target
        # (caratheodory.py:94-98).
        n_sub = P.shape[0] + 1
        max_size = int(sizes.max())
        if n_sub * max_size < n_target:
            n_sub = n_target // max_size
        _, w_sub, kept_clusters = caratheodory(means, u_cluster, n_sub)
        cols = np.concatenate(
            [np.arange(starts[c], ends[c]) for c in kept_clusters]
        )
        factors = np.repeat(w_sub / u_cluster[kept_clusters], sizes[kept_clusters])
        P = P[:, cols]
        u = factors * u[cols]
        keep = keep[cols]
    return P, u, keep


def create_gn_set(J: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Lift (N, D) Jacobians + (N,) residuals to moment vectors (M, N) whose
    weighted sum reproduces H (upper triangle), g and e^2 exactly
    (caratheodory.py:118-138). For D=6 the lift is 21 + 6 + 1 = 28-D.
    """
    J = np.asarray(J, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    n, d = J.shape
    iu, ju = np.triu_indices(d)
    outer = J[:, :, None] * J[:, None, :]  # (N, D, D)
    P = np.concatenate(
        [outer[:, iu, ju], J * r[:, None], (r * r)[:, None]], axis=1
    )
    return P.T
