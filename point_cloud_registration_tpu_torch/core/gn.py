"""Host-driven Gauss-Newton loop for SE(3) registration (counterpart of
``point_cloud_registration_tpu/core/gn.py``).

The JAX package compiles the loop into one ``lax.while_loop``. Here the loop
runs on the host: each iteration calls the solver's stats function, which
runs on the data's device and hands its handful of stat values to the host
in one transfer (the one sync of the iteration); the loop then solves,
checks and updates in float32 on the host. The new transform goes to the
next launch by value.

Iteration semantics match the reference exactly (registration.py:89-111):

    for i in range(max_iter):
        H, g, e2 = stats(T)              # solver-specific, fused
        dx = -solve(H, g)                # 6x6
        if ||dx|| < tol: break           # T NOT updated on the breaking step
        T = T boxplus dx

A non-finite ``dx`` ends the loop with ``solver_failed`` set instead of
propagating NaNs (the reference lets ``np.linalg.solve`` raise).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.se3 import plus


class GNStats(NamedTuple):
    """One linearization: normal equations + bookkeeping.

    ``H`` (6, 6) is ``sum_i w_i J_i^T J_i``, ``g`` (6,) is
    ``sum_i w_i J_i^T r_i``, ``e2`` the weighted squared error and
    ``n_inliers`` the summed weight of the gated correspondences.
    """

    H: torch.Tensor
    g: torch.Tensor
    e2: torch.Tensor
    n_inliers: torch.Tensor


class GNDiagnostics(NamedTuple):
    """Per-align diagnostics; the histories have length ``max_iter``."""

    iterations: int  # number of linearizations performed
    converged: bool  # ||dx|| < tol reached
    solver_failed: bool  # non-finite update encountered
    e2_history: torch.Tensor  # (max_iter,) f32, 0 past the last iteration
    dx_norm_history: torch.Tensor  # (max_iter,) f32
    inlier_history: torch.Tensor  # (max_iter,) i32
    final_e2: float


def solve_6x6_batched(H, g) -> np.ndarray:
    """Solve ``H[b] dx[b] = -g[b]`` for B problems at once, on the host:
    ``H`` (B, 6, 6) and ``g`` (B, 6), tensors or arrays -> (B, 6) float32 NumPy.

    The unrolled scalar Cholesky of the JAX package after Jacobi (diagonal)
    scaling, in float32 with the same operation order, each scalar step an
    elementwise NumPy operation over the B problems (the counterpart of
    ``jax.vmap(solve_6x6)``). Every step rounds once per element, so row b is
    the single solve of problem b, bit for bit. A singular H yields NaNs in
    its row (never an exception).
    """
    Hn = np.asarray(torch.as_tensor(H).detach().to("cpu", torch.float32))
    gn = np.asarray(torch.as_tensor(g).detach().to("cpu", torch.float32))
    one = np.float32(1.0)
    with np.errstate(all="ignore"):
        s = one / np.sqrt(np.maximum(np.diagonal(Hn, axis1=1, axis2=2), np.float32(1e-30)))
        Hs = Hn * s[:, :, None] * s[:, None, :]
        b = -(gn * s)

        # Unrolled Cholesky factorization Hs = L L^T.
        L = [[None] * 6 for _ in range(6)]
        for i in range(6):
            for j in range(i + 1):
                acc = Hs[:, i, j]
                for k in range(j):
                    acc = acc - L[i][k] * L[j][k]
                if i == j:
                    L[i][j] = np.sqrt(acc)
                else:
                    L[i][j] = acc / L[j][j]
        # Forward substitution L y = b.
        y = [None] * 6
        for i in range(6):
            acc = b[:, i]
            for k in range(i):
                acc = acc - L[i][k] * y[k]
            y[i] = acc / L[i][i]
        # Back substitution L^T x = y.
        x = [None] * 6
        for i in reversed(range(6)):
            acc = y[i]
            for k in range(i + 1, 6):
                acc = acc - L[k][i] * x[k]
            x[i] = acc / L[i][i]
        return np.stack(x, axis=1).astype(np.float32) * s


def solve_6x6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve ``H dx = -g`` for the GN step (registration.py:103), on the host:
    :func:`solve_6x6_batched` of the one problem. H is symmetric PSD by
    construction; a singular H yields NaNs (never an exception), which the
    GN loop reports as ``solver_failed``. Returns a float32 CPU tensor.
    """
    H = torch.as_tensor(H).reshape(1, 6, 6)
    g = torch.as_tensor(g).reshape(1, 6)
    return torch.from_numpy(solve_6x6_batched(H, g)[0])


def gauss_newton(
    stats_fn: Callable[[torch.Tensor], GNStats],
    init_T,
    max_iter: int,
    tol: float,
) -> tuple[torch.Tensor, GNDiagnostics]:
    """Run the GN loop and return ``(T (4, 4) f32 CPU tensor, diagnostics)``.

    ``stats_fn(T) -> GNStats`` encapsulates everything solver-specific
    (correspondence + linearization + reduction). It receives T as a
    float32 CPU tensor and returns the stats on the host, copied there in
    one transfer (stats left on a device still work, at one sync each).
    """
    T = torch.as_tensor(init_T).to("cpu", torch.float32).clone()
    e2_hist = torch.zeros(max_iter, dtype=torch.float32)
    dxn_hist = torch.zeros(max_iter, dtype=torch.float32)
    inl_hist = torch.zeros(max_iter, dtype=torch.int32)
    it = 0
    done = failed = converged = False
    final_e2 = 0.0
    while it < max_iter and not done:
        stats = stats_fn(T)
        dx = solve_6x6(stats.H, stats.g)
        dx_norm = torch.linalg.norm(dx)
        bad = not bool(torch.isfinite(dx_norm))
        converged_now = bool(dx_norm < tol)
        done = converged_now or bad
        # Reference ordering: the transform is NOT updated on the breaking step.
        if not done:
            T = plus(T, dx)
        failed = failed or bad
        converged = converged or converged_now
        e2_hist[it] = stats.e2.to(torch.float32)
        dxn_hist[it] = dx_norm
        inl_hist[it] = stats.n_inliers.to(torch.int32)
        final_e2 = float(stats.e2)
        it += 1
    diag = GNDiagnostics(
        iterations=it,
        converged=converged,
        solver_failed=failed,
        e2_history=e2_hist,
        dx_norm_history=dxn_hist,
        inlier_history=inl_hist,
        final_e2=final_e2,
    )
    return T, diag
