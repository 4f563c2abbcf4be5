"""Shared pieces of the benchmark's plain references: SE(3) on plain torch
tensors, the Gauss-Newton loop of the upstream ``Registration.align``
(registration.py:89-111), and window searches over a sorted cell index.

Plain PyTorch, written from the upstream library's equations. It imports
nothing of the program under test, nor JAX. Every function runs in the
``dtype`` and on the ``device`` of its inputs: float64 for the reference,
float32 with TF32 matrix products for the lower-precision control. The
matrix products that TF32 would round are written as ``@`` on purpose.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

_BIAS = 1 << 20  # cell coordinates are packed as three 21-bit fields
_SO3_EPS = 1e-5  # small-angle branch of expSO3, on theta**2 (math_tools.py:12)


def expSO3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with the upstream small-angle branch."""
    theta2 = torch.dot(w, w)
    W = torch.zeros((3, 3), dtype=w.dtype, device=w.device)
    W[0, 1], W[0, 2], W[1, 0] = -w[2], w[1], w[2]
    W[1, 2], W[2, 0], W[2, 1] = -w[0], -w[1], w[0]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(theta2) <= _SO3_EPS:
        return eye + W
    theta = torch.sqrt(theta2)
    return eye + torch.sin(theta) / theta * W + (1 - torch.cos(theta)) / theta2 * (W @ W)


def plus(T: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """``T boxplus dx = T @ [expSO3(dx[3:]) | dx[:3]]`` (math_tools.py:101-108)."""
    M = torch.eye(4, dtype=T.dtype, device=T.device)
    M[:3, :3] = expSO3(dx[3:])
    M[:3, 3] = dx[:3]
    return T @ M


def transform(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``R p + t`` for (N, 3) points, as one matrix product."""
    return points @ T[:3, :3].T + T[:3, 3]


def plane_system(src, q, target, normals, inlier, R):
    """Point-to-plane normal equations (plane_icp.py:30-69,
    voxelized_plane_icp.py:24-64): ``r = n . (T p - q)``,
    ``J = [n | skew(p) R^T n]`` over the inliers -> ``(H, g, e2, n)``."""
    src, q, target, normals = src[inlier], q[inlier], target[inlier], normals[inlier]
    r = torch.sum(normals * (q - target), dim=1)
    J = torch.cat([normals, torch.linalg.cross(src, normals @ R)], dim=1)
    return J.T @ J, J.T @ r, torch.dot(r, r), int(inlier.sum())


@dataclass
class GNResult:
    """One align of the reference. ``poses[j]`` is the pose after j
    updates; past the loop's own end the trajectory goes on by ``extra``
    updates, ungated. ``dx_norms[j]`` and ``e2[j]`` are linearization j's
    step norm and squared error."""

    poses: list = field(default_factory=list)
    dx_norms: list = field(default_factory=list)
    e2: list = field(default_factory=list)
    iterations: int = 0
    converged: bool = False
    failed: bool = False
    counts: dict = field(default_factory=dict)

    @property
    def updates(self) -> int:
        return self.iterations - 1 if (self.converged or self.failed) else self.iterations


def gauss_newton(linearize, init_T: torch.Tensor, max_iter: int, tol: float,
                 extra: int = 0) -> GNResult:
    """The upstream loop: ``dx = -solve(H, g)``; stop when ``|dx| < tol``,
    the pose not updated on that step; at most ``max_iter`` linearizations.
    Then ``extra`` more updates of the trajectory, ungated and uncounted
    (the first of them the stopping step's)."""
    out = GNResult(poses=[init_T])
    T, dx = init_T, None
    for _ in range(max_iter):
        H, g, e2, _ = linearize(T)
        dx = -torch.linalg.solve(H, g)
        norm = float(torch.linalg.vector_norm(dx))
        out.dx_norms.append(norm)
        out.e2.append(float(e2))
        out.iterations += 1
        if not np.isfinite(norm):
            out.failed = True
            return out
        if norm < tol:
            out.converged = True
            break
        T, dx = plus(T, dx), None
        out.poses.append(T)
    for _ in range(extra):
        if dx is None:
            H, g, _, _ = linearize(T)
            dx = -torch.linalg.solve(H, g)
        T, dx = plus(T, dx), None
        out.poses.append(T)
    return out


def cell_of(points: torch.Tensor, size: float) -> torch.Tensor:
    """``floor(p / size)`` as int64 cell coordinates."""
    return torch.floor(points / size).to(torch.int64)


def pack_keys(cells: torch.Tensor) -> torch.Tensor:
    """(..., 3) int64 cell coordinates -> one int64 key each (clamped to
    +-2**20 cells, far outside any map of the benchmark)."""
    c = cells.clamp(-_BIAS + 1, _BIAS - 1) + _BIAS
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


def window_offsets(radius: int, device) -> torch.Tensor:
    r = torch.arange(-radius, radius + 1, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


class CellIndex:
    """Points sorted by cell: ``order`` maps sorted slots to the rows given;
    each occupied cell has a ``start`` and a ``count`` in that order."""

    def __init__(self, cells: torch.Tensor):
        keys = pack_keys(cells)
        self.keys_sorted, self.order = torch.sort(keys)
        self.cell_keys, counts = torch.unique_consecutive(self.keys_sorted, return_counts=True)
        self.counts = counts
        self.starts = torch.cumsum(counts, 0) - counts
        self.max_count = int(counts.max()) if counts.numel() else 0

    def lookup(self, keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(start, count)`` of each key's cell; count 0 where it is empty."""
        pos = torch.searchsorted(self.cell_keys, keys).clamp(max=self.cell_keys.numel() - 1)
        hit = self.cell_keys[pos] == keys
        return self.starts[pos], torch.where(hit, self.counts[pos], 0)

    def candidates(self, query_cells: torch.Tensor, radius: int, cap: int | None = None):
        """Rows (into the points given) of every point in the window of
        ``radius`` cells around each query cell: ``(rows (Q, C), ok (Q, C))``."""
        offs = window_offsets(radius, query_cells.device)
        start, count = self.lookup(pack_keys(query_cells[:, None, :] + offs[None]))
        m = self.max_count if cap is None else min(cap, self.max_count)
        slot = torch.arange(max(m, 1), device=query_cells.device)
        ok = slot[None, None, :] < count[..., None]
        pos = (start[..., None] + slot).clamp(max=self.order.numel() - 1)
        q = query_cells.shape[0]
        return self.order[pos].reshape(q, -1), ok.reshape(q, -1)


def chunks(n: int, per_row: int, budget: int = 1 << 25):
    """Row ranges whose candidate tables stay under ``budget`` entries."""
    step = max(1, budget // max(per_row, 1))
    for s in range(0, n, step):
        yield s, min(n, s + step)


def nearest_in_window(index: CellIndex, points: torch.Tensor, query: torch.Tensor,
                      size: float, radius: int, touched: torch.Tensor | None = None):
    """Nearest of ``points`` (indexed by ``index`` at cell ``size``) among the
    window of ``radius`` cells around each query -> ``(d2, row, n_cand)``:
    ``inf`` and -1 where the window is empty; ``n_cand`` counts the
    candidates each query looked at, and ``touched`` (a mask over
    ``points``), when given, marks them."""
    n = query.shape[0]
    d2 = torch.full((n,), float("inf"), dtype=query.dtype, device=query.device)
    row = torch.full((n,), -1, dtype=torch.int64, device=query.device)
    n_cand = torch.zeros(n, dtype=torch.int64, device=query.device)
    qc = cell_of(query, size)
    per_row = (2 * radius + 1) ** 3 * max(index.max_count, 1)
    for s, e in chunks(n, per_row):
        rows, ok = index.candidates(qc[s:e], radius)
        diff = points[rows] - query[s:e, None, :]
        dd = torch.where(ok, torch.sum(diff * diff, dim=-1), float("inf"))
        best, arg = torch.min(dd, dim=1)
        d2[s:e] = best
        row[s:e] = torch.where(torch.isfinite(best), torch.gather(rows, 1, arg[:, None])[:, 0], -1)
        n_cand[s:e] = ok.sum(dim=1)
        if touched is not None:
            touched[rows[ok]] = True
    return d2, row, n_cand


def smallest_eigvec(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of each (3, 3), by
    LAPACK on the host (cuSOLVER's batched solver refuses a batch of a
    million 3 x 3 matrices)."""
    _, vecs = torch.linalg.eigh(cov.cpu())
    return vecs[..., :, 0].to(cov.device)
