"""Plain reference of voxelized point-to-plane ICP (upstream
voxelized_plane_icp.py:12-64 over voxel.py:104-169).

The map: the points grouped by the cell ``floor(p / voxel_size)``; per
cell the count, mean and covariance (divisor n - 1); a cell with at least
``min_points`` points is valid and its normal is the eigenvector of its
covariance's smallest eigenvalue. A scan point ``q = T p`` matches the
nearest valid mean closer than ``max_dist`` (the window of
``ceil(max_dist / voxel_size)`` cells holds every such mean); its residual
is ``n . (q - mean)``.
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
    plane_system,
    smallest_eigvec,
    transform,
)

MIN_POINTS = 10  # voxel validity (voxel.py:56)


@dataclass
class VoxelTarget:
    means: torch.Tensor  # (V, 3) valid cells only
    normals: torch.Tensor  # (V, 3)
    index: CellIndex  # over the valid cells' coordinates
    voxel: float


def build(points: np.ndarray, params: dict, device, dtype) -> VoxelTarget:
    voxel = float(params["voxel_size"])
    p = torch.as_tensor(points, device=device).to(dtype)
    key_index = CellIndex(cell_of(p, voxel))
    order = key_index.order
    n_cells = key_index.cell_keys.numel()
    seg = torch.repeat_interleave(torch.arange(n_cells, device=device), key_index.counts)
    ps = p[order]
    count = key_index.counts.to(dtype)
    mean = torch.zeros((n_cells, 3), dtype=dtype, device=device).index_add_(0, seg, ps)
    mean = mean / count[:, None]
    c = ps - mean[seg]
    outer = (c[:, :, None] * c[:, None, :]).reshape(-1, 9)
    cov = torch.zeros((n_cells, 9), dtype=dtype, device=device).index_add_(0, seg, outer)
    cov = (cov / torch.clamp(count - 1, min=1)[:, None]).reshape(-1, 3, 3)
    valid = key_index.counts >= MIN_POINTS
    means = mean[valid]
    normals = smallest_eigvec(cov[valid])
    return VoxelTarget(means=means, normals=normals, index=CellIndex(cell_of(means, voxel)),
                       voxel=voxel)


def register(target: VoxelTarget, scan: np.ndarray, init_T: np.ndarray, params: dict,
             device, dtype):
    """The align from ``init_T`` -> ``_common.GNResult`` (its trajectory
    two updates past its end), with the work the loop needs in ``counts``:
    distances, linearizations, and the bytes of every input read once."""
    src = torch.as_tensor(scan, device=device).to(dtype)
    max_dist = float(params["max_dist"])
    radius = int(math.ceil(max_dist / target.voxel - 1e-9))
    touched = torch.zeros(target.means.shape[0], dtype=torch.bool, device=device)
    winners = torch.zeros_like(touched)
    work = []  # (distances, linearizations) of each linearization

    def linearize(T):
        q = transform(src, T)
        d2, row, n_cand = nearest_in_window(target.index, target.means, q, target.voxel, radius,
                                            touched)
        inlier = d2 < max_dist * max_dist
        safe = row.clamp(min=0)
        work.append((int(n_cand.sum()), int(inlier.sum())))
        winners[safe[inlier]] = True
        return plane_system(src, q, target.means[safe], target.normals[safe], inlier, T[:3, :3])

    out = gauss_newton(linearize, torch.as_tensor(init_T, device=device).to(dtype),
                       int(params["max_iter"]), float(params["tol"]), extra=2)
    # Bytes once: the scan (12 B a point) and its weights (4 B), the mean of
    # each valid cell in some query's window (12 B), the normal of each cell that
    # won an inlier (12 B), the 29 output sums.
    own = work[:out.iterations]  # the loop's own linearizations
    out.counts = dict(distances=sum(w[0] for w in own), linearizations=sum(w[1] for w in own),
                      bytes=16 * src.shape[0] + 12 * int(touched.sum())
                      + 12 * int(winners.sum()) + 29 * 4)
    return out
