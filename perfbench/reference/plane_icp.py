"""Plain reference of point-to-plane ICP on the packed correspondence
method (upstream plane_icp.py:13-69; the method and its defaults are those
of ``CorrespondenceConfig``: packed cells of ``max_dist / 4``, 32 points
kept a block, a proxy voxel for the queries the packed tier leaves).

The target, from the points alone:

* normals: each point's exact k nearest points (itself among them), the
  covariance of those k about their mean (divisor k), and the eigenvector
  of its smallest eigenvalue (estimate_normals.py:11-87);
* the kept points: a block is the cell ``floor(floor(p / f) / 2)`` of the
  fine size ``f = max_dist / 4``; inside a block the points are ranked by a
  hash of their index and the first ``cap`` are kept, a uniform subsample;
* the proxy voxels: one per block, over its kept points: the mean, the
  normal of their covariance (divisor max(n - 1, 1)), valid from 3 points.

A scan point ``q = T p`` matches the nearest kept point when it lies closer
than ``f`` (the packed tier is exact there), with that point's normal; else
the nearest valid proxy mean, with the proxy's normal; then the gate
``dist < max_dist``. The residual is ``n . (q - target)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference._common import (
    CellIndex,
    cell_of,
    chunks,
    gauss_newton,
    nearest_in_window,
    plane_system,
    smallest_eigvec,
    transform,
)

PACKED_CAP = 32  # CorrespondenceConfig.packed_cap
PROXY_MIN_POINTS = 3  # the proxy serves planes: 3 points at least


def index_hash(n: int, device) -> torch.Tensor:
    """The int32 hash of each index that orders a block's points
    (pointgrid.py:173-176): two rounds of ``(x ^ (x >> 16)) * 0x45D9F3B``
    with 32-bit wrap-around, then ``x ^ (x >> 16)``; non-negative."""
    def wrap(x):
        return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)

    x = torch.arange(n, dtype=torch.int64, device=device)
    x = wrap((x ^ (x >> 16)) * 0x45D9F3B)
    x = wrap((x ^ (x >> 16)) * 0x45D9F3B)
    return x ^ (x >> 16)


def knn_normals(p: torch.Tensor, k: int, size: float = 0.5) -> torch.Tensor:
    """Exact k-NN PCA normals of every point. A window of one cell around
    a point's cell holds every point closer than the cell size, so a k-th
    distance below it is exact; the points beyond are searched again with
    cells twice as large."""
    n = p.shape[0]
    normals = torch.empty_like(p)
    todo = torch.arange(n, device=p.device)
    while todo.numel():
        index = CellIndex(cell_of(p, size))
        qc = cell_of(p[todo], size)
        exact = torch.zeros(todo.numel(), dtype=torch.bool, device=p.device)
        for s, e in chunks(todo.numel(), 27 * index.max_count):
            rows, ok = index.candidates(qc[s:e], 1)
            q = p[todo[s:e]]
            diff = p[rows] - q[:, None, :]
            dd = torch.where(ok, torch.sum(diff * diff, dim=-1), float("inf"))
            kk = min(k, dd.shape[1])
            top, arg = torch.topk(dd, kk, dim=1, largest=False)
            exact[s:e] = (kk == k) & (top[:, -1] < size * size)
            nb = p[torch.gather(rows, 1, arg)]  # (m, k, 3)
            c = nb - nb.mean(dim=1, keepdim=True)
            normals[todo[s:e]] = smallest_eigvec(c.transpose(1, 2) @ c / kk)
        todo = todo[~exact]
        size *= 2
    return normals


@dataclass
class PackedTarget:
    kept: torch.Tensor  # (K, 3) kept points
    kept_normals: torch.Tensor  # (K, 3)
    kept_index: CellIndex  # over the kept points' fine cells
    fine: float
    proxy_means: torch.Tensor  # (P, 3) valid proxies only
    proxy_normals: torch.Tensor  # (P, 3)
    proxy_index: CellIndex  # over the valid proxies' blocks


def build(points: np.ndarray, params: dict, device, dtype) -> PackedTarget:
    max_dist = float(params["max_dist"])
    fine = float(np.float32(max_dist / 4))
    p = torch.as_tensor(points, device=device).to(dtype)
    normals = knn_normals(p, int(params["k"]))
    block = torch.div(torch.floor(torch.as_tensor(points, device=device) / np.float32(fine)),
                      2, rounding_mode="floor").to(torch.int64)
    blocks = CellIndex(block)
    # rank inside the block by the index hash: sort by (block, hash)
    h = index_hash(p.shape[0], device)
    seg_of = torch.empty_like(blocks.order)
    seg_of[blocks.order] = torch.repeat_interleave(
        torch.arange(blocks.cell_keys.numel(), device=device), blocks.counts)
    order = torch.argsort((seg_of << 32) | h)
    seg = seg_of[order]
    rank = torch.arange(order.numel(), device=device) - blocks.starts[seg]
    keep = rank < PACKED_CAP
    kept_rows, kept_seg = order[keep], seg[keep]
    kept = p[kept_rows]
    n_blocks = blocks.cell_keys.numel()
    cnt = torch.zeros(n_blocks, dtype=dtype, device=device).index_add_(
        0, kept_seg, torch.ones_like(kept[:, 0]))
    mean = torch.zeros((n_blocks, 3), dtype=dtype, device=device).index_add_(0, kept_seg, kept)
    mean = mean / cnt[:, None]
    c = kept - mean[kept_seg]
    cov = torch.zeros((n_blocks, 9), dtype=dtype, device=device).index_add_(
        0, kept_seg, (c[:, :, None] * c[:, None, :]).reshape(-1, 9))
    cov = (cov / torch.clamp(cnt - 1, min=1)[:, None]).reshape(-1, 3, 3)
    valid = cnt >= PROXY_MIN_POINTS
    proxy_means = mean[valid]
    return PackedTarget(
        kept=kept, kept_normals=normals[kept_rows],
        kept_index=CellIndex(cell_of(kept, fine)), fine=fine,
        proxy_means=proxy_means, proxy_normals=smallest_eigvec(cov[valid]),
        proxy_index=CellIndex(cell_of(proxy_means, 2 * fine)))


def register(target: PackedTarget, scan: np.ndarray, init_T: np.ndarray, params: dict,
             device, dtype):
    """The align from ``init_T`` -> ``_common.GNResult`` (its trajectory
    two updates past its end), with the work the loop needs in ``counts``."""
    src = torch.as_tensor(scan, device=device).to(dtype)
    max_dist = float(params["max_dist"])
    radius = int(math.ceil(max_dist / (2 * target.fine) - 1e-9))
    touched = torch.zeros(target.kept.shape[0], dtype=torch.bool, device=device)
    touched_proxy = torch.zeros(target.proxy_means.shape[0], dtype=torch.bool, device=device)
    work = []  # (distances, linearizations) of each linearization

    def linearize(T):
        q = transform(src, T)
        d2, row, n1 = nearest_in_window(target.kept_index, target.kept, q, target.fine, 1,
                                        touched)
        resolved = d2 < target.fine * target.fine
        un = torch.nonzero(~resolved)[:, 0]
        d2p, rowp, n2 = nearest_in_window(target.proxy_index, target.proxy_means, q[un],
                                          2 * target.fine, radius, touched_proxy)
        tgt = target.kept[row.clamp(min=0)]
        nrm = target.kept_normals[row.clamp(min=0)]
        tgt[un] = target.proxy_means[rowp.clamp(min=0)]
        nrm[un] = target.proxy_normals[rowp.clamp(min=0)]
        d2[un] = d2p
        inlier = d2 < max_dist * max_dist
        work.append((int(n1.sum()) + int(n2.sum()), int(inlier.sum())))
        return plane_system(src, q, tgt, nrm, inlier, T[:3, :3])

    out = gauss_newton(linearize, torch.as_tensor(init_T, device=device).to(dtype),
                       int(params["max_iter"]), float(params["tol"]), extra=2)
    # Bytes once: the scan and its weights (16 B a point), each kept point
    # some query's window held, with its normal (24 B), each valid proxy an
    # unresolved query's window held, mean and normal (24 B), the 29 sums.
    own = work[:out.iterations]  # the loop's own linearizations
    out.counts = dict(distances=sum(w[0] for w in own), linearizations=sum(w[1] for w in own),
                      bytes=16 * src.shape[0] + 24 * int(touched.sum())
                      + 24 * int(touched_proxy.sum()) + 29 * 4)
    return out
