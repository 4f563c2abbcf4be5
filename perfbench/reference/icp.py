"""Plain reference of point-to-point ICP (upstream icp.py:12-57) on the
packed correspondence method, the method and defaults of
``CorrespondenceConfig`` for a map of 50k points and more: packed cells of
``max_dist / 4``, 32 points kept a block, a proxy voxel for the queries the
packed tier leaves.

The target, from the points alone:

* the kept points: a block is the cell ``floor(floor(p / f) / 2)`` of the
  fine size ``f = max_dist / 4``; inside a block the points are ranked by
  ``plane_icp.index_hash`` of their index and the first ``cap`` are kept, a
  uniform subsample;
* the proxy voxels: one per block, the mean of its kept points, valid from
  one point (point-to-point needs no plane), with no normal.

A scan point ``q = T p`` matches the nearest kept point when it lies closer
than ``f`` (the packed tier is exact there), else the nearest valid proxy
mean in the window of ``ceil(max_dist / 2f)`` blocks around it; then the
gate ``dist < max_dist``. With ``r = q - target`` over the inliers and the
upstream Jacobian ``J = [I | -R skew(p)]``, each linearization is the closed
form of icp.py:42-56::

    H = [[n I, -R skew(sum p)], [., sum skew(p)^T skew(p)]]
    g = [sum r, sum p x (R^T r)]
    e2 = sum r^T r

Departures from upstream, none of which changes the answer on these inputs
beyond the correspondence method the program documents:

- upstream matches the exact nearest map point by a k-d tree; here, as in
  ``plane_icp.py``, the packed method above, which is the program's
  correspondence for ICP at this size (the kept subsample and the proxy);
- the trajectory runs two updates past the loop's end, ungated and
  uncounted, for the harness's ``pose_gap`` (``_common.gauss_newton``);
- the matrix products are written as ``@`` so that TF32 rounds them in the
  lower-precision control.

``counts`` hold the loop's work in the units that
``perfbench/metrics/_roofline.py::loop_bound_ms`` reads:

- ``distances``: the candidates the correspondence search looked at (the
  kept points in each query's window, and the valid proxies in an
  unresolved query's window) at each of the loop's own linearizations;
- ``linearizations``: each inlier's closed-form operations over the 92 of a
  point-to-plane row (``FLOPS_PLANE_ROW``), a float. An inlier's
  operations, its weight ``w`` included (the residual's differences are the
  winning distance's, counted there): ``R^T r`` 15 (9 products, 6 sums),
  ``p x R^T r`` 9, ``e2 += w r.r`` 7, ``g0 += w r`` 6, ``g1 += w (p x R^T r)``
  6, ``n += w`` 1, ``sum w p`` 6, ``sum w skew(p)^T skew(p)`` 21 (the six
  products of p's coordinates, the three diagonal sums, six weighted and six
  accumulated): 71, that is 71 / 92 = 0.77 of a plane row an inlier, under
  the three rows of the whitened form the kernel evaluates;
- ``bytes``: each input once: the scan padded to the program's bucket of
  8,192 rows and its weights (16 B a row), each kept point some query's
  window held (12 B: no normal), the mean of each proxy that won a query
  (12 B), and the 29 sums of 4 B.
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
from perfbench.reference.plane_icp import PACKED_CAP, index_hash

PROXY_MIN_POINTS = 1  # the proxy serves points: one kept point makes a mean
SCAN_BUCKET = 8192  # the program pads a scan to a multiple of this many rows
FLOPS_INLIER = 71  # the closed form's operations an inlier (see above)
FLOPS_PLANE_ROW = 92  # _roofline.py's unit of a linearization


@dataclass
class PointTarget:
    kept: torch.Tensor  # (K, 3) kept points
    kept_index: CellIndex  # over the kept points' fine cells
    fine: float
    proxy_means: torch.Tensor  # (P, 3) valid proxies only
    proxy_index: CellIndex  # over the valid proxies' blocks


def build(points: np.ndarray, params: dict, device, dtype) -> PointTarget:
    max_dist = float(params["max_dist"])
    fine = float(np.float32(max_dist / 4))
    p = torch.as_tensor(points, device=device).to(dtype)
    block = torch.div(torch.floor(torch.as_tensor(points, device=device) / np.float32(fine)),
                      2, rounding_mode="floor").to(torch.int64)
    blocks = CellIndex(block)
    # rank inside the block by the index hash: sort by (block, hash)
    seg_of = torch.empty_like(blocks.order)
    seg_of[blocks.order] = torch.repeat_interleave(
        torch.arange(blocks.cell_keys.numel(), device=device), blocks.counts)
    order = torch.argsort((seg_of << 32) | index_hash(p.shape[0], device))
    seg = seg_of[order]
    rank = torch.arange(order.numel(), device=device) - blocks.starts[seg]
    keep = rank < PACKED_CAP
    kept, kept_seg = p[order[keep]], seg[keep]
    n_blocks = blocks.cell_keys.numel()
    cnt = torch.zeros(n_blocks, dtype=dtype, device=device).index_add_(
        0, kept_seg, torch.ones_like(kept[:, 0]))
    mean = torch.zeros((n_blocks, 3), dtype=dtype, device=device).index_add_(0, kept_seg, kept)
    proxy_means = (mean / cnt[:, None])[cnt >= PROXY_MIN_POINTS]
    return PointTarget(kept=kept, kept_index=CellIndex(cell_of(kept, fine)), fine=fine,
                       proxy_means=proxy_means,
                       proxy_index=CellIndex(cell_of(proxy_means, 2 * fine)))


def point_system(src, q, target, inlier, R):
    """The closed-form point-to-point normal equations over the inliers
    (icp.py:42-56) -> ``(H, g, e2, n)``."""
    src, r = src[inlier], q[inlier] - target[inlier]
    n = src.shape[0]
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    x, y, z = src.sum(dim=0).unbind()
    o = torch.zeros_like(x)
    skew_sum = torch.stack([torch.stack([o, -z, y]), torch.stack([z, o, -x]),
                            torch.stack([-y, x, o])])
    H = torch.zeros((6, 6), dtype=src.dtype, device=src.device)
    H[:3, :3] = n * eye
    H[:3, 3:] = -(R @ skew_sum)
    H[3:, :3] = H[:3, 3:].T
    H[3:, 3:] = torch.sum(src * src) * eye - src.T @ src  # sum skew(p)^T skew(p)
    g = torch.cat([r.sum(dim=0), torch.linalg.cross(src, r @ R).sum(dim=0)])
    return H, g, torch.dot(r.reshape(-1), r.reshape(-1)), n


def register(target: PointTarget, scan: np.ndarray, init_T: np.ndarray, params: dict,
             device, dtype):
    """The align from ``init_T`` -> ``_common.GNResult`` (its trajectory
    two updates past its end), with the work the loop needs in ``counts``
    (see the module's docstring)."""
    src = torch.as_tensor(scan, device=device).to(dtype)
    max_dist = float(params["max_dist"])
    radius = int(math.ceil(max_dist / (2 * target.fine) - 1e-9))
    touched = torch.zeros(target.kept.shape[0], dtype=torch.bool, device=device)
    winners = torch.zeros(target.proxy_means.shape[0], dtype=torch.bool, device=device)
    work = []  # (distances, inliers, target rows read so far) of each linearization

    def linearize(T):
        q = transform(src, T)
        d2, row, n1 = nearest_in_window(target.kept_index, target.kept, q, target.fine, 1,
                                        touched)
        un = torch.nonzero(~(d2 < target.fine * target.fine))[:, 0]
        d2p, rowp, n2 = nearest_in_window(target.proxy_index, target.proxy_means, q[un],
                                          2 * target.fine, radius)
        winners[rowp[rowp >= 0]] = True
        tgt = target.kept[row.clamp(min=0)]
        tgt[un] = target.proxy_means[rowp.clamp(min=0)]
        d2[un] = d2p
        inlier = d2 < max_dist * max_dist
        work.append((int(n1.sum()) + int(n2.sum()), int(inlier.sum()),
                     int(touched.sum()) + int(winners.sum())))
        return point_system(src, q, tgt, inlier, T[:3, :3])

    out = gauss_newton(linearize, torch.as_tensor(init_T, device=device).to(dtype),
                       int(params["max_iter"]), float(params["tol"]), extra=2)
    own = work[:out.iterations]  # the loop's own linearizations
    padded = -(-src.shape[0] // SCAN_BUCKET) * SCAN_BUCKET
    out.counts = dict(distances=sum(w[0] for w in own),
                      linearizations=FLOPS_INLIER / FLOPS_PLANE_ROW * sum(w[1] for w in own),
                      bytes=16 * padded + 12 * own[-1][2] + 29 * 4)
    return out
