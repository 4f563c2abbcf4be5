"""k-NN moments for PCA normals (counterpart of
``point_cloud_registration_tpu/ops/pallas/knn_normals.py``).

``knn_moments(pg, q, w, k, radius)`` computes, for each query point, the
query-centred covariance of its ``k`` nearest kept points of a packed point
grid (``ops/pointgrid.py``, slot width 3), searched in the box of packed
blocks that covers the fine-cell window of ``radius`` around the query::

    cov6 (N, 6) f32   c00 c11 c22 c01 c02 c12, divisor = selected count
    count (N,) f32    points selected: k, more on ties at the k-th distance,
                      all candidates when the box holds fewer than k
    rk2 (N,) f32      the k-th smallest squared distance (1e30 when fewer)
    unresolved (N,)   bool: fewer than k candidates and w > 0
    exact (N,)        bool: k candidates, rk2 < (radius * cell)^2 and no
                      truncated block in the box: provably the true k-NN

The box is the TPU kernel's (whole fused blocks of 2x2x1 packed blocks; see
``csrc/knn_normals.cu``), so that every output compares with the JAX
package's point by point. The eigensolve stays outside
(``ops.eigh3.smallest_eigvec_sym3``).

For CUDA tensors it launches the hand-written kernel
``csrc/knn_normals.cu``; for CPU tensors it runs the plain PyTorch version,
:func:`knn_moments_reference`, which the tests and ``chip_smoke.py`` also
call directly. There is no fallback between the two.

The box depends only on the fused block in which it starts, so queries that
share that block share their candidates. Before the launch the wrapper
groups the queries by box into work items of one box and at most
:data:`ITEM` queries (:func:`box_groups_cuda`: one stable sort of integer
keys between two small kernels of the same source; :func:`box_groups` is
its plain version); the kernel gives each item one warp, which stages the
box's points in shared memory once for all of its queries. Outputs come
back in the caller's order.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from point_cloud_registration_tpu_torch.ops.kernels._build import load_library
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    check_operands,
    inv_cell_f32,
    require_cuda,
)
from point_cloud_registration_tpu_torch.ops.knn import CELL_CLAMP, FOUND_MAX
from point_cloud_registration_tpu_torch.ops.pointgrid import PackedPointGrid, _block_ranks

ROUND_K = 32  # the most neighbours one walk of the kernel selects; a larger k takes rounds
MISS_D2 = np.float32(1e30)  # rk2 of a query with fewer than k candidates
ITEM = 32  # queries of one work item at most: the lanes of a warp
_FUSED = (4, 4, 2)  # fine cells per fused block
_GROUP = (2, 2, 1)  # packed blocks per fused block
_INT32_MAX = np.iinfo(np.int32).max


def exact_d2_f32(radius: int, cell: float) -> np.float32:
    """The certification bound ``(radius * cell)^2`` as the float32 the JAX
    kernel compares with (knn_normals.py:97)."""
    return np.float32((radius * cell) ** 2)


def box_blocks(radius: int) -> tuple[int, int, int]:
    """Packed blocks per axis of the candidate box at ``radius``."""
    return tuple(((2 * radius + f - 1) // f + 1) * g for f, g in zip(_FUSED, _GROUP))


def _box_start(pg: PackedPointGrid, q: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, 3) int64 fused block at which each query's candidate box starts:
    that of the fine cell ``c - radius``, with ``c`` binned by the float32
    reciprocal of the cell size."""
    dev = q.device
    inv_cell = torch.tensor(inv_cell_f32(pg.cell_fine), device=dev)
    origin = torch.tensor(pg.origin_fine, dtype=torch.int64, device=dev)
    fused = torch.tensor(_FUSED, dtype=torch.int64, device=dev)
    c = torch.floor(q * inv_cell).clamp(-CELL_CLAMP, CELL_CLAMP).to(torch.int64) - origin
    return torch.div(c - radius, fused, rounding_mode="floor")


def box_rows(pg: PackedPointGrid, q: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, B) int64 packed rows of each query's candidate box, x fastest;
    blocks outside the grid and empty blocks give the sentinel row (the
    last one, which holds no point)."""
    dev = q.device
    sentinel = pg.pts_packed.shape[0] - 1
    nb = torch.tensor(pg.nb_dims, dtype=torch.int64, device=dev)
    group = torch.tensor(_GROUP, dtype=torch.int64, device=dev)
    bx, by, bz = (torch.arange(b, device=dev) for b in box_blocks(radius))
    offs = torch.stack(torch.meshgrid(bz, by, bx, indexing="ij"), dim=-1).reshape(-1, 3)
    offs = offs.flip(-1)  # (B, 3) as (x, y, z), x fastest
    lo = _box_start(pg, q, radius) * group
    b3 = lo[:, None, :] + offs[None]  # (N, B, 3)
    ok = ((b3 >= 0) & (b3 < nb)).all(dim=-1)
    bkey = b3[..., 0] + pg.nb_dims[0] * (b3[..., 1] + pg.nb_dims[1] * b3[..., 2])
    row = pg.block_row[torch.where(ok, bkey, 0)].to(torch.int64)
    return torch.where(ok & (row >= 0), row, sentinel)


def _box_key_space(pg: PackedPointGrid, radius: int):
    """Per axis, the fused blocks of a box (``span``) and of the grid
    (``last``): a box start is clamped to ``[-span, last]``, the first and the
    last start whose box is clipped to nothing, so the key of a box counts
    ``last + span + 1`` values per axis. Returns ``(spans, lasts, n_keys)``."""
    spans = [b // g for b, g in zip(box_blocks(radius), _GROUP)]
    lasts = [-(-d // g) for d, g in zip(pg.nb_dims, _GROUP)]
    n_keys = 1
    for span, last in zip(spans, lasts):
        n_keys *= last + span + 1
    return spans, lasts, n_keys


def box_groups(pg: PackedPointGrid, q: torch.Tensor, radius: int, item: int = ITEM):
    """Group the queries ``q`` (N, 3) by candidate box, in plain PyTorch on
    the device of ``q``: ``(order, starts)``, both int64. ``order`` (N,) lists
    the queries box by box, each box's queries in the caller's order; work
    item ``j`` is ``order[starts[j]:starts[j + 1]]`` (the last one runs to
    N): queries of one box, at most ``item`` of them, a box with more queries
    taking several items in a row.

    The key is the fused block at which the box starts, clamped per axis
    (:func:`_box_key_space`), so that queries far outside the grid need no
    wider key: their boxes hold no block of the grid either way.
    """
    start = _box_start(pg, q, radius)
    spans, lasts, n_keys = _box_key_space(pg, radius)
    key = None
    for axis in (2, 1, 0):
        g = start[:, axis].clamp(-spans[axis], lasts[axis]) + spans[axis]
        key = g if key is None else g + (lasts[axis] + spans[axis] + 1) * key
    if n_keys <= _INT32_MAX:
        key = key.to(torch.int32)  # half the passes of a radix sort
    skey, order = torch.sort(key, stable=True)
    rank = _block_ranks(skey)[2]  # of each query inside its box
    return order, torch.nonzero(rank % item == 0)[:, 0]


def box_groups_cuda(pg: PackedPointGrid, q: torch.Tensor, radius: int):
    """:func:`box_groups` with :data:`ITEM` for CUDA tensors: the keys and the
    item starts come from two small kernels of ``csrc/knn_normals.cu``, the
    sort between them from ``torch.sort``. One host sync (the number of
    items). The same ``(order, starts)``, element for element; int64 keys
    only where int32 cannot hold them, as there."""
    require_cuda(q)
    if q.dtype != torch.float32 or q.dim() != 2 or q.shape[1] != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous float32 (N, 3) tensor, got {q.dtype} "
                         f"{tuple(q.shape)}")
    lib = _library()
    n = q.shape[0]
    wide = _box_key_space(pg, radius)[2] > _INT32_MAX
    stream = torch.cuda.current_stream(q.device).cuda_stream
    key = torch.empty(n, dtype=torch.int64 if wide else torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.pcr_knn_box_keys(
            q.data_ptr(), n, *(int(d) for d in pg.nb_dims), *(int(o) for o in pg.origin_fine),
            float(inv_cell_f32(pg.cell_fine)), int(radius), int(wide), key.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"knn_moments box-key kernel launch failed: CUDA error {rc}")
    skey, order = torch.sort(key, stable=True)
    flag = torch.empty(n, dtype=torch.bool, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.pcr_knn_item_flags(skey.data_ptr(), int(wide), n, ITEM, flag.data_ptr(),
                                    stream)
    if rc != 0:
        raise RuntimeError(f"knn_moments item-flag kernel launch failed: CUDA error {rc}")
    return order, torch.nonzero(flag)[:, 0]


def knn_moments_reference(pg: PackedPointGrid, q: torch.Tensor, w: torch.Tensor, k: int,
                          radius: int, chunk: int = 1024):
    """Plain PyTorch version of the kernel, on the device of ``q``: the same
    box, selection and moments, over chunks of ``chunk`` queries."""
    dev = q.device
    cap, width = pg.cap, pg.width
    found_max2 = float(np.float32(FOUND_MAX) ** 2)
    exact_d2 = float(exact_d2_f32(radius, pg.cell_fine))
    n = q.shape[0]
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    flags = torch.empty((n, 2), dtype=torch.bool, device=dev)
    slot_id = torch.arange(cap, device=dev)
    for a in range(0, n, chunk):
        qc = q[a:a + chunk]
        m = qc.shape[0]
        row = box_rows(pg, qc, radius)
        over = pg.row_over[row].any(dim=1)
        cand = pg.pts_packed[row].reshape(m, -1, cap, width)[..., :3]  # (M, B, cap, 3)
        kept = slot_id[None, None, :] < pg.row_count[row][..., None]
        d = (qc[:, None, None, :] - cand).reshape(m, -1, 3)
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        d2 = dx * dx + dy * dy + dz * dz
        real = kept.reshape(m, -1) & (d2 < found_max2)
        d2 = torch.where(real, d2, float("inf"))
        done = real.sum(dim=1) >= k
        kk = min(k, d2.shape[1])  # a box of fewer slots than k is never done
        kth = torch.topk(d2, kk, dim=1, largest=False, sorted=True).values[:, kk - 1]
        rk = torch.where(done, kth, torch.full_like(kth, float(MISS_D2)))
        sel = (real & (d2 <= rk[:, None])).to(torch.float32)
        dx, dy, dz = (torch.where(real, v, 0.0) for v in (dx, dy, dz))
        cnt = sel.sum(dim=1)
        denom = torch.clamp(cnt, min=1.0)
        sx, sy, sz = ((sel * v).sum(dim=1) / denom for v in (dx, dy, dz))
        pairs = ((dx, dx, sx, sx), (dy, dy, sy, sy), (dz, dz, sz, sz),
                 (dx, dy, sx, sy), (dx, dz, sx, sz), (dy, dz, sy, sz))
        for j, (u, v, mu, mv) in enumerate(pairs):
            out[a:a + chunk, j] = (sel * u * v).sum(dim=1) / denom - mu * mv
        out[a:a + chunk, 6] = cnt
        out[a:a + chunk, 7] = rk
        flags[a:a + chunk, 0] = ~done & (w[a:a + chunk] > 0)
        flags[a:a + chunk, 1] = done & (rk < exact_d2) & ~over
    return out[:, 0:6], out[:, 6], out[:, 7], flags[:, 0], flags[:, 1]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the three entry points of a build of
    ``csrc/knn_normals.cu``."""
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.pcr_knn_moments.argtypes = (
        [c_ptr] * 4 + [c_int] * 8 + [c_float, c_float]  # packed grid, inv_cell, exact_d2
        + [c_int, c_int]  # radius, k
        + [c_ptr, c_ptr, c_int]  # q, w, n
        + [c_ptr, c_ptr, c_int]  # order, starts, items
        + [c_ptr, c_ptr]  # out, stream
    )
    lib.pcr_knn_box_keys.argtypes = (
        [c_ptr, c_int] + [c_int] * 6 + [c_float, c_int, c_int]  # q, n, grid, inv_cell, radius, wide
        + [c_ptr, c_ptr]  # key, stream
    )
    lib.pcr_knn_item_flags.argtypes = [c_ptr, c_int, c_int, c_int, c_ptr, c_ptr]
    for fn in (lib.pcr_knn_moments, lib.pcr_knn_box_keys, lib.pcr_knn_item_flags):
        fn.restype = c_int
    if lib.pcr_knn_item_size() != ITEM or lib.pcr_knn_round_k() != ROUND_K:
        raise RuntimeError("csrc/knn_normals.cu was built for another item size or round")
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(load_library("knn_normals"))


_REFUSED = {
    -1: "k must be at least 1",
    -3: "the cap is too large: one packed row per warp does not fit in shared memory",
}


def _check_grid(pg: PackedPointGrid, q: torch.Tensor) -> None:
    r1, cap = pg.idx_packed.shape
    nb_total = pg.nb_dims[0] * pg.nb_dims[1] * pg.nb_dims[2]
    expect = {
        "pts_packed": (pg.pts_packed, torch.float32, (r1, cap * pg.width)),
        "row_count": (pg.row_count, torch.int32, (r1,)),
        "row_over": (pg.row_over, torch.bool, (r1,)),
        "block_row": (pg.block_row, torch.int32, (nb_total,)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.device != q.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name} must be a {dtype} tensor of shape {shape} on {q.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_moments(pg: PackedPointGrid, q, w, k: int, radius: int, order, starts, out) -> None:
    """Launch the kernel on checked operands: the queries grouped as
    ``(order, starts)`` by :func:`box_groups_cuda`, ``out`` (10, N) float32.
    Apart from :func:`knn_moments`, the measurement scripts call it to time
    the kernel without its grouping. It runs with the card of ``q`` current
    (the kernel's shared-memory limit is set there)."""
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.pcr_knn_moments(
            pg.pts_packed.data_ptr(), pg.row_count.data_ptr(), pg.block_row.data_ptr(),
            pg.row_over.data_ptr(), pg.cap, pg.width, *(int(d) for d in pg.nb_dims),
            *(int(o) for o in pg.origin_fine), float(inv_cell_f32(pg.cell_fine)),
            float(exact_d2_f32(radius, pg.cell_fine)), int(radius), int(k),
            q.data_ptr(), w.data_ptr(), q.shape[0],
            order.data_ptr(), starts.data_ptr(), starts.shape[0],
            out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc < 0:
        raise ValueError(f"knn_moments: {_REFUSED.get(rc, rc)}")
    if rc != 0:
        raise RuntimeError(f"knn_moments kernel launch failed: CUDA error {rc}")


def knn_moments(pg: PackedPointGrid, q: torch.Tensor, w: torch.Tensor, k: int, radius: int):
    """k-NN moments of ``q`` (N, 3) with weights ``w`` (N,) against the
    packed grid ``pg`` -> ``(cov6, count, rk2, unresolved, exact)`` on the
    device of ``q`` (see the module doc). Any ``k >= 1``: the kernel selects
    up to :data:`ROUND_K` neighbours per walk of the box and a larger ``k``
    in rounds (one walk more per round). On the card the cap of ``pg`` is at
    most about 15,000 (one packed row must fit a warp's stage in shared
    memory).
    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``knn_moments.launches``."""
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if radius < 1:
        raise ValueError(f"radius must be at least 1, got {radius}")
    if q.device.type == "cpu":
        return knn_moments_reference(pg, q, w, k, radius)
    require_cuda(q)
    check_operands(q, w)
    _check_grid(pg, q)
    n = q.shape[0]
    out = torch.empty((10, n), dtype=torch.float32, device=q.device)
    if n:
        order, starts = box_groups_cuda(pg, q, radius)
        launch_moments(pg, q, w, k, radius, order, starts, out)
        knn_moments.launches += 1
    return out[0:6].T.contiguous(), out[6], out[7], out[8] > 0, out[9] > 0


knn_moments.launches = 0
