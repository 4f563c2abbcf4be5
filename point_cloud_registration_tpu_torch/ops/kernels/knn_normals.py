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
from point_cloud_registration_tpu_torch.ops.pointgrid import PackedPointGrid

MAX_K = 32  # the largest k the kernel is compiled for
MISS_D2 = np.float32(1e30)  # rk2 of a query with fewer than k candidates
_FUSED = (4, 4, 2)  # fine cells per fused block
_GROUP = (2, 2, 1)  # packed blocks per fused block


def exact_d2_f32(radius: int, cell: float) -> np.float32:
    """The certification bound ``(radius * cell)^2`` as the float32 the JAX
    kernel compares with (knn_normals.py:97)."""
    return np.float32((radius * cell) ** 2)


def box_blocks(radius: int) -> tuple[int, int, int]:
    """Packed blocks per axis of the candidate box at ``radius``."""
    return tuple(((2 * radius + f - 1) // f + 1) * g for f, g in zip(_FUSED, _GROUP))


def box_rows(pg: PackedPointGrid, q: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, B) int64 packed rows of each query's candidate box, x fastest;
    blocks outside the grid and empty blocks give the sentinel row (the
    last one, which holds no point)."""
    dev = q.device
    sentinel = pg.pts_packed.shape[0] - 1
    nb = torch.tensor(pg.nb_dims, dtype=torch.int64, device=dev)
    inv_cell = torch.tensor(inv_cell_f32(pg.cell_fine), device=dev)
    origin = torch.tensor(pg.origin_fine, dtype=torch.int64, device=dev)
    fused = torch.tensor(_FUSED, dtype=torch.int64, device=dev)
    group = torch.tensor(_GROUP, dtype=torch.int64, device=dev)
    bx, by, bz = (torch.arange(b, device=dev) for b in box_blocks(radius))
    offs = torch.stack(torch.meshgrid(bz, by, bx, indexing="ij"), dim=-1).reshape(-1, 3)
    offs = offs.flip(-1)  # (B, 3) as (x, y, z), x fastest
    c = torch.floor(q * inv_cell).clamp(-CELL_CLAMP, CELL_CLAMP).to(torch.int64) - origin
    lo = torch.div(c - radius, fused, rounding_mode="floor") * group
    b3 = lo[:, None, :] + offs[None]  # (N, B, 3)
    ok = ((b3 >= 0) & (b3 < nb)).all(dim=-1)
    bkey = b3[..., 0] + pg.nb_dims[0] * (b3[..., 1] + pg.nb_dims[1] * b3[..., 2])
    row = pg.block_row[torch.where(ok, bkey, 0)].to(torch.int64)
    return torch.where(ok & (row >= 0), row, sentinel)


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
        kth = torch.topk(d2, k, dim=1, largest=False, sorted=True).values[:, k - 1]
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


@functools.cache
def _kernel_fn():
    lib = load_library("knn_normals")
    fn = lib.pcr_knn_moments
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = (
        [c_ptr] * 4 + [c_int] * 8 + [c_float, c_float]  # packed grid, inv_cell, exact_d2
        + [c_int, c_int]  # radius, k
        + [c_ptr, c_ptr, c_int, c_ptr, c_ptr]  # q, w, n, out, stream
    )
    fn.restype = c_int
    return fn


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


def knn_moments(pg: PackedPointGrid, q: torch.Tensor, w: torch.Tensor, k: int, radius: int):
    """k-NN moments of ``q`` (N, 3) with weights ``w`` (N,) against the
    packed grid ``pg`` -> ``(cov6, count, rk2, unresolved, exact)`` on the
    device of ``q`` (see the module doc). ``k`` is at most :data:`MAX_K`.
    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``knn_moments.launches``."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} is outside [1, {MAX_K}], the range the kernel is built for")
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
        rc = _kernel_fn()(
            pg.pts_packed.data_ptr(), pg.row_count.data_ptr(), pg.block_row.data_ptr(),
            pg.row_over.data_ptr(), pg.cap, pg.width, *(int(d) for d in pg.nb_dims),
            *(int(o) for o in pg.origin_fine), float(inv_cell_f32(pg.cell_fine)),
            float(exact_d2_f32(radius, pg.cell_fine)), int(radius), int(k),
            q.data_ptr(), w.data_ptr(), n, out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"knn_moments kernel launch failed: CUDA error {rc}")
        knn_moments.launches += 1
    return out[0:6].T.contiguous(), out[6], out[7], out[8] > 0, out[9] > 0


knn_moments.launches = 0
