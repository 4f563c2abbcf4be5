"""Fused correspondence + linearization + reduction for VPlaneICP (counterpart
of ``point_cloud_registration_tpu/ops/pallas/fused_align.py``, kind "plane").

``fused_plane_stats`` computes one Gauss-Newton linearization of the scan
against a voxel map: for each scan point ``q = R p + t``, the nearest valid
voxel centroid within ``radius = ceil(max_dist / cell)`` cells, gated on
``dist < max_dist``, linearized as point-to-plane, and reduced to the 29
unique terms of ``sum_i w_i [J_i|r_i|1]^T [J_i|r_i|1]``::

    [H upper triangle, row-major (21) | g (6) | e2 | n_inliers]

For CUDA tensors it launches the hand-written kernel ``csrc/fused_align.cu``;
for CPU tensors it runs the plain PyTorch version,
:func:`fused_plane_stats_reference`, which the tests and ``chip_smoke.py``
also call directly. There is no fallback between the two.

The TPU kernel's band layout, region DMA, bf16x3 one-hot gathers and
straggler fallback exist for the TPU's memory system and have no
counterpart: a CUDA thread reads its window straight from the table.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.gn import GNStats
from point_cloud_registration_tpu_torch.core.se3 import makeT, transform_points
from point_cloud_registration_tpu_torch.ops.kernels._build import load_library
from point_cloud_registration_tpu_torch.ops.knn import FOUND_MAX, TABLE_WIDTH
from point_cloud_registration_tpu_torch.ops.reduce import plane_stats

STATS_WIDTH = 29
# Most blocks of one launch: each block writes one row of partials, so the
# launch shape (and with it the summation order) depends on the scan size only.
MAX_BLOCKS = 1024
# Cell coordinates are clamped before the integer conversion (as in the kernel).
_CELL_CLAMP = 1e9
_TRIU = torch.triu_indices(6, 6)


def window_radius(max_dist: float, cell_size: float) -> int:
    """Probe radius in cells that covers ``max_dist`` (fused_align.py:670)."""
    return int(np.ceil(max_dist / cell_size - 1e-9))


def inv_cell_f32(cell_size: float) -> np.float32:
    """The float32 ``1 / cell`` the kernel's cell rule multiplies by
    (fused_align.py:429)."""
    return np.float32(1.0 / float(np.float32(cell_size)))


def window_offsets(radius: int, device=None) -> torch.Tensor:
    """(K, 3) int64 cell offsets of the probe window, x fastest, z slowest."""
    r = torch.arange(-radius, radius + 1, device=device)
    oz, oy, ox = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], dim=-1)


def packed_from_stats(stats: GNStats) -> torch.Tensor:
    """GNStats -> the (29,) layout of the kernel's output."""
    triu = _TRIU.to(stats.H.device)
    return torch.cat([
        stats.H[triu[0], triu[1]],
        stats.g.reshape(6),
        stats.e2.reshape(1),
        stats.n_inliers.reshape(1),
    ])


def stats_from_packed(packed: torch.Tensor) -> GNStats:
    """The (29,) kernel output -> GNStats (H symmetric), on its device."""
    triu = _TRIU.to(packed.device)
    H = torch.zeros((6, 6), dtype=packed.dtype, device=packed.device)
    H[triu[0], triu[1]] = packed[:21]
    H[triu[1], triu[0]] = packed[:21]
    return GNStats(H=H, g=packed[21:27], e2=packed[27], n_inliers=packed[28])


def _check_geometry(table, dims):
    d_total = int(np.prod([int(x) for x in dims]))
    if table.shape != (d_total, TABLE_WIDTH):
        raise ValueError(
            f"table of shape {tuple(table.shape)} does not match dims {dims} "
            f"(expected ({d_total}, {TABLE_WIDTH}))"
        )


def fused_plane_stats_reference(
    table: torch.Tensor,
    origin_cell,
    dims,
    cell_size: float,
    src: torch.Tensor,
    w: torch.Tensor,
    R,
    t,
    max_dist: float,
    huber_delta: float | None = None,
    chunk: int = 8192,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the device of ``src``.

    Same window, probe order, tie rule, gate and linearization as the
    kernel; the window search runs over chunks of ``chunk`` queries so that
    the (chunk, K, 4) candidate block stays small on the card. Returns the
    (29,) stats.
    """
    _check_geometry(table, dims)
    dev = src.device
    R = torch.as_tensor(R, dtype=torch.float32).to(dev)
    t = torch.as_tensor(t, dtype=torch.float32).to(dev)
    q = transform_points(makeT(R, t), src)
    inv_cell = torch.tensor(inv_cell_f32(cell_size), device=dev)
    origin = torch.tensor(origin_cell, dtype=torch.int64, device=dev)
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)
    nx, ny = int(dims[0]), int(dims[1])
    cell = torch.floor(q * inv_cell).clamp(-_CELL_CLAMP, _CELL_CLAMP).to(torch.int64)
    cell = cell - origin
    offs = window_offsets(window_radius(max_dist, cell_size), dev)

    n = src.shape[0]
    best_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    best_key = torch.empty(n, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        c = cell[s:s + chunk, None, :] + offs[None]  # (M, K, 3)
        inb = ((c >= 0) & (c < dims_t)).all(dim=-1)
        key = c[..., 0] + nx * (c[..., 1] + ny * c[..., 2])
        key = torch.where(inb, key, torch.zeros_like(key))
        rows = table[key, :4]  # (M, K, 4): centroid + valid flag
        d = q[s:s + chunk, None, :] - rows[..., :3]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        d2 = torch.where(inb & (rows[..., 3] > 0), d2, torch.full_like(d2, float("inf")))
        arg = torch.argmin(d2, dim=1)  # first minimum in probe order
        best_d2[s:s + chunk] = torch.gather(d2, 1, arg[:, None])[:, 0]
        best_key[s:s + chunk] = torch.gather(key, 1, arg[:, None])[:, 0]

    found = best_d2 < np.float32(FOUND_MAX) ** 2
    wq = w * found * (torch.sqrt(best_d2) < max_dist)
    row = table[best_key]
    stats = plane_stats(src, q, row[:, 0:3], row[:, 4:7], wq, R,
                        huber_delta=huber_delta)
    return packed_from_stats(stats)


@functools.cache
def _kernel_fn():
    fn = load_library().pcr_fused_plane_stats
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = (
        [c_ptr] + [c_int] * 6 + [c_float, c_int]  # table, geometry
        + [c_ptr, c_ptr, c_int]  # src, w, n
        + [c_float] * 12  # R (row-major), t
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + [c_ptr, c_int, c_ptr]  # partials, n_blocks, stream
    )
    fn.restype = c_int
    block = load_library().pcr_fused_plane_block_size
    block.argtypes = []
    block.restype = c_int
    return fn, int(block())


def fused_plane_stats(
    table: torch.Tensor,
    origin_cell,
    dims,
    cell_size: float,
    src: torch.Tensor,
    w: torch.Tensor,
    R,
    t,
    max_dist: float,
    huber_delta: float | None = None,
) -> torch.Tensor:
    """One linearization -> (29,) float32 stats on the device of ``src``.

    ``table`` is the (D, 8) cell table of a map with ``dims`` cells from
    ``origin_cell``; ``src`` (N, 3) and ``w`` (N,) are the untransformed
    scan and its weights; ``R`` (3, 3) and ``t`` (3,) are host values.
    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``fused_plane_stats.launches``.
    """
    if src.device.type == "cpu":
        return fused_plane_stats_reference(
            table, origin_cell, dims, cell_size, src, w, R, t, max_dist, huber_delta
        )
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    _check_geometry(table, dims)
    for name, x, ndim in (("table", table, 2), ("src", src, 2), ("w", w, 1)):
        if x.device != src.device or x.dtype != torch.float32 or x.dim() != ndim:
            raise ValueError(
                f"{name} must be a {ndim}-d float32 tensor on {src.device}, "
                f"got {x.dim()}-d {x.dtype} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = src.shape[0]
    if src.shape[1] != 3 or w.shape[0] != n:
        raise ValueError(f"src {tuple(src.shape)} and w {tuple(w.shape)} do not match")
    if n == 0:
        return torch.zeros(STATS_WIDTH, dtype=torch.float32, device=src.device)
    fn, block = _kernel_fn()
    n_blocks = min(-(-n // block), MAX_BLOCKS)
    partials = torch.empty((n_blocks, STATS_WIDTH), dtype=torch.float32,
                           device=src.device)
    r = [float(v) for v in torch.as_tensor(R, dtype=torch.float32).reshape(9).tolist()]
    tv = [float(v) for v in torch.as_tensor(t, dtype=torch.float32).reshape(3).tolist()]
    rc = fn(
        table.data_ptr(), *(int(d) for d in dims), *(int(o) for o in origin_cell),
        float(inv_cell_f32(cell_size)), window_radius(max_dist, cell_size),
        src.data_ptr(), w.data_ptr(), n,
        *r, *tv,
        float(max_dist), int(huber_delta is not None),
        float(huber_delta) if huber_delta is not None else 0.0,
        partials.data_ptr(), n_blocks,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_plane_stats kernel launch failed: CUDA error {rc}")
    fused_plane_stats.launches += 1
    return partials.sum(dim=0)


fused_plane_stats.launches = 0
