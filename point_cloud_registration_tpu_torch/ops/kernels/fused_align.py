"""Fused correspondence + linearization + reduction for VPlaneICP and NDT
(counterpart of ``point_cloud_registration_tpu/ops/pallas/fused_align.py``,
kinds "plane" and "ndt").

``fused_plane_stats`` and ``fused_ndt_stats`` compute one Gauss-Newton
linearization of the scan against a voxel map: for each scan point
``q = R p + t``, the nearest valid voxel centroid within
``radius = ceil(max_dist / cell)`` cells, gated on ``dist < max_dist``,
linearized (point-to-plane, or NDT's whitened Mahalanobis residual), and
reduced to the 29 unique terms of ``sum_i w_i [J_i|r_i|1]^T [J_i|r_i|1]``
(NDT sums its three whitened rows per point and counts the weight once)::

    [H upper triangle, row-major (21) | g (6) | e2 | n_inliers]

The map comes as its :class:`~point_cloud_registration_tpu_torch.ops.knn.CellIndex`:
an occupancy bitmap with ranks, and the centroids and features of the valid
cells only.

For CUDA tensors they launch the hand-written kernels of
``csrc/fused_align.cu``; for CPU tensors they run the plain PyTorch
versions, ``fused_*_stats_reference``, which the tests and ``chip_smoke.py``
also call directly. There is no fallback between the two.

The TPU kernel's band layout, region DMA, bf16x3 one-hot gathers and
straggler fallback exist for the TPU's memory system and have no
counterpart: a CUDA thread walks its window's bits and reads the centroids
of the valid cells straight from global memory.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.gn import GNStats
from point_cloud_registration_tpu_torch.core.se3 import makeT, transform_points
from point_cloud_registration_tpu_torch.ops.kernels._build import load_library
from point_cloud_registration_tpu_torch.ops.knn import (
    CELL_CLAMP,
    FOUND_MAX,
    FEAT_WIDTHS,
    WORD_BITS,
    CellIndex,
    nearest_valid_cell,
    window_offsets,
    window_radius,
)
from point_cloud_registration_tpu_torch.ops.reduce import plane_stats, whitened_stats

STATS_WIDTH = 29
# Most blocks of one launch: each block writes one row of partials, so the
# launch shape (and with it the summation order) depends on the scan size only.
MAX_BLOCKS = 1024
_TRIU = torch.triu_indices(6, 6)
_FEAT_WIDTHS = {"plane": FEAT_WIDTHS[3], "ndt": FEAT_WIDTHS[6]}

__all__ = [
    "STATS_WIDTH", "fused_ndt_stats", "fused_ndt_stats_reference",
    "fused_plane_stats", "fused_plane_stats_reference", "inv_cell_f32",
    "packed_from_stats", "stats_from_packed", "window_offsets", "window_radius",
]


def inv_cell_f32(cell_size: float) -> np.float32:
    """The float32 ``1 / cell`` the kernel's cell rule multiplies by
    (fused_align.py:429)."""
    return np.float32(1.0 / float(np.float32(cell_size)))


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


def _check_geometry(cells: CellIndex, dims, kind):
    d_total = int(np.prod([int(x) for x in dims]))
    n_words = -(-d_total // WORD_BITS)
    width = _FEAT_WIDTHS[kind]
    occ, centers, feats = cells
    if occ.shape != (n_words, 2) or occ.dtype != torch.int32:
        raise ValueError(
            f"occupancy words {occ.dtype} {tuple(occ.shape)} do not match dims {dims} "
            f"(expected int32 ({n_words}, 2))"
        )
    if (centers.dim() != 2 or centers.shape[0] < 1 or centers.shape[1] != 4
            or feats.shape != (centers.shape[0], width)):
        raise ValueError(
            f"centers {tuple(centers.shape)} and feats {tuple(feats.shape)} are not those of "
            f"kind {kind!r} (expected (V + 1, 4) and (V + 1, {width}))"
        )


def _voxel_matches(cells, origin_cell, dims, cell_size, src, w, R, t, max_dist, chunk):
    """Shared search of the plain versions: ``(q, R, best_row, wq)`` with
    ``q = R src + t``, the nearest valid cell's row of ``cells.centers``, and
    the weights with the found flag and the ``dist < max_dist`` gate folded
    in."""
    dev = src.device
    R = torch.as_tensor(R, dtype=torch.float32).to(dev)
    t = torch.as_tensor(t, dtype=torch.float32).to(dev)
    q = transform_points(makeT(R, t), src)
    inv_cell = torch.tensor(inv_cell_f32(cell_size), device=dev)
    origin = torch.tensor(origin_cell, dtype=torch.int64, device=dev)
    cell = torch.floor(q * inv_cell).clamp(-CELL_CLAMP, CELL_CLAMP).to(torch.int64)
    best_d2, best_row = nearest_valid_cell(
        cells.centers, dims, cell - origin, q, window_radius(max_dist, cell_size), chunk,
        occ=cells.occ,
    )
    found = best_d2 < np.float32(FOUND_MAX) ** 2
    wq = w * found * (torch.sqrt(best_d2) < max_dist)
    return q, R, best_row, wq


def fused_plane_stats_reference(
    cells: CellIndex,
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
    """Plain PyTorch version of the plane kernel, on the device of ``src``.

    Same window, probe order, tie rule, gate and linearization as the
    kernel; the window search probes every cell of the window, over chunks
    of ``chunk`` queries (``ops.knn.nearest_valid_cell``). Returns the
    (29,) stats.
    """
    _check_geometry(cells, dims, "plane")
    q, R, best, wq = _voxel_matches(cells, origin_cell, dims, cell_size, src, w, R, t,
                                    max_dist, chunk)
    stats = plane_stats(src, q, cells.centers[best, 0:3], cells.feats[best, 0:3], wq, R,
                        huber_delta=huber_delta)
    return packed_from_stats(stats)


def fused_ndt_stats_reference(
    cells: CellIndex,
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
    """Plain PyTorch version of the NDT kernel: the plane kernel's search,
    then :func:`whitened_stats` with the winner's ``U`` from the 8-wide NDT
    features. Returns the (29,) stats."""
    _check_geometry(cells, dims, "ndt")
    q, R, best, wq = _voxel_matches(cells, origin_cell, dims, cell_size, src, w, R, t,
                                    max_dist, chunk)
    stats = whitened_stats(src, q, cells.centers[best, 0:3], cells.feats[best, 0:6], wq, R,
                           huber_delta=huber_delta)
    return packed_from_stats(stats)


_C_SYMBOLS = {"plane": "pcr_fused_plane_stats", "ndt": "pcr_fused_ndt_stats"}


def bind(lib: ctypes.CDLL, kind: str):
    """``(fn, threads per block)`` of the ``kind`` entry point of a build of
    ``csrc/fused_align.cu``, with its argument types set."""
    fn = getattr(lib, _C_SYMBOLS[kind])
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = (
        [c_ptr] * 3 + [c_int] * 6 + [c_float, c_int]  # occ, centers, feats, geometry
        + [c_ptr, c_ptr, c_int]  # src, w, n
        + [c_float] * 12  # R (row-major), t
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + [c_ptr, c_int]  # partials, n_blocks
        + [c_ptr]  # stream
    )
    fn.restype = c_int
    block = lib.pcr_fused_block_size
    block.argtypes = []
    block.restype = c_int
    return fn, int(block())


@functools.cache
def _kernel_fn(kind: str):
    return bind(load_library("fused_align"), kind)


def check_operands(src: torch.Tensor, w: torch.Tensor, **tensors) -> None:
    """Raise unless ``src`` (N, 3), ``w`` (N,) and every other tensor are
    contiguous float32 tensors on the device of ``src``."""
    for name, x in {"src": src, "w": w, **tensors}.items():
        if x.device != src.device or x.dtype != torch.float32:
            raise ValueError(
                f"{name} must be a float32 tensor on {src.device}, "
                f"got {x.dtype} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if src.dim() != 2 or src.shape[1] != 3 or w.dim() != 1 or w.shape[0] != src.shape[0]:
        raise ValueError(f"src {tuple(src.shape)} and w {tuple(w.shape)} do not match")


def rt_args(R, t) -> list[float]:
    """``R`` (row-major) and ``t`` as 12 host floats, passed by value."""
    r = torch.as_tensor(R, dtype=torch.float32).reshape(9).tolist()
    tv = torch.as_tensor(t, dtype=torch.float32).reshape(3).tolist()
    return [float(v) for v in r + tv]


def launch_stats(kind, bound, cells, origin_cell, dims, cell_size, src, w, R, t, max_dist,
                 huber_delta, partials=None) -> torch.Tensor:
    """Launch the kernel ``bound`` (:func:`bind`) on checked operands; returns
    the (n_blocks, 29) per-block partial sums. ``partials``, when given, is
    the float32 buffer the blocks write, at least ``n_blocks * 29`` long."""
    fn, block = bound
    n = src.shape[0]
    n_blocks = min(-(-n // block), MAX_BLOCKS)
    if partials is None:
        partials = torch.empty((n_blocks, STATS_WIDTH), dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = fn(
        cells.occ.data_ptr(), cells.centers.data_ptr(), cells.feats.data_ptr(),
        *(int(d) for d in dims), *(int(o) for o in origin_cell),
        float(inv_cell_f32(cell_size)), window_radius(max_dist, cell_size),
        src.data_ptr(), w.data_ptr(), n,
        *rt_args(R, t),
        float(max_dist), int(huber_delta is not None),
        float(huber_delta) if huber_delta is not None else 0.0,
        partials.data_ptr(), n_blocks, stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused {kind} stats kernel launch failed: CUDA error {rc}")
    return partials


def check_launch(kind, cells: CellIndex, dims, src: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless the kernel of ``kind`` can read these operands."""
    _check_geometry(cells, dims, kind)
    check_operands(src, w, centers=cells.centers, feats=cells.feats)
    if cells.occ.device != src.device or not cells.occ.is_contiguous():
        raise ValueError(f"occ must be a contiguous tensor on {src.device}")
    if cells.occ.data_ptr() % 8 or cells.centers.data_ptr() % 16 or cells.feats.data_ptr() % 16:
        raise ValueError("occ, centers and feats must start at multiples of 8, 16 and 16 bytes")


def _launch(kind, cells, origin_cell, dims, cell_size, src, w, R, t, max_dist,
            huber_delta) -> torch.Tensor:
    check_launch(kind, cells, dims, src, w)
    if src.shape[0] == 0:
        return torch.zeros(STATS_WIDTH, dtype=torch.float32, device=src.device)
    partials = launch_stats(kind, _kernel_fn(kind), cells, origin_cell, dims, cell_size, src,
                            w, R, t, max_dist, huber_delta)
    return partials.sum(dim=0)


def require_cuda(src: torch.Tensor) -> None:
    """Raise for a device that is neither the CPU nor a CUDA card."""
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")


def fused_plane_stats(
    cells: CellIndex,
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
    """One point-to-plane linearization -> (29,) float32 stats on the device
    of ``src``.

    ``cells`` is the cell index (4-wide features) of a map with ``dims`` cells
    from ``origin_cell``; ``src`` (N, 3) and ``w`` (N,) are the untransformed
    scan and its weights; ``R`` (3, 3) and ``t`` (3,) are host values.
    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``fused_plane_stats.launches``.
    """
    if src.device.type == "cpu":
        return fused_plane_stats_reference(
            cells, origin_cell, dims, cell_size, src, w, R, t, max_dist, huber_delta
        )
    require_cuda(src)
    out = _launch("plane", cells, origin_cell, dims, cell_size, src, w, R, t, max_dist,
                  huber_delta)
    fused_plane_stats.launches += 1
    return out


def fused_ndt_stats(
    cells: CellIndex,
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
    """One NDT (whitened Mahalanobis) linearization -> (29,) float32 stats,
    as :func:`fused_plane_stats` but with the 8-wide NDT features. CUDA tensors
    launch the kernel and add one to ``fused_ndt_stats.launches``."""
    if src.device.type == "cpu":
        return fused_ndt_stats_reference(
            cells, origin_cell, dims, cell_size, src, w, R, t, max_dist, huber_delta
        )
    require_cuda(src)
    out = _launch("ndt", cells, origin_cell, dims, cell_size, src, w, R, t, max_dist,
                  huber_delta)
    fused_ndt_stats.launches += 1
    return out


fused_plane_stats.launches = 0
fused_ndt_stats.launches = 0
