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

``fused_*_stats_batched`` compute the same stats for B scans, each with its
own pose, against one map in one launch (the TPU kernel's ``per_tile``
mode): (B, 29), row b equal to the single wrapper's stats of problem b.

Every launch runs with the card of its tensors current
(``torch.cuda.device``), whatever the caller's current device. Every
launch, single or batched, is one launch path: the kernel reads each
problem's pose from (B, 12) pose rows on the card (B = 1 for a single
problem; the wrappers copy their host pose there first), and each
problem's block rows are summed in double precision, then rounded once to
float32, as the loop kernel (``ops/kernels/gn_loop``) sums them. A resident
Gauss-Newton loop (``core/gn.py``) binds :func:`resident_stats` once per
align: its state's pose rows and done flags stay on the card, where the
kernel reads them; the blocks of a finished problem exit at once. Nothing is
copied from or to the host.

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

from point_cloud_registration_tpu_torch.core.gn import packed_from_stats, stats_from_packed
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
_FEAT_WIDTHS = {"plane": FEAT_WIDTHS[3], "ndt": FEAT_WIDTHS[6]}

__all__ = [
    "MAX_PROBLEMS", "STATS_WIDTH", "fused_ndt_stats", "fused_ndt_stats_batched",
    "fused_ndt_stats_batched_reference", "fused_ndt_stats_reference", "fused_plane_stats",
    "fused_plane_stats_batched", "fused_plane_stats_batched_reference",
    "fused_plane_stats_reference", "inv_cell_f32",
    "packed_from_stats", "stats_from_packed", "window_offsets", "window_radius",
]


def inv_cell_f32(cell_size: float) -> np.float32:
    """The float32 ``1 / cell`` the kernel's cell rule multiplies by
    (fused_align.py:429)."""
    return np.float32(1.0 / float(np.float32(cell_size)))


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


def per_problem(stats_fn, src, w, R, t) -> torch.Tensor:
    """(B, 29): ``stats_fn(src[b], w[b], R[b], t[b])``, a plain
    single-problem version, of each problem b."""
    R = torch.as_tensor(R, dtype=torch.float32)
    t = torch.as_tensor(t, dtype=torch.float32)
    return torch.stack([stats_fn(src[b], w[b], R[b], t[b]) for b in range(src.shape[0])])


def fused_plane_stats_batched_reference(cells, origin_cell, dims, cell_size, src, w, R, t,
                                        max_dist, huber_delta=None) -> torch.Tensor:
    """Plain version of the batched plane kernel: :func:`fused_plane_stats_reference`
    of each problem b (``src`` (B, n, 3), ``w`` (B, n), ``R`` (B, 3, 3),
    ``t`` (B, 3)). Returns the (B, 29) stats."""
    return per_problem(lambda *p: fused_plane_stats_reference(
        cells, origin_cell, dims, cell_size, *p, max_dist, huber_delta), src, w, R, t)


def fused_ndt_stats_batched_reference(cells, origin_cell, dims, cell_size, src, w, R, t,
                                      max_dist, huber_delta=None) -> torch.Tensor:
    """Plain version of the batched NDT kernel: :func:`fused_ndt_stats_reference`
    of each problem. Returns the (B, 29) stats."""
    return per_problem(lambda *p: fused_ndt_stats_reference(
        cells, origin_cell, dims, cell_size, *p, max_dist, huber_delta), src, w, R, t)


_C_SYMBOLS = {"plane": "pcr_fused_plane_stats", "ndt": "pcr_fused_ndt_stats"}
# Most problems of one launch: they run along the grid's y dimension.
MAX_PROBLEMS = 65535


def bind(lib: ctypes.CDLL, kind: str):
    """``(fn, threads per block)`` of the ``kind`` entry point of a build of
    ``csrc/fused_align.cu``, with its argument types set."""
    fn = getattr(lib, _C_SYMBOLS[kind])
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = (
        [c_ptr] * 3 + [c_int] * 6 + [c_float, c_int]  # occ, centers, feats, geometry
        + [c_ptr, c_ptr, c_int, c_int, c_ptr, c_ptr]  # src, w, n per problem, B, poses, done
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


def pose_rows(R, t, device) -> torch.Tensor:
    """(B, 12) float32 on ``device``: each problem's ``R`` (row-major) and
    ``t``, the poses a kernel reads. Host rows go to a card from pinned
    memory, a copy ordered on the current stream before the launch that
    reads it, which does not wait for the card."""
    R = torch.as_tensor(R, dtype=torch.float32)
    t = torch.as_tensor(t, dtype=torch.float32)
    B = R.shape[0]
    rows = torch.cat([R.reshape(B, 9), t.reshape(B, 3)], dim=1)
    device = torch.device(device)
    if rows.device.type == "cpu" and device.type == "cuda":
        return rows.pin_memory().to(device, non_blocking=True)
    return rows.to(device).contiguous()


def check_batched(src: torch.Tensor, w: torch.Tensor, R, t) -> None:
    """Raise unless ``src`` (B, n, 3), ``w`` (B, n), ``R`` (B, 3, 3) and
    ``t`` (B, 3) match, with 1 <= B <= MAX_PROBLEMS."""
    B = src.shape[0] if src.dim() == 3 else -1
    if (src.dim() != 3 or src.shape[2] != 3 or tuple(w.shape) != tuple(src.shape[:2])
            or tuple(torch.as_tensor(R).shape) != (B, 3, 3)
            or tuple(torch.as_tensor(t).shape) != (B, 3)):
        raise ValueError(f"src {tuple(src.shape)}, w {tuple(w.shape)}, R "
                         f"{tuple(torch.as_tensor(R).shape)} and t {tuple(torch.as_tensor(t).shape)} "
                         "are not (B, n, 3), (B, n), (B, 3, 3) and (B, 3)")
    if not 1 <= B <= MAX_PROBLEMS:
        raise ValueError(f"{B} problems: a launch takes 1 to {MAX_PROBLEMS}")


def check_poses(poses: torch.Tensor, done, B: int, device) -> None:
    """Raise unless ``poses`` is a contiguous float32 (B, 12) tensor on
    ``device`` and ``done`` None or a contiguous int32 (B,) tensor there."""
    if (poses.device != device or poses.dtype != torch.float32
            or tuple(poses.shape) != (B, 12) or not poses.is_contiguous()):
        raise ValueError(f"poses must be a contiguous float32 ({B}, 12) tensor on {device}, "
                         f"got {poses.dtype} {tuple(poses.shape)} on {poses.device}")
    if done is not None and (done.device != device or done.dtype != torch.int32
                             or tuple(done.shape) != (B,) or not done.is_contiguous()):
        raise ValueError(f"done must be a contiguous int32 ({B},) tensor on {device}")


def rt_of_poses(poses: torch.Tensor, batched: bool):
    """``(R, t)`` of (B, 12) pose rows: (B, 3, 3) and (B, 3), or the first
    problem's (3, 3) and (3,) unless ``batched``; views, on their device."""
    B = poses.shape[0]
    R, t = poses[:, :9].reshape(B, 3, 3), poses[:, 9:12]
    return (R, t) if batched else (R[0], t[0])


def sum_partials(partials: torch.Tensor) -> torch.Tensor:
    """(B, n_blocks, 29) block partials -> (B, 29): each problem's rows summed
    in one fixed order, so a problem's stats do not depend on B."""
    if partials.shape[0] == 1:
        return partials[0].sum(dim=0)[None]
    return torch.stack([p.sum(dim=0) for p in partials])


def launch_args(bound, cells, origin_cell, dims, cell_size, src, w, poses, done, max_dist,
                huber_delta, partials=None) -> tuple:
    """``(fn, args, partials)``: the C function of ``bound`` (:func:`bind`)
    and its arguments for these checked operands (``src`` (B, n, 3), ``w``
    (B, n), ``poses`` (B, 12) and ``done`` (B,) or None on the card), on the
    current stream, and the (B, n_blocks, 29) partials buffer they name
    (``partials``, when given: a float32 buffer at least that long)."""
    fn, block = bound
    n = src.shape[1]
    n_blocks = min(-(-n // block), MAX_BLOCKS)
    if partials is None:
        partials = torch.empty((src.shape[0], n_blocks, STATS_WIDTH), dtype=torch.float32,
                               device=src.device)
    args = (
        cells.occ.data_ptr(), cells.centers.data_ptr(), cells.feats.data_ptr(),
        *(int(d) for d in dims), *(int(o) for o in origin_cell),
        float(inv_cell_f32(cell_size)), window_radius(max_dist, cell_size),
        src.data_ptr(), w.data_ptr(), n, src.shape[0], poses.data_ptr(),
        done.data_ptr() if done is not None else None,
        float(max_dist), int(huber_delta is not None),
        float(huber_delta) if huber_delta is not None else 0.0,
        partials.data_ptr(), n_blocks, torch.cuda.current_stream(src.device).cuda_stream,
    )
    return fn, args, partials


def bound_launch(fn, args, partials: torch.Tensor, counter, what: str, operands: tuple,
                 sum_dtype: torch.dtype = torch.float32):
    """``launch() -> (B, 29)``: one launch of ``fn(*args)``, every argument
    bound beforehand, adding one to ``counter.launches``, then each
    problem's (n_blocks, 29) partials summed into one float32 (B, 29)
    buffer that every call refills: in float32 as :func:`sum_partials` sums
    them, or, with ``sum_dtype`` float64, all problems' rows in one sum in
    double precision, rounded once to float32. The launch runs with the
    card of ``partials`` current. The launcher holds ``operands``, the
    tensors whose pointers ``args`` carries."""
    out = torch.empty((partials.shape[0], STATS_WIDTH), dtype=torch.float32,
                      device=partials.device)
    acc = None if sum_dtype == torch.float32 else torch.empty_like(out, dtype=sum_dtype)

    def launch() -> torch.Tensor:
        with torch.cuda.device(out.device):
            rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
        counter.launches += 1
        if acc is None:
            for b in range(out.shape[0]):
                torch.sum(partials[b], dim=0, out=out[b])
        else:
            torch.sum(partials, dim=1, dtype=acc.dtype, out=acc)
            out.copy_(acc)
        return out

    launch.operands = operands
    return launch


def check_launch(kind, cells: CellIndex, dims, src: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless the kernel of ``kind`` can read these operands."""
    _check_geometry(cells, dims, kind)
    check_operands(src, w, centers=cells.centers, feats=cells.feats)
    if cells.occ.device != src.device or not cells.occ.is_contiguous():
        raise ValueError(f"occ must be a contiguous tensor on {src.device}")
    if cells.occ.data_ptr() % 8 or cells.centers.data_ptr() % 16 or cells.feats.data_ptr() % 16:
        raise ValueError("occ, centers and feats must start at multiples of 8, 16 and 16 bytes")


def resident_launch(kind, counter, cells, origin_cell, dims, cell_size, src, w, poses, done,
                    max_dist, huber_delta):
    """``launch() -> (B, 29)`` on the card: the kernel of ``kind`` on
    ``src`` (B, n, 3) and ``w`` (B, n) at the pose rows ``poses`` (B, 12)
    on the card, skipping the problems whose ``done`` flag is set (None:
    none), with every operand checked and every argument bound once."""
    require_cuda(src)
    check_batched(src, w, *rt_of_poses(poses, True))
    check_poses(poses, done, src.shape[0], src.device)
    check_launch(kind, cells, dims, src.reshape(-1, 3), w.reshape(-1))
    if src.shape[1] == 0:
        zeros = torch.zeros((src.shape[0], STATS_WIDTH), dtype=torch.float32, device=src.device)
        return lambda: zeros
    fn, args, partials = launch_args(_kernel_fn(kind), cells, origin_cell, dims, cell_size, src,
                                     w, poses, done, max_dist, huber_delta)
    # the rows summed in double, as the loop kernel sums them (ops/kernels/gn_loop)
    return bound_launch(fn, args, partials, counter, f"fused {kind} stats",
                        (cells, src, w, poses, done), sum_dtype=torch.float64)


def require_cuda(src: torch.Tensor) -> None:
    """Raise for a device that is neither the CPU nor a CUDA card."""
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")


def one_problem(src: torch.Tensor, w: torch.Tensor, R, t) -> tuple:
    """``(src, w, R, t)`` of one problem as a batch of one: (1, N, 3), (1, N),
    (1, 3, 3) and (1, 3)."""
    R = torch.as_tensor(R, dtype=torch.float32).reshape(1, 3, 3)
    t = torch.as_tensor(t, dtype=torch.float32).reshape(1, 3)
    return src[None], w[None], R, t


def _stats(kind, counter, reference, batched, cells, origin_cell, dims, cell_size, src, w, R, t,
           max_dist, huber_delta) -> torch.Tensor:
    if src.device.type == "cpu":
        return reference(cells, origin_cell, dims, cell_size, src, w, R, t, max_dist, huber_delta)
    require_cuda(src)
    if not batched:
        check_operands(src, w)
        src, w, R, t = one_problem(src, w, R, t)
    check_batched(src, w, R, t)  # the poses go to the card, then one launch
    out = resident_launch(kind, counter, cells, origin_cell, dims, cell_size, src, w,
                          pose_rows(R, t, src.device), None, max_dist, huber_delta)()
    return out if batched else out[0]


def resident_stats(kind: str, cells: CellIndex, origin_cell, dims, cell_size: float,
                   src: torch.Tensor, w: torch.Tensor, max_dist: float,
                   huber_delta: float | None, poses: torch.Tensor, done: torch.Tensor | None):
    """The stats of a resident Gauss-Newton loop, bound once per align:
    ``launch() -> (B, 29)`` (or (29,) for one problem on the CPU) at the
    current pose rows ``poses`` (B, 12) of the loop's state.

    ``src`` (n, 3) is one problem (its launches count as the single
    wrapper's), (B, n, 3) a batch (its launches count as the batched
    wrapper's). CUDA tensors: each call is one launch of the kernel, the
    launch the wrappers make, with every argument bound beforehand, reading
    the poses and ``done`` where they lie; CPU tensors: the plain version at
    the poses as they are when it is called."""
    batched = src.dim() == 3
    if kind not in _C_SYMBOLS:
        raise ValueError(f"unknown kind {kind!r}")
    if src.device.type == "cpu":
        reference = {("plane", False): fused_plane_stats_reference,
                     ("ndt", False): fused_ndt_stats_reference,
                     ("plane", True): fused_plane_stats_batched_reference,
                     ("ndt", True): fused_ndt_stats_batched_reference}[kind, batched]
        R, t = rt_of_poses(poses, batched)  # views: they follow the state
        return lambda: reference(cells, origin_cell, dims, cell_size, src, w, R, t, max_dist,
                                 huber_delta)
    counter = {("plane", False): fused_plane_stats, ("ndt", False): fused_ndt_stats,
               ("plane", True): fused_plane_stats_batched,
               ("ndt", True): fused_ndt_stats_batched}[kind, batched]
    return resident_launch(kind, counter, cells, origin_cell, dims, cell_size,
                           src if batched else src[None], w if batched else w[None], poses, done,
                           max_dist, huber_delta)


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
    scan and its weights; ``R`` (3, 3) and ``t`` (3,) the pose, copied to the
    card as one pose row (a resident Gauss-Newton loop binds the same launch
    to its state's pose rows instead: :func:`resident_stats`). CPU tensors
    take the plain version; CUDA tensors launch the kernel at B = 1 and add
    one to ``fused_plane_stats.launches``.
    """
    return _stats("plane", fused_plane_stats, fused_plane_stats_reference, False, cells,
                  origin_cell, dims, cell_size, src, w, R, t, max_dist, huber_delta)


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
    return _stats("ndt", fused_ndt_stats, fused_ndt_stats_reference, False, cells, origin_cell,
                  dims, cell_size, src, w, R, t, max_dist, huber_delta)


def fused_plane_stats_batched(cells: CellIndex, origin_cell, dims, cell_size: float,
                              src: torch.Tensor, w: torch.Tensor, R, t, max_dist: float,
                              huber_delta: float | None = None) -> torch.Tensor:
    """:func:`fused_plane_stats` of B problems against one map in one launch
    -> (B, 29) float32 stats on the device of ``src``.

    ``src`` (B, n, 3) and ``w`` (B, n) hold each problem's scan and weights,
    ``R`` (B, 3, 3) and ``t`` (B, 3) its pose (host values, copied to the
    card as pose rows). Row b equals the single wrapper's stats of problem
    b. CPU tensors take the plain version; CUDA tensors launch the kernel
    once, with the problems along the grid's y dimension, and add one to
    ``fused_plane_stats_batched.launches``.
    """
    return _stats("plane", fused_plane_stats_batched, fused_plane_stats_batched_reference, True,
                  cells, origin_cell, dims, cell_size, src, w, R, t, max_dist, huber_delta)


def fused_ndt_stats_batched(cells: CellIndex, origin_cell, dims, cell_size: float,
                            src: torch.Tensor, w: torch.Tensor, R, t, max_dist: float,
                            huber_delta: float | None = None) -> torch.Tensor:
    """:func:`fused_ndt_stats` of B problems in one launch -> (B, 29), as
    :func:`fused_plane_stats_batched`. CUDA tensors add one to
    ``fused_ndt_stats_batched.launches``."""
    return _stats("ndt", fused_ndt_stats_batched, fused_ndt_stats_batched_reference, True, cells,
                  origin_cell, dims, cell_size, src, w, R, t, max_dist, huber_delta)


fused_plane_stats.launches = 0
fused_ndt_stats.launches = 0
fused_plane_stats_batched.launches = 0
fused_ndt_stats_batched.launches = 0
