"""The whole Gauss-Newton loop of one VPlaneICP (kind "plane") or NDT (kind
"ndt") align on a dense voxel map in one launch (counterpart of the JAX
package's compiled ``gauss_newton`` while_loop around the fused stats,
``point_cloud_registration_tpu/core/gn.py:124-192`` and
``models/_fused.py:92-165``).

:func:`fused_loop` runs every iteration of one problem's loop on the
device of its :class:`~point_cloud_registration_tpu_torch.core.gn.GNState`:
the stats of ``ops/kernels/fused_align`` at the state's pose, the solve, the
step test, the update and the histories (``ops/kernels/gn_step``), until the
state is done. It leaves the state as the two-launch resident loop
(``core.gn.gauss_newton_device`` over ``fused_align.resident_stats``) leaves
it, up to the order in which the block rows are summed.

For CUDA tensors it makes one cooperative launch of the hand-written kernel
of ``csrc/gn_loop.cu``, a persistent grid of the CTAs that fit on the card
at once (:func:`loop_grid`), which synchronises across the grid between the
stats and the update; a launch that the card refuses raises
``RuntimeError``, and nothing falls back to another loop. For CPU tensors it
runs the plain PyTorch version, :func:`fused_loop_reference`, which the tests
and ``chip_smoke.py`` also call directly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from point_cloud_registration_tpu_torch.core.gn import GNState
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.kernels._build import load_library
from point_cloud_registration_tpu_torch.ops.kernels.gn_step import gn_step_reference
from point_cloud_registration_tpu_torch.ops.knn import CellIndex, window_radius

__all__ = ["fused_loop", "fused_loop_reference", "fused_looper", "loop_grid"]

_KINDS = {"plane": 0, "ndt": 1}
_REFERENCE = {"plane": fa.fused_plane_stats_reference, "ndt": fa.fused_ndt_stats_reference}


def loop_grid(n: int, block: int, sms: int, blocks_per_sm: int) -> tuple[int, int]:
    """``(grid, virtual_blocks)`` of the loop kernel for a scan of ``n``
    points: the virtual block ids are the stats launch's blocks,
    ``min(ceil(n / block), MAX_BLOCKS)`` (at least one), and the grid is as
    many CTAs as fit on the card at once (``sms * blocks_per_sm``), at most
    one a virtual block. CTA c takes the ids c, c + grid, ... Raises
    ``RuntimeError`` when no CTA fits."""
    resident = sms * blocks_per_sm
    if resident <= 0:
        raise RuntimeError(f"no CTA of the loop kernel fits on the card ({sms} SMs, "
                           f"{blocks_per_sm} CTAs an SM): it cannot launch")
    virtual = min(max(-(-n // block), 1), fa.MAX_BLOCKS)
    return min(virtual, resident), virtual


def fused_loop_reference(kind: str, cells: CellIndex, origin_cell, dims, cell_size: float,
                         src: torch.Tensor, w: torch.Tensor, state: GNState, max_dist: float,
                         huber_delta: float | None, tol: float, max_iter: int) -> None:
    """Plain PyTorch version of :func:`fused_loop`: while the problem of
    ``state`` (a single problem, on the CPU) is not done, the plain stats of
    ``kind`` (``fused_*_stats_reference``, on the device of ``src``) at the
    state's pose, then ``gn_step_reference``. Updates ``state`` in place,
    as the two-launch loop over the same plain versions does, bit for bit."""
    _check_state(state, max_iter, torch.device("cpu"))
    reference = _REFERENCE[kind]
    R, t = fa.rt_of_poses(state.poses, False)  # views: they follow the state
    while not bool(state.done[0]):
        stats = reference(cells, origin_cell, dims, cell_size, src, w, R, t, max_dist,
                          huber_delta)
        gn_step_reference(stats.to("cpu"), state, tol)


def _check_state(state: GNState, max_iter: int, device) -> None:
    B, M = state.e2.shape
    if B != 1 or M != max_iter:
        raise ValueError(f"the loop takes the state of one problem of {max_iter} iterations, "
                         f"got B = {B}, max_iter = {M}")
    if state.words.device != device:
        raise ValueError(f"state on {state.words.device}, expected {device}")


def bind(lib: ctypes.CDLL, kind: str):
    """``(fn, block, blocks_per_sm, error_string)`` of the ``kind`` entry of
    a build of ``csrc/gn_loop.cu``, with argument types set: ``block`` is
    its threads per CTA, ``blocks_per_sm()`` the CTAs that fit on one SM."""
    fn = getattr(lib, f"pcr_gn_loop_{kind}")
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = (
        [c_ptr] * 3 + [c_int] * 6 + [c_float, c_int]  # occ, centers, feats, geometry
        + [c_ptr, c_ptr, c_int, c_int]  # src, w, n, n_blocks
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + [c_ptr] * 11  # the state's nine fields, partials, rows_out
        + [c_int, c_float, c_int, c_ptr]  # max_iter, tol, grid, stream
    )
    fn.restype = c_int
    occupancy = lib.pcr_gn_loop_blocks_per_sm
    occupancy.argtypes = [c_int, ctypes.POINTER(c_int)]
    occupancy.restype = c_int
    error_string = lib.pcr_gn_loop_error_string
    error_string.argtypes = [c_int]
    error_string.restype = ctypes.c_char_p
    block = lib.pcr_gn_loop_block_size
    block.argtypes = []
    block.restype = c_int

    @functools.cache
    def blocks_per_sm() -> int:
        out = c_int(0)
        rc = occupancy(_KINDS[kind], ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"gn_loop occupancy query failed: CUDA error {rc} "
                               f"({error_string(rc).decode()})")
        return out.value

    return fn, int(block()), blocks_per_sm, lambda rc: error_string(rc).decode()


@functools.cache
def _kernel_fn(kind: str):
    return bind(load_library("gn_loop"), kind)


@functools.cache
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_looper(kind: str, cells: CellIndex, origin_cell, dims, cell_size: float,
                 src: torch.Tensor, w: torch.Tensor, state: GNState, max_dist: float,
                 huber_delta: float | None, tol: float, max_iter: int, *,
                 rows: torch.Tensor | None = None, bound=None):
    """``launch()``: :func:`fused_loop` of these operands with every argument
    bound once. CPU tensors take :func:`fused_loop_reference`; CUDA tensors
    one cooperative launch of the loop kernel on the stream current now,
    which adds one to ``fused_loop.launches``.

    ``rows``, when given, is a float32 (n_blocks, 29) tensor on the card
    that receives the first iteration's block rows (the stats launch's
    partials of one problem at the initial pose); ``bound`` is another
    build's :func:`bind` of ``kind`` (default: the package's)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if src.device.type == "cpu":
        return lambda: fused_loop_reference(kind, cells, origin_cell, dims, cell_size, src, w,
                                            state, max_dist, huber_delta, tol, max_iter)
    fa.require_cuda(src)
    dev = src.device
    _check_state(state, max_iter, dev)
    fa.check_launch(kind, cells, dims, src, w)
    fn, block, blocks_per_sm, error_string = bound or _kernel_fn(kind)
    sms = _multiprocessors(dev)
    grid, n_blocks = loop_grid(src.shape[0], block, sms, blocks_per_sm())
    partials = torch.empty((2, n_blocks, fa.STATS_WIDTH), dtype=torch.float32, device=dev)
    if rows is not None and (rows.device != dev or rows.dtype != torch.float32
                             or tuple(rows.shape) != (n_blocks, fa.STATS_WIDTH)
                             or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous float32 ({n_blocks}, {fa.STATS_WIDTH}) "
                         f"tensor on {dev}")
    args = (
        cells.occ.data_ptr(), cells.centers.data_ptr(), cells.feats.data_ptr(),
        *(int(d) for d in dims), *(int(o) for o in origin_cell),
        float(fa.inv_cell_f32(cell_size)), window_radius(max_dist, cell_size),
        src.data_ptr(), w.data_ptr(), src.shape[0], n_blocks,
        float(max_dist), int(huber_delta is not None),
        float(huber_delta) if huber_delta is not None else 0.0,
        *(x.data_ptr() for x in state[1:]), partials.data_ptr(),
        rows.data_ptr() if rows is not None else None,
        int(max_iter), float(tol), grid, torch.cuda.current_stream(dev).cuda_stream,
    )

    def launch() -> None:
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"gn_loop {kind} cooperative launch of {grid} CTAs failed: "
                               f"CUDA error {rc} ({error_string(rc)})")
        fused_loop.launches += 1

    launch.operands = (cells, src, w, state, partials, rows)
    launch.grid = (grid, n_blocks)
    return launch


def fused_loop(kind: str, cells: CellIndex, origin_cell, dims, cell_size: float,
               src: torch.Tensor, w: torch.Tensor, state: GNState, max_dist: float,
               huber_delta: float | None, tol: float, max_iter: int) -> None:
    """Every Gauss-Newton iteration of one VPlaneICP (``kind`` "plane") or
    NDT ("ndt") align on a dense voxel map, in place on ``state`` (a
    single problem's :class:`GNState` of ``max_iter`` iterations, on the
    device of ``src``), until it is done.

    ``cells`` is the map's cell index (``dims`` cells from ``origin_cell``,
    ``cell_size``); ``src`` (n, 3) and ``w`` (n,) the untransformed scan and
    its weights; ``max_dist``, ``huber_delta`` and ``tol`` the solver's. CUDA
    tensors: one cooperative launch of the loop kernel on the current
    stream, adding one to ``fused_loop.launches``; it never waits for the
    card, and a refused launch raises ``RuntimeError``. CPU tensors:
    :func:`fused_loop_reference`.
    """
    fused_looper(kind, cells, origin_cell, dims, cell_size, src, w, state, max_dist,
                 huber_delta, tol, max_iter)()


fused_loop.launches = 0
