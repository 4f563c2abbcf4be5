"""The whole Gauss-Newton loop of one align in one launch (counterpart of
the JAX package's compiled ``gauss_newton`` while_loop around a solver's
stats, ``point_cloud_registration_tpu/core/gn.py:124-192``).

Each loop runs every iteration of one problem's loop on the device of its
:class:`~point_cloud_registration_tpu_torch.core.gn.GNState`: a solver's
stats at the state's pose, the solve, the step test, the update and the
histories (``ops/kernels/gn_step``), until the state is done. It leaves the
state as the two-launch resident loop (``core.gn.gauss_newton_device`` over
the same stats' ``resident_stats``) leaves it, up to the order in which the
block rows are summed (both sum them in double precision).

* :func:`fused_loop`: VPlaneICP ("plane") and NDT ("ndt") on a dense voxel
  map, over the fused stats of ``ops/kernels/fused_align``
  (``models/_fused.py:92-165``; kernel ``csrc/gn_loop.cu``);
* :func:`point_loop`: ICP ("point") and PlaneICP ("plane_pt") on the packed
  point grid, over the stats of ``ops/kernels/point_align``
  (``models/_point_fused.py:98-169``; kernel ``csrc/point_loop.cu``);
* :func:`grid_loop`: ICP ("point") and PlaneICP ("plane_pt") on a small
  target's grid, VPlaneICP ("plane") and NDT ("ndt") on a hashed voxel map,
  over the grid stats of ``ops/kernels/grid_align`` (``models/icp.py:60-67``,
  ``plane_icp.py:91-92``, ``voxelized_plane_icp.py:83-84``,
  ``ndt.py:82-83``; kernel ``csrc/grid_loop.cu``).

For CUDA tensors each makes one cooperative launch of a hand-written kernel
(``csrc/gn_loop.cuh``'s loop over the stats kernel's own body), a
persistent grid of the CTAs that fit on the card at once
(:func:`loop_grid`), which synchronises across the grid between the stats
and the update; a launch that the card refuses raises ``RuntimeError``, and
nothing falls back to another loop. For CPU tensors each runs its plain
PyTorch version (:func:`fused_loop_reference`, :func:`point_loop_reference`,
:func:`grid_loop_reference`: cases of :func:`loop_reference`, the stats' plain version then
``gn_step_reference`` until done), which the tests and ``chip_smoke.py``
also call directly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from point_cloud_registration_tpu_torch.core.gn import GNState
from point_cloud_registration_tpu_torch.ops.hashgrid import Grid
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga
from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa
from point_cloud_registration_tpu_torch.ops.kernels._build import load_library
from point_cloud_registration_tpu_torch.ops.kernels.gn_step import gn_step_reference
from point_cloud_registration_tpu_torch.ops.knn import CellIndex, window_radius
from point_cloud_registration_tpu_torch.ops.pointgrid import PackedPointGrid, ProxyMap

__all__ = ["fused_loop", "fused_loop_reference", "fused_looper", "grid_loop",
           "grid_loop_reference", "grid_looper", "loop_grid", "loop_reference", "point_loop",
           "point_loop_reference", "point_looper"]

# Each kind's C id and the plain stats that its plain loop runs, by name:
# looked up at each iteration, as a launch looks up its kernel.
_FUSED_KINDS = {"plane": 0, "ndt": 1}
_FUSED_REFERENCE = {"plane": "fused_plane_stats_reference", "ndt": "fused_ndt_stats_reference"}
_POINT_KINDS = {"point": 0, "plane_pt": 1}
_POINT_REFERENCE = {"point": "point_stats_reference", "plane_pt": "plane_point_stats_reference"}
_GRID_KINDS = {"point": 0, "plane_pt": 1, "plane": 2, "ndt": 3}
_GRID_REFERENCE = {"point": "grid_point_stats_reference",
                   "plane_pt": "grid_point_stats_reference",
                   "plane": "hashed_voxel_stats_reference",
                   "ndt": "hashed_voxel_stats_reference"}

c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
# The trailing arguments of the point and grid loops' C entries
# (gn_loop.cuh's PCR_LOOP_STATE_PARAMS): the state's nine fields, partials,
# rows_out, n_blocks, max_iter, tol, grid, stream.
_STATE_ARGTYPES = [c_ptr] * 11 + [c_int, c_int, c_float, c_int, c_ptr]


def loop_grid(n: int, block: int, sms: int, blocks_per_sm: int,
              max_blocks: int = fa.MAX_BLOCKS) -> tuple[int, int]:
    """``(grid, virtual_blocks)`` of a loop kernel for a scan of ``n``
    points: the virtual block ids are the stats launch's blocks of ``block``
    queries, ``min(ceil(n / block), max_blocks)`` (at least one), and the
    grid is as many CTAs as fit on the card at once (``sms *
    blocks_per_sm``), at most one a virtual block. CTA c takes the ids c,
    c + grid, ... Raises ``RuntimeError`` when no CTA fits."""
    resident = sms * blocks_per_sm
    if resident <= 0:
        raise RuntimeError(f"no CTA of the loop kernel fits on the card ({sms} SMs, "
                           f"{blocks_per_sm} CTAs an SM): it cannot launch")
    virtual = min(max(-(-n // block), 1), max_blocks)
    return min(virtual, resident), virtual


def loop_reference(stats: Callable[[], torch.Tensor], state: GNState, tol: float,
                   max_iter: int) -> None:
    """Plain PyTorch version of every loop kernel: while the problem of
    ``state`` (a single problem of ``max_iter`` iterations, on the CPU) is
    not done, ``stats()`` (the (29,) packed stats at the state's pose as it
    is then, on any device), then ``gn_step_reference``. Updates ``state``
    in place, as the two-launch loop over the same stats does, bit for
    bit."""
    _check_state(state, max_iter, torch.device("cpu"))
    while not bool(state.done[0]):
        gn_step_reference(stats().to("cpu"), state, tol)


def fused_loop_reference(kind: str, cells: CellIndex, origin_cell, dims, cell_size: float,
                         src: torch.Tensor, w: torch.Tensor, state: GNState, max_dist: float,
                         huber_delta: float | None, tol: float, max_iter: int) -> None:
    """Plain PyTorch version of :func:`fused_loop`: :func:`loop_reference`
    over the plain stats of ``kind`` (``fused_*_stats_reference``, on the
    device of ``src``)."""
    name = _FUSED_REFERENCE[kind]
    R, t = fa.rt_of_poses(state.poses, False)  # views: they follow the state
    loop_reference(lambda: getattr(fa, name)(cells, origin_cell, dims, cell_size, src, w, R, t,
                                             max_dist, huber_delta), state, tol, max_iter)


def point_loop_reference(kind: str, pg: PackedPointGrid, proxy: ProxyMap, src: torch.Tensor,
                         w: torch.Tensor, state: GNState, max_dist: float, proxy_radius: int,
                         huber_delta: float | None, tol: float, max_iter: int) -> None:
    """Plain PyTorch version of :func:`point_loop`: :func:`loop_reference`
    over the plain stats of ``kind`` (``point_stats_reference`` or
    ``plane_point_stats_reference``, on the device of ``src``)."""
    name = _POINT_REFERENCE[kind]
    R, t = fa.rt_of_poses(state.poses, False)
    loop_reference(lambda: getattr(pa, name)(pg, proxy, src, w, R, t, max_dist, proxy_radius,
                                             huber_delta), state, tol, max_iter)


def grid_loop_reference(kind: str, grid: Grid, table: ga.GridTable, src: torch.Tensor,
                        w: torch.Tensor, offsets, state: GNState, max_dist: float,
                        huber_delta: float | None, tol: float, max_iter: int) -> None:
    """Plain PyTorch version of :func:`grid_loop`: :func:`loop_reference`
    over the plain stats of ``kind`` (``grid_point_stats_reference`` or
    ``hashed_voxel_stats_reference``, on the device of ``src``)."""
    name = _GRID_REFERENCE[kind]
    R, t = fa.rt_of_poses(state.poses, False)
    loop_reference(lambda: getattr(ga, name)(grid, table, src, w, R, t, offsets, max_dist,
                                             huber_delta), state, tol, max_iter)


def _check_state(state: GNState, max_iter: int, device) -> None:
    B, M = state.e2.shape
    if B != 1 or M != max_iter:
        raise ValueError(f"the loop takes the state of one problem of {max_iter} iterations, "
                         f"got B = {B}, max_iter = {M}")
    if state.words.device != device:
        raise ValueError(f"state on {state.words.device}, expected {device}")


def _bind(lib: ctypes.CDLL, prefix: str, kind: str, kind_id: int, argtypes: list, block):
    """``(fn, block, blocks_per_sm, error_string)`` of the ``kind`` entry
    ``pcr_<prefix>_<kind>`` of a loop kernel's library: ``block`` the stats
    launch's queries per block, ``blocks_per_sm()`` the CTAs of the kind's
    kernel that fit on one SM."""
    fn = getattr(lib, f"pcr_{prefix}_{kind}")
    fn.argtypes = argtypes
    fn.restype = c_int
    occupancy = getattr(lib, f"pcr_{prefix}_blocks_per_sm")
    occupancy.argtypes = [c_int, ctypes.POINTER(c_int)]
    occupancy.restype = c_int
    error_string = getattr(lib, f"pcr_{prefix}_error_string")
    error_string.argtypes = [c_int]
    error_string.restype = ctypes.c_char_p

    @functools.cache
    def blocks_per_sm() -> int:
        out = c_int(0)
        rc = occupancy(kind_id, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"{prefix} occupancy query failed: CUDA error {rc} "
                               f"({error_string(rc).decode()})")
        return out.value

    return fn, int(block), blocks_per_sm, lambda rc: error_string(rc).decode()


def bind(lib: ctypes.CDLL, kind: str):
    """``(fn, block, blocks_per_sm, error_string)`` of the ``kind`` entry of
    a build of ``csrc/gn_loop.cu`` (the fused loop), with argument types
    set: ``block`` is its threads per CTA, ``blocks_per_sm()`` the CTAs that
    fit on one SM."""
    argtypes = (
        [c_ptr] * 3 + [c_int] * 6 + [c_float, c_int]  # occ, centers, feats, geometry
        + [c_ptr, c_ptr, c_int, c_int]  # src, w, n, n_blocks
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + [c_ptr] * 11  # the state's nine fields, partials, rows_out
        + [c_int, c_float, c_int, c_ptr]  # max_iter, tol, grid, stream
    )
    block = lib.pcr_gn_loop_block_size
    block.argtypes = []
    block.restype = c_int
    return _bind(lib, "gn_loop", kind, _FUSED_KINDS[kind], argtypes, block())


def bind_point(lib: ctypes.CDLL, kind: str):
    """:func:`bind` of the ``kind`` entry of a build of
    ``csrc/point_loop.cu`` (the packed-grid loop)."""
    argtypes = (
        [c_ptr] * 3 + [c_int] * 7 + [c_float]  # packed grid
        + [c_ptr] + [c_int] * 3 + [c_float, c_int]  # proxy map
        + [c_ptr, c_ptr, c_int]  # src, w, n
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + _STATE_ARGTYPES
    )
    block = lib.pcr_point_loop_block_size
    block.argtypes = []
    block.restype = c_int
    return _bind(lib, "point_loop", kind, _POINT_KINDS[kind], argtypes, block())


def bind_grid(lib: ctypes.CDLL, kind: str):
    """:func:`bind` of the ``kind`` entry of a build of
    ``csrc/grid_loop.cu`` (the grid loop); ``block`` is the stats launch's
    queries per block of the kind."""
    argtypes = (
        [c_ptr] * 6 + [c_int]  # pts, feats, valid, bucket rows, starts, counts, cap
        + [c_ptr, c_int, c_ptr] + [c_int] * 6 + [c_float]  # keys, n_cells, dense, box, cell
        + [c_ptr, c_int, c_ptr, c_int, c_ptr, c_int]  # offsets, K, rows, R, ranks, W
        + [c_ptr, c_ptr, c_int]  # src, w, n
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + _STATE_ARGTYPES
    )
    per_block = lib.pcr_grid_loop_queries_per_block
    per_block.argtypes = [c_int]
    per_block.restype = c_int
    return _bind(lib, "grid_loop", kind, _GRID_KINDS[kind], argtypes,
                 per_block(_GRID_KINDS[kind]))


@functools.cache
def _kernel_fn(kind: str):
    return bind(load_library("gn_loop"), kind)


@functools.cache
def _point_kernel_fn(kind: str):
    return bind_point(load_library("point_loop"), kind)


@functools.cache
def _grid_kernel_fn(kind: str):
    return bind_grid(load_library("grid_loop"), kind)


@functools.cache
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _geometry(bound, src: torch.Tensor, state: GNState, max_iter: int, rows,
              max_blocks: int) -> tuple:
    """``(grid, n_blocks, partials)`` of a loop launch over the queries of
    ``src``, after checking that ``state`` and ``rows`` lie on its card."""
    dev = src.device
    _check_state(state, max_iter, dev)
    _, block, blocks_per_sm, _ = bound
    grid, n_blocks = loop_grid(src.shape[0], block, _multiprocessors(dev), blocks_per_sm(),
                               max_blocks)
    partials = torch.empty((2, n_blocks, fa.STATS_WIDTH), dtype=torch.float32, device=dev)
    if rows is not None and (rows.device != dev or rows.dtype != torch.float32
                             or tuple(rows.shape) != (n_blocks, fa.STATS_WIDTH)
                             or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous float32 ({n_blocks}, {fa.STATS_WIDTH}) "
                         f"tensor on {dev}")
    return grid, n_blocks, partials


def _state_args(state: GNState, partials, rows, n_blocks: int, max_iter: int, tol: float,
                grid: int) -> tuple:
    """The trailing C arguments of the point and grid loops (_STATE_ARGTYPES)."""
    return (*(x.data_ptr() for x in state[1:]), partials.data_ptr(),
            rows.data_ptr() if rows is not None else None, n_blocks, int(max_iter),
            float(tol), grid, torch.cuda.current_stream(state.words.device).cuda_stream)


def _huber_args(max_dist: float, huber_delta: float | None) -> tuple:
    return (float(max_dist), int(huber_delta is not None),
            float(huber_delta) if huber_delta is not None else 0.0)


def _launcher(what: str, counter, bound, args: tuple, grid: int, n_blocks: int,
              operands: tuple):
    """``launch()``: one cooperative launch of ``bound``'s function with
    ``args``, adding one to ``counter.launches``; a refused launch raises
    ``RuntimeError`` with the CUDA error."""
    fn, _, _, error_string = bound

    def launch() -> None:
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{what} cooperative launch of {grid} CTAs failed: "
                               f"CUDA error {rc} ({error_string(rc)})")
        counter.launches += 1

    launch.operands = operands
    launch.grid = (grid, n_blocks)
    return launch


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
    if kind not in _FUSED_KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if src.device.type == "cpu":
        return lambda: fused_loop_reference(kind, cells, origin_cell, dims, cell_size, src, w,
                                            state, max_dist, huber_delta, tol, max_iter)
    fa.require_cuda(src)
    fa.check_launch(kind, cells, dims, src, w)
    bound = bound or _kernel_fn(kind)
    grid, n_blocks, partials = _geometry(bound, src, state, max_iter, rows,
                                         fa.MAX_BLOCKS)
    args = (
        cells.occ.data_ptr(), cells.centers.data_ptr(), cells.feats.data_ptr(),
        *(int(d) for d in dims), *(int(o) for o in origin_cell),
        float(fa.inv_cell_f32(cell_size)), window_radius(max_dist, cell_size),
        src.data_ptr(), w.data_ptr(), src.shape[0], n_blocks,
        *_huber_args(max_dist, huber_delta),
        *(x.data_ptr() for x in state[1:]), partials.data_ptr(),
        rows.data_ptr() if rows is not None else None,
        int(max_iter), float(tol), grid, torch.cuda.current_stream(src.device).cuda_stream,
    )
    return _launcher(f"gn_loop {kind}", fused_loop, bound, args, grid, n_blocks,
                     (cells, src, w, state, partials, rows))


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


def point_looper(kind: str, pg: PackedPointGrid, proxy: ProxyMap, src: torch.Tensor,
                 w: torch.Tensor, state: GNState, max_dist: float, proxy_radius: int,
                 huber_delta: float | None, tol: float, max_iter: int, *,
                 rows: torch.Tensor | None = None, bound=None):
    """``launch()``: :func:`point_loop` of these operands with every argument
    bound once, as :func:`fused_looper`: CPU tensors take
    :func:`point_loop_reference`; CUDA tensors one cooperative launch of the
    loop kernel of ``csrc/point_loop.cu``, which adds one to
    ``point_loop.launches``. ``rows`` receives the first iteration's block
    rows; ``bound`` is another build's :func:`bind_point` of ``kind``."""
    if kind not in _POINT_KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if src.device.type == "cpu":
        return lambda: point_loop_reference(kind, pg, proxy, src, w, state, max_dist,
                                            proxy_radius, huber_delta, tol, max_iter)
    fa.require_cuda(src)
    fa.check_operands(src, w)
    pa.check_tables(kind, pg, proxy, src)
    bound = bound or _point_kernel_fn(kind)
    grid, n_blocks, partials = _geometry(bound, src, state, max_iter, rows,
                                         fa.MAX_BLOCKS)
    args = (*pa.table_args(pg, proxy, proxy_radius), src.data_ptr(), w.data_ptr(),
            src.shape[0], *_huber_args(max_dist, huber_delta),
            *_state_args(state, partials, rows, n_blocks, max_iter, tol, grid))
    return _launcher(f"point_loop {kind}", point_loop, bound, args, grid, n_blocks,
                     (pg, proxy, src, w, state, partials, rows))


def point_loop(kind: str, pg: PackedPointGrid, proxy: ProxyMap, src: torch.Tensor,
               w: torch.Tensor, state: GNState, max_dist: float, proxy_radius: int,
               huber_delta: float | None, tol: float, max_iter: int) -> None:
    """Every Gauss-Newton iteration of one ICP (``kind`` "point") or
    PlaneICP ("plane_pt") align on the packed point grid ``pg`` and its
    proxy map (``proxy_radius`` proxy cells), in place on ``state``, as
    :func:`fused_loop`: CUDA tensors one cooperative launch of the loop
    kernel, adding one to ``point_loop.launches``; CPU tensors
    :func:`point_loop_reference`."""
    point_looper(kind, pg, proxy, src, w, state, max_dist, proxy_radius, huber_delta, tol,
                 max_iter)()


def grid_looper(kind: str, grid: Grid, table: ga.GridTable, src: torch.Tensor, w: torch.Tensor,
                offsets, state: GNState, max_dist: float, huber_delta: float | None, tol: float,
                max_iter: int, *, rows: torch.Tensor | None = None, bound=None):
    """``launch()``: :func:`grid_loop` of these operands with every argument
    bound once, as :func:`fused_looper`: CPU tensors take
    :func:`grid_loop_reference`; CUDA tensors one cooperative launch of the
    loop kernel of ``csrc/grid_loop.cu``, which adds one to
    ``grid_loop.launches``. ``rows`` receives the first iteration's block
    rows; ``bound`` is another build's :func:`bind_grid` of ``kind``."""
    if kind not in _GRID_KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if src.device.type == "cpu":
        return lambda: grid_loop_reference(kind, grid, table, src, w, offsets, state, max_dist,
                                           huber_delta, tol, max_iter)
    fa.require_cuda(src)
    fa.check_operands(src, w)
    ga.check_table(kind, grid, table, src.device)
    offsets, window = ga.bind_window(grid, offsets, src.device)
    bound = bound or _grid_kernel_fn(kind)
    grid_ctas, n_blocks, partials = _geometry(bound, src, state, max_iter, rows, ga.MAX_BLOCKS)
    args = (*ga.table_args(grid, table, offsets, window), src.data_ptr(), w.data_ptr(),
            src.shape[0], *_huber_args(max_dist, huber_delta),
            *_state_args(state, partials, rows, n_blocks, max_iter, tol, grid_ctas))
    return _launcher(f"grid_loop {kind}", grid_loop, bound, args, grid_ctas, n_blocks,
                     (grid, table, src, w, offsets, window, state, partials, rows))


def grid_loop(kind: str, grid: Grid, table: ga.GridTable, src: torch.Tensor, w: torch.Tensor,
              offsets, state: GNState, max_dist: float, huber_delta: float | None, tol: float,
              max_iter: int) -> None:
    """Every Gauss-Newton iteration of one align over the grid stats of
    ``kind`` (ICP "point" or PlaneICP "plane_pt" on a small target's grid
    and :func:`~ops.kernels.grid_align.point_table`; VPlaneICP "plane" or
    NDT "ndt" on a hashed map's grid and
    :func:`~ops.kernels.grid_align.voxel_table`), with the window
    ``offsets`` (K, 3), in place on ``state``, as :func:`fused_loop`: CUDA
    tensors one cooperative launch of the loop kernel, adding one to
    ``grid_loop.launches``; CPU tensors :func:`grid_loop_reference`."""
    grid_looper(kind, grid, table, src, w, offsets, state, max_dist, huber_delta, tol,
                max_iter)()


fused_loop.launches = 0
point_loop.launches = 0
grid_loop.launches = 0
