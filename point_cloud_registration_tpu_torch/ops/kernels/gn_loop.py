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
  ``ndt.py:82-83``; kernel ``csrc/grid_loop.cu``);
* :func:`fused_loop_batched` and :func:`point_loop_batched`: the loop of B
  scans against one dense map or one packed target in one launch (the JAX
  package's ``batched_gauss_newton``, ``models/_fused.py:288-355``, around
  the batched stats; kernels ``csrc/gn_loop.cu`` and ``csrc/point_loop.cu``,
  ``gn_loop.cuh``'s batched template), each problem's state that of its
  single align, bit for bit.

For CUDA tensors each makes one cooperative launch of a hand-written kernel
(``csrc/gn_loop.cuh``'s loop over the stats kernel's own body), a
persistent grid of the CTAs that fit on the card at once
(:func:`loop_grid`), which synchronises across the grid between the stats
and the update; a launch that the card refuses raises ``RuntimeError``, and
nothing falls back to another loop. For CPU tensors each runs its plain
PyTorch version (:func:`fused_loop_reference`, :func:`point_loop_reference`,
:func:`grid_loop_reference`: cases of :func:`loop_reference`, the stats' plain version then
``gn_step_reference`` until done; the batched loops' :func:`batched_loop_reference`),
which the tests and ``chip_smoke.py`` also call directly.

A launch runs on the card of its tensors: the occupancy query that sizes
the grid and the launch itself run with that card current
(``torch.cuda.device``), whatever the caller's current device.
"""

from __future__ import annotations

import contextlib
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

__all__ = ["batched_loop_reference", "fused_loop", "fused_loop_batched",
           "fused_loop_batched_reference", "fused_loop_reference", "fused_looper",
           "fused_looper_batched", "grid_loop", "grid_loop_reference", "grid_looper",
           "loop_grid", "loop_reference", "point_loop", "point_loop_batched",
           "point_loop_batched_reference", "point_loop_reference", "point_looper",
           "point_looper_batched"]

# Each kind's C id and the plain stats that its plain loop runs, by name:
# looked up at each iteration, as a launch looks up its kernel.
_FUSED_KINDS = {"plane": 0, "ndt": 1}
_FUSED_REFERENCE = {"plane": "fused_plane_stats_reference", "ndt": "fused_ndt_stats_reference"}
_FUSED_BATCHED_REFERENCE = {"plane": "fused_plane_stats_batched_reference",
                            "ndt": "fused_ndt_stats_batched_reference"}
_POINT_KINDS = {"point": 0, "plane_pt": 1}
_POINT_REFERENCE = {"point": "point_stats_reference", "plane_pt": "plane_point_stats_reference"}
_POINT_BATCHED_REFERENCE = {"point": "point_stats_batched_reference",
                            "plane_pt": "plane_point_stats_batched_reference"}
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
              max_blocks: int = fa.MAX_BLOCKS, problems: int = 1) -> tuple[int, int]:
    """``(grid, virtual_blocks)`` of a loop kernel for ``problems`` scans of
    ``n`` points: the virtual block ids of a problem are the stats launch's
    blocks of ``block`` queries, ``min(ceil(n / block), max_blocks)`` (at
    least one), and the grid is as many CTAs as fit on the card at once
    (``sms * blocks_per_sm``), at most one a virtual block of all the
    problems. CTA c takes the ids c, c + grid, ... (a batched loop's id is
    ``b * virtual_blocks + v``). Raises ``RuntimeError`` when no CTA
    fits."""
    resident = sms * blocks_per_sm
    if resident <= 0:
        raise RuntimeError(f"no CTA of the loop kernel fits on the card ({sms} SMs, "
                           f"{blocks_per_sm} CTAs an SM): it cannot launch")
    virtual = min(max(-(-n // block), 1), max_blocks)
    return min(problems * virtual, resident), virtual


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


def batched_loop_reference(stats: Callable[[], torch.Tensor], state: GNState, tol: float,
                           max_iter: int) -> None:
    """Plain PyTorch version of the batched loop kernels: while any problem
    of ``state`` (B problems of ``max_iter`` iterations, on the CPU) is not
    done, ``stats()`` (the (B, 29) packed stats of every problem at the
    state's poses as they are then, on any device), then
    ``gn_step_reference``, which leaves a done problem as it is. Updates
    ``state`` in place, as the two-launch batched loop over the same stats
    does, bit for bit."""
    _check_state(state, max_iter, torch.device("cpu"), None)
    while not bool(state.done.all()):
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


def fused_loop_batched_reference(kind: str, cells: CellIndex, origin_cell, dims,
                                 cell_size: float, src: torch.Tensor, w: torch.Tensor,
                                 state: GNState, max_dist: float, huber_delta: float | None,
                                 tol: float, max_iter: int) -> None:
    """Plain PyTorch version of :func:`fused_loop_batched`:
    :func:`batched_loop_reference` over the batched plain stats of ``kind``
    (``fused_*_stats_batched_reference``, on the device of ``src``)."""
    name = _FUSED_BATCHED_REFERENCE[kind]
    R, t = fa.rt_of_poses(state.poses, True)
    batched_loop_reference(lambda: getattr(fa, name)(cells, origin_cell, dims, cell_size, src,
                                                     w, R, t, max_dist, huber_delta),
                           state, tol, max_iter)


def point_loop_batched_reference(kind: str, pg: PackedPointGrid, proxy: ProxyMap,
                                 src: torch.Tensor, w: torch.Tensor, state: GNState,
                                 max_dist: float, proxy_radius: int, huber_delta: float | None,
                                 tol: float, max_iter: int) -> None:
    """Plain PyTorch version of :func:`point_loop_batched`:
    :func:`batched_loop_reference` over the batched plain stats of ``kind``
    (``point_stats_batched_reference`` or
    ``plane_point_stats_batched_reference``, on the device of ``src``)."""
    name = _POINT_BATCHED_REFERENCE[kind]
    R, t = fa.rt_of_poses(state.poses, True)
    batched_loop_reference(lambda: getattr(pa, name)(pg, proxy, src, w, R, t, max_dist,
                                                     proxy_radius, huber_delta),
                           state, tol, max_iter)


def _check_state(state: GNState, max_iter: int, device, problems: int | None = 1) -> None:
    """Raise unless ``state`` holds ``problems`` problems (any number when
    None) of ``max_iter`` iterations on ``device``."""
    B, M = state.e2.shape
    if M != max_iter or (problems is not None and B != problems):
        want = "one problem" if problems == 1 else f"{problems or 'B'} problems"
        raise ValueError(f"the loop takes the state of {want} of {max_iter} iterations, "
                         f"got B = {B}, max_iter = {M}")
    if state.words.device != device:
        raise ValueError(f"state on {state.words.device}, expected {device}")


def _bind(lib: ctypes.CDLL, prefix: str, kind: str, kind_id: int, argtypes: list, block):
    """``(fn, block, blocks_per_sm, error_string)`` of the ``kind`` entry
    ``pcr_<prefix>_<kind>`` of a loop kernel's library: ``block`` the stats
    launch's queries per block, ``blocks_per_sm(device=None)`` the CTAs of
    the kind's kernel that fit on one SM of ``device``."""
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
    def blocks_per_sm(device: torch.device | None = None) -> int:
        out = c_int(0)
        with torch.cuda.device(device) if device is not None else contextlib.nullcontext():
            rc = occupancy(kind_id, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"{prefix} occupancy query failed: CUDA error {rc} "
                               f"({error_string(rc).decode()})")
        return out.value

    return fn, int(block), blocks_per_sm, lambda rc: error_string(rc).decode()


def bind(lib: ctypes.CDLL, kind: str, batched: bool = False):
    """``(fn, block, blocks_per_sm, error_string)`` of the ``kind`` entry of
    a build of ``csrc/gn_loop.cu`` (the fused loop; with ``batched`` its
    batched entry ``pcr_gn_loop_batched_<kind>``, the loop of B problems),
    with argument types set: ``block`` is its threads per CTA,
    ``blocks_per_sm(device=None)`` the CTAs that fit on one SM."""
    argtypes = (
        [c_ptr] * 3 + [c_int] * 6 + [c_float, c_int]  # occ, centers, feats, geometry
        + [c_ptr, c_ptr, c_int] + [c_int] * batched + [c_int]  # src, w, n, [B,] n_blocks
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + [c_ptr] * 11  # the state's nine fields, partials, rows_out
        + [c_int, c_float, c_int, c_ptr]  # max_iter, tol, grid, stream
    )
    block = lib.pcr_gn_loop_block_size
    block.argtypes = []
    block.restype = c_int
    return _bind(lib, "gn_loop_batched" if batched else "gn_loop", kind, _FUSED_KINDS[kind],
                 argtypes, block())


def bind_point(lib: ctypes.CDLL, kind: str, batched: bool = False):
    """:func:`bind` of the ``kind`` entry of a build of
    ``csrc/point_loop.cu`` (the packed-grid loop; with ``batched``
    ``pcr_point_loop_batched_<kind>``)."""
    argtypes = (
        [c_ptr] * 3 + [c_int] * 7 + [c_float]  # packed grid
        + [c_ptr] + [c_int] * 3 + [c_float, c_int]  # proxy map
        + [c_ptr, c_ptr, c_int] + [c_int] * batched  # src, w, n, [B]
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + _STATE_ARGTYPES
    )
    block = lib.pcr_point_loop_block_size
    block.argtypes = []
    block.restype = c_int
    return _bind(lib, "point_loop_batched" if batched else "point_loop", kind,
                 _POINT_KINDS[kind], argtypes, block())


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
def _batched_kernel_fn(kind: str):
    return bind(load_library("gn_loop"), kind, batched=True)


@functools.cache
def _point_batched_kernel_fn(kind: str):
    return bind_point(load_library("point_loop"), kind, batched=True)


@functools.cache
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# The batched loop kernel's block ids b * n_blocks + v are ints.
MAX_BATCH_IDS = 2**31 - 1


def check_batch_ids(problems: int, n: int, block: int, max_blocks: int = fa.MAX_BLOCKS) -> None:
    """Raise ``ValueError`` unless the ids of a batched loop of ``problems``
    scans of ``n`` points (``problems`` times the virtual blocks of one) fit
    in MAX_BATCH_IDS."""
    ids = problems * min(max(-(-n // block), 1), max_blocks)
    if ids > MAX_BATCH_IDS:
        raise ValueError(f"{problems} problems of {n} points make {ids} block ids: the batched "
                         f"loop kernel takes at most MAX_BATCH_IDS = {MAX_BATCH_IDS}")


def _geometry(bound, src: torch.Tensor, state: GNState, max_iter: int, rows,
              max_blocks: int, problems: int = 0) -> tuple:
    """``(grid, n_blocks, partials)`` of a loop launch over the queries of
    ``src`` ((n, 3), or (B, n, 3) with ``problems`` = B for a batched loop),
    after checking that ``state`` and ``rows`` lie on its card; the
    occupancy is that card's."""
    dev = src.device
    _check_state(state, max_iter, dev, max(problems, 1))
    _, block, blocks_per_sm, _ = bound
    check_batch_ids(problems, src.shape[-2], block, max_blocks)
    grid, n_blocks = loop_grid(src.shape[-2], block, _multiprocessors(dev), blocks_per_sm(dev),
                               max_blocks, max(problems, 1))
    shape = (problems, n_blocks, fa.STATS_WIDTH) if problems else (n_blocks, fa.STATS_WIDTH)
    # a single loop's two buffers of rows (gn_loop.cuh's kRedundant), a batch's one
    partials = torch.empty((max(problems, 2), n_blocks, fa.STATS_WIDTH), dtype=torch.float32,
                           device=dev)
    if rows is not None and (rows.device != dev or rows.dtype != torch.float32
                             or tuple(rows.shape) != shape or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous float32 {shape} tensor on {dev}")
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


# The scan's pointer among a fused entry's arguments: after occ, centers,
# feats, the six geometry ints, the inverse cell and the window radius.
_FUSED_SCAN_AT = 11


def _fused_args(cells, origin_cell, dims, cell_size, src, w, batch: tuple, n_blocks: int,
                max_dist, huber_delta, state, partials, rows, max_iter, tol, grid) -> tuple:
    """The C arguments of a fused loop entry (``bind``'s argument types):
    ``batch`` is ``(B,)`` for a batched entry, ``()`` for a single one."""
    return (
        cells.occ.data_ptr(), cells.centers.data_ptr(), cells.feats.data_ptr(),
        *(int(d) for d in dims), *(int(o) for o in origin_cell),
        float(fa.inv_cell_f32(cell_size)), window_radius(max_dist, cell_size),
        src.data_ptr(), w.data_ptr(), src.shape[-2], *batch, n_blocks,
        *_huber_args(max_dist, huber_delta),
        *(x.data_ptr() for x in state[1:]), partials.data_ptr(),
        rows.data_ptr() if rows is not None else None,
        int(max_iter), float(tol), grid, torch.cuda.current_stream(src.device).cuda_stream,
    )


class _Launch:
    """``launch()``: one cooperative launch of ``bound``'s function with
    ``args`` with the card ``device`` current, adding one to
    ``counter.launches``; a refused launch raises ``RuntimeError`` with the
    CUDA error. ``operands`` keeps the tensors whose pointers ``args``
    carries; ``grid`` is ``(CTAs, virtual blocks)``.

    A single loop's launch also takes another scan of the bound one's
    length (:meth:`run`): ``args[scan_at:scan_at + 3]`` are the scan's and
    the weights' pointers and ``n``."""

    def __init__(self, what: str, counter, bound, args: tuple, grid: int, n_blocks: int,
                 operands: tuple, device: torch.device, scan_at: int | None = None):
        self.what, self.counter, self.device, self.scan_at = what, counter, device, scan_at
        self.fn, self.error_string = bound[0], bound[3]
        self.args = list(args)
        self.operands = operands
        self.grid = (grid, n_blocks)

    def __call__(self) -> None:
        with torch.cuda.device(self.device):
            rc = self.fn(*self.args)
        self._count(rc)

    def run(self, src: torch.Tensor, w: torch.Tensor) -> None:
        """The launch on the scan ``src`` (n, 3) and its weights ``w`` (n,),
        of the bound scan's ``n`` on its card: their pointers patched in,
        the rest as bound; the card is entered only when it is not current."""
        fa.check_operands(src, w)
        n = self.args[self.scan_at + 2]
        if src.device != self.device or src.shape[0] != n:
            raise ValueError(f"the loop is bound to {n} points on {self.device}, "
                             f"got {src.shape[0]} on {src.device}")
        self.args[self.scan_at:self.scan_at + 2] = src.data_ptr(), w.data_ptr()
        if torch.cuda.current_device() == self.device.index:
            rc = self.fn(*self.args)
        else:
            with torch.cuda.device(self.device):
                rc = self.fn(*self.args)
        self._count(rc)

    def _count(self, rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"{self.what} cooperative launch of {self.grid[0]} CTAs failed: "
                               f"CUDA error {rc} ({self.error_string(rc)})")
        self.counter.launches += 1


class _Plain:
    """A CPU looper's ``launch()``: its plain loop ``loop(src, w)`` on the
    bound scan, or on another (:meth:`run`), as a launch takes one."""

    def __init__(self, loop: Callable[[torch.Tensor, torch.Tensor], None], src, w):
        self.loop, self.scan = loop, (src, w)

    def __call__(self) -> None:
        self.loop(*self.scan)

    def run(self, src: torch.Tensor, w: torch.Tensor) -> None:
        self.loop(src, w)


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
        return _Plain(lambda s, ws: fused_loop_reference(kind, cells, origin_cell, dims,
                                                         cell_size, s, ws, state, max_dist,
                                                         huber_delta, tol, max_iter), src, w)
    fa.require_cuda(src)
    fa.check_launch(kind, cells, dims, src, w)
    bound = bound or _kernel_fn(kind)
    grid, n_blocks, partials = _geometry(bound, src, state, max_iter, rows,
                                         fa.MAX_BLOCKS)
    args = _fused_args(cells, origin_cell, dims, cell_size, src, w, (), n_blocks, max_dist,
                       huber_delta, state, partials, rows, max_iter, tol, grid)
    return _Launch(f"gn_loop {kind}", fused_loop, bound, args, grid, n_blocks,
                   (cells, src, w, state, partials, rows), src.device, _FUSED_SCAN_AT)


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
        return _Plain(lambda s, ws: point_loop_reference(kind, pg, proxy, s, ws, state, max_dist,
                                                         proxy_radius, huber_delta, tol,
                                                         max_iter), src, w)
    fa.require_cuda(src)
    fa.check_operands(src, w)
    pa.check_tables(kind, pg, proxy, src)
    bound = bound or _point_kernel_fn(kind)
    grid, n_blocks, partials = _geometry(bound, src, state, max_iter, rows,
                                         fa.MAX_BLOCKS)
    table = pa.table_args(pg, proxy, proxy_radius)
    args = (*table, src.data_ptr(), w.data_ptr(), src.shape[0],
            *_huber_args(max_dist, huber_delta),
            *_state_args(state, partials, rows, n_blocks, max_iter, tol, grid))
    return _Launch(f"point_loop {kind}", point_loop, bound, args, grid, n_blocks,
                   (pg, proxy, src, w, state, partials, rows), src.device, len(table))


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
        return _Plain(lambda s, ws: grid_loop_reference(kind, grid, table, s, ws, offsets, state,
                                                        max_dist, huber_delta, tol, max_iter),
                      src, w)
    fa.require_cuda(src)
    fa.check_operands(src, w)
    ga.check_table(kind, grid, table, src.device)
    offsets, window = ga.bind_window(grid, offsets, src.device)
    bound = bound or _grid_kernel_fn(kind)
    grid_ctas, n_blocks, partials = _geometry(bound, src, state, max_iter, rows, ga.MAX_BLOCKS)
    head = ga.table_args(grid, table, offsets, window)
    args = (*head, src.data_ptr(), w.data_ptr(), src.shape[0],
            *_huber_args(max_dist, huber_delta),
            *_state_args(state, partials, rows, n_blocks, max_iter, tol, grid_ctas))
    return _Launch(f"grid_loop {kind}", grid_loop, bound, args, grid_ctas, n_blocks,
                   (grid, table, src, w, offsets, window, state, partials, rows), src.device,
                   len(head))


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


def _check_batch(src: torch.Tensor, w: torch.Tensor, state: GNState) -> None:
    """Raise unless ``src`` (B, n, 3) and ``w`` (B, n) hold the B problems of
    ``state``."""
    B = state.e2.shape[0]
    if src.dim() != 3 or src.shape[0] != B or src.shape[2] != 3 or w.shape != src.shape[:2]:
        raise ValueError(f"src {tuple(src.shape)} and w {tuple(w.shape)} are not (B, n, 3) and "
                         f"(B, n) of the state's B = {B} problems")


def fused_looper_batched(kind: str, cells: CellIndex, origin_cell, dims, cell_size: float,
                         src: torch.Tensor, w: torch.Tensor, state: GNState, max_dist: float,
                         huber_delta: float | None, tol: float, max_iter: int, *,
                         rows: torch.Tensor | None = None, bound=None):
    """``launch()``: :func:`fused_loop_batched` of these operands with every
    argument bound once. CPU tensors take :func:`fused_loop_batched_reference`;
    CUDA tensors one cooperative launch of the batched loop kernel of
    ``csrc/gn_loop.cu`` on the stream current now, which adds one to
    ``fused_loop_batched.launches``. ``rows``, when given, is a float32
    (B, n_blocks, 29) tensor on the card that receives the first iteration's
    block rows (the batched stats launch's partials at the initial poses);
    ``bound`` another build's ``bind(lib, kind, batched=True)``."""
    if kind not in _FUSED_KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _check_batch(src, w, state)
    if src.device.type == "cpu":
        return lambda: fused_loop_batched_reference(kind, cells, origin_cell, dims, cell_size,
                                                    src, w, state, max_dist, huber_delta, tol,
                                                    max_iter)
    fa.require_cuda(src)
    fa.check_launch(kind, cells, dims, src.reshape(-1, 3), w.reshape(-1))
    bound = bound or _batched_kernel_fn(kind)
    B = src.shape[0]
    grid, n_blocks, partials = _geometry(bound, src, state, max_iter, rows, fa.MAX_BLOCKS, B)
    args = _fused_args(cells, origin_cell, dims, cell_size, src, w, (B,), n_blocks, max_dist,
                       huber_delta, state, partials, rows, max_iter, tol, grid)
    return _Launch(f"gn_loop batched {kind}", fused_loop_batched, bound, args, grid, n_blocks,
                   (cells, src, w, state, partials, rows), src.device)


def fused_loop_batched(kind: str, cells: CellIndex, origin_cell, dims, cell_size: float,
                       src: torch.Tensor, w: torch.Tensor, state: GNState, max_dist: float,
                       huber_delta: float | None, tol: float, max_iter: int) -> None:
    """Every Gauss-Newton iteration of B VPlaneICP (``kind`` "plane") or NDT
    ("ndt") aligns against one dense voxel map, in place on ``state`` (the
    :class:`GNState` of B problems of ``max_iter`` iterations, on the device
    of ``src``), until every problem is done (the JAX package's
    ``batched_gauss_newton`` around the batched fused stats).

    ``src`` (B, n, 3) and ``w`` (B, n) hold the untransformed scans and
    their weights; the rest as :func:`fused_loop`. Each problem's state is
    left as its single align leaves it; a done problem is not touched again.
    CUDA tensors: one cooperative launch of the batched loop kernel on the
    current stream, adding one to ``fused_loop_batched.launches``; it never
    waits for the card, and a refused launch raises ``RuntimeError``. CPU
    tensors: :func:`fused_loop_batched_reference`."""
    fused_looper_batched(kind, cells, origin_cell, dims, cell_size, src, w, state, max_dist,
                         huber_delta, tol, max_iter)()


def point_looper_batched(kind: str, pg: PackedPointGrid, proxy: ProxyMap, src: torch.Tensor,
                         w: torch.Tensor, state: GNState, max_dist: float, proxy_radius: int,
                         huber_delta: float | None, tol: float, max_iter: int, *,
                         rows: torch.Tensor | None = None, bound=None):
    """``launch()``: :func:`point_loop_batched` of these operands with every
    argument bound once, as :func:`fused_looper_batched`: CPU tensors take
    :func:`point_loop_batched_reference`; CUDA tensors one cooperative
    launch of the batched loop kernel of ``csrc/point_loop.cu``, which adds
    one to ``point_loop_batched.launches``. ``rows`` receives the first
    iteration's (B, n_blocks, 29) block rows; ``bound`` is another build's
    ``bind_point(lib, kind, batched=True)``."""
    if kind not in _POINT_KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _check_batch(src, w, state)
    if src.device.type == "cpu":
        return lambda: point_loop_batched_reference(kind, pg, proxy, src, w, state, max_dist,
                                                    proxy_radius, huber_delta, tol, max_iter)
    fa.require_cuda(src)
    fa.check_operands(src.reshape(-1, 3), w.reshape(-1))
    pa.check_tables(kind, pg, proxy, src)
    bound = bound or _point_batched_kernel_fn(kind)
    B = src.shape[0]
    grid, n_blocks, partials = _geometry(bound, src, state, max_iter, rows, fa.MAX_BLOCKS, B)
    args = (*pa.table_args(pg, proxy, proxy_radius), src.data_ptr(), w.data_ptr(),
            src.shape[1], B, *_huber_args(max_dist, huber_delta),
            *_state_args(state, partials, rows, n_blocks, max_iter, tol, grid))
    return _Launch(f"point_loop batched {kind}", point_loop_batched, bound, args, grid,
                   n_blocks, (pg, proxy, src, w, state, partials, rows), src.device)


def point_loop_batched(kind: str, pg: PackedPointGrid, proxy: ProxyMap, src: torch.Tensor,
                       w: torch.Tensor, state: GNState, max_dist: float, proxy_radius: int,
                       huber_delta: float | None, tol: float, max_iter: int) -> None:
    """Every Gauss-Newton iteration of B ICP (``kind`` "point") or PlaneICP
    ("plane_pt") aligns against one packed point grid ``pg`` and its proxy
    map, in place on ``state`` (B problems), as :func:`fused_loop_batched`:
    CUDA tensors one cooperative launch of the batched loop kernel, adding
    one to ``point_loop_batched.launches``; CPU tensors
    :func:`point_loop_batched_reference`."""
    point_looper_batched(kind, pg, proxy, src, w, state, max_dist, proxy_radius, huber_delta,
                         tol, max_iter)()


fused_loop.launches = 0
point_loop.launches = 0
grid_loop.launches = 0
fused_loop_batched.launches = 0
point_loop_batched.launches = 0
