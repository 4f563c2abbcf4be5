"""Hashed-grid correspondence + linearization + reduction: the stats of one
Gauss-Newton iteration of ICP and PlaneICP on a small target (the ``"grid"``
method: raw points in CSR buckets) and of VPlaneICP and NDT on a hashed
voxel map (a box over the dense budget).

These are the port's own kernels for XLA code of the JAX package, which has
no Pallas kernel for either layout: ``ops/knn.py::nearest_point`` (:410) or
``nearest_voxel`` (:78) chained with ``ops/reduce.py``'s ``point_stats``,
``plane_stats`` or ``ndt_stats`` as ``icp_stats``, ``plane_icp_stats``,
``vplane_stats`` and ``ndt_solver_stats`` chain them. For each scan point
``q = R p + t``: the first minimum of the squared distance over the cells
of ``hashgrid.search_offsets`` in their order (a bucket's first ``cap``
points, or a slot's centroid where it is valid), gated on
``sqrt(d2) < max_dist``, linearized point-to-point, point-to-plane with the
matched point's or voxel's normal, or in NDT's Mahalanobis (icov) form, and
reduced to the 29 stat values of ``fused_align``.

The kernel reads the grid and a :class:`GridTable`: :func:`point_table`
(a small target's points, optional normals, CSR buckets, their points in
bucket order (``hashgrid.bucket_rows``) and ``cap``) or :func:`voxel_table`
(a hashed map's centroids, valid flags and normals or packed inverse
covariances). For a grid without a dense key table the launcher hands the
kernel the window as rows of consecutive keys with their probe ranks
(:func:`window_rows`). The wrappers :func:`grid_point_stats`,
:func:`grid_plane_point_stats`, :func:`hashed_plane_stats` and
:func:`hashed_ndt_stats` launch the hand-written kernels of
``csrc/grid_align.cu`` for CUDA tensors and add one to their ``launches``;
CPU tensors take the plain PyTorch versions,
:func:`grid_point_stats_reference` and :func:`hashed_voxel_stats_reference`
(``knn.nearest_point`` / ``nearest_voxel`` and ``ops/reduce.py``), which the
tests and ``chip_smoke.py`` also call directly. There is no fallback between
the two. The aligns run the same per-query work inside the loop kernel
(``ops/kernels/gn_loop.grid_loop``, ``csrc/grid_loop.cu``; the body is
``csrc/grid_stats.cuh``).

``matches``, a pair of (n,) int32 and float32 tensors, receives each query's
winner (a point index or a slot, -1 for none) and its squared distance
(``inf`` for none), weighted or not: the checks hold them to the plain
queries.

There is no batched entry: a batched align on a grid target or a hashed map
raises ``ValueError``, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from point_cloud_registration_tpu_torch.core.gn import packed_from_stats
from point_cloud_registration_tpu_torch.core.se3 import makeT, transform_points
from point_cloud_registration_tpu_torch.ops import reduce
from point_cloud_registration_tpu_torch.ops.hashgrid import Buckets, Grid
from point_cloud_registration_tpu_torch.ops.kernels._build import load_library
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    STATS_WIDTH,
    bound_launch,
    check_operands,
    check_poses,
    pose_rows,
    require_cuda,
)
from point_cloud_registration_tpu_torch.ops.knn import _sq_dist, nearest_point, nearest_voxel

__all__ = [
    "GridTable", "grid_plane_point_stats", "grid_point_stats", "grid_point_stats_reference",
    "hashed_ndt_stats", "hashed_plane_stats", "hashed_voxel_stats_reference", "point_table",
    "voxel_table", "window_rows",
]

# Most blocks of one launch (256 threads each); past it the blocks stride over
# the scan. A small target's 10k queries would take 1,250 blocks, a hashed
# map's 100k 782 (32 and 2 lanes a query).
MAX_BLOCKS = 1024
_C_SYMBOLS = {"point": "pcr_grid_point_stats", "plane_pt": "pcr_grid_plane_point_stats",
              "plane": "pcr_hashed_plane_stats", "ndt": "pcr_hashed_ndt_stats"}
_KIND_IDS = {"point": 0, "plane_pt": 1, "plane": 2, "ndt": 3}
# The kernel forms cells in the box's coordinates as int32, clamped to +-2^30:
# exact while every dim and every offset stays below these.
_MAX_DIM, _MAX_OFFSET = 1 << 29, 1 << 20
_FEAT_WIDTHS = {"point": None, "plane_pt": 3, "plane": 3, "ndt": 6}


class GridTable(NamedTuple):
    """What a grid stats kernel reads at a slot of the grid: a small target's
    raw points in CSR buckets (``buckets`` and ``cap`` set, ``valid`` None)
    or a hashed voxel map's slots (``valid`` set, ``buckets`` None)."""

    points: torch.Tensor  # (N, 3) target points, or (C, 3) voxel centroids
    feats: torch.Tensor | None  # (N, 3) or (C, 3) normals, (C, 6) packed icov, or None
    valid: torch.Tensor | None  # (C,) bool, a hashed map's
    buckets: Buckets | None  # a small target's CSR buckets
    cap: int  # points scanned per bucket (0 for a hashed map)
    rows: torch.Tensor | None = None  # (N, 4) hashgrid.bucket_rows of a grid target


def point_table(points: torch.Tensor, buckets: Buckets, cap: int,
                normals: torch.Tensor | None = None, *, rows: torch.Tensor) -> GridTable:
    """The table of a grid target: ``points`` (N, 3) bucketed by the grid,
    at most ``cap`` of a bucket scanned, ``normals`` (N, 3) for PlaneICP;
    ``rows``, the points in bucket order (``hashgrid.bucket_rows``, kept
    with the target)."""
    return GridTable(points=points, feats=normals, valid=None, buckets=buckets, cap=int(cap),
                     rows=rows)


def voxel_table(means: torch.Tensor, valid: torch.Tensor, feats: torch.Tensor) -> GridTable:
    """The table of a hashed voxel map: per slot its centroid ``means``
    (C, 3), ``valid`` (C,) flag and ``feats``, normals (C, 3) for VPlaneICP
    or packed inverse covariances (C, 6) ``[xx, yy, zz, xy, xz, yz]`` for
    NDT."""
    return GridTable(points=means, feats=feats, valid=valid, buckets=None, cap=0)


def table_kind(table: GridTable) -> str:
    """The kind a table serves: ``"point"`` or ``"plane_pt"`` (buckets,
    without or with normals), ``"plane"`` or ``"ndt"`` (valid flags, with
    normals or inverse covariances)."""
    if table.valid is None:
        return "point" if table.feats is None else "plane_pt"
    return "plane" if table.feats.shape[-1] == 3 else "ndt"


def _transformed(src: torch.Tensor, R, t) -> tuple:
    dev = src.device
    R = torch.as_tensor(R, dtype=torch.float32).to(dev)
    t = torch.as_tensor(t, dtype=torch.float32).to(dev)
    return transform_points(makeT(R, t), src), R


def grid_point_stats_reference(grid: Grid, table: GridTable, src: torch.Tensor,
                               w: torch.Tensor, R, t, offsets, max_dist: float,
                               huber_delta: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the grid kinds, on the device of ``src``:
    ``knn.nearest_point`` at ``q = R src + t``, the gate ``dist < max_dist``
    on a found match, then ``reduce.point_stats`` (a table without normals)
    or ``reduce.plane_stats`` with the matched point's normal. Returns the
    (29,) stats."""
    q, R = _transformed(src, R, t)
    nn = nearest_point(grid, table.buckets, table.points, q, offsets, cap=table.cap)
    idx = nn.idx.to(torch.int64)
    found = ((nn.dist < max_dist) & (idx >= 0)).to(torch.float32)
    wq = w * found
    safe = idx.clamp(0, table.points.shape[0] - 1)
    if table.feats is None:
        stats = reduce.point_stats(src, q, table.points[safe], wq, R, huber_delta=huber_delta)
    else:
        safe_n = idx.clamp(0, table.feats.shape[0] - 1)
        stats = reduce.plane_stats(src, q, table.points[safe], table.feats[safe_n], wq, R,
                                   huber_delta=huber_delta)
    return packed_from_stats(stats)


def hashed_voxel_stats_reference(grid: Grid, table: GridTable, src: torch.Tensor,
                                 w: torch.Tensor, R, t, offsets, max_dist: float,
                                 huber_delta: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the hashed kinds, on the device of ``src``:
    ``knn.nearest_voxel`` at ``q = R src + t``, the gate ``dist < max_dist``
    on a found slot, then ``reduce.plane_stats`` with the slot's normal or
    ``reduce.ndt_stats`` with its inverse covariance (the Mahalanobis form).
    Returns the (29,) stats."""
    q, R = _transformed(src, R, t)
    nn = nearest_voxel(grid, table.points, table.valid, q, offsets)
    wq = w * (nn.dist < max_dist) * (nn.idx >= 0)
    safe = nn.idx.clamp(0, table.points.shape[0] - 1).to(torch.int64)
    stats_fn = reduce.plane_stats if table.feats.shape[-1] == 3 else reduce.ndt_stats
    stats = stats_fn(src, q, table.points[safe], table.feats[safe], wq, R,
                     huber_delta=huber_delta)
    return packed_from_stats(stats)


def _reference(kind: str):
    return grid_point_stats_reference if kind in ("point", "plane_pt") \
        else hashed_voxel_stats_reference


def plain_matches(grid: Grid, table: GridTable, src: torch.Tensor, R, t, offsets) -> tuple:
    """``(idx (n,) int32, d2 (n,) float32)``: each query's winner by the plain
    query (-1 and ``inf`` for none), with the squared distance the search
    formed (``knn._sq_dist``)."""
    q, _ = _transformed(src, R, t)
    if table.valid is None:
        nn = nearest_point(grid, table.buckets, table.points, q, offsets, cap=table.cap)
    else:
        nn = nearest_voxel(grid, table.points, table.valid, q, offsets)
    safe = nn.idx.clamp(0, table.points.shape[0] - 1).to(torch.int64)
    d2 = _sq_dist(q, table.points[safe])
    return nn.idx, torch.where(nn.idx >= 0, d2, torch.full_like(d2, float("inf")))


def window_rows(offsets) -> tuple[np.ndarray, np.ndarray]:
    """``(rows (R, 4), ranks (R, W))`` int32: the window ``offsets`` (K, 3)
    as runs of consecutive dx at a fixed (dy, dz), in the keys' order (z,
    then y, then x). The cells of a run have consecutive linear keys, so the
    kernel finds a run's occupied cells by one lower-bound search and a walk
    over the sorted keys. ``rows[r] = [dy, dz, dx_lo, dx_hi]``;
    ``ranks[r, i]`` is the probe rank of ``(dx_lo + i, dy, dz)``, its
    position in ``offsets`` (the first, if repeated), and -1 past the run.
    ``search_offsets`` windows give one run per (dy, dz): 25 at radius 2."""
    first = {}
    for k, o in enumerate(map(tuple, np.asarray(offsets).reshape(-1, 3).tolist())):
        first.setdefault(o, k)  # a repeated offset keeps its first rank
    runs = []  # [dy, dz, dx_lo, dx_hi, ranks]
    for dx, dy, dz in sorted(first, key=lambda o: (o[2], o[1], o[0])):  # key order
        if runs and runs[-1][:2] == [dy, dz] and runs[-1][3] == dx - 1:
            runs[-1][3] = dx
            runs[-1][4].append(first[(dx, dy, dz)])
        else:
            runs.append([dy, dz, dx, dx, [first[(dx, dy, dz)]]])
    rows = np.array([r[:4] for r in runs], np.int32).reshape(-1, 4)
    ranks = np.full((len(runs), max((len(r[4]) for r in runs), default=1)), -1, np.int32)
    for i, r in enumerate(runs):
        ranks[i, :len(r[4])] = r[4]
    return rows, ranks


def _bind(lib: ctypes.CDLL, kind: str):
    """``(C function, queries per block)`` of ``kind`` in a built library."""
    fn = getattr(lib, _C_SYMBOLS[kind])
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = (
        [c_ptr] * 6 + [c_int]  # pts, feats, valid, bucket rows, starts, counts, cap
        + [c_ptr, c_int, c_ptr] + [c_int] * 6 + [c_float]  # keys, n_cells, dense, box, cell
        + [c_ptr, c_int, c_ptr, c_int, c_ptr, c_int]  # offsets, K, rows, R, ranks, W
        + [c_ptr, c_ptr, c_int, c_ptr, c_ptr]  # src, w, n, pose, done
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + [c_ptr, c_int, c_ptr, c_ptr, c_ptr]  # partials, n_blocks, matches, stream
    )
    fn.restype = c_int
    per_block = lib.pcr_grid_queries_per_block
    per_block.argtypes = [c_int]
    per_block.restype = c_int
    return fn, int(per_block(_KIND_IDS[kind]))


@functools.cache
def _kernel_fn(kind: str):
    return _bind(load_library("grid_align"), kind)


def _need(name: str, x, dtype, shape, device) -> None:
    if (not isinstance(x, torch.Tensor) or x.device != device or x.dtype != dtype
            or tuple(x.shape) != tuple(shape)):
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise ValueError(f"{name} must be a {dtype} tensor of shape {tuple(shape)} on {device}, "
                         f"got {got}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_table(kind: str, grid: Grid, table: GridTable, device) -> None:
    """Raise unless the kernel of ``kind`` can read ``grid`` and ``table`` on
    ``device``."""
    if kind not in _C_SYMBOLS:
        raise ValueError(f"unknown kind {kind!r}")
    if table_kind(table) != kind:
        raise ValueError(f"a table of kind {table_kind(table)!r} given to the {kind!r} kernel")
    C = grid.keys.shape[0]
    _need("grid.keys", grid.keys, torch.int32, (C,), device)
    if not 0 <= grid.n_cells <= C:
        raise ValueError(f"n_cells {grid.n_cells} is not within the {C} keys")
    cells = int(np.prod([float(d) for d in grid.dims]))
    if min(grid.dims) < 1 or cells >= np.iinfo(np.int32).max or max(grid.dims) >= _MAX_DIM:
        raise ValueError(f"dims {grid.dims} do not give an int32 keyspace with every dim "
                         f"below {_MAX_DIM}")
    if grid.dense is not None:
        if grid.dense.dim() != 1 or grid.dense.shape[0] < cells:
            raise ValueError(f"the dense table ({tuple(grid.dense.shape)}) is smaller than the "
                             f"{cells} cells of the box")
        _need("grid.dense", grid.dense, torch.int32, grid.dense.shape, device)
    n = table.points.shape[0]
    _need("points", table.points, torch.float32, (n, 3), device)
    if table.feats is not None:
        _need("feats", table.feats, torch.float32, (n, _FEAT_WIDTHS[kind]), device)
    if table.valid is None:
        b = table.buckets
        _need("buckets.perm", b.perm, torch.int32, (n,), device)
        _need("buckets.starts", b.starts, torch.int32, (C,), device)
        _need("buckets.counts", b.counts, torch.int32, (C,), device)
        _need("rows", table.rows, torch.float32, (n, 4), device)
        if table.rows.data_ptr() % 16:
            raise ValueError("rows must start at a multiple of 16 bytes")
        if table.cap < 0:
            raise ValueError(f"cap {table.cap} is negative")
    else:
        _need("valid", table.valid, torch.bool, (C,), device)
        if n != C:
            raise ValueError(f"{n} centroids for the grid's {C} slots")


def offsets_on(offsets, device) -> torch.Tensor:
    """The (K, 3) window offsets as a contiguous int32 tensor on ``device``;
    host offsets go to a card from pinned memory, a copy that does not wait
    for the card."""
    off = torch.as_tensor(np.asarray(offsets) if not isinstance(offsets, torch.Tensor)
                          else offsets).to(torch.int32)
    if off.dim() != 2 or off.shape[1] != 3:
        raise ValueError(f"offsets must be (K, 3), got {tuple(off.shape)}")
    device = torch.device(device)
    if off.device.type == "cpu" and device.type == "cuda":
        return off.contiguous().pin_memory().to(device, non_blocking=True)
    return off.to(device).contiguous()


def _check_matches(matches, n: int, device) -> None:
    if matches is not None:
        idx, d2 = matches
        _need("matches[0]", idx, torch.int32, (n,), device)
        _need("matches[1]", d2, torch.float32, (n,), device)


def table_args(grid: Grid, table: GridTable, offsets: torch.Tensor, window) -> tuple:
    """The C arguments that name the table, the grid's index and the window
    (:func:`bind_window`'s ``offsets`` and ``window`` on the card): the first
    23 of the stats kernels' and of the loop kernel's (``csrc/grid_loop.cu``)
    entries."""
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    b = table.buckets
    n_rows, width = window[1] if window is not None else (0, 0)
    rows = window[0] if window is not None else None
    return (
        ptr(table.points), ptr(table.feats), ptr(table.valid),
        ptr(table.rows), ptr(b.starts if b else None), ptr(b.counts if b else None),
        table.cap,
        grid.keys.data_ptr(), int(grid.n_cells), ptr(grid.dense),
        *(int(o) for o in grid.origin_cell), *(int(d) for d in grid.dims),
        float(np.float32(grid.cell_size)),
        offsets.data_ptr(), offsets.shape[0],
        ptr(rows), n_rows, rows.data_ptr() + 16 * n_rows if rows is not None else None, width,
    )


def _launch_args(bound, grid: Grid, table: GridTable, src, w, offsets, window,
                 poses, done, max_dist, huber_delta, matches) -> tuple:
    """``(fn, args, partials)``: the C function of ``bound`` and its
    arguments for these checked operands on the card, on the current
    stream, and the (1, n_blocks, 29) partials buffer they name. ``window``:
    the (R, 4) rows and (R, W) ranks of :func:`window_rows` in one int32
    tensor on the card, or None with a dense key table."""
    fn, per_block = bound
    n = src.shape[0]
    n_blocks = min(-(-n // per_block), MAX_BLOCKS)
    partials = torch.empty((1, n_blocks, STATS_WIDTH), dtype=torch.float32, device=src.device)
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    args = (
        *table_args(grid, table, offsets, window),
        src.data_ptr(), w.data_ptr(), n, poses.data_ptr(), ptr(done),
        float(max_dist), int(huber_delta is not None),
        float(huber_delta) if huber_delta is not None else 0.0,
        partials.data_ptr(), n_blocks,
        ptr(matches[0]) if matches is not None else None,
        ptr(matches[1]) if matches is not None else None,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    return fn, args, partials


def _counter(kind: str):
    return {"point": grid_point_stats, "plane_pt": grid_plane_point_stats,
            "plane": hashed_plane_stats, "ndt": hashed_ndt_stats}[kind]


@functools.lru_cache(maxsize=32)
def _window_on(offsets_bytes: bytes, device: torch.device, rows: bool) -> tuple:
    """``(offsets (K, 3), window)`` on ``device``, kept for later binds: the
    offsets and, with ``rows``, ``(tensor, (R, W))``, :func:`window_rows`
    of them as one int32 tensor, the rows then the ranks (else None)."""
    off = np.frombuffer(offsets_bytes, np.int32).reshape(-1, 3)
    if off.size and np.abs(off.astype(np.int64)).max() >= _MAX_OFFSET:
        raise ValueError(f"offsets must stay below {_MAX_OFFSET} cells")
    window = None
    if rows:
        r, ranks = window_rows(off)
        flat = torch.from_numpy(np.concatenate([r.ravel(), ranks.ravel()]))
        window = (flat.pin_memory().to(device, non_blocking=True), ranks.shape)
    return offsets_on(off.copy(), device), window


def resident_launch(kind: str, grid: Grid, table: GridTable, src: torch.Tensor,
                    w: torch.Tensor, offsets, poses: torch.Tensor, done, max_dist: float,
                    huber_delta: float | None, matches=None):
    """``launch() -> (1, 29)`` on the card: the kernel of ``kind`` on ``src``
    (n, 3) and ``w`` (n,) at the pose row ``poses`` (1, 12) on the card,
    writing zeros once ``done`` (1,) is set (None: never), with every
    operand checked and every argument bound once: the offsets on the card
    and, without a dense key table, the window's rows and ranks (both kept
    per device for later binds). Each call adds one to the
    kind's wrapper's ``launches``."""
    require_cuda(src)
    check_operands(src, w)
    check_poses(poses, done, 1, src.device)
    check_table(kind, grid, table, src.device)
    _check_matches(matches, src.shape[0], src.device)
    if src.shape[0] == 0:
        zeros = torch.zeros((1, STATS_WIDTH), dtype=torch.float32, device=src.device)
        return lambda: zeros
    offsets, window = bind_window(grid, offsets, src.device)
    fn, args, partials = _launch_args(_kernel_fn(kind), grid, table, src, w, offsets, window,
                                      poses, done, max_dist, huber_delta, matches)
    # the rows summed in double, as the loop kernel sums them (ops/kernels/gn_loop)
    return bound_launch(fn, args, partials, _counter(kind), f"grid {kind} stats",
                        (grid, table, src, w, offsets, window, poses, done, matches),
                        sum_dtype=torch.float64)


def bind_window(grid: Grid, offsets, device) -> tuple:
    """``(offsets, window)`` on ``device`` for the kernels: the (K, 3) window
    offsets and, for a grid without a dense key table, its rows and ranks
    (:func:`window_rows`) as one int32 tensor with their shape (else None);
    kept per device for later binds."""
    host = offsets.cpu().numpy() if isinstance(offsets, torch.Tensor) else np.asarray(offsets)
    if host.ndim != 2 or host.shape[1] != 3:
        raise ValueError(f"offsets must be (K, 3), got {host.shape}")
    return _window_on(np.ascontiguousarray(host, np.int32).tobytes(), torch.device(device),
                      grid.dense is None)


def _stats(kind: str, grid: Grid, table: GridTable, src: torch.Tensor, w: torch.Tensor, R, t,
           offsets, max_dist: float, huber_delta: float | None, matches) -> torch.Tensor:
    if src.device.type == "cpu":
        check_operands(src, w)
        check_table(kind, grid, table, src.device)
        _check_matches(matches, src.shape[0], src.device)
        offsets = offsets_on(offsets, src.device)
        if matches is not None:
            idx, d2 = plain_matches(grid, table, src, R, t, offsets)
            matches[0].copy_(idx)
            matches[1].copy_(d2)
        return _reference(kind)(grid, table, src, w, R, t, offsets, max_dist, huber_delta)
    require_cuda(src)
    R = torch.as_tensor(R, dtype=torch.float32).reshape(1, 3, 3)
    t = torch.as_tensor(t, dtype=torch.float32).reshape(1, 3)
    return resident_launch(kind, grid, table, src, w, offsets, pose_rows(R, t, src.device), None,
                           max_dist, huber_delta, matches)()[0]


def grid_point_stats(grid: Grid, table: GridTable, src: torch.Tensor, w: torch.Tensor, R, t,
                     offsets, max_dist: float, huber_delta: float | None = None, *,
                     matches=None) -> torch.Tensor:
    """One point-to-point linearization on a grid target -> (29,) float32
    stats on the device of ``src``.

    ``grid`` and ``table`` (:func:`point_table` without normals) are the
    target's; ``src`` (n, 3) and ``w`` (n,) the untransformed scan and its
    weights; ``R`` (3, 3) and ``t`` (3,) the pose, copied to the card as one
    pose row (:func:`resident_launch`); ``offsets`` (K, 3) the window, in
    ``hashgrid.search_offsets``' order. CPU tensors take the plain version;
    CUDA tensors launch the kernel and add one to
    ``grid_point_stats.launches``."""
    return _stats("point", grid, table, src, w, R, t, offsets, max_dist, huber_delta, matches)


def grid_plane_point_stats(grid: Grid, table: GridTable, src: torch.Tensor, w: torch.Tensor, R,
                           t, offsets, max_dist: float, huber_delta: float | None = None, *,
                           matches=None) -> torch.Tensor:
    """One point-to-plane linearization on a grid target whose table
    carries the points' normals (:func:`point_table` with ``normals``), as
    :func:`grid_point_stats`. CUDA tensors add one to
    ``grid_plane_point_stats.launches``."""
    return _stats("plane_pt", grid, table, src, w, R, t, offsets, max_dist, huber_delta,
                  matches)


def hashed_plane_stats(grid: Grid, table: GridTable, src: torch.Tensor, w: torch.Tensor, R, t,
                       offsets, max_dist: float, huber_delta: float | None = None, *,
                       matches=None) -> torch.Tensor:
    """One point-to-plane linearization on a hashed voxel map
    (:func:`voxel_table` with normals), as :func:`grid_point_stats`. CUDA
    tensors add one to ``hashed_plane_stats.launches``."""
    return _stats("plane", grid, table, src, w, R, t, offsets, max_dist, huber_delta, matches)


def hashed_ndt_stats(grid: Grid, table: GridTable, src: torch.Tensor, w: torch.Tensor, R, t,
                     offsets, max_dist: float, huber_delta: float | None = None, *,
                     matches=None) -> torch.Tensor:
    """One NDT (Mahalanobis, icov) linearization on a hashed voxel map
    (:func:`voxel_table` with packed inverse covariances), as
    :func:`grid_point_stats`. CUDA tensors add one to
    ``hashed_ndt_stats.launches``."""
    return _stats("ndt", grid, table, src, w, R, t, offsets, max_dist, huber_delta, matches)


grid_point_stats.launches = 0
grid_plane_point_stats.launches = 0
hashed_plane_stats.launches = 0
hashed_ndt_stats.launches = 0
