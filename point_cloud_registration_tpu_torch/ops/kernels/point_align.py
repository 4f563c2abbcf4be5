"""Raw-point correspondence + linearization + reduction for ICP and PlaneICP
(counterpart of ``point_cloud_registration_tpu/ops/pallas/point_align.py``,
kinds "point" and "plane_pt", with the fallback its caller runs).

``point_stats`` computes one Gauss-Newton linearization of the scan against
a packed point grid and its proxy voxel map: for each scan point
``q = R p + t``, the correspondence of ``models/_point_corr.match_points``
(the nearest kept target point when it lies within ``cell_fine``, else the
nearest proxy-voxel centroid within ``max_dist``), gated on
``dist < max_dist``, linearized as point-to-point (``r = q - target``,
``J = [I | -R skew(p)]``) and reduced to the 29 stat values of
``fused_align``.

``plane_point_stats`` is PlaneICP's: the same correspondence on a packed
grid whose slots carry each point's normal (width 6), linearized as
point-to-plane (``r = n . (q - target)``, ``J = [n, p x (R^T n)]``) with the
matched point's normal, or the proxy voxel's for a query that took the
proxy.

For CUDA tensors they launch the hand-written kernels of
``csrc/point_align.cu``; for CPU tensors they run the plain PyTorch
versions, :func:`point_stats_reference` and
:func:`plane_point_stats_reference` (``ops.pointgrid.match_packed`` followed
by ``ops.reduce.point_stats`` or ``plane_stats``), which the tests and
``chip_smoke.py`` also call directly. There is no fallback between the two.

``point_stats_batched`` and ``plane_point_stats_batched`` compute the same
stats for B scans, each with its own pose, against one target in one launch
(the TPU kernel's ``per_tile`` mode): (B, 29), row b equal to the single
wrapper's stats of problem b. Single and batched wrappers and the resident
loop's :func:`resident_stats` make one launch path, as in ``fused_align``:
the kernel reads the poses from (B, 12) pose rows on the card. A single
align runs the same per-query work (``csrc/point_stats.cuh``) inside the
loop kernel (``ops/kernels/gn_loop.point_loop``, ``csrc/point_loop.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from point_cloud_registration_tpu_torch.core.se3 import makeT, transform_points
from point_cloud_registration_tpu_torch.ops import reduce
from point_cloud_registration_tpu_torch.ops.kernels._build import load_library
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    MAX_BLOCKS,
    STATS_WIDTH,
    bound_launch,
    check_batched,
    check_operands,
    check_poses,
    one_problem,
    packed_from_stats,
    per_problem,
    pose_rows,
    require_cuda,
    rt_of_poses,
)
from point_cloud_registration_tpu_torch.ops.pointgrid import (
    PackedPointGrid,
    ProxyMap,
    match_packed,
)


def point_stats_reference(
    pg: PackedPointGrid,
    proxy: ProxyMap,
    src: torch.Tensor,
    w: torch.Tensor,
    R,
    t,
    max_dist: float,
    proxy_radius: int,
    huber_delta: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the device of ``src``:
    the (29,) stats."""
    dev = src.device
    R = torch.as_tensor(R, dtype=torch.float32).to(dev)
    t = torch.as_tensor(t, dtype=torch.float32).to(dev)
    q = transform_points(makeT(R, t), src)
    m = match_packed(pg, proxy, q, max_dist, proxy_radius)
    stats = reduce.point_stats(src, q, m.target, w * m.weight, R, huber_delta=huber_delta)
    return packed_from_stats(stats)


def plane_point_stats_reference(
    pg: PackedPointGrid,
    proxy: ProxyMap,
    src: torch.Tensor,
    w: torch.Tensor,
    R,
    t,
    max_dist: float,
    proxy_radius: int,
    huber_delta: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the "plane_pt" kernel, on the device of
    ``src``: ``match_packed``, the normal of the matched point (from its
    packed slot) or of the proxy voxel (plane_icp.py:78-88), then
    ``plane_stats``. Returns the (29,) stats."""
    dev = src.device
    R = torch.as_tensor(R, dtype=torch.float32).to(dev)
    t = torch.as_tensor(t, dtype=torch.float32).to(dev)
    q = transform_points(makeT(R, t), src)
    m = match_packed(pg, proxy, q, max_dist, proxy_radius)
    safe_proxy = torch.clamp(m.proxy_slot, 0, proxy.normals.shape[0] - 1)
    normals = torch.where((m.point_idx >= 0)[:, None], m.feat, proxy.normals[safe_proxy])
    stats = reduce.plane_stats(src, q, m.target, normals, w * m.weight, R,
                               huber_delta=huber_delta)
    return packed_from_stats(stats)


def point_stats_batched_reference(pg, proxy, src, w, R, t, max_dist, proxy_radius,
                                  huber_delta=None) -> torch.Tensor:
    """Plain version of the batched point kernel: :func:`point_stats_reference`
    of each problem b (``src`` (B, n, 3), ``w`` (B, n), ``R`` (B, 3, 3),
    ``t`` (B, 3)). Returns the (B, 29) stats."""
    return per_problem(lambda *p: point_stats_reference(
        pg, proxy, *p, max_dist, proxy_radius, huber_delta), src, w, R, t)


def plane_point_stats_batched_reference(pg, proxy, src, w, R, t, max_dist, proxy_radius,
                                        huber_delta=None) -> torch.Tensor:
    """Plain version of the batched "plane_pt" kernel:
    :func:`plane_point_stats_reference` of each problem. Returns (B, 29)."""
    return per_problem(lambda *p: plane_point_stats_reference(
        pg, proxy, *p, max_dist, proxy_radius, huber_delta), src, w, R, t)


_C_SYMBOLS = {"point": "pcr_point_stats", "plane_pt": "pcr_plane_point_stats"}
_WIDTHS = {"point": 3, "plane_pt": 6}


def _bind(lib: ctypes.CDLL, kind: str):
    """``(C function, threads per block)`` of ``kind`` in a built library."""
    fn = getattr(lib, _C_SYMBOLS[kind])
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = (
        [c_ptr, c_ptr, c_ptr] + [c_int] * 7 + [c_float]  # packed grid
        + [c_ptr] + [c_int] * 3 + [c_float, c_int]  # proxy map
        + [c_ptr, c_ptr, c_int, c_int, c_ptr, c_ptr]  # src, w, n per problem, B, poses, done
        + [c_float, c_int, c_float]  # max_dist, use_huber, huber_delta
        + [c_ptr, c_int, c_ptr]  # partials, n_blocks, stream
    )
    fn.restype = c_int
    block = lib.pcr_point_block_size
    block.argtypes = []
    block.restype = c_int
    return fn, int(block())


@functools.cache
def _kernel_fn(kind: str):
    return _bind(load_library("point_align"), kind)


def check_tables(kind: str, pg: PackedPointGrid, proxy: ProxyMap,
                 src: torch.Tensor) -> None:
    """Raise unless the kernels of ``kind`` can read ``pg`` and ``proxy``
    beside ``src``."""
    r1, cap = pg.idx_packed.shape
    nb_total = pg.nb_dims[0] * pg.nb_dims[1] * pg.nb_dims[2]
    expect = {
        "pts_packed": (pg.pts_packed, torch.float32, (r1, cap * _WIDTHS[kind])),
        "row_count": (pg.row_count, torch.int32, (r1,)),
        "block_row": (pg.block_row, torch.int32, (nb_total,)),
        "proxy.table": (proxy.table, torch.float32, (nb_total, 8)),
    }
    for name, (x, dtype, shape) in expect.items():
        if x.device != src.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name} must be a {dtype} tensor of shape {shape} on {src.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(proxy.dims) != tuple(pg.nb_dims):
        raise ValueError(f"proxy dims {proxy.dims} are not the block grid {pg.nb_dims}")


def table_args(pg: PackedPointGrid, proxy: ProxyMap, proxy_radius: int) -> tuple:
    """The C arguments that name the packed grid and its proxy map: the
    first 17 of the stats kernels' and of the loop kernel's
    (``csrc/point_loop.cu``) entries."""
    return (
        pg.pts_packed.data_ptr(), pg.row_count.data_ptr(), pg.block_row.data_ptr(),
        pg.cap, *(int(d) for d in pg.nb_dims), *(int(o) for o in pg.origin_fine),
        float(pg.cell_fine),
        proxy.table.data_ptr(), *(int(o) for o in proxy.origin_cell),
        float(proxy.cell_size), int(proxy_radius),
    )


def partials_args(bound, pg, proxy, src, w, poses, done, max_dist, proxy_radius,
                  huber_delta) -> tuple:
    """``(fn, args, partials)``: the C function of ``bound`` (:func:`_bind`)
    and its arguments for these checked operands (``src`` (B, n, 3), ``w``
    (B, n), ``poses`` (B, 12) and ``done`` (B,) or None on the card), on the
    current stream, and the (B, n_blocks, 29) partials buffer they name."""
    fn, block = bound
    n = src.shape[1]
    n_blocks = min(-(-n // block), MAX_BLOCKS)
    partials = torch.empty((src.shape[0], n_blocks, STATS_WIDTH), dtype=torch.float32,
                           device=src.device)
    args = (
        *table_args(pg, proxy, proxy_radius),
        src.data_ptr(), w.data_ptr(), n, src.shape[0], poses.data_ptr(),
        done.data_ptr() if done is not None else None,
        float(max_dist), int(huber_delta is not None),
        float(huber_delta) if huber_delta is not None else 0.0,
        partials.data_ptr(), n_blocks,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    return fn, args, partials


def resident_launch(kind, counter, pg, proxy, src, w, poses, done, max_dist, proxy_radius,
                    huber_delta):
    """``launch() -> (B, 29)`` on the card: the kernel of ``kind`` on ``src``
    (B, n, 3) and ``w`` (B, n) at the pose rows ``poses`` (B, 12) on the
    card, skipping the problems whose ``done`` flag is set (None: none),
    with every operand checked and every argument bound once."""
    require_cuda(src)
    check_batched(src, w, *rt_of_poses(poses, True))
    check_poses(poses, done, src.shape[0], src.device)
    check_operands(src.reshape(-1, 3), w.reshape(-1))
    check_tables(kind, pg, proxy, src)
    if src.shape[1] == 0:
        zeros = torch.zeros((src.shape[0], STATS_WIDTH), dtype=torch.float32, device=src.device)
        return lambda: zeros
    fn, args, partials = partials_args(_kernel_fn(kind), pg, proxy, src, w, poses, done,
                                       max_dist, proxy_radius, huber_delta)
    # the rows summed in double, as the loop kernel sums them (ops/kernels/gn_loop)
    return bound_launch(fn, args, partials, counter, f"{kind} stats",
                        (pg, proxy, src, w, poses, done), sum_dtype=torch.float64)


def _stats(kind, counter, reference, batched, pg, proxy, src, w, R, t, max_dist, proxy_radius,
           huber_delta) -> torch.Tensor:
    if src.device.type == "cpu":
        return reference(pg, proxy, src, w, R, t, max_dist, proxy_radius, huber_delta)
    require_cuda(src)
    if not batched:
        check_operands(src, w)
        src, w, R, t = one_problem(src, w, R, t)
    check_batched(src, w, R, t)  # the poses go to the card, then one launch
    out = resident_launch(kind, counter, pg, proxy, src, w, pose_rows(R, t, src.device), None,
                          max_dist, proxy_radius, huber_delta)()
    return out if batched else out[0]


def resident_stats(kind: str, pg: PackedPointGrid, proxy: ProxyMap, src: torch.Tensor,
                   w: torch.Tensor, max_dist: float, proxy_radius: int,
                   huber_delta: float | None, poses: torch.Tensor, done: torch.Tensor | None):
    """The stats kernel bound once to pose rows that stay on the device, as
    ``fused_align.resident_stats``: ``launch() -> (B, 29)`` (or (29,) for
    one problem on the CPU) at the current pose rows ``poses`` (B, 12);
    ``src`` (n, 3) counts as the single wrapper's launches, (B, n, 3) as the
    batched wrapper's."""
    batched = src.dim() == 3
    if kind not in _C_SYMBOLS:
        raise ValueError(f"unknown kind {kind!r}")
    if src.device.type == "cpu":
        reference = {("point", False): point_stats_reference,
                     ("plane_pt", False): plane_point_stats_reference,
                     ("point", True): point_stats_batched_reference,
                     ("plane_pt", True): plane_point_stats_batched_reference}[kind, batched]
        R, t = rt_of_poses(poses, batched)  # views: they follow the state
        return lambda: reference(pg, proxy, src, w, R, t, max_dist, proxy_radius, huber_delta)
    counter = {("point", False): point_stats, ("plane_pt", False): plane_point_stats,
               ("point", True): point_stats_batched,
               ("plane_pt", True): plane_point_stats_batched}[kind, batched]
    return resident_launch(kind, counter, pg, proxy, src if batched else src[None],
                           w if batched else w[None], poses, done, max_dist, proxy_radius,
                           huber_delta)


def point_stats(
    pg: PackedPointGrid,
    proxy: ProxyMap,
    src: torch.Tensor,
    w: torch.Tensor,
    R,
    t,
    max_dist: float,
    proxy_radius: int,
    huber_delta: float | None = None,
) -> torch.Tensor:
    """One point-to-point linearization -> (29,) float32 stats on the device
    of ``src``.

    ``pg`` and ``proxy`` are the target's packed grid and proxy map;
    ``proxy_radius`` the proxy window in proxy cells; ``src`` (N, 3) and
    ``w`` (N,) the untransformed scan and its weights; ``R`` (3, 3) and
    ``t`` (3,) the pose, copied to the card as one pose row (a resident
    loop binds the same launch to its state's pose rows instead:
    :func:`resident_stats`). CPU tensors take the plain version; CUDA
    tensors launch the kernel at B = 1 and add one to
    ``point_stats.launches``.
    """
    return _stats("point", point_stats, point_stats_reference, False, pg, proxy, src, w, R, t,
                  max_dist, proxy_radius, huber_delta)


def plane_point_stats(
    pg: PackedPointGrid,
    proxy: ProxyMap,
    src: torch.Tensor,
    w: torch.Tensor,
    R,
    t,
    max_dist: float,
    proxy_radius: int,
    huber_delta: float | None = None,
) -> torch.Tensor:
    """One point-to-plane linearization against raw target points -> (29,)
    float32 stats, as :func:`point_stats` but on a packed grid of slot width
    6 (xyz + normal) and a proxy map with normals. CUDA tensors launch the
    kernel and add one to ``plane_point_stats.launches``."""
    return _stats("plane_pt", plane_point_stats, plane_point_stats_reference, False, pg, proxy,
                  src, w, R, t, max_dist, proxy_radius, huber_delta)


def point_stats_batched(pg: PackedPointGrid, proxy: ProxyMap, src: torch.Tensor,
                        w: torch.Tensor, R, t, max_dist: float, proxy_radius: int,
                        huber_delta: float | None = None) -> torch.Tensor:
    """:func:`point_stats` of B problems against one target in one launch
    -> (B, 29) float32 stats on the device of ``src``.

    ``src`` (B, n, 3) and ``w`` (B, n) hold each problem's scan and weights,
    ``R`` (B, 3, 3) and ``t`` (B, 3) its pose (host values, copied to the
    card as pose rows). Row b equals the single wrapper's stats of problem b. CPU tensors take the plain
    version; CUDA tensors launch the kernel once, with the problems along the
    grid's y dimension, and add one to ``point_stats_batched.launches``.
    """
    return _stats("point", point_stats_batched, point_stats_batched_reference, True, pg, proxy,
                  src, w, R, t, max_dist, proxy_radius, huber_delta)


def plane_point_stats_batched(pg: PackedPointGrid, proxy: ProxyMap, src: torch.Tensor,
                              w: torch.Tensor, R, t, max_dist: float, proxy_radius: int,
                              huber_delta: float | None = None) -> torch.Tensor:
    """:func:`plane_point_stats` of B problems in one launch -> (B, 29), as
    :func:`point_stats_batched`. CUDA tensors add one to
    ``plane_point_stats_batched.launches``."""
    return _stats("plane_pt", plane_point_stats_batched, plane_point_stats_batched_reference,
                  True, pg, proxy, src, w, R, t, max_dist, proxy_radius, huber_delta)


point_stats.launches = 0
plane_point_stats.launches = 0
point_stats_batched.launches = 0
plane_point_stats_batched.launches = 0
