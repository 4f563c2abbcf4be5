"""The steps of ``ops/normals.py::estimate_normals`` around the k-NN moments
kernel, on the card with no host read after the cell size
(``csrc/normals_chain.cu``):

* :func:`sampled_median`: the radius sampler's median k-th-NN distance, in
  one launch (the cell size, the one value the host reads);
* :func:`tail_lists`: the lists of the wide tier's queries and of the
  fallback's points, compacted on the card in index order;
* :func:`eig_normals`: each point's normal from its covariance;
* :func:`fallback_normals`: the normals of the points whose box held fewer
  than k candidates, from their k nearest in a wider window.

Each wrapper runs its plain PyTorch version (``*_reference``, the code that
``estimate_normals`` ran on the host's schedule before) for CPU tensors, and the kernel for
CUDA tensors of every shape, adding one to its ``launches``. There is no
fallback between the two. On the card the kernels give the plain versions'
bits, with one exception: the fallback's sums from k = 64 on keep the order
that ATen's reduction takes below 64 (ATen's own changes with k and the number
of points), so there its normals agree with the plain version's to rounding.

The sampler takes one of two ways to each query's k-th distance, chosen by
:func:`sample_plan`: tiles of references with each query's k smallest in
registers (``k <= SAMPLE_MAX_K`` and a scratch of at most
``SAMPLE_PART_MAX`` floats), else a radix select over all the references, a
block a query. Above 2**18 points ``sample_knn_radius`` scales ``k`` down to
``max(2, ceil(k * 2**17 / n))``, so there any ``k`` up to 64 takes the tiles.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from point_cloud_registration_tpu_torch.ops.eigh3 import smallest_eigvec_sym3
from point_cloud_registration_tpu_torch.ops.kernels._build import load_library
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import require_cuda
from point_cloud_registration_tpu_torch.ops.pointgrid import PackedPointGrid, _knn_window_pass

SAMPLE_TILE = 1024  # references of one block of the sampler's tiles
SAMPLE_MAX_K = 32  # the tiles' lists in registers
SAMPLE_PART_MAX = 1 << 25  # the tiles' scratch, floats
SAMPLE_MAX_GROUPS = 65535  # the tiles' groups of 256 queries (the grid's second axis)
TILE = 2048  # positions of one compaction tile (csrc/compact.cuh)
FALLBACK_BLOCKS = 264  # the fallback's blocks, each with a scratch of 5 k words


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the entry points of a build of
    ``csrc/normals_chain.cu``."""
    c_int, c_ll, c_float, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
    lib.pcr_normals_sample.argtypes = [c_ptr, c_ptr, c_int, c_ptr, c_int, c_int, c_ptr, c_ptr,
                                       c_ptr, c_ptr]
    lib.pcr_normals_tails.argtypes = [c_ptr, c_int, c_float, c_int, c_ll, c_ll, c_ptr, c_ptr,
                                      c_ptr, c_ptr, c_ptr, c_ptr]
    lib.pcr_normals_eig.argtypes = [c_ptr, c_ll, c_int, c_ptr, c_ptr]
    lib.pcr_normals_fallback.argtypes = (
        [c_ptr, c_ptr] + [c_int] * 6 + [c_ll] * 3 + [c_float, c_int]  # the packed grid
        + [c_ptr, c_ptr, c_ptr, c_int, c_int, c_ptr]  # points, un, count, cap_q, k, scratch
        + [c_ptr, c_ptr]  # normals, stream
    )
    for fn in (lib.pcr_normals_sample, lib.pcr_normals_tails, lib.pcr_normals_eig,
               lib.pcr_normals_fallback):
        fn.restype = c_int
    lib.pcr_normals_sample_part_max.restype = ctypes.c_longlong
    if ((lib.pcr_normals_sample_tile(), lib.pcr_normals_sample_max_k(),
         lib.pcr_normals_sample_part_max(), lib.pcr_normals_tile_size(),
         lib.pcr_normals_fallback_blocks())
            != (SAMPLE_TILE, SAMPLE_MAX_K, SAMPLE_PART_MAX, TILE, FALLBACK_BLOCKS)):
        raise RuntimeError("csrc/normals_chain.cu was built for other limits or tiles")
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(load_library("normals_chain"))


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: code {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --- the radius sampler -------------------------------------------------------


def sampled_knn_reference(queries: torch.Tensor, points: torch.Tensor, k: int,
                          tile: int = 16384) -> torch.Tensor:
    """Exact k smallest distances of a few queries against a big cloud, one
    reference tile at a time: (nq, k) ascending."""
    best_d2 = torch.full((queries.shape[0], k), float("inf"), dtype=torch.float32,
                         device=queries.device)
    for s in range(0, points.shape[0], tile):
        diff = queries[:, None, :] - points[None, s:s + tile, :]
        d2 = torch.sum(diff * diff, dim=-1)
        best_d2 = torch.topk(torch.cat([best_d2, d2], dim=1), k, dim=1, largest=False,
                             sorted=True).values
    return torch.sqrt(best_d2)


def sampled_median_reference(points: torch.Tensor, sel: torch.Tensor, ref: torch.Tensor | None,
                             k: int) -> float:
    """Plain version of :func:`sampled_median`."""
    refs = points if ref is None else points[ref]
    kth = torch.sort(sampled_knn_reference(points[sel], refs, k)[:, -1]).values
    m = kth.shape[0]
    return float((kth[(m - 1) // 2] + kth[m // 2]) * 0.5)


def sample_plan(m: int, n_ref: int, k: int) -> str:
    """The sampler's way to the k-th distances of ``m`` queries over
    ``n_ref`` references: ``"tiles"`` (each query's k smallest in registers,
    a tile of references a block, then a merge) where ``k`` fits the
    registers and the tiles' lists fit the scratch (and the queries the
    grid), else ``"select"`` (a
    radix select over all the references, a block a query)."""
    if (k <= SAMPLE_MAX_K and m <= SAMPLE_MAX_GROUPS * 256
            and m * -(-n_ref // SAMPLE_TILE) * k <= SAMPLE_PART_MAX):
        return "tiles"
    return "select"


def sampled_median(points: torch.Tensor, sel: torch.Tensor, ref: torch.Tensor | None,
                   k: int) -> float:
    """The median over the queries ``points[sel]`` of the distance to their
    ``k``-th nearest reference, ``points[ref]`` (``points`` itself when
    ``ref`` is None), as a host float: sorted, the mean of the two middle
    values in float32. ``sel`` and ``ref`` are int64 on the device of
    ``points`` (N, 3). On the card: one launch (each query's k-th distance
    by the way :func:`sample_plan` picks, then the median), one read of the
    result."""
    if points.device.type == "cpu":
        return sampled_median_reference(points, sel, ref, k)
    require_cuda(points)
    m = sel.shape[0]
    n_ref = points.shape[0] if ref is None else ref.shape[0]
    if k < 1 or m < 1 or n_ref < 1:
        raise ValueError(f"the sampler needs k, queries and references, got k = {k}, "
                         f"{m} queries, {n_ref} references")
    points = points.contiguous()
    dev = points.device
    part = None
    if sample_plan(m, n_ref, k) == "tiles":
        part = torch.empty(m * -(-n_ref // SAMPLE_TILE) * k, dtype=torch.float32, device=dev)
    kth = torch.empty(m, dtype=torch.float32, device=dev)
    median = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _library().pcr_normals_sample(
            points.data_ptr(), sel.data_ptr(), m, None if ref is None else ref.data_ptr(), n_ref,
            k, None if part is None else part.data_ptr(), kth.data_ptr(), median.data_ptr(),
            _stream(points))
    _launched(rc, "sampled_median")
    sampled_median.launches += 1
    return float(median.item())


sampled_median.launches = 0


# --- the lists of the wide tier and of the fallback ---------------------------


def tail_lists_reference(out: torch.Tensor, cert: float | None, cap_t: int, cap_q: int):
    """Plain version of :func:`tail_lists`; its lists are no longer than
    their counts."""
    unres, exact = out[8] > 0, out[9] > 0
    tail = (torch.nonzero(~exact & ~unres & (out[7] < cert))[:, 0] if cert is not None
            else torch.zeros(0, dtype=torch.int64, device=out.device))
    un = torch.nonzero(unres)[:, 0]
    totals = torch.tensor([tail.numel(), un.numel()], dtype=torch.int32, device=out.device)
    return tail[:cap_t], un[:cap_q], totals


def tail_lists(out: torch.Tensor, cert: float | None, cap_t: int, cap_q: int):
    """From the base tier's planar outputs ``out`` (10, N)
    (``knn_normals.knn_moments_out``): ``(tail (cap_t,), un (cap_q,), totals
    (2,) int32)``, the first ``cap_t`` points of the wide tier's queries,
    ``~exact & ~unresolved & (rk2 < cert)`` (none if ``cert`` is None), and
    the first ``cap_q`` unresolved points, both int64 in index order as
    ``torch.nonzero(...)[:cap]`` lists them, and the whole count of each. On
    the card: one launch, nothing read by the host; a list's entries beyond
    its count are not written."""
    if out.device.type == "cpu":
        return tail_lists_reference(out, cert, cap_t, cap_q)
    require_cuda(out)
    if (out.dtype != torch.float32 or out.dim() != 2 or out.shape[0] != 10
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 (10, N) tensor, got {out.dtype} "
                         f"{tuple(out.shape)}")
    n, dev = out.shape[1], out.device
    tail = torch.empty(cap_t, dtype=torch.int64, device=dev)
    un = torch.empty(cap_q, dtype=torch.int64, device=dev)
    totals = torch.zeros(2, dtype=torch.int32, device=dev) if n == 0 else torch.empty(
        2, dtype=torch.int32, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    tile_counts = torch.empty(2 * -(-n // TILE), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _library().pcr_normals_tails(
            out.data_ptr(), n, float(-np.inf if cert is None else cert), int(cert is not None),
            cap_t, cap_q, flags.data_ptr(), tile_counts.data_ptr(), tail.data_ptr(),
            un.data_ptr(), totals.data_ptr(), _stream(out))
    _launched(rc, "tail_lists")
    tail_lists.launches += 1
    return tail, un, totals


tail_lists.launches = 0


# --- the eigensolve -----------------------------------------------------------


def eig_normals_reference(out: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`eig_normals`."""
    return smallest_eigvec_sym3(out[0:6].T.contiguous())


def eig_normals(out: torch.Tensor) -> torch.Tensor:
    """(N, 3) unit normals from the covariance rows c00 c11 c22 c01 c02 c12
    of the planar ``out`` (>= 6, N): ``ops.eigh3.smallest_eigvec_sym3`` of
    each, on the card in one launch with its bits."""
    if out.device.type == "cpu":
        return eig_normals_reference(out)
    require_cuda(out)
    if out.dtype != torch.float32 or out.dim() != 2 or out.shape[0] < 6 or out.stride(1) != 1:
        raise ValueError(f"out must be a float32 (>= 6, N) tensor of unit column stride, got "
                         f"{out.dtype} {tuple(out.shape)}")
    n = out.shape[1]
    normals = torch.empty((n, 3), dtype=torch.float32, device=out.device)
    with torch.cuda.device(out.device):
        rc = _library().pcr_normals_eig(out.data_ptr(), out.stride(0), n, normals.data_ptr(),
                                        _stream(out))
    _launched(rc, "eig_normals")
    eig_normals.launches += 1
    return normals


eig_normals.launches = 0


# --- the fallback -------------------------------------------------------------


def fallback_normals_reference(pg: PackedPointGrid, points: torch.Tensor, un: torch.Tensor,
                               count: torch.Tensor, k: int, radius: int,
                               normals: torch.Tensor) -> None:
    """Plain version of :func:`fallback_normals` (it reads the count)."""
    from point_cloud_registration_tpu_torch.ops.normals import normals_from_neighbors

    live = un[:int(count[0])]
    if live.numel():
        q = points[live]
        _, wi = _knn_window_pass(pg, q, k, radius=radius, chunk=min(un.shape[0], 2048))
        normals[live] = normals_from_neighbors(points, wi, q)


def fallback_normals(pg: PackedPointGrid, points: torch.Tensor, un: torch.Tensor,
                     count: torch.Tensor, k: int, radius: int, normals: torch.Tensor) -> None:
    """The normals of the points ``un[:c]``, ``c = min(count, len(un))``
    (``count`` (1,) int32), written into ``normals`` (N, 3) in place: each
    point's ``k`` nearest in the fine-cell window of ``radius``
    (``pointgrid._knn_window_pass``) and their query-centred moments
    (``normals.normals_from_neighbors``). On the card: one launch, which
    does nothing when ``c`` is 0, and nothing read by the host."""
    if points.device.type == "cpu":
        fallback_normals_reference(pg, points, un, count, k, radius, normals)
        return
    require_cuda(points)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    for name, x, dtype in (("points", points, torch.float32), ("un", un, torch.int64),
                           ("count", count, torch.int32), ("normals", normals, torch.float32)):
        if x.device != points.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {points.device}")
    scratch = torch.empty(min(un.shape[0], FALLBACK_BLOCKS) * 5 * k, dtype=torch.int32,
                          device=points.device)
    with torch.cuda.device(points.device):
        rc = _library().pcr_normals_fallback(
            pg.pts_packed.data_ptr(), pg.block_row.data_ptr(), pg.cap, pg.width,
            *(int(d) for d in pg.nb_dims), pg.pts_packed.shape[0] - 1,
            *(int(o) for o in pg.origin_fine), float(np.float32(pg.cell_fine)), int(radius),
            points.data_ptr(), un.data_ptr(), count.data_ptr(), un.shape[0], int(k),
            scratch.data_ptr(), normals.data_ptr(), _stream(points))
    _launched(rc, "fallback_normals")
    fallback_normals.launches += 1


fallback_normals.launches = 0
