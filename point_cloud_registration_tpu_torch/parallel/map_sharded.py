"""Map-sharded alignment: voxel maps split into slabs across ranks
(counterpart of ``point_cloud_registration_tpu/parallel/map_sharded.py``).

* The global cell grid is split into ``n_shards`` equal slabs along one
  axis (z for :func:`shard_voxel_map`, the widest axis of the box for
  :func:`shard_voxel_map_on_mesh` by default). Each rank on the mesh's
  ``model`` axis holds one slab: a dense
  :class:`~point_cloud_registration_tpu_torch.ops.voxelize.VoxelMap` of the
  slab's cells whose ``origin_cell`` is the slab's global origin, with its
  own cell index. A rank's map memory is 1/S of the map's.
* Per Gauss-Newton iteration, each rank queries the scan points whose
  window overlaps its slab (``query_nearest_voxel``, every cell within
  ``max_dist``), a MIN all-reduce over ``model`` elects each query's
  nearest voxel, a second MIN keeps the lowest rank on exact ties, and the
  winner's plain ``plane_stats`` / ``ndt_stats`` (``ops/reduce.py``) are
  summed by one all-reduce over the whole mesh. As in the JAX package, no
  kernel runs here.
* The JAX package's blocked query table (``dense_blocks``) and its
  fixed-capacity query compaction with its overflow fallback serve the
  TPU's static shapes; here a rank selects its queries by a boolean mask
  of any size, so neither has a counterpart.

Exact f32 ties between voxels of two slabs go to the lowest rank; on a
z-split map that is also the whole map's probe order (z slowest).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from point_cloud_registration_tpu_torch.core.device import resolve_device
from point_cloud_registration_tpu_torch.core.gn import gauss_newton
from point_cloud_registration_tpu_torch.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu_torch.models.base import AlignResult
from point_cloud_registration_tpu_torch.ops.hashgrid import _bbox_cells, query_cells
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    packed_from_stats,
    stats_from_packed,
)
from point_cloud_registration_tpu_torch.ops.knn import cell_index, window_radius
from point_cloud_registration_tpu_torch.ops.reduce import ndt_stats, plane_stats
from point_cloud_registration_tpu_torch.ops.voxelize import (
    VoxelMap,
    _build_voxel_map_dense,
    query_nearest_voxel,
    sqrt_icov_u6,
)
from point_cloud_registration_tpu_torch.parallel.mesh import (
    all_reduce,
    axes_rank,
    axis_size,
    device_mesh,
)
from point_cloud_registration_tpu_torch.parallel.sharded import part

_BIG_RANK = 1 << 30


@dataclasses.dataclass(frozen=True)
class ShardedMapMeta:
    """Static geometry of a sharded map."""

    n_shards: int
    dims_slab: tuple[int, int, int]  # cells per slab
    origin_cell: tuple[int, int, int]  # global min cell coordinate
    cell_size: float
    # shard axis: 2 (z) for shard_voxel_map; shard_voxel_map_on_mesh picks
    # the widest bbox axis by default, so slabs are thick relative to
    # max_dist and flat scenes still balance
    axis: int = 2

    @property
    def slab_cells(self) -> int:
        nx, ny, nz = self.dims_slab
        return nx * ny * nz


class ShardedVoxelMap(NamedTuple):
    """The slabs a process holds, by rank on the mesh's ``model`` axis:
    every slab after :func:`shard_voxel_map`, its own after
    :func:`shard_voxel_map_on_mesh`."""

    slabs: dict[int, VoxelMap]


def _slab_origin(meta: ShardedMapMeta, rank: int) -> tuple[int, int, int]:
    """Global origin cell of slab ``rank`` (shifted along ``meta.axis``)."""
    origin = list(meta.origin_cell)
    origin[meta.axis] += rank * meta.dims_slab[meta.axis]
    return tuple(origin)


def _slab_geometry(points, voxel_size: float, n_shards: int, axis):
    """``(meta, points' bbox)`` with the shard axis padded to a multiple of
    ``n_shards`` cells."""
    lo_cell, hi_cell = _bbox_cells(points, voxel_size)
    dims = [int(x) for x in (hi_cell - lo_cell + 1)]
    ax = int(np.argmax(dims)) if axis == "auto" else int(axis)
    ns = -(-dims[ax] // n_shards)
    dims_slab = tuple(ns if i == ax else d for i, d in enumerate(dims))
    return ShardedMapMeta(n_shards=n_shards, dims_slab=dims_slab,
                          origin_cell=tuple(int(x) for x in lo_cell),
                          cell_size=float(voxel_size), axis=ax)


def _rich(with_icov: bool) -> str:
    return "sqrt_icov" if with_icov else "normals"


def shard_voxel_map(points, voxel_size: float, n_shards: int, *, min_points: int = 10,
                    with_icov: bool = False, device=None,
                    ) -> tuple[ShardedVoxelMap, ShardedMapMeta]:
    """Build a z-slab-sharded dense voxel map in one process.

    The global map is built on ``device`` first (default: the tensor's
    device, or the card for NumPy input), with z padded so that slabs are
    uniform, and split into ``n_shards`` slab maps, each with its own cell
    index. For maps beyond one device use :func:`shard_voxel_map_on_mesh`,
    which builds each slab on its own rank.
    """
    meta = _slab_geometry(points, voxel_size, n_shards, 2)
    dims = list(meta.dims_slab)
    dims[2] *= n_shards
    pts = torch.as_tensor(points).to(device=resolve_device(points, device), dtype=torch.float32)
    vm = _build_voxel_map_dense(pts, meta.origin_cell, float(np.float32(voxel_size)),
                                tuple(dims), min_points=min_points, with_icov=with_icov,
                                rich=_rich(with_icov))
    c = meta.slab_cells
    slabs = {}
    for s in range(n_shards):
        rows = slice(s * c, (s + 1) * c)
        icovs = None if vm.icovs is None else vm.icovs[rows]
        means, valid, normals = vm.means[rows], vm.valid[rows], vm.normals[rows]
        slabs[s] = vm._replace(
            origin_cell=_slab_origin(meta, s), dims=meta.dims_slab, means=means,
            covs=vm.covs[rows], normals=normals, counts=vm.counts[rows], valid=valid,
            icovs=icovs,
            cells=cell_index(means, valid, sqrt_icov_u6(icovs) if with_icov else normals))
    return ShardedVoxelMap(slabs=slabs), meta


def shard_voxel_map_on_mesh(points, voxel_size: float, mesh: DeviceMesh, *,
                            min_points: int = 10, with_icov: bool = False,
                            axis: str | int = "auto", device=None,
                            ) -> tuple[ShardedVoxelMap, ShardedMapMeta]:
    """Build a slab-sharded voxel map on the mesh: each rank sums the
    (replicated) points into its own slab only, on ``device`` (default: the
    tensor's device, or the card for NumPy input), so no global dense array
    exists anywhere. Points outside the slab go to the dropped key.

    ``axis="auto"`` splits along the widest axis of the box, so slabs stay
    thick relative to ``max_dist`` and flat scenes balance across ranks.
    Every rank of the mesh calls it, each with the same points.
    """
    n_shards = axis_size(mesh, "model")
    rank = axes_rank(mesh, ("model",))
    meta = _slab_geometry(points, voxel_size, n_shards, axis)
    pts = torch.as_tensor(points).to(device=resolve_device(points, device), dtype=torch.float32)
    vm = _build_voxel_map_dense(pts, _slab_origin(meta, rank), float(np.float32(voxel_size)),
                                meta.dims_slab, min_points=min_points, with_icov=with_icov,
                                rich=_rich(with_icov))
    return ShardedVoxelMap(slabs={rank: vm}), meta


def slab_queries(q: torch.Tensor, w: torch.Tensor, meta: ShardedMapMeta, rank: int,
                 max_dist: float) -> torch.Tensor:
    """Mask of the weighted queries ``q`` whose window (every cell within
    ``max_dist``) reaches slab ``rank``: those whose cell along the shard
    axis lies within the window radius of the slab's cells."""
    radius = window_radius(max_dist, meta.cell_size)
    ns = meta.dims_slab[meta.axis]
    c = query_cells(q, meta.cell_size)[:, meta.axis] - meta.origin_cell[meta.axis]
    return (c >= rank * ns - radius) & (c < (rank + 1) * ns + radius) & (w > 0)


def align_map_sharded(kind: str, svm: ShardedVoxelMap, meta: ShardedMapMeta, source,
                      src_weight, init_T, cfg, mesh: DeviceMesh) -> AlignResult:
    """Align against a map split over the mesh's ``model`` axis.

    ``source`` (N, 3) / ``src_weight`` (N,) are the whole scan, split over
    ``data`` (N must divide by its size; pad with ``models.base.pad_points``)
    and replicated over ``model``. Kinds: ``vplane_icp`` (plane residual
    against the voxel's mean and normal) and ``ndt`` (Mahalanobis, which
    needs a map built ``with_icov``). Returns the same ``AlignResult`` on
    every rank.
    """
    if kind not in ("vplane_icp", "ndt"):
        raise ValueError(f"map sharding supports voxel-map kinds, not {kind!r}")
    if kind == "ndt" and any(vm.icovs is None for vm in svm.slabs.values()):
        raise ValueError(
            "align_map_sharded(kind='ndt') needs per-voxel icovs: build the "
            "map with shard_voxel_map(..., with_icov=True)"
        )
    rank = axes_rank(mesh, ("model",))
    if axis_size(mesh, "model") != meta.n_shards or rank not in svm.slabs:
        raise ValueError(f"model rank {rank} of {axis_size(mesh, 'model')} holds no slab of "
                         f"this {meta.n_shards}-slab map")
    vm = svm.slabs[rank]
    dev = vm.means.device
    nd, di = axis_size(mesh, "data"), axes_rank(mesh, ("data",))
    src = part(source, nd, di).to(device=dev, dtype=torch.float32).contiguous()
    w = part(src_weight, nd, di).to(device=dev, dtype=torch.float32).contiguous()
    n = src.shape[0]
    last = vm.means.shape[0] - 1

    def stats_fn(T):
        Td = T.to(dev)
        R, _ = makeRt(Td)
        q = transform_points(Td, src)
        sel = torch.nonzero(slab_queries(q, w, meta, rank, cfg.max_dist))[:, 0]
        nn = query_nearest_voxel(vm, q[sel], voxel_size=meta.cell_size, max_dist=cfg.max_dist)
        d = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
        idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
        d[sel] = torch.where(nn.idx >= 0, nn.dist, torch.full_like(nn.dist, float("inf")))
        idx[sel] = nn.idx.to(torch.int64)
        d_best = all_reduce(d, mesh, ("model",), dist.ReduceOp.MIN).to(dev)
        win = (d == d_best) & torch.isfinite(d)
        mine = torch.where(win, torch.full_like(idx, rank), torch.full_like(idx, _BIG_RANK))
        first = all_reduce(mine, mesh, ("model",), dist.ReduceOp.MIN).to(dev)
        win = win & (first == rank)
        w_eff = w * win.to(torch.float32) * (d < cfg.max_dist).to(torch.float32)
        safe = idx.clamp(0, last)
        if kind == "vplane_icp":
            st = plane_stats(src, q, vm.means[safe], vm.normals[safe], w_eff, R,
                             huber_delta=cfg.huber_delta)
        else:
            st = ndt_stats(src, q, vm.means[safe], vm.icovs[safe], w_eff, R,
                           huber_delta=cfg.huber_delta)
        return stats_from_packed(all_reduce(packed_from_stats(st), mesh, ("model", "data")).cpu())

    T, diag = gauss_newton(stats_fn, init_T, cfg.max_iter, cfg.tol)
    return AlignResult(T=T, diagnostics=diag)


def make_map_mesh(model: int, data: int | None = None, *,
                  device_type: str = "cuda") -> DeviceMesh:
    """(model, data) mesh for map-sharded alignment, as
    :func:`~point_cloud_registration_tpu_torch.parallel.mesh.make_mesh`."""
    return device_mesh((model, data), ("model", "data"), device_type)
