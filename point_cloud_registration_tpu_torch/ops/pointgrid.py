"""Packed-block point table: gated 1-NN over raw target points (counterpart of
``point_cloud_registration_tpu/ops/pointgrid.py``, the parts ICP's packed
correspondence path runs).

* Target points are bucketed into fine cells of ``cell_fine``; fine cells
  are grouped 2x2x2 into blocks, and each occupied block's points are packed
  into one row of ``cap`` slots (coordinates, +inf padded) with a parallel
  row of original indices (-1 padded).
* Inside a block the points are ordered by a hash of their index
  (pointgrid.py:162-182), so a block with more than ``cap`` points keeps a
  uniform subsample of them. The order, and so every packed row, is the JAX
  package's bit for bit.
* A query probes the 2x2x2 blocks around its fine cell; a best match closer
  than ``cell_fine`` is provably the exact nearest kept point ("resolved").
  Unresolved queries take the nearest centroid of a coarse proxy voxel map
  whose voxels are the blocks themselves (``2 * cell_fine``), built from the
  packed rows.

The TPU mechanism of the JAX build is left out: the phase-shifted gather
packing, the index bitcast into float rows and the power-of-two row padding.
The rows are the occupied blocks in key order plus one sentinel row (all
padding) at the end: no row means no candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from point_cloud_registration_tpu_torch.ops.hashgrid import cell_coords
from point_cloud_registration_tpu_torch.ops.knn import CELL_CLAMP, cell_table, nearest_valid_cell

_BLOCK = 2  # fine cells per block edge
_INT32_MAX = np.iinfo(np.int32).max


class PackedPointGrid(NamedTuple):
    """Packed candidate tables of one target cloud, on one device.

    ``origin_fine`` is rounded down to an even cell so that blocks coincide
    with absolute cells of size ``2 * cell_fine`` (the proxy map's voxels).
    Rows ``0 .. R-1`` are the occupied blocks in key order; row ``R`` is the
    sentinel.
    """

    origin_fine: tuple[int, int, int]  # min fine-cell coordinate (even)
    cell_fine: float  # float32 value
    nb_dims: tuple[int, int, int]  # block-grid dims
    block_row: torch.Tensor  # (NB,) i32 block key -> packed row (-1 empty)
    row_key: torch.Tensor  # (R+1,) i32 packed row -> block key (-1 sentinel)
    pts_packed: torch.Tensor  # (R+1, cap*3) f32 block points, +inf padded
    idx_packed: torch.Tensor  # (R+1, cap) i32 original point indices, -1 padded
    row_over: torch.Tensor  # (R+1,) bool block held > cap points (truncated)
    row_count: torch.Tensor  # (R+1,) i32 points kept in the row, min(size, cap)

    @property
    def cap(self) -> int:
        return self.idx_packed.shape[1]


class ProxyMap(NamedTuple):
    """Coarse proxy voxel map of a packed grid: one voxel per block."""

    origin_cell: tuple[int, int, int]  # origin_fine // 2
    dims: tuple[int, int, int]  # the block-grid dims
    cell_size: float  # 2 * cell_fine, float32 value
    means: torch.Tensor  # (R+1, 3) f32 centroid of each packed row
    counts: torch.Tensor  # (R+1,) i32
    valid: torch.Tensor  # (R+1,) bool, counts >= min_points
    table: torch.Tensor  # (NB, 8) f32 ops.knn.cell_table in block-key order


class PointNN(NamedTuple):
    dist: torch.Tensor  # (N,) f32, inf when nothing was found in the window
    idx: torch.Tensor  # (N,) i64 original target-point index, -1 when none
    resolved: torch.Tensor  # (N,) bool, dist < cell_fine: provably exact
    point: torch.Tensor  # (N, 3) f32 the matched point, inf when none


class PointMatch(NamedTuple):
    """Per-query correspondence (``_point_corr.PointMatch``): ``weight``
    folds the ``dist < max_dist`` gate; ``target`` is the matched raw point
    or, for proxy-resolved queries, the voxel centroid."""

    target: torch.Tensor  # (N, 3)
    weight: torch.Tensor  # (N,) f32 in {0, 1}
    point_idx: torch.Tensor  # (N,) i64 raw target index or -1
    proxy_slot: torch.Tensor  # (N,) i64 proxy row or -1


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wrap-around of int64 values."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def index_hash(n: int, device=None) -> torch.Tensor:
    """(n,) int64 holding the int32 hash of each index (pointgrid.py:173-176):
    wrap-around multiplies and arithmetic shifts, as in the JAX package."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = _wrap_i32((x ^ (x >> 16)) * 0x45D9F3B)
    x = _wrap_i32((x ^ (x >> 16)) * 0x45D9F3B)
    return x ^ (x >> 16)


def _keys_sort_count(points: torch.Tensor, cell_fine: float):
    """Block keys sorted by ``(key, hash of index)``, with the grid geometry
    read on the host in one copy (pointgrid.py:126-197).

    The two keys become one int64, ``(bkey << 32) | h``: the hash's last
    ``x ^ (x >> 16)`` clears the sign bit, so ``h`` lies in [0, 2**31) and
    the int64 orders like the pair. ``h`` is a bijection of the index, so the
    order is total. Returns ``(skey, spts, sidx, lo_fine, nb_dims, n_occ)``.
    """
    dev = points.device
    fine = cell_coords(points, cell_fine).to(torch.int64)
    lo_f = torch.div(fine.amin(dim=0), _BLOCK, rounding_mode="floor") * _BLOCK
    nb = torch.div(fine.amax(dim=0) - lo_f, _BLOCK, rounding_mode="floor") + 1
    b = torch.div(fine - lo_f, _BLOCK, rounding_mode="floor")
    bkeys = b[:, 0] + nb[0] * (b[:, 1] + nb[1] * b[:, 2])
    h = index_hash(points.shape[0], dev)
    order = torch.argsort((bkeys << 32) | h)
    skey = bkeys[order]
    n_occ = (skey[1:] != skey[:-1]).sum() + 1
    meta = torch.cat([lo_f, nb, n_occ[None]]).cpu().tolist()
    return skey, points[order], order, tuple(meta[0:3]), tuple(meta[3:6]), int(meta[6])


def _pack(skey, spts, sidx, n_occ: int, nb_total: int, cap: int):
    """Pack key-sorted points into ``(n_occ + 1)`` rows of ``cap`` slots
    (pointgrid.py:200-307, its row-scatter branch): a block's points are
    contiguous in the sorted order and keep their first ``cap``."""
    dev = spts.device
    n = spts.shape[0]
    r1 = n_occ + 1
    new_block = torch.ones(n, dtype=torch.bool, device=dev)
    new_block[1:] = skey[1:] != skey[:-1]
    starts = torch.nonzero(new_block)[:, 0]  # (n_occ,)
    sizes = torch.diff(starts, append=torch.tensor([n], device=dev))
    row = torch.cumsum(new_block, 0) - 1
    rank = torch.arange(n, device=dev) - starts[row]
    keep = rank < cap
    slot = (row * cap + rank)[keep]
    pts = torch.full((r1 * cap, 3), float("inf"), dtype=torch.float32, device=dev)
    pts[slot] = spts[keep]
    idx = torch.full((r1 * cap,), -1, dtype=torch.int32, device=dev)
    idx[slot] = sidx[keep].to(torch.int32)
    key_at = skey[starts]
    block_row = torch.full((nb_total,), -1, dtype=torch.int32, device=dev)
    block_row[key_at] = torch.arange(n_occ, dtype=torch.int32, device=dev)
    pad_i = torch.tensor([-1], dtype=torch.int32, device=dev)
    row_key = torch.cat([key_at.to(torch.int32), pad_i])
    row_over = torch.cat([sizes > cap, torch.zeros(1, dtype=torch.bool, device=dev)])
    row_count = torch.cat([torch.clamp(sizes, max=cap).to(torch.int32), pad_i + 1])
    return block_row, row_key, pts.reshape(r1, cap * 3), idx.reshape(r1, cap), row_over, row_count


def build_packed_grid(points: torch.Tensor, cell_fine: float, cap: int = 32) -> PackedPointGrid:
    """Packed tables of ``points`` (N, 3) float32 on their device, with one
    host sync for the grid geometry."""
    if points.shape[0] == 0:
        raise ValueError("empty point cloud: at least one point is required")
    cell_fine = float(np.float32(cell_fine))
    skey, spts, sidx, lo_f, nb_dims, n_occ = _keys_sort_count(points, cell_fine)
    nb_total = nb_dims[0] * nb_dims[1] * nb_dims[2]  # Python ints: no wrap
    if nb_total >= _INT32_MAX:
        raise ValueError("block grid exceeds int32 keyspace; increase cell_fine")
    block_row, row_key, pts, idx, row_over, row_count = _pack(
        skey, spts, sidx, n_occ, nb_total, cap
    )
    return PackedPointGrid(
        origin_fine=lo_f, cell_fine=cell_fine, nb_dims=nb_dims, block_row=block_row,
        row_key=row_key, pts_packed=pts, idx_packed=idx, row_over=row_over,
        row_count=row_count,
    )


def proxy_stats_from_packed(pg: PackedPointGrid, *, min_points: int) -> ProxyMap:
    """Proxy voxel map from the packed rows (pointgrid.py:310-369): a block
    is an absolute voxel of size ``2 * cell_fine``. Its statistics see only
    the ``cap`` points the row kept. Normals are not formed (ICP does not
    read them)."""
    r1, cap = pg.idx_packed.shape
    pts = pg.pts_packed.reshape(r1, cap, 3)
    mask = torch.isfinite(pts[..., 0])
    cnt = mask.sum(dim=1).to(torch.int32)
    safe = torch.where(mask[..., None], pts, torch.zeros_like(pts))
    means = safe.sum(dim=1) / torch.clamp(cnt, min=1).to(torch.float32)[:, None]
    return proxy_map(pg, means, cnt, cnt >= min_points)


def proxy_map(pg: PackedPointGrid, means: torch.Tensor, counts: torch.Tensor,
              valid: torch.Tensor) -> ProxyMap:
    """:class:`ProxyMap` of ``pg`` from per-row statistics, with its query
    table in block-key order."""
    nb_total = pg.block_row.shape[0]
    live = pg.row_key[:-1].to(torch.int64)
    means_k = torch.zeros((nb_total, 3), dtype=torch.float32, device=means.device)
    valid_k = torch.zeros(nb_total, dtype=torch.bool, device=means.device)
    means_k[live] = means[:-1]
    valid_k[live] = valid[:-1]
    return ProxyMap(
        origin_cell=tuple(o // _BLOCK for o in pg.origin_fine),
        dims=pg.nb_dims,
        cell_size=float(np.float32(pg.cell_fine) * np.float32(2.0)),
        means=means,
        counts=counts,
        valid=valid,
        table=cell_table(means_k, valid_k, torch.zeros_like(means_k)),
    )


def build_packed_grid_and_proxy(points, cell_fine: float, cap: int, *,
                                min_points: int) -> tuple[PackedPointGrid, ProxyMap]:
    """Packed tables + coarse proxy voxel map (pointgrid.py:385-419)."""
    pg = build_packed_grid(points, cell_fine, cap)
    return pg, proxy_stats_from_packed(pg, min_points=min_points)


def _cells(q: torch.Tensor, cell_size: float, origin) -> torch.Tensor:
    """``floor(q / cell_size) - origin`` as int64, by true division as in
    ``hashgrid.cell_coords`` and clamped like the kernel's cell rule."""
    div = torch.tensor(cell_size, dtype=torch.float32, device=q.device)
    c = torch.floor(q / div).clamp(-CELL_CLAMP, CELL_CLAMP).to(torch.int64)
    return c - torch.tensor(origin, dtype=torch.int64, device=q.device)


def nearest_point_packed(pg: PackedPointGrid, query: torch.Tensor,
                         chunk: int = 8192) -> PointNN:
    """Tier-1 nearest kept point over the 2x2x2 blocks around each query's
    fine cell (pointgrid.py:422-460): blocks in the order ``dbx`` outer,
    ``dbz`` inner, slots in packed order, strict ``<``."""
    dev = query.device
    cap = pg.cap
    sentinel = pg.pts_packed.shape[0] - 1
    nb = torch.tensor(pg.nb_dims, dtype=torch.int64, device=dev)
    nbx, nby = pg.nb_dims[0], pg.nb_dims[1]
    lo_b = torch.div(_cells(query, pg.cell_fine, pg.origin_fine) - 1, _BLOCK,
                     rounding_mode="floor")
    n = query.shape[0]
    best_d2 = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    best_row = torch.full((n,), sentinel, dtype=torch.int64, device=dev)
    best_slot = torch.zeros(n, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        q = query[s:s + chunk]
        d2_best, row_best = best_d2[s:s + chunk], best_row[s:s + chunk]
        slot_best = best_slot[s:s + chunk]
        for dbx in range(2):
            for dby in range(2):
                for dbz in range(2):
                    b3 = lo_b[s:s + chunk] + torch.tensor([dbx, dby, dbz], device=dev)
                    ok = ((b3 >= 0) & (b3 < nb)).all(dim=-1)
                    bkey = b3[:, 0] + nbx * (b3[:, 1] + nby * b3[:, 2])
                    row = pg.block_row[torch.where(ok, bkey, 0)].to(torch.int64)
                    row = torch.where(ok & (row >= 0), row, sentinel)
                    cand = pg.pts_packed[row].reshape(-1, cap, 3)
                    diff = q[:, None, :] - cand
                    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                          + diff[..., 2] * diff[..., 2])
                    arg = torch.argmin(d2, dim=1)
                    d2m = torch.gather(d2, 1, arg[:, None])[:, 0]
                    better = d2m < d2_best
                    d2_best.copy_(torch.where(better, d2m, d2_best))
                    row_best.copy_(torch.where(better, row, row_best))
                    slot_best.copy_(torch.where(better, arg, slot_best))
    idx = pg.idx_packed[best_row, best_slot].to(torch.int64)
    point = pg.pts_packed.reshape(-1, cap, 3)[best_row, best_slot]
    dist = torch.sqrt(best_d2)
    resolved = dist < pg.cell_fine
    return PointNN(dist=dist, idx=torch.where(torch.isfinite(dist), idx, -1),
                   resolved=resolved, point=point)


def match_packed(pg: PackedPointGrid, proxy: ProxyMap, query: torch.Tensor,
                 max_dist: float, proxy_radius: int) -> PointMatch:
    """The packed branch of ``match_points`` (_point_corr.py:150-209): the
    tier-1 match when resolved, else the nearest valid proxy centroid within
    ``proxy_radius`` proxy cells; then the gate ``dist < max_dist``.

    The JAX package re-searches the unresolved queries in data-dependent
    tiers (compacted subset or everything); every tier finds the same
    nearest voxel, so one pass over the unresolved subset replaces them.
    """
    t1 = nearest_point_packed(pg, query)
    unres = torch.nonzero(~t1.resolved)[:, 0]
    q_un = query[unres]
    d2_p, key_p = nearest_valid_cell(
        proxy.table, proxy.dims, _cells(q_un, proxy.cell_size, proxy.origin_cell),
        q_un, proxy_radius,
    )
    found_p = torch.isfinite(d2_p)
    dist = t1.dist.clone()
    dist[unres] = torch.sqrt(d2_p)
    tgt = t1.point.clone()  # the packed copy of points[idx]
    tgt[unres] = proxy.table[key_p, 0:3]
    found = t1.idx >= 0
    found[unres] = found_p
    slot = torch.full_like(t1.idx, -1)
    slot[unres] = torch.where(found_p, pg.block_row[key_p].to(torch.int64), -1)
    point_idx = t1.idx.clone()
    point_idx[unres] = -1
    w = ((dist < max_dist) & found).to(torch.float32)
    return PointMatch(target=tgt, weight=w, point_idx=point_idx, proxy_slot=slot)
