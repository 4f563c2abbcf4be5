"""The voxel maps' cell index and the packed grid's per-cell proxy table
(counterparts of the constants of ``point_cloud_registration_tpu/ops/knn.py``
and of its ``dense_blocks_from_dense``), the window search the kernels' plain
versions share, and the brute-force nearest-neighbour oracles.

The TPU kernels read blocked planar tables shaped for region DMAs and MXU
one-hot gathers. A CUDA thread reads rows straight from global memory, so the
port keeps float32 rows in linear-key order (``key = x + nx * (y + ny * z)``).

The voxel maps of VPlaneICP and NDT keep only the valid cells, behind an
occupancy bitmap (:class:`CellIndex`, :func:`cell_index`), their centroids
and features in two arrays: at bench size 32,893 of 840,000 cells are valid,
so a probe of an empty cell costs one bit instead of a 16-byte row, and the
centroids that the search reads lie 16 bytes apart, two to a 32-byte sector,
in 0.5 MB.

The packed grid's proxy map (``ops/pointgrid.py``) keeps one row per cell of
its grid (:func:`cell_table`)::

    [mu_x, mu_y, mu_z, valid, n_x, n_y, n_z, 0]    (8 floats)

A probe is one 16-byte load of the centroid and the validity flag; the
normal is a second 16-byte load, made only for the winning cell.

The hashed grid's queries (``ops/hashgrid.build_grid``) are plain torch ops,
as the JAX package leaves them to XLA: :func:`nearest_voxel` (nearest valid
centroid of a hashed voxel map), :func:`nearest_point` (gated 1-NN over the
CSR buckets of raw points) and :func:`knn_points` (k-NN over them). Each
visits the cells of ``hashgrid.search_offsets`` in their order and, within a
cell, the first ``cap`` points of its bucket; the first minimum in that order
wins (the JAX package's strict ``<`` over a sequential scan). The CSR scans
lay out only the candidates they scan, enumerated (query, offset, bucket
position), so the first minimum is the smallest enumeration position among
the minima, and a stable sort keeps that order among equal distances.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from point_cloud_registration_tpu_torch.ops.hashgrid import (  # noqa: F401 (CELL_CLAMP)
    CELL_CLAMP,
    Buckets,
    Grid,
    coords_to_key,
    lookup_slots,
    query_cells,
)

# Finite miss sentinel of the JAX tables, kept for API parity: a squared
# distance of at least FOUND_MAX**2 means "no valid cell was found".
MISS_COORD = np.float32(1e30)
FOUND_MAX = np.float32(1e14)
# Candidates of one chunk of a CSR scan: 2**22 hold 50 MB of coordinates
# (and about four times that in indices and distances on the way).
SCAN_BUDGET = 1 << 22
# Queries per chunk of nearest_voxel: 2**15 x 125 window cells.
VOXEL_CHUNK = 1 << 15

TABLE_WIDTH = 8
WORD_BITS = 32  # cells per word of the occupancy bitmap
# CellIndex.feats widths for normals (3) and u6 (6): whole 16-byte loads
FEAT_WIDTHS = {3: 4, 6: 8}


def cell_table(means: torch.Tensor, valid: torch.Tensor,
               normals: torch.Tensor) -> torch.Tensor:
    """The (D, 8) per-cell float32 table in linear-key order (see module
    doc) of ``means`` (D, 3), ``valid`` (D,) bool and ``normals`` (D, 3).

    Invalid cells keep their centroid but carry ``valid = 0``, and the
    kernels skip them; their normals are zero.
    """
    table = torch.zeros((means.shape[0], TABLE_WIDTH), dtype=torch.float32, device=means.device)
    table[:, 0:3] = means
    table[:, 3] = valid.to(torch.float32)
    table[:, 4:7] = torch.where(valid[:, None], normals, torch.zeros_like(normals))
    return table


class CellIndex(NamedTuple):
    """The valid cells of a dense grid of ``D`` cells, for the fused kernels.

    ``occ`` (W, 2) int32, ``W = ceil(D / 32)``: per word ``w``, the bits of
    cells ``32 w .. 32 w + 31`` (bit ``b`` set when cell ``32 w + b`` is
    valid; the int32 holds the unsigned pattern) and the rank, the number of
    valid cells before the word. ``centers`` (V + 1, 4) float32: ``[mu, 1]``
    of the V valid cells in key order, then a sentinel ``[0, 0, 0, 0]``
    (``valid = 0``). ``feats`` (V + 1, 4) ``[n, 0]`` or (V + 1, 8)
    ``[u00, u01, u02, u11, u12, u22, 0, 0]`` float32, the same rows, zero on
    the sentinel. The row of a valid cell ``key`` is
    ``rank[key >> 5] + popcount(bits[key >> 5] & ((1 << (key & 31)) - 1))``.
    """

    occ: torch.Tensor
    centers: torch.Tensor
    feats: torch.Tensor


def cell_index(means: torch.Tensor, valid: torch.Tensor,
               feats: torch.Tensor) -> CellIndex:
    """:class:`CellIndex` of a per-cell map: ``means`` (D, 3), ``valid``
    (D,) bool and ``feats`` (D, 3) normals or (D, 6) ``u6``
    ``[u00, u01, u02, u11, u12, u22]``, in linear-key order."""
    dev = valid.device
    d = valid.shape[0]
    n_words = -(-d // WORD_BITS)
    bits = torch.zeros(n_words * WORD_BITS, dtype=torch.int64, device=dev)
    bits[:d] = valid.to(torch.int64)
    bits = bits.reshape(n_words, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=dev)
    words = (bits << shifts).sum(dim=1)  # unsigned, < 2**32
    counts = bits.sum(dim=1)
    rank = torch.cumsum(counts, dim=0) - counts
    occ = torch.stack([torch.where(words >= 1 << 31, words - (1 << 32), words),
                       rank], dim=1).to(torch.int32)
    keep = torch.nonzero(valid)[:, 0]
    n_valid, f = keep.numel(), feats.shape[1]
    centers = torch.zeros((n_valid + 1, 4), dtype=torch.float32, device=dev)
    centers[:n_valid, 0:3] = means[keep]
    centers[:n_valid, 3] = 1.0
    out = torch.zeros((n_valid + 1, FEAT_WIDTHS[f]), dtype=torch.float32, device=dev)
    out[:n_valid, 0:f] = feats[keep]
    return CellIndex(occ=occ.contiguous(), centers=centers, feats=out)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 in ``[0, 2**32)``."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def compact_rows(occ: torch.Tensor, key: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Row in :attr:`CellIndex.centers` (and ``feats``) of each cell ``key``
    (int64, in the grid): ``rank + popcount`` for a valid cell,
    ``sentinel`` otherwise."""
    word = occ[key >> 5].to(torch.int64)
    bits = word[..., 0] & 0xFFFFFFFF
    b = key & 31
    row = word[..., 1] + _popcount32(bits & ((1 << b) - 1))
    return torch.where(((bits >> b) & 1) == 1, row, torch.full_like(row, sentinel))


def window_radius(max_dist: float, cell_size: float) -> int:
    """Probe radius in cells that covers ``max_dist`` (fused_align.py:670)."""
    return int(np.ceil(max_dist / cell_size - 1e-9))


def window_offsets(radius: int, device=None) -> torch.Tensor:
    """(K, 3) int64 cell offsets of the probe window, x fastest, z slowest."""
    r = torch.arange(-radius, radius + 1, device=device)
    oz, oy, ox = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], dim=-1)


def nearest_valid_cell(
    table: torch.Tensor,
    dims,
    cell: torch.Tensor,
    q: torch.Tensor,
    radius: int,
    chunk: int = 8192,
    occ: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid cell centroid of each query within its probe window.

    ``table`` holds rows whose first four columns are ``[mu, valid]``: one
    per cell in linear-key order (:func:`cell_table`) or, with ``occ``, the
    centers of a :class:`CellIndex` (``table = centers``), which the bitmap
    ``occ`` maps cells to. ``cell`` (N, 3) int64 holds the queries' cells
    relative to the grid's origin. Every cell of the window is probed, x
    fastest and z slowest, and the first minimum wins (``argmin``), as in
    the kernels. Returns ``(best_d2, best_row)``, ``best_row`` indexing
    ``table``; ``best_d2`` is ``inf`` where the window holds no valid cell,
    and ``best_row`` is then meaningless. Queries go in chunks of ``chunk``
    so that the (chunk, K, 4) candidate block stays small on the card.
    """
    dev = q.device
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)
    nx, ny = int(dims[0]), int(dims[1])
    offs = window_offsets(radius, dev)
    n = q.shape[0]
    best_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    best_row = torch.empty(n, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        c = cell[s:s + chunk, None, :] + offs[None]  # (M, K, 3)
        inb = ((c >= 0) & (c < dims_t)).all(dim=-1)
        key = c[..., 0] + nx * (c[..., 1] + ny * c[..., 2])
        key = torch.where(inb, key, torch.zeros_like(key))
        row = key if occ is None else compact_rows(occ, key, table.shape[0] - 1)
        rows = table[row, :4]  # (M, K, 4): centroid + valid flag
        d = q[s:s + chunk, None, :] - rows[..., :3]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        d2 = torch.where(inb & (rows[..., 3] > 0), d2, torch.full_like(d2, float("inf")))
        arg = torch.argmin(d2, dim=1)  # first minimum in probe order
        best_d2[s:s + chunk] = torch.gather(d2, 1, arg[:, None])[:, 0]
        best_row[s:s + chunk] = torch.gather(row, 1, arg[:, None])[:, 0]
    return best_d2, best_row


def brute_force_nn(query: torch.Tensor, ref: torch.Tensor, ref_valid: torch.Tensor | None = None,
                   tile: int = 4096, chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN by tiled exhaustive search (knn.py:535, the validation
    oracle): ``(dist (Nq,) f32, idx (Nq,) i32)``, the first index on ties,
    ``inf`` and -1 when no reference is valid. References go in tiles of
    ``tile`` and queries in chunks of ``chunk``, so the distance block stays
    at ``chunk * tile`` floats."""
    dev = query.device
    nq, nr = query.shape[0], ref.shape[0]
    best_d2 = torch.full((nq,), float("inf"), dtype=torch.float32, device=dev)
    best_idx = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    for a in range(0, nq, chunk):
        q = query[a:a + chunk]
        bd, bi = best_d2[a:a + chunk], best_idx[a:a + chunk]
        for s in range(0, nr, tile):
            diff = q[:, None, :] - ref[None, s:s + tile, :]
            d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                  + diff[..., 2] * diff[..., 2])
            if ref_valid is not None:
                d2 = torch.where(ref_valid[None, s:s + tile], d2, float("inf"))
            ti = torch.argmin(d2, dim=1)  # first minimum
            td = torch.gather(d2, 1, ti[:, None])[:, 0]
            better = td < bd
            bd.copy_(torch.where(better, td, bd))
            bi.copy_(torch.where(better, (ti + s).to(torch.int32), bi))
    return torch.sqrt(best_d2), best_idx


def brute_force_knn(query: torch.Tensor, ref: torch.Tensor, k: int,
                    chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by chunked exhaustive search (knn.py:568, the validation
    oracle): ``(dist (Nq, k) ascending, idx (Nq, k) i32)``; among equal
    distances the lower index comes first, as ``lax.top_k`` gives it. The
    distance block is ``chunk * len(ref)`` floats."""
    dists, idxs = [], []
    ar = torch.arange(ref.shape[0], dtype=torch.int64, device=ref.device)
    for a in range(0, query.shape[0], chunk):
        diff = query[a:a + chunk, None, :] - ref[None, :, :]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
              + diff[..., 2] * diff[..., 2])
        # float32 bits of a distance >= 0 order as the distance: with the
        # index below them, one int64 key per pair is unique and ranks ties
        key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | ar
        top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        dists.append(torch.sqrt((top >> 32).to(torch.int32).view(torch.float32)))
        idxs.append((top & 0xFFFFFFFF).to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)


class NNResult(NamedTuple):
    dist: torch.Tensor  # (N,) f32: Euclidean distance, inf when no candidate
    idx: torch.Tensor  # (N,) i32: matched slot or point index, -1 when none


def _window_slots(grid: Grid, query: torch.Tensor, offsets) -> torch.Tensor:
    """(N, K) int32 slots of the cells of ``query``'s window (-1: empty or
    outside the grid), in the order of ``offsets`` (K, 3)."""
    off = torch.as_tensor(np.asarray(offsets), dtype=torch.int64, device=query.device)
    cells = query_cells(query, grid.cell_size)[:, None, :] + off[None]
    return lookup_slots(grid, coords_to_key(cells, grid.origin_cell, grid.dims))


def _sq_dist(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``sum((q - c)^2)`` over the last axis, never the GEMM expansion."""
    d = q - c
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _first_min(d2: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row the first minimum of ``d2`` (M, L) and its ``idx``: ``(inf,
    -1)`` where no entry is finite (no candidate, or a NaN query)."""
    arg = torch.argmin(d2, dim=1, keepdim=True)
    best = torch.gather(d2, 1, arg)[:, 0]
    found = best < float("inf")
    best = torch.where(found, best, torch.full_like(best, float("inf")))
    won = torch.gather(idx, 1, arg)[:, 0].to(torch.int32)
    return best, torch.where(found, won, torch.full_like(won, -1))


def nearest_voxel(grid: Grid, means: torch.Tensor, valid: torch.Tensor, query: torch.Tensor,
                  offsets) -> NNResult:
    """Nearest valid voxel centroid within the offset window (knn.py:78):
    ``means`` (C, 3) and ``valid`` (C,) per slot; returns the winning slot.
    Queries go in chunks of ``VOXEL_CHUNK``."""
    n, dev, chunk = query.shape[0], query.device, VOXEL_CHUNK
    best_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    best_slot = torch.empty(n, dtype=torch.int32, device=dev)
    for a in range(0, n, chunk):
        q = query[a:a + chunk]
        slot = _window_slots(grid, q, offsets)
        safe = slot.clamp(0, means.shape[0] - 1).to(torch.int64)
        d2 = _sq_dist(q[:, None, :], means[safe])
        d2 = torch.where((slot >= 0) & valid[safe], d2, torch.full_like(d2, float("inf")))
        best_d2[a:a + chunk], best_slot[a:a + chunk] = _first_min(d2, slot)
    return NNResult(dist=torch.sqrt(best_d2), idx=best_slot)


def _ragged_candidates(buckets: Buckets, points: torch.Tensor, q: torch.Tensor,
                       slot: torch.Tensor, cap: int):
    """The scanned candidates of the queries ``q`` (M, 3) in their window
    slots ``slot`` (M, K): each (query, offset) pair holds ``min(count,
    cap)`` of them, enumerated (query, offset, bucket position), the probe
    order. Returns ``(qi, d2, pidx)``: each candidate's query, squared
    distance (NaN as ``inf``) and point index (int64)."""
    dev = q.device
    m, n_off = slot.shape
    slot = slot.reshape(-1)
    safe = slot.clamp(0, buckets.starts.shape[0] - 1).to(torch.int64)
    rep = torch.where(slot >= 0, buckets.counts[safe], torch.zeros_like(slot)).clamp(max=cap)
    rep = rep.to(torch.int64)
    pair = torch.repeat_interleave(torch.arange(m * n_off, device=dev), rep)
    first_of_pair = torch.cumsum(rep, dim=0) - rep
    pos = buckets.starts[safe].to(torch.int64)[pair] + (
        torch.arange(pair.shape[0], device=dev) - first_of_pair[pair])
    pidx = buckets.perm[pos].to(torch.int64)
    qi = torch.div(pair, n_off, rounding_mode="floor")
    d2 = _sq_dist(q[qi], points[pidx])
    return qi, torch.where(torch.isnan(d2), torch.full_like(d2, float("inf")), d2), pidx


def _scan_chunks(grid: Grid, buckets: Buckets, query: torch.Tensor, offsets, cap: int):
    """``(slot (N, K), overflow (N,), chunk)``: the window slots of every
    query, whether a window holds a cell of more than ``cap`` points, and
    the queries per chunk that keep a chunk's scanned candidates under
    ``SCAN_BUDGET`` (one host read of their count)."""
    slot = _window_slots(grid, query, offsets)
    safe = slot.clamp(0, buckets.starts.shape[0] - 1).to(torch.int64)
    count = torch.where(slot >= 0, buckets.counts[safe], torch.zeros_like(slot))
    n_chunks = max(1, -(-int(count.clamp(max=cap).sum()) // SCAN_BUDGET))
    return slot, (count > cap).any(dim=1), max(1, -(-query.shape[0] // n_chunks))


def nearest_point(grid: Grid, buckets: Buckets, points: torch.Tensor, query: torch.Tensor,
                  offsets, cap: int, with_overflow: bool = False):
    """Gated 1-NN over raw points through the CSR buckets (knn.py:410).

    A cell contributes the first ``cap`` points of its bucket, in their input
    order. ``with_overflow`` also returns a per-query bool: the window touched
    a cell of more than ``cap`` points, so the match is not provably the
    nearest. Only the scanned candidates are laid out (a window's empty cells
    and a bucket's unused cap cost nothing); a query's first minimum is its
    smallest enumeration position among its minima."""
    n, dev = query.shape[0], query.device
    slot, over, chunk = _scan_chunks(grid, buckets, query, offsets, cap)
    best_d2 = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    best_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for a in range(0, n, chunk):
        qi, d2, pidx = _ragged_candidates(buckets, points, query[a:a + chunk],
                                          slot[a:a + chunk], cap)
        if d2.numel() == 0:
            continue
        m = slot[a:a + chunk].shape[0]
        best = torch.full((m,), float("inf"), dtype=torch.float32, device=dev)
        best = best.scatter_reduce(0, qi, d2, "amin")
        hit = (d2 == best[qi]) & (d2 < float("inf"))
        first = torch.full((m,), d2.numel(), dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, qi[hit], torch.arange(d2.numel(), device=dev)[hit],
                                     "amin")
        best_d2[a:a + chunk] = best
        best_idx[a:a + chunk] = torch.where(first < d2.numel(),
                                            pidx[first.clamp(max=d2.numel() - 1)], -1).int()
    res = NNResult(dist=torch.sqrt(best_d2), idx=best_idx)
    return (res, over) if with_overflow else res


def knn_points(grid: Grid, buckets: Buckets, points: torch.Tensor, query: torch.Tensor,
               offsets, cap: int, k: int, with_overflow: bool = False):
    """k-NN over raw points: ``(dist (N, k), idx (N, k) int32)`` ascending
    (knn.py:472), ``inf`` and -1 past the candidates found. Ties keep the
    probe order (offset, then bucket position), as ``lax.top_k`` keeps the
    lower position: two stable sorts, by distance and then by query.
    ``with_overflow`` as in :func:`nearest_point`."""
    n, dev = query.shape[0], query.device
    slot, over, chunk = _scan_chunks(grid, buckets, query, offsets, cap)
    dist = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    for a in range(0, n, chunk):
        qi, d2, pidx = _ragged_candidates(buckets, points, query[a:a + chunk],
                                          slot[a:a + chunk], cap)
        order = torch.sort(d2, stable=True).indices
        order = order[torch.sort(qi[order], stable=True).indices]
        qs, ds, ps = qi[order], d2[order], pidx[order]
        per_query = torch.bincount(qs, minlength=slot[a:a + chunk].shape[0])
        rank = torch.arange(qs.shape[0], device=dev) - (torch.cumsum(per_query, 0) - per_query)[qs]
        keep = (rank < k) & (ds < float("inf"))
        dist[a + qs[keep], rank[keep]] = torch.sqrt(ds[keep])
        idx[a + qs[keep], rank[keep]] = ps[keep].to(torch.int32)
    return (dist, idx, over) if with_overflow else (dist, idx)
