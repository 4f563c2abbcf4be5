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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Finite miss sentinel of the JAX tables, kept for API parity: a squared
# distance of at least FOUND_MAX**2 means "no valid cell was found".
MISS_COORD = np.float32(1e30)
FOUND_MAX = np.float32(1e14)
# Cell coordinates are clamped to +-CELL_CLAMP before the integer conversion,
# as in the kernels (gn_accumulate.cuh clamped_cell).
CELL_CLAMP = 1e9

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
    oracle): ``(dist (Nq, k) ascending, idx (Nq, k) i32)``. Among equal
    distances the order is unspecified."""
    dists, idxs = [], []
    for a in range(0, query.shape[0], chunk):
        diff = query[a:a + chunk, None, :] - ref[None, :, :]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
              + diff[..., 2] * diff[..., 2])
        top, arg = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        dists.append(torch.sqrt(top))
        idxs.append(arg.to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)
