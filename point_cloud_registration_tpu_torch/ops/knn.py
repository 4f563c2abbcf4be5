"""Per-cell query tables of a dense voxel map (counterpart of the constants of
``point_cloud_registration_tpu/ops/knn.py`` and of its
``dense_blocks_from_dense``), and the window search the kernels' plain
versions share.

The TPU kernel reads a blocked planar table shaped for region DMAs and MXU
one-hot gathers. A CUDA thread reads cells straight from global memory (the
table stays in the H100's 50 MB L2 at bench size), so the port keeps one
row per cell in linear-key order (``key = x + nx * (y + ny * z)``)::

    [mu_x, mu_y, mu_z, valid, n_x, n_y, n_z, 0]    (D, 8) float32

A probe is one 16-byte load of the centroid and the validity flag; the
normal is a second 16-byte load, made only for the winning cell. NDT's table
carries the six components of the upper Cholesky factor ``U`` of the inverse
covariance (``U^T U = icov``) instead of the normal::

    [mu_x, mu_y, mu_z, valid | u00, u01, u02, u11 | u12, u22, 0, 0]  (D, 12)

12 floats and not 16: at bench size (840k cells) the table is 40 MB and
stays in the H100's 50 MB L2; a 16-float row (54 MB) would not.
"""

from __future__ import annotations

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
NDT_TABLE_WIDTH = 12


def cell_table(means: torch.Tensor, valid: torch.Tensor,
               feats: torch.Tensor) -> torch.Tensor:
    """Per-cell float32 table in linear-key order (see module doc): the
    (D, 8) table for (D, 3) normals, the (D, 12) NDT table for (D, 6) ``u6``
    features ``[u00, u01, u02, u11, u12, u22]``.

    Invalid cells keep their centroid but carry ``valid = 0``, and the
    kernels skip them; their features are zero.
    """
    d, f = feats.shape
    width = {3: TABLE_WIDTH, 6: NDT_TABLE_WIDTH}[f]
    table = torch.zeros((d, width), dtype=torch.float32, device=means.device)
    table[:, 0:3] = means
    table[:, 3] = valid.to(torch.float32)
    table[:, 4:4 + f] = torch.where(valid[:, None], feats, torch.zeros_like(feats))
    return table


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid cell centroid of each query within its probe window.

    ``table`` is a per-cell table in linear-key order whose first four
    columns are ``[mu, valid]``; ``cell`` (N, 3) int64 holds the queries'
    cells relative to the table's origin. Probes run x fastest and z
    slowest and the first minimum wins (``argmin``), as in the kernels.
    Returns ``(best_d2, best_key)``; ``best_d2`` is ``inf`` where the window
    holds no valid cell, and ``best_key`` is then meaningless. Queries go
    in chunks of ``chunk`` so that the (chunk, K, 4) candidate block stays
    small on the card.
    """
    dev = q.device
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)
    nx, ny = int(dims[0]), int(dims[1])
    offs = window_offsets(radius, dev)
    n = q.shape[0]
    best_d2 = torch.empty(n, dtype=torch.float32, device=dev)
    best_key = torch.empty(n, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        c = cell[s:s + chunk, None, :] + offs[None]  # (M, K, 3)
        inb = ((c >= 0) & (c < dims_t)).all(dim=-1)
        key = c[..., 0] + nx * (c[..., 1] + ny * c[..., 2])
        key = torch.where(inb, key, torch.zeros_like(key))
        rows = table[key, :4]  # (M, K, 4): centroid + valid flag
        d = q[s:s + chunk, None, :] - rows[..., :3]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        d2 = torch.where(inb & (rows[..., 3] > 0), d2, torch.full_like(d2, float("inf")))
        arg = torch.argmin(d2, dim=1)  # first minimum in probe order
        best_d2[s:s + chunk] = torch.gather(d2, 1, arg[:, None])[:, 0]
        best_key[s:s + chunk] = torch.gather(key, 1, arg[:, None])[:, 0]
    return best_d2, best_key
