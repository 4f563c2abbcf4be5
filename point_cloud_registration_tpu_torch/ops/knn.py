"""Per-cell query table of a dense voxel map (counterpart of the constants of
``point_cloud_registration_tpu/ops/knn.py`` and of its
``dense_blocks_from_dense``).

The TPU kernel reads a blocked planar table shaped for region DMAs and MXU
one-hot gathers. A CUDA thread reads cells straight from global memory (the
table stays in the H100's 50 MB L2 at bench size), so the port keeps one
row per cell in linear-key order (``key = x + nx * (y + ny * z)``)::

    [mu_x, mu_y, mu_z, valid, n_x, n_y, n_z, 0]    (D, 8) float32

A probe is one 16-byte load of the centroid and the validity flag; the
normal is a second 16-byte load, made only for the winning cell.
"""

from __future__ import annotations

import numpy as np
import torch

# Finite miss sentinel of the JAX tables, kept for API parity: a squared
# distance of at least FOUND_MAX**2 means "no valid cell was found".
MISS_COORD = np.float32(1e30)
FOUND_MAX = np.float32(1e14)

TABLE_WIDTH = 8


def cell_table(means: torch.Tensor, valid: torch.Tensor,
               normals: torch.Tensor) -> torch.Tensor:
    """(D, 8) float32 per-cell table in linear-key order (see module doc).

    Invalid cells keep their centroid but carry ``valid = 0``, and the
    kernels skip them; their normal is zero.
    """
    d = means.shape[0]
    table = torch.zeros((d, TABLE_WIDTH), dtype=torch.float32, device=means.device)
    table[:, 0:3] = means
    table[:, 3] = valid.to(torch.float32)
    table[:, 4:7] = torch.where(valid[:, None], normals, torch.zeros_like(normals))
    return table
