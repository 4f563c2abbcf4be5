"""Cell arithmetic of the voxel grid (counterpart of the parts of
``point_cloud_registration_tpu/ops/hashgrid.py`` the dense-direct build uses).

Cells are absolute integer coordinates ``floor(p / cell_size)``, the grouping
of the reference hash (voxel.py:16). A map keys its cells by position inside
its bounding box, which is collision free and fits int32.
"""

from __future__ import annotations

import numpy as np
import torch

# Padding key for unoccupied slots: sorts after every real key.
INVALID_KEY = np.iinfo(np.int32).max
# Ceiling for a dense per-cell map (cells); larger maps need the sparse build.
DENSE_CELL_BUDGET = 1 << 26


def cell_coords(points: torch.Tensor, cell_size) -> torch.Tensor:
    """Absolute integer cell coordinates ``floor(p / cell_size)`` -> (..., 3) i32.

    True float32 division, as in the JAX package. The divisor is a tensor on
    the points' device: divided by a Python scalar, CUDA tensors are
    multiplied by the scalar's reciprocal instead, which can move a point
    that lies within an ulp of a cell border into the neighbouring cell.
    """
    div = torch.as_tensor(cell_size, dtype=points.dtype, device=points.device)
    return torch.floor(points / div).to(torch.int32)


def _bbox_cells(points, cell_size: float) -> tuple[np.ndarray, np.ndarray]:
    """Host-side bounding box in cell units: ``(lo_cell, hi_cell)`` int64.

    NumPy inputs are reduced on the host; tensors cost one device-to-host
    copy of the two corners. Both reduce in float32, so the cells are
    identical wherever the input lives.
    """
    if points.shape[0] == 0:
        raise ValueError("empty point cloud: at least one point is required")
    if isinstance(points, np.ndarray):
        pts32 = points if points.dtype == np.float32 else points.astype(np.float32)
        lo = pts32.min(axis=0).astype(np.float64)
        hi = pts32.max(axis=0).astype(np.float64)
    else:
        p32 = points.to(torch.float32)
        corners = torch.stack([p32.amin(dim=0), p32.amax(dim=0)]).cpu().numpy()
        lo = corners[0].astype(np.float64)
        hi = corners[1].astype(np.float64)
    lo_cell = np.floor(lo / cell_size).astype(np.int64)
    hi_cell = np.floor(hi / cell_size).astype(np.int64)
    return lo_cell, hi_cell
