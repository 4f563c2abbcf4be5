"""Frozen solver configurations (counterpart of
``point_cloud_registration_tpu/core/config.py``).

Only the configurations of the ported solvers are here. ``backend`` accepts
``"auto"`` alone: the hand-written kernel runs for CUDA tensors and its plain
PyTorch version for CPU tensors, chosen by the device of the data.
"""

from __future__ import annotations

import dataclasses

BACKENDS = ("auto",)


@dataclasses.dataclass(frozen=True)
class GNConfig:
    """Gauss-Newton loop parameters (registration.py:11-19 defaults)."""

    max_iter: int = 30
    tol: float = 1e-3


@dataclasses.dataclass(frozen=True)
class VPlaneICPConfig:
    """Voxelized point-to-plane ICP (voxelized_plane_icp.py:12-16 defaults)."""

    voxel_size: float = 1.0
    max_iter: int = 30
    max_dist: float = 2.0
    tol: float = 1e-3
    min_points: int = 10  # voxel validity threshold (voxel.py:56)
    huber_delta: float | None = None
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} is not supported; expected one of {BACKENDS}"
            )
