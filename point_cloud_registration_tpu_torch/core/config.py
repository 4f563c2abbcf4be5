"""Frozen solver configurations (counterpart of
``point_cloud_registration_tpu/core/config.py``).

Only the configurations of the ported solvers are here. ``backend`` accepts
``"auto"`` alone: the hand-written kernel runs for CUDA tensors and its plain
PyTorch version for CPU tensors, chosen by the device of the data. The JAX
configurations' ``fixed_tiers`` flag serves vmapped TPU programs, whose
query tiers the CUDA kernels do not have, so it is left out.
"""

from __future__ import annotations

import dataclasses

BACKENDS = ("auto",)
CORR_METHODS = ("auto", "packed", "grid")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(
            f"backend {backend!r} is not supported; expected one of {BACKENDS}"
        )


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
        _check_backend(self.backend)


@dataclasses.dataclass(frozen=True)
class CorrespondenceConfig:
    """Neighbour-search parameters of the raw-point correspondence engine
    (config.py:23-48).

    ``method``: ``"auto"`` picks ``"packed"`` (packed block tables + proxy
    voxel fallback, ``ops/pointgrid.py``) for targets of at least
    ``auto_threshold`` points and ``"grid"`` (the CSR bucket scan of
    ``ops/hashgrid.py`` and ``ops/knn.nearest_point``) for smaller ones.
    ``cell_fine`` is the packed method's fine-cell size (None = max_dist /
    4), also the radius within which its tier-1 match is provably exact;
    ``packed_cap`` is the number of points packed per block. ``cell_size``
    (None = max_dist / 2) and ``cell_cap`` belong to the grid method.
    """

    method: str = "auto"
    cell_size: float | None = None
    cell_cap: int = 64
    cell_fine: float | None = None
    packed_cap: int = 32
    auto_threshold: int = 50_000

    def __post_init__(self):
        if self.method not in CORR_METHODS:
            raise ValueError(
                f"method {self.method!r} is not supported; expected one of {CORR_METHODS}"
            )

    def resolved_method(self, n_points: int) -> str:
        if self.method == "auto":
            return "packed" if n_points >= self.auto_threshold else "grid"
        return self.method


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Point-to-point ICP (icp.py:12-15 defaults)."""

    max_iter: int = 30
    max_dist: float = 2.0
    tol: float = 1e-3
    huber_delta: float | None = None
    corr: CorrespondenceConfig = CorrespondenceConfig()
    backend: str = "auto"

    def __post_init__(self):
        _check_backend(self.backend)


@dataclasses.dataclass(frozen=True)
class PlaneICPConfig:
    """Point-to-plane ICP (plane_icp.py:13-17 defaults)."""

    max_iter: int = 30
    max_dist: float = 2.0
    tol: float = 1e-3
    k: int = 15  # neighbours for normal estimation
    huber_delta: float | None = None
    corr: CorrespondenceConfig = CorrespondenceConfig()
    backend: str = "auto"

    def __post_init__(self):
        _check_backend(self.backend)


@dataclasses.dataclass(frozen=True)
class NDTConfig:
    """NDT (ndt.py:12-16 defaults)."""

    voxel_size: float = 1.0
    max_iter: int = 30
    max_dist: float = 2.0
    tol: float = 1e-3
    min_points: int = 10
    huber_delta: float | None = None
    backend: str = "auto"

    def __post_init__(self):
        _check_backend(self.backend)
