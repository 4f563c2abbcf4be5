"""ICP through the program's class API: the configuration's ``params`` are
the constructor's keywords; a map of 50k points and more takes the packed
correspondence method. NumPy in, a float64 NumPy T out."""

from __future__ import annotations

import numpy as np

# the loop kernel of an align, by the name the device trace gives it
LOOP_KERNEL = "gn_loop_kernel"


def make(params: dict, device):
    from point_cloud_registration_tpu_torch import ICP

    return ICP(**params, device=device)


def set_target(solver, points: np.ndarray) -> None:
    solver.set_target(points)


def align(solver, scan: np.ndarray, init_T: np.ndarray) -> np.ndarray:
    return solver.align(scan, init_T)


def outcome(solver) -> tuple[int, list, list]:
    """``(iterations, e2, step norms)`` of the last align: its
    linearizations, and the squared error and the step norm of each."""
    d = solver.last_diagnostics
    n = int(d.iterations)
    return n, d.e2_history[:n].tolist(), d.dx_norm_history[:n].tolist()
