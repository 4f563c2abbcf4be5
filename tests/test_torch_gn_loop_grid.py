"""The grid loop's plain version on the CPU
(``point_cloud_registration_tpu_torch/ops/kernels/gn_loop.py::
grid_loop_reference``: on the card one cooperative launch of
``csrc/grid_loop.cu`` runs the whole Gauss-Newton loop of an ICP or
PlaneICP align on a small target's grid and of a VPlaneICP or NDT align on
a hashed map), by test_torch_gn_loop_point.py's checks: against the JAX
package's ``icp_align``, ``plane_icp_align``, ``vplane_align`` and
``ndt_align`` (XLA code, no Pallas kernel; T within 1e-3, equal
iterations and flags) and against the host loop (``core.gn.gauss_newton``)
over the same plain stats, also at the loop's edges (every field bit for
bit).
"""

import numpy as np
import pytest

import point_cloud_registration_tpu_torch as pt
from oracles import make_scan, make_scene
from test_torch_gn_loop_point import (
    ALL_PATHS,
    EDGES,
    N_SCAN,
    OFFSET,
    _port_target,
    check_edge,
    check_matches_jax,
    check_host,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PATHS = ALL_PATHS[2:]


@pytest.fixture(scope="module")
def scene():
    pts = make_scene(np.random.RandomState(5)).astype(np.float32)
    scan = make_scan(np.random.RandomState(8), pts, np.array(OFFSET), n_points=N_SCAN)[0]
    return pts, scan


@pytest.fixture(scope="module")
def normals(scene):
    """The port's normals of the scene, given to both packages' PlaneICP."""
    return np.asarray(pt.estimate_normals(scene[0], device="cpu"), np.float32)


@pytest.fixture(scope="module")
def targets(scene, normals):
    return {path: _port_target(path, scene[0], normals) for path in PATHS}


@pytest.mark.parametrize("path", PATHS)
def test_reference_matches_jax(scene, normals, targets, path):
    check_matches_jax(scene, normals, targets, path)


@pytest.mark.parametrize("path", PATHS)
def test_reference_equals_the_host_loop(scene, targets, path):
    check_host(scene, targets, path)


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("path", PATHS)
def test_edges_equal_the_host_loop(scene, targets, path, edge):
    check_edge(scene, targets, path, edge)
