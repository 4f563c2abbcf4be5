"""The benchmark's NDT cell (``ndt_b01``) at the seeded small cut of
``perfbench/tests/small.py`` (a 40 m tile of 60,000 points, scans of 5,000):
the plain float64 reference ``perfbench/reference/ndt.py`` is independent of
the program and of JAX, finds the protocol's offset, is unchanged by a
whole-metre motion of map and pose, inverts covariances as upstream
``calc_icov`` does, and agrees with the port's ``NDT`` (its plain versions on
the CPU) on the same inputs.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.gen import traffic as gen
from perfbench.reference import ndt as ref
from perfbench.solvers import ndt as solver
from perfbench.tests.small import SMALL
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REF_FILE = harness.ROOT / "perfbench" / "reference" / "ndt.py"
PARAMS = json.loads((harness.ROOT / "perfbench/configs/ndt_b01.json").read_text())["params"]


def inputs(seed):
    """The small cut's map, its first scan and a request's ``init_T``."""
    streams = gen.seed_streams(seed)
    pool = gen.make_pool(SMALL, {"maps": 1, "scans_per_map": 1}, streams)
    req = gen.Requests(pool, {"init_translation_sigma_m": 0.1, "init_yaw_sigma_deg": 0.2},
                       1.0, streams["requests"]).next()
    return pool.maps[0], pool.scans[0][0], req.init_T


def run_ref(map_np, scan_np, init_T):
    target = ref.build(map_np, PARAMS, "cpu", torch.float64)
    out = ref.register(target, scan_np, init_T, PARAMS, "cpu", torch.float64)
    return out, out.poses[out.updates].numpy()


def test_reference_source_imports_neither_jax_nor_a_package():
    allowed = {"__future__", "math", "dataclasses", "numpy", "torch", "perfbench"}
    for node in ast.walk(ast.parse(REF_FILE.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in allowed, n
            if n.startswith("perfbench"):
                assert n.startswith("perfbench.reference"), n


def test_reference_loads_no_jax_and_no_package_module():
    code = ("import sys; sys.path.insert(0, '.'); import perfbench.reference.ndt;"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith("
            "('point_cloud', 'jax', 'flax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def adjugate_inverse(c: np.ndarray) -> np.ndarray:
    """The inverse by cofactors, written out: ``adj[i, j] = (-1)**(i + j)``
    times the minor of ``c`` without row j and column i, over the
    determinant; a determinant of 0 taken as 1e6 (voxel.py:69-102)."""
    adj = np.empty((3, 3))
    for i in range(3):
        for j in range(3):
            minor = np.delete(np.delete(c, j, axis=0), i, axis=1)
            adj[i, j] = (-1) ** (i + j) * (minor[0, 0] * minor[1, 1] - minor[0, 1] * minor[1, 0])
    det = sum(c[0, k] * adj[k, 0] for k in range(3))
    return adj / (1e6 if det == 0 else det)


COVS = {
    "diagonal": np.diag([0.08, 0.05, 0.0009]),
    "wall": np.array([[0.0830, 0.0010, 0.0002], [0.0010, 0.0004, 0.0001],
                      [0.0002, 0.0001, 0.0790]]),
    "general": np.array([[2.0, 0.3, -0.4], [0.3, 1.5, 0.2], [-0.4, 0.2, 0.9]]),
    "singular": np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]]),
}


@pytest.mark.parametrize("name", sorted(COVS))
def test_calc_icov_is_the_adjugate_inverse(name):
    c = COVS[name]
    got = ref.calc_icov(torch.from_numpy(c)).numpy()
    want = adjugate_inverse(c)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-18 * np.abs(want).max())
    if name == "singular":  # the guard: adj(c) / 1e6, here diag(0, 0, 1) / 1e6
        np.testing.assert_array_equal(got, np.diag([0.0, 0.0, 1e-6]))
    else:
        np.testing.assert_allclose(got @ c, np.eye(3), atol=1e-9)


def test_reference_recovers_the_protocol_offset():
    map_np, scan_np, init_T = inputs(4)
    out, T = run_ref(map_np, scan_np, init_T)
    assert out.converged and out.iterations >= 2
    assert out.counts["distances"] > 0 and out.counts["linearizations"] > 0
    assert out.counts["linearizations"] % 3 == 0  # three whitened rows an inlier
    # the scan lies 0.3 m above the map: the align takes the pose there
    assert abs(T[2, 3] + 0.3) < 0.06 and abs(T[2, 3] + 0.3) < abs(init_T[2, 3] + 0.3)
    assert np.abs(T[:3, :3] - np.eye(3)).max() < 1e-2


def test_reference_is_invariant_under_a_whole_metre_translation():
    """The map moved by whole metres maps every cell onto another: the same
    problem, the pose moved with it. The map is moved in float64, where the
    sum is exact (in float32 it would round the points by up to 4e-6 m,
    which the icov's large eigenvalues would show)."""
    map_np, scan_np, init_T = inputs(6)
    M = np.eye(4)
    M[:3, 3] = [37.0, -12.0, 4.0]
    map64 = map_np.astype(np.float64)
    a, Ta = run_ref(map64, scan_np, init_T)
    b, Tb = run_ref(map64 + M[:3, 3], scan_np, M @ init_T)
    assert a.converged and b.converged and a.iterations == b.iterations
    assert np.abs(M @ Ta - Tb).max() < 1e-6


def test_reference_agrees_with_the_program_on_the_cpu():
    """The port's ``NDT`` (plain versions on the CPU, the whitened form) and
    the reference (float64, the icov form) on the same inputs: the same
    iterations, the pose and the squared error within the limits."""
    map_np, scan_np, init_T = inputs(6)
    s = solver.make(PARAMS, "cpu")
    solver.set_target(s, map_np)
    T = solver.align(s, scan_np, init_T)
    iterations, e2, _ = solver.outcome(s)
    out, _ = run_ref(map_np, scan_np, init_T)
    gap, _ = harness.pose_gap(T, out, harness.box_corners(scan_np))
    assert iterations == out.iterations and gap < 1e-4
    assert harness.e2_gap(e2, out) < 1e-3
