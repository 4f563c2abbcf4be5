"""The benchmark's ICP cell (``icp_b01``) at the seeded small cut of
``perfbench/tests/small.py`` (a 40 m tile of 60,000 points, which takes the
packed method; scans of 5,000): the plain float64 reference
``perfbench/reference/icp.py`` is independent of the program and of JAX,
finds the protocol's offset, is unchanged by a whole-metre motion of map and
pose, counts its work in the roofline's units, and agrees with the port's
``ICP`` (its plain versions on the CPU) on the same inputs.
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
from perfbench.reference import icp as ref
from perfbench.solvers import icp as solver
from perfbench.tests.small import SMALL
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REF_FILE = harness.ROOT / "perfbench" / "reference" / "icp.py"
PARAMS = json.loads((harness.ROOT / "perfbench/configs/icp_b01.json").read_text())["params"]


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
    code = ("import sys; sys.path.insert(0, '.'); import perfbench.reference.icp;"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith("
            "('point_cloud', 'jax', 'flax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@pytest.fixture(scope="module")
def offset_run():
    map_np, scan_np, init_T = inputs(4)
    out, T = run_ref(map_np, scan_np, init_T)
    return out, T, init_T, scan_np


def test_reference_recovers_the_protocol_offset(offset_run):
    out, T, init_T, _ = offset_run
    assert out.converged and out.iterations >= 2
    # the scan lies 0.3 m above the map: the align takes the pose there
    assert abs(T[2, 3] + 0.3) < 0.06 and abs(T[2, 3] + 0.3) < abs(init_T[2, 3] + 0.3)
    assert np.abs(T[:3, :3] - np.eye(3)).max() < 1e-2


def test_reference_counts_its_work_in_the_roofline_units(offset_run):
    """Positive counts; the closed form costs at most three plane rows an
    inlier (71 of 92 operations a row), and the bytes hold the padded scan."""
    out, _, _, scan_np = offset_run
    c = out.counts
    assert c["distances"] > 0 and c["linearizations"] > 0
    inliers = c["linearizations"] * ref.FLOPS_PLANE_ROW / ref.FLOPS_INLIER
    assert abs(inliers - round(inliers)) < 1e-6
    assert 0 < round(inliers) <= out.iterations * scan_np.shape[0]
    assert c["linearizations"] <= 3 * round(inliers)
    assert c["bytes"] > 16 * -(-scan_np.shape[0] // ref.SCAN_BUCKET) * ref.SCAN_BUCKET


def test_reference_is_invariant_under_a_whole_metre_translation():
    """The map moved by whole metres maps every fine cell and block onto
    another, and the index hash ranks the same points: the same problem, the
    pose moved with it. The map is moved in float64, where the sum is exact."""
    map_np, scan_np, init_T = inputs(6)
    M = np.eye(4)
    M[:3, 3] = [37.0, -12.0, 4.0]
    map64 = map_np.astype(np.float64)
    a, Ta = run_ref(map64, scan_np, init_T)
    b, Tb = run_ref(map64 + M[:3, 3], scan_np, M @ init_T)
    assert a.converged and b.converged and a.iterations == b.iterations
    assert np.abs(M @ Ta - Tb).max() < 1e-6


def test_reference_agrees_with_the_program_on_the_cpu():
    """The port's ``ICP`` (plain versions on the CPU, the whitened form with
    ``U = I``) and the reference (float64, the closed form) on the same
    inputs: the same iterations, the pose and the squared error close."""
    map_np, scan_np, init_T = inputs(6)
    s = solver.make(PARAMS, "cpu")
    solver.set_target(s, map_np)
    assert s._target.packed is not None  # the packed method, as on the card
    T = solver.align(s, scan_np, init_T)
    iterations, e2, _ = solver.outcome(s)
    out, _ = run_ref(map_np, scan_np, init_T)
    gap, _ = harness.pose_gap(T, out, harness.box_corners(scan_np))
    assert iterations == out.iterations and gap < 1e-4
    assert harness.e2_gap(e2, out) < 1e-3
