"""The plain references: independent of the program, self-consistent under
a rigid motion that keeps the grids, and in agreement with the program's
plain versions on the CPU."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.gen import traffic as gen
from perfbench.tests.small import SMALL
from perfbench.reference import plane_icp, vplane_icp

REF_DIR = Path(vplane_icp.__file__).parent
REFS = {"vplane_b01": vplane_icp, "plane_icp_b01": plane_icp}


def params_of(config):
    import json

    return json.loads((harness.ROOT / f"perfbench/configs/{config}.json").read_text())["params"]


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "math", "dataclasses", "numpy", "torch", "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
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


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.reference.vplane_icp, perfbench.reference.plane_icp;"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith("
            "('point_cloud', 'jax', 'flax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def inputs(seed=3):
    streams = gen.seed_streams(seed)
    pool = gen.make_pool(SMALL, {"maps": 1, "scans_per_map": 1}, streams)
    req = gen.Requests(pool, {"init_translation_sigma_m": 0.1, "init_yaw_sigma_deg": 0.2},
                       1.0, streams["requests"]).next()
    return pool.maps[0], pool.scans[0][0], req.init_T


def run_ref(ref, params, map_np, scan_np, init_T):
    target = ref.build(map_np, params, "cpu", torch.float64)
    out = ref.register(target, scan_np, init_T, params, "cpu", torch.float64)
    return out, out.poses[out.updates].numpy()


@pytest.mark.parametrize("config", sorted(REFS))
def test_reference_is_invariant_under_a_motion_that_keeps_the_grids(config):
    """The map moved by whole metres maps every cell and block onto
    another: the same problem, the pose moved with it. (The upstream
    Jacobian's translation part is ``n``, not ``R^T n``, so a rotation of the
    world, or any motion of the scan's frame, changes the iterates.)"""
    ref, params = REFS[config], params_of(config)
    map_np, scan_np, init_T = inputs()
    M = np.eye(4)
    M[:3, 3] = [37.0, -12.0, 4.0]
    a, Ta = run_ref(ref, params, map_np, scan_np, init_T)
    b, Tb = run_ref(ref, params, map_np + M[:3, 3].astype(np.float32), scan_np, M @ init_T)
    assert a.converged and b.converged and a.iterations == b.iterations
    assert np.abs(M @ Ta - Tb).max() < 1e-6


@pytest.mark.parametrize("config", sorted(REFS))
def test_reference_recovers_the_protocol_offset(config):
    ref, params = REFS[config], params_of(config)
    map_np, scan_np, init_T = inputs(4)
    out, T = run_ref(ref, params, map_np, scan_np, init_T)
    assert out.iterations >= 2 and out.counts["distances"] > 0 and out.counts["bytes"] > 0
    # the scan lies 0.3 m above the map: the align moves the pose towards it
    assert abs(T[2, 3] + 0.3) < abs(init_T[2, 3] + 0.3) and np.abs(T[:3, :3] - np.eye(3)).max() < 1e-2


@pytest.mark.parametrize("config", sorted(REFS))
def test_reference_agrees_with_the_program_on_the_cpu(config):
    """The program's plain versions on the CPU and the reference on the same
    inputs: the same iterations, the pose within the configuration's limit."""
    from perfbench.solvers import plane_icp as s_plane
    from perfbench.solvers import vplane_icp as s_vplane

    solver_mod = {"vplane_b01": s_vplane, "plane_icp_b01": s_plane}[config]
    ref, params = REFS[config], params_of(config)
    map_np, scan_np, init_T = inputs(5)
    s = solver_mod.make(params, "cpu")
    solver_mod.set_target(s, map_np)
    T = solver_mod.align(s, scan_np, init_T)
    iterations, e2, _ = solver_mod.outcome(s)
    out, _ = run_ref(ref, params, map_np, scan_np, init_T)
    gap, _ = harness.pose_gap(T, out, harness.box_corners(scan_np))
    assert iterations == out.iterations and gap < 1e-4
    assert harness.e2_gap(e2, out) < 1e-3


def test_pose_gap_is_taken_along_the_reference_trajectory():
    from perfbench.reference._common import GNResult

    poses = [torch.eye(4, dtype=torch.float64) for _ in range(7)]
    for j, p in enumerate(poses):
        p[0, 3] = j * 0.01
    corners = np.zeros((1, 3))
    # the reference stopped after 3 updates; its trajectory goes on to 5
    ref = GNResult(poses=poses[:6], iterations=4, converged=True)
    for k in (2, 3, 4, 5):  # one update short of its end to two past it
        assert harness.pose_gap(poses[k].numpy(), ref, corners) == (0.0, k)
    # farther along or short of it, the nearest end of the window is compared
    assert harness.pose_gap(poses[1].numpy(), ref, corners) == (pytest.approx(0.01), 2)
    assert harness.pose_gap(poses[6].numpy(), ref, corners) == (pytest.approx(0.01), 5)
    # a loop of one update: the start itself is never a match
    ref1 = GNResult(poses=poses[:4], iterations=2, converged=True)
    assert harness.pose_gap(poses[0].numpy(), ref1, corners) == (pytest.approx(0.01), 1)
