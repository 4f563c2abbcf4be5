"""The port's demos (``demos/*_torch.py``) against the JAX package on the same
inputs, on the CPU (``--device cpu``), at a small size.

The demos' synthetic scenes are cut from the JAX demos' 120k / 60k / 80k
points to ``N_SCENE`` by wrapping the port demo's ``make_demo_scene`` with a
smaller ``n``; the random draws keep their order, so the JAX side replays
them with the JAX demo's own functions (loaded by path from
``demos/demo_matching.py``) and the JAX package's classes.

Tolerances: T within 1e-3 of the JAX package's with equal iterations and
``converged`` (the port's parity budget); normals against the JAX k-NN
kernel path (``backend="pallas"``, interpreted), ``|dot| >= 1 - 1e-5``:
the JAX default on a CPU is the packed-block XLA path, which picks other
neighbours at some points; voxel counts, ``voxel_filter``'s row count and
``color_by_voxel``'s colours exact, its rows within 1e-5 (the port sums in
fixed point).
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import point_cloud_registration_tpu as jpcr
from point_cloud_registration_tpu.ops.normals import estimate_normals as jax_estimate_normals
from point_cloud_registration_tpu_torch.utils import write_pcd
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DEMOS = Path(__file__).resolve().parents[1] / "demos"
N_SCENE = 16_000
N_SCAN = 4_000
METHODS = ("VPlaneICP", "NDT", "ICP", "PlaneICP", "FastVPlaneICP")
TOL_T = 1e-3
# The JAX demo's defaults, for its SOLVERS table
JAX_ARGS = argparse.Namespace(voxel_size=1.0, max_dist=2.0, max_iter=30, tol=1e-3, k=15,
                              x=0.2, y=-0.1, z=0.3, roll=0.0, pitch=0.0, yaw=1.0)


def _load(name: str):
    """A demo module by path, registered under its file name (the port's
    estimate/voxel demos import ``demo_matching_torch`` by that name)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, DEMOS / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


jdemo = _load("demo_matching")
tdemo = _load("demo_matching_torch")
tnormals = _load("demo_estimate_normals_torch")
tvoxels = _load("demo_visualize_voxels_torch")
make_demo_scene = tdemo.make_demo_scene


def _small_scene(monkeypatch, module):
    """The demo's scene at ``N_SCENE`` points, whatever size it asks for."""
    monkeypatch.setattr(module, "make_demo_scene",
                        lambda rng, n=None: make_demo_scene(rng, n=N_SCENE))


def _jax_draws(map_np):
    """The JAX demo's map and scan: ``make_demo_scene`` only without a map,
    then ``choice``, then ``randn`` (demo_matching.py:92-103)."""
    a = JAX_ARGS
    rng = np.random.RandomState(0)
    if map_np is None:
        map_np = jdemo.make_demo_scene(rng, n=N_SCENE)
    R = jdemo.rpy_to_so3(a.roll, a.pitch, a.yaw)
    t = np.array([a.x, a.y, a.z])
    sel = rng.choice(len(map_np), min(N_SCAN, len(map_np)), replace=False)
    scan = (map_np[sel] @ R.T + t + rng.randn(len(sel), 3) * 0.005).astype(np.float32)
    return map_np, scan


@pytest.fixture(scope="module")
def scene():
    """The demo map at ``N_SCENE`` points and the JAX k-NN kernel path's
    normals of it (interpreted; the port's normals compute that function)."""
    map_np, scan = _jax_draws(None)
    normals = np.asarray(jax_estimate_normals(map_np, k=15, backend="pallas"))
    return map_np, scan, normals


def _jax_align(method, map_np, scan, normals):
    solver = jdemo.SOLVERS[method](JAX_ARGS)
    if method == "PlaneICP":
        solver.set_target(map_np, norm=normals)
    else:
        solver.set_target(map_np)
    T = np.asarray(solver.align(scan), np.float64)
    return T, solver.last_diagnostics


def _hold(out, T_ref, d_ref):
    err = float(np.abs(out["T"] - T_ref).max())
    assert err < TOL_T, (out["method"], err)
    assert out["iterations"] == int(d_ref.iterations)
    assert out["converged"] == bool(d_ref.converged)
    np.testing.assert_array_equal(out["translation"], out["T"][:3, 3])
    np.testing.assert_array_equal(out["quaternion"],
                                  tdemo.rotation_to_quaternion(out["T"][:3, :3]))


@pytest.mark.parametrize("method", METHODS)
def test_matching_demo_matches_jax(method, scene, monkeypatch, tmp_path):
    map_np, scan, normals = scene
    _small_scene(monkeypatch, tdemo)
    out = tdemo.main(["--method", method, "--scan-points", str(N_SCAN), "--device", "cpu",
                      "--out", str(tmp_path / "m.png")])
    assert out["device"] == "cpu" and (out["n_map"], out["n_scan"]) == (N_SCENE, N_SCAN)
    _hold(out, *_jax_align(method, map_np, scan, normals))


def test_matching_demo_reads_a_pcd_map(scene, tmp_path):
    """``--map``: the map through a PCD file, no scene drawn, so the scan's
    draws start at ``choice``."""
    map_np = scene[0]
    path = tmp_path / "map.pcd"
    write_pcd(str(path), map_np)
    out = tdemo.main(["--map", str(path), "--method", "VPlaneICP", "--scan-points",
                      str(N_SCAN), "--device", "cpu", "--out", str(tmp_path / "m.png")])
    map_read, scan = _jax_draws(map_np)
    assert out["n_map"] == N_SCENE
    _hold(out, *_jax_align("VPlaneICP", map_read, scan, None))


def test_normals_demo_matches_jax_kernel_path(scene, tmp_path):
    map_np, _, normals_jax = scene
    path = tmp_path / "cloud.pcd"
    write_pcd(str(path), map_np)
    out = tnormals.main(["--pcd", str(path), "--k", "15", "--device", "cpu",
                         "--out", str(tmp_path / "n.png")])
    n = out["normals"]
    assert n.shape == (N_SCENE, 3) and np.isfinite(n).all()
    dots = np.abs(np.sum(n * normals_jax, axis=1))
    assert dots.min() >= 1 - 1e-5, dots.min()
    step = max(1, N_SCENE // 400)
    np.testing.assert_array_equal(out["lines"],
                                  jpcr.get_norm_lines(map_np[::step], n[::step], length=0.5))


def test_voxel_demo_matches_jax(monkeypatch, tmp_path):
    _small_scene(monkeypatch, tvoxels)
    out = tvoxels.main(["--voxel-size", "1.0", "--device", "cpu",
                        "--out", str(tmp_path / "v.png")])
    pts = jdemo.make_demo_scene(np.random.RandomState(2), n=N_SCENE)
    vg = jpcr.VoxelGrid(1.0)
    vg.set_points(pts)
    counts = np.asarray(vg._compacted("count"))
    assert (out["n_valid"], out["min_points"]) == (len(vg.mean), vg.min_points)
    np.testing.assert_array_equal(out["counts"], counts)
    assert (out["count_mean"], out["count_max"]) == (float(counts.mean()), int(counts.max()))
    filtered = jpcr.voxel_filter(pts, 1.0)
    assert out["filtered"].shape == filtered.shape
    np.testing.assert_allclose(out["filtered"], filtered, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["irgb"], jpcr.color_by_voxel(pts, 1.0)["irgb"])


def test_demo_helpers_equal_the_jax_demos():
    for seed, n in ((0, 12_000), (1, 60_000), (2, 80_000)):
        np.testing.assert_array_equal(
            tdemo.make_demo_scene(np.random.RandomState(seed), n=n),
            jdemo.make_demo_scene(np.random.RandomState(seed), n=n))
    rng = np.random.RandomState(3)
    for roll, pitch, yaw in [(0.0, 0.0, 1.0), (0.0, 0.0, 0.0), *rng.uniform(-180, 180, (20, 3))]:
        R = tdemo.rpy_to_so3(roll, pitch, yaw)
        np.testing.assert_array_equal(R, jdemo.rpy_to_so3(roll, pitch, yaw))
        np.testing.assert_array_equal(tdemo.rotation_to_quaternion(R),
                                      jdemo.rotation_to_quaternion(R))
    R180 = np.diag([-1.0, -1.0, 1.0])  # w = 0: the fallback branch
    np.testing.assert_array_equal(tdemo.rotation_to_quaternion(R180),
                                  jdemo.rotation_to_quaternion(R180))
    assert sorted(tdemo.SOLVERS) == sorted(jdemo.SOLVERS)


@pytest.mark.parametrize("module", [tdemo, tnormals, tvoxels], ids=lambda m: m.__name__)
def test_demo_without_a_card_raises(module, monkeypatch):
    """No ``--device`` means the card; without one the demo raises before it
    reads or draws anything, and never goes on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def test_demo_run_imports_no_jax(tmp_path):
    cloud = tdemo.make_demo_scene(np.random.RandomState(4), n=8_000)
    write_pcd(str(tmp_path / "c.pcd"), cloud)
    script = DEMOS / "demo_visualize_voxels_torch.py"
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{str(script)!r}, '--pcd', {str(tmp_path / 'c.pcd')!r}, "
        f"'--device', 'cpu', '--out', {str(tmp_path / 'v.png')!r}]\n"
        f"runpy.run_path({str(script)!r}, run_name='__main__')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'point_cloud_registration_tpu')\n"
        "       or m.startswith(('jax.', 'point_cloud_registration_tpu.', 'demo_matching.'))\n"
        "       or m == 'demo_matching']\n"
        "sys.exit(f'imported {bad}' if bad else 0)\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "valid voxels (>= 10 points)" in run.stdout
