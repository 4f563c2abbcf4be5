"""Port parity of ICP and PlaneICP on small targets, where the default
``CorrespondenceConfig`` resolves to the ``"grid"`` method (the CSR bucket
scan of ``models/_point_corr.py``) and the stats are the plain reductions,
against the JAX package through the class API with default configurations
(the small-target parts of tests/test_icp.py and tests/test_picp.py) and
against the float64 oracles.

Tolerances: T within 1e-3 of JAX's with equal iteration counts, ``converged``
and ``solver_failed``; matches (weights, indices, targets) equal; stats
normalised by their largest entry within 1e-5 of JAX's (float32 sums in
another order) and within 1e-3 of the float64 oracle (the reference's own
test bound). PlaneICP shares the port's normals with JAX, or holds the
port's own normals (the k-NN kernel's function) against the JAX kernel
path's (``backend="pallas"``, interpreted).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import point_cloud_registration_tpu as jpcr
from point_cloud_registration_tpu.core.config import CorrespondenceConfig as JaxCorr
from point_cloud_registration_tpu.core.config import ICPConfig as JaxICPConfig
from point_cloud_registration_tpu.core.se3 import transform_points as jax_transform_points
from point_cloud_registration_tpu.models._point_corr import match_points as jax_match_points
from point_cloud_registration_tpu.models.icp import build_icp_target as jax_build_icp_target
from point_cloud_registration_tpu.models.icp import icp_stats as jax_icp_stats
from point_cloud_registration_tpu.ops.normals import estimate_normals as jax_estimate_normals
from point_cloud_registration_tpu_torch import ICP, CorrespondenceConfig, ICPConfig, PlaneICP
from point_cloud_registration_tpu_torch.models import _point_fused
from point_cloud_registration_tpu_torch.models._point_corr import build_point_corr, match_points
from point_cloud_registration_tpu_torch.models.icp import icp_stats
from point_cloud_registration_tpu_torch.ops.normals import estimate_normals
from oracles import icp_stats_np, make_scan, make_scene, plane_stats_np, plus_np, transform_np
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_DIST = 2.0
PARAMS = dict(max_iter=30, max_dist=MAX_DIST, tol=1e-3)

# (scene seed, scan seed, 6-dof offset), as in tests/test_torch_icp.py
SCANS = {
    "small_offset": (0, 1, [0.02, -0.02, 0.04, 0.008, -0.01, 0.012]),
    "scene_offset": (0, 2, [0.05, -0.04, 0.1, 0.01, -0.015, 0.02]),
    "large_offset": (3, 4, [0.3, -0.25, 0.2, 0.02, -0.03, 0.05]),
}
POSES = {
    "identity": np.zeros(6),
    "offset": np.array([0.3, -0.2, 0.15, 0.02, -0.03, 0.04]),
}


@pytest.fixture(scope="module")
def scenes():
    return {seed: make_scene(np.random.RandomState(seed)) for seed in (0, 3)}


@pytest.fixture(scope="module")
def sparse_cube():
    """600 random points in a 4 m cube: no 1 m cell holds more than the
    grid's cap, so every gated match is the exact nearest neighbour."""
    return (np.random.RandomState(43).rand(600, 3) * 4).astype(np.float32)


def _normalised_close(got, want, atol):
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol)


def _check_same(port, jax_solver, T_t, T_j):
    d, dj = port.last_diagnostics, jax_solver.last_diagnostics
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-3)
    assert d.iterations == int(dj.iterations)
    assert d.converged == bool(dj.converged)
    assert d.solver_failed == bool(dj.solver_failed)


@pytest.mark.parametrize("scan_name", sorted(SCANS))
def test_icp_default_config_matches_jax(scenes, scan_name):
    scene_seed, seed, dx = SCANS[scan_name]
    pts = scenes[scene_seed]
    scan, _ = make_scan(np.random.RandomState(seed), pts, np.array(dx))
    ji = jpcr.ICP(**PARAMS)
    ji.set_target(pts)
    T_j = ji.align(scan)
    ti = ICP(device="cpu", **PARAMS)
    ti.set_target(pts)
    assert ti.cfg.corr.resolved_method(len(pts)) == "grid" and ti._target.packed is None
    T_t = ti.align(scan)
    assert T_t.dtype == np.float64 and T_t.shape == (4, 4)
    _check_same(ti, ji, T_t, T_j)
    assert ti.last_diagnostics.converged and not ti.last_diagnostics.solver_failed


@pytest.mark.parametrize("scan_name", ["small_offset", "large_offset"])
def test_plane_icp_shared_normals_matches_jax(scenes, scan_name):
    scene_seed, seed, dx = SCANS[scan_name]
    pts = scenes[scene_seed]
    scan, _ = make_scan(np.random.RandomState(seed), pts, np.array(dx))
    normals = estimate_normals(torch.from_numpy(pts)).numpy()
    jp = jpcr.PlaneICP(**PARAMS)
    jp.set_target(pts, norm=normals)
    T_j = jp.align(scan)
    tp = PlaneICP(device="cpu", **PARAMS)
    tp.set_target(pts, norm=normals)
    assert tp._target.corr.packed is None
    _check_same(tp, jp, tp.align(scan), T_j)


def test_plane_icp_own_normals_matches_jax_kernel_path():
    """The port estimates its normals through the k-NN moments path; the JAX
    package's kernel path (interpreted) computes the same function."""
    pts = make_scene(np.random.RandomState(0), n_floor=2000, n_wall=1000)
    scan, _ = make_scan(np.random.RandomState(1), pts, np.array(SCANS["scene_offset"][2]))
    jp = jpcr.PlaneICP(**PARAMS)
    jp.set_target(pts, norm=np.asarray(jax_estimate_normals(pts, k=15, backend="pallas")))
    T_j = jp.align(scan)
    tp = PlaneICP(device="cpu", **PARAMS)
    tp.set_target(pts)
    _check_same(tp, jp, tp.align(scan), T_j)


@pytest.mark.parametrize("pose", sorted(POSES))
def test_grid_match_points_matches_jax(scenes, pose):
    pts = scenes[0]
    jt = jax_build_icp_target(pts, JaxICPConfig(**PARAMS))
    tt = build_point_corr(pts, CorrespondenceConfig(), MAX_DIST, device="cpu")
    assert jt.packed is None and tt.packed is None
    for a, b in zip(tt.buckets, jt.buckets):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.RandomState(5)
    scan = (pts[rng.choice(len(pts), 2000, replace=False)] + rng.randn(2000, 3) * 0.01)
    T = plus_np(np.eye(4), POSES[pose]).astype(np.float32)
    q = np.array(jax_transform_points(jnp.asarray(T), jnp.asarray(scan, jnp.float32)))
    q[0] = [1e3, 1e3, 1e3]  # gated out
    a = jax_match_points(jt, jnp.asarray(q), JaxCorr(), MAX_DIST)
    b = match_points(tt, torch.from_numpy(q), CorrespondenceConfig(), MAX_DIST)
    np.testing.assert_array_equal(b.weight.numpy(), np.asarray(a.weight))
    np.testing.assert_array_equal(b.point_idx.numpy(), np.asarray(a.point_idx))
    np.testing.assert_array_equal(b.proxy_slot.numpy(), np.asarray(a.proxy_slot))
    np.testing.assert_array_equal(b.target.numpy(), np.asarray(a.target))
    assert float(b.weight[0]) == 0.0 and float(b.weight.sum()) > 1500


@pytest.mark.parametrize("huber_delta", [None, 0.1], ids=["plain", "huber"])
@pytest.mark.parametrize("pose", sorted(POSES))
def test_grid_stats_match_jax(scenes, pose, huber_delta):
    pts = scenes[0]
    cfg_j = JaxICPConfig(**PARAMS, huber_delta=huber_delta)
    cfg_t = ICPConfig(**PARAMS, huber_delta=huber_delta)
    jt = jax_build_icp_target(pts, cfg_j)
    tt = build_point_corr(pts, cfg_t.corr, MAX_DIST, device="cpu")
    rng = np.random.RandomState(6)
    scan = (pts[rng.choice(len(pts), 2000, replace=False)]
            + rng.randn(2000, 3) * 0.01).astype(np.float32)
    T = plus_np(np.eye(4), POSES[pose]).astype(np.float32)
    want = jax_icp_stats(jt, jnp.asarray(scan), jnp.ones(len(scan)), jnp.asarray(T), cfg_j)
    got = icp_stats(tt, torch.from_numpy(scan), torch.ones(len(scan)), torch.from_numpy(T),
                    cfg_t)
    _normalised_close([x.numpy() for x in got], want, atol=1e-5)


SMALL_DX = np.array([0.02, -0.03, 0.01, 0.01, -0.005, 0.008])


@pytest.mark.parametrize("kind", ["icp", "plane_icp"])
def test_calc_H_g_e2_matches_oracle(sparse_cube, kind):
    src = transform_np(plus_np(np.eye(4), SMALL_DX), sparse_cube).astype(np.float32)
    if kind == "icp":
        solver = ICP(device="cpu", max_iter=10, max_dist=MAX_DIST)
        solver.set_target(sparse_cube)
        want = icp_stats_np(sparse_cube, src, np.eye(4), max_dist=MAX_DIST)
        grid = solver._target
    else:
        normals = np.random.RandomState(44).randn(len(sparse_cube), 3)
        normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
        solver = PlaneICP(device="cpu", max_iter=10, max_dist=MAX_DIST)
        solver.set_target(sparse_cube, norm=normals)
        want = plane_stats_np(sparse_cube, normals, src, np.eye(4), max_dist=MAX_DIST)
        grid = solver._target.corr
    assert int(grid.buckets.counts.max()) <= solver.cfg.corr.cell_cap
    H, g, e2 = solver.calc_H_g_e2(np.eye(4), src)
    assert H.dtype == np.float64
    _normalised_close([H, g, np.float64(e2)], want[:3], atol=1e-3)


def test_huber_align_matches_jax():
    """The corrupted scene of tests/test_icp.py (15% directional outliers
    inside the gate) with Huber weighting, on the grid method."""
    rng = np.random.RandomState(77)
    target = make_scene(rng, n_floor=4000, n_wall=2000)
    scan, _ = make_scan(rng, target, np.array([0.02, -0.03, 0.01, 0.15, -0.1, 0.08]))
    n_out = len(scan) * 15 // 100
    scan[:n_out] += np.float32([0.9, 0.6, 0.4]) + rng.randn(n_out, 3).astype(np.float32) * 0.1
    kw = dict(max_iter=12, max_dist=MAX_DIST, tol=1e-6, huber_delta=0.1)
    ji = jpcr.ICP(**kw)
    ji.set_target(target)
    T_j = ji.align(scan)
    ti = ICP(device="cpu", **kw)
    ti.set_target(target)
    _check_same(ti, ji, ti.align(scan), T_j)


@pytest.mark.parametrize("solver", ["icp", "plane_icp"])
def test_all_outlier_scan_matches_jax(scenes, solver):
    pts = scenes[0]
    scan = pts[:500] + np.float32([50.0, 50.0, 50.0])
    if solver == "icp":
        js, ts = jpcr.ICP(**PARAMS), ICP(device="cpu", **PARAMS)
        js.set_target(pts)
        ts.set_target(pts)
    else:
        normals = np.tile(np.float32([0.0, 0.0, 1.0]), (len(pts), 1))
        js, ts = jpcr.PlaneICP(**PARAMS), PlaneICP(device="cpu", **PARAMS)
        js.set_target(pts, norm=normals)
        ts.set_target(pts, norm=normals)
    T_t = ts.align(scan)
    _check_same(ts, js, T_t, js.align(scan))
    np.testing.assert_array_equal(T_t, np.eye(4))
    assert ts.last_diagnostics.solver_failed and ts.last_diagnostics.iterations == 1


def test_grid_target_takes_the_plain_stats(scenes, monkeypatch):
    """The stats follow the target's layout: a grid target never reaches a
    packed-grid kernel wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("a packed-grid kernel was called for a grid target")

    monkeypatch.setattr(_point_fused, "_STATS_FN", {"point": refuse, "plane_pt": refuse})
    pts = scenes[0]
    scan, _ = make_scan(np.random.RandomState(1), pts, np.array(SMALL_DX), n_points=500)
    kw = dict(PARAMS, max_iter=3)
    for solver in (ICP(device="cpu", **kw), PlaneICP(device="cpu", **kw)):
        if isinstance(solver, PlaneICP):
            solver.set_target(pts, norm=np.tile(np.float32([0.0, 0.0, 1.0]), (len(pts), 1)))
        else:
            solver.set_target(pts)
        assert np.isfinite(solver.align(scan)).all()
