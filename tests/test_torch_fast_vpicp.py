"""Port parity of FastVPlaneICP (the coreset two-phase solver): the explicit
plane linearization, the phase-2 loop and its kernel-path stats, and the
class against the JAX package's on ``oracles.make_scene`` with the cases and
parameters of tests/test_fast_vpicp.py.

Tolerances: J, r, w within 1e-5 of the JAX function's (on the JAX map
carried into the port); the phase-2 stats within 1e-4 of the largest entry (float32
sums in another order); phase 2 from one coreset and T1 within 1e-4 with
equal iterations; ``"always"`` within 6e-2 of JAX's and of plain VPlaneICP
(the JAX test's bound: the coreset objective's optimum lies cm-scale from
the full cloud's), with phase 1's iteration count equal to JAX's; ``"auto"``
bit-equal to the port's VPlaneICP.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import point_cloud_registration_tpu as jpcr
from point_cloud_registration_tpu.core.config import VPlaneICPConfig as JaxConfig
from point_cloud_registration_tpu.core.se3 import plus as jax_plus
from point_cloud_registration_tpu.models import fast_vplane_icp as jfast
from point_cloud_registration_tpu.models.coreset import create_gn_set as jax_create_gn_set
from point_cloud_registration_tpu.models.coreset import fast_caratheodory as jax_fast_caratheodory
from point_cloud_registration_tpu.ops.reduce import reduce_H_g_e2
from point_cloud_registration_tpu.ops.voxelize import build_voxel_map as jax_build_voxel_map
import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.core.config import VPlaneICPConfig
from point_cloud_registration_tpu_torch.models.fast_vplane_icp import (
    FastVPlaneICP,
    _phase2_align,
    vplane_linearize,
)
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import fused_plane_stats
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import stats_from_packed
from point_cloud_registration_tpu_torch.utils.convert import voxel_map_from_numpy
from oracles import make_scan, make_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PARAMS = dict(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)
T_PERTURBED = [0.03, -0.02, 0.05, 0.004, -0.003, 0.002]


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.RandomState(5))


@pytest.fixture(scope="module")
def maps(scene):
    """The JAX package's map and the same map carried into the port (its own
    build's normals differ from JAX's by float32 eigen-solver rounding)."""
    jm = jax_build_voxel_map(scene, 1.0, min_points=10, rich="normals")
    tm = voxel_map_from_numpy(jm.means, jm.covs, jm.normals, jm.counts, jm.valid,
                              jm.grid.origin_cell, jm.grid.dims, jm.grid.cell_size, device="cpu")
    return jm, tm


def _T(dx):
    return np.array(jax_plus(jnp.eye(4), jnp.asarray(dx, jnp.float32)), np.float32)


def _scan(scene, seed, dx):
    return make_scan(np.random.RandomState(seed), scene, np.array(dx))[0]


def _record_phase1(solver):
    """Wrap ``solver._phase1`` to keep its diagnostics in ``solver.phase1``."""
    inner = solver._phase1

    def phase1(*args):
        T, diag = inner(*args)
        solver.phase1 = diag
        return T, diag

    solver._phase1 = phase1
    return solver


def _jax_coreset(jm, scan, T1, n_target=1024, clusters=64):
    """The JAX package's lift at ``T1``: the padded coreset and its weights."""
    src = np.zeros((len(scan), 3), np.float32) + scan
    w = np.ones(len(scan), np.float32)
    J, r, wl = (np.asarray(x) for x in jfast.vplane_linearize(
        jm, jnp.asarray(src), jnp.asarray(w), jnp.asarray(T1), JaxConfig(**PARAMS)))
    live = np.where(wl > 0)[0]
    _, w_core, sel = jax_fast_caratheodory(jax_create_gn_set(J[live], r[live]),
                                           wl[live].astype(np.float64), clusters, n_target)
    chosen = live[sel]
    pad = n_target - len(chosen)
    src_sub = np.vstack([src[chosen], np.zeros((pad, 3), np.float32)])
    return src_sub, np.concatenate([w_core, np.zeros(pad)]).astype(np.float32)


def test_constructor_defaults():
    # tests/test_api.py:57-58, and the reference's other defaults
    fast = pt.FastVPlaneICP(voxel_size=1.0, device="cpu")
    assert fast.N_target == 1024
    assert (fast.voxel_size, fast.max_iter, fast.max_dist, fast.tol) == (1.0, 30, 2, 1e-3)
    assert (fast.coreset_switch, fast.coreset_clusters, fast.coreset_mode) == (1e-2, 64, "auto")
    assert FastVPlaneICP.CORESET_BREAKEVEN_ITERS == jpcr.FastVPlaneICP.CORESET_BREAKEVEN_ITERS
    with pytest.raises(ValueError, match="coreset mode"):
        pt.FastVPlaneICP(coreset="sometimes", device="cpu")


def test_vplane_linearize_matches_jax(scene, maps):
    jm, tm = maps
    scan = _scan(scene, 7, [0.04, -0.02, 0.05, 0.008, 0.0, -0.006])
    T = torch.from_numpy(_T(T_PERTURBED))
    w = np.ones(len(scan), np.float32)
    w[::5] = 0.0
    J_j, r_j, w_j = (np.asarray(x) for x in jfast.vplane_linearize(
        jm, jnp.asarray(scan), jnp.asarray(w), jnp.asarray(T.numpy()), JaxConfig(**PARAMS)))
    J_t, r_t, w_t = vplane_linearize(tm, torch.from_numpy(scan), torch.from_numpy(w), T,
                                     VPlaneICPConfig(**PARAMS))
    assert J_t.shape == (len(scan), 6) and r_t.shape == w_t.shape == (len(scan),)
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    live = w_j > 0
    np.testing.assert_allclose(J_t.numpy()[live], J_j[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(r_t.numpy()[live], r_j[live], rtol=0, atol=1e-5)


def test_phase2_stats_equal_jax_linearize(scene, maps):
    """The kernel path's stats (the fused plane stats weighted by the
    coreset) equal the JAX phase 2's ``_linearize_body`` + ``reduce_H_g_e2``
    with ``w_sub * (w_lin > 0)``."""
    jm, tm = maps
    scan = _scan(scene, 7, [0.04, -0.02, 0.05, 0.008, 0.0, -0.006])
    T1 = _T([-0.04, 0.02, -0.05, -0.008, 0.0, 0.006])
    src_sub, w_sub = _jax_coreset(jm, scan, T1)
    T = _T(T_PERTURBED)  # away from T1 some coreset points change their match
    cfg = JaxConfig(**PARAMS)
    J, r, w_lin = jfast._linearize_body(jm, jnp.asarray(src_sub), (jnp.asarray(w_sub) > 0)
                                        .astype(jnp.float32), jnp.asarray(T), cfg)
    wsc = jnp.asarray(w_sub) * (w_lin > 0)
    H_j, g_j, e2_j = (np.asarray(x, np.float64) for x in reduce_H_g_e2(J, r, wsc))
    R, t = T[:3, :3], T[:3, 3]
    s = stats_from_packed(fused_plane_stats(
        tm.cells, tm.origin_cell, tm.dims, tm.cell_size, torch.from_numpy(src_sub),
        torch.from_numpy(w_sub), R, t, PARAMS["max_dist"]).double())
    scale = np.abs(H_j).max()
    np.testing.assert_allclose(s.H.numpy() / scale, H_j / scale, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.g.numpy() / np.abs(g_j).max(), g_j / np.abs(g_j).max(),
                               rtol=0, atol=1e-4)
    assert abs(float(s.e2) - e2_j) <= 1e-4 * e2_j
    assert abs(float(s.n_inliers) - float(jnp.sum(wsc))) <= 1e-4 * float(jnp.sum(wsc))


def test_phase2_align_matches_jax(scene, maps):
    jm, tm = maps
    scan = _scan(scene, 9, [0.05, -0.03, 0.04, 0.01, 0.0, 0.0])
    T1 = _T([-0.045, 0.028, -0.041, -0.0095, 0.0, 0.0])
    src_sub, w_sub = _jax_coreset(jm, scan, T1)
    iters_left = 20
    T_j, it_j, failed_j, conv_j, *_ = jfast._phase2_align(
        jm, jnp.asarray(src_sub), jnp.asarray(w_sub), jnp.asarray(T1), jnp.int32(iters_left),
        JaxConfig(**PARAMS), PARAMS["max_iter"])
    T_t, d_t = _phase2_align(tm, torch.from_numpy(src_sub), torch.from_numpy(w_sub),
                             torch.from_numpy(T1), iters_left, VPlaneICPConfig(**PARAMS))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=0, atol=1e-4)
    assert d_t.iterations == int(it_j) > 0
    assert d_t.converged == bool(conv_j) and d_t.solver_failed == bool(failed_j)
    assert d_t.e2_history.shape == (iters_left,)


def test_fast_always_matches_jax_and_plain(scene):
    """tests/test_fast_vpicp.py::test_fast_align_matches_plain."""
    scan, T_true = make_scan(np.random.RandomState(7), scene,
                             np.array([0.04, -0.02, 0.05, 0.008, 0.0, -0.006]))
    kw = dict(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3, coreset_switch=2e-2,
              coreset="always")
    fast_j = _record_phase1(jpcr.FastVPlaneICP(**kw))
    fast_j.set_target(scene)
    T_j = fast_j.align(scan)
    fast = _record_phase1(FastVPlaneICP(**kw, device="cpu"))
    fast.set_target(scene)
    T_f = fast.align(scan)
    d = fast.last_diagnostics
    assert not d.solver_failed and d.iterations <= 30
    # the coreset engaged: phase 2 ran after phase 1's iterations
    assert fast.phase1.converged and d.iterations > fast.phase1.iterations
    assert fast.phase1.iterations == int(fast_j.phase1.iterations)
    plain = pt.VPlaneICP(**PARAMS, device="cpu")
    plain.set_target(scene)
    T_p = plain.align(scan)
    np.testing.assert_allclose(T_f, T_j, atol=6e-2)
    np.testing.assert_allclose(T_f, T_p, atol=6e-2)
    np.testing.assert_allclose(T_f, np.linalg.inv(T_true), atol=6e-2)


def test_fast_auto_is_plain_vplane_icp(scene):
    """tests/test_fast_vpicp.py::test_fast_align_no_switch_is_plain: below
    the breakeven "auto" is plain VPlaneICP, bit for bit."""
    scan, _ = make_scan(np.random.RandomState(8), scene,
                        np.array([0.03, 0.01, -0.02, 0.0, 0.005, 0.0]))
    fast = FastVPlaneICP(**PARAMS, device="cpu")
    fast.set_target(scene)
    T_f = fast.align(scan)
    plain = pt.VPlaneICP(**PARAMS, device="cpu")
    plain.set_target(scene)
    T_p = plain.align(scan)
    np.testing.assert_array_equal(T_f, T_p)
    d_f, d_p = fast.last_diagnostics, plain.last_diagnostics
    assert d_f.iterations == d_p.iterations and d_f.converged == d_p.converged
    np.testing.assert_array_equal(d_f.e2_history.numpy(), d_p.e2_history.numpy())
    fast_j = jpcr.FastVPlaneICP(**PARAMS)
    fast_j.set_target(scene)
    np.testing.assert_allclose(T_f, fast_j.align(scan), rtol=0, atol=1e-3)


def test_fast_diagnostics_phase_merge(scene):
    """tests/test_fast_vpicp.py::test_fast_diagnostics_phase_merge: the
    histories concatenate phase 1 and phase 2 without gaps."""
    scan, _ = make_scan(np.random.RandomState(9), scene,
                        np.array([0.05, -0.03, 0.04, 0.01, 0.0, 0.0]))
    kw = dict(voxel_size=1.0, max_iter=25, max_dist=2.0, tol=1e-4, coreset_switch=3e-2,
              coreset="always")
    fast = _record_phase1(FastVPlaneICP(**kw, device="cpu"))
    fast.set_target(scene)
    fast.align(scan)
    d = fast.last_diagnostics
    it, it1 = d.iterations, fast.phase1.iterations
    assert 0 < it1 < it <= 25
    assert (d.inlier_history[:it] > 0).all() and (d.inlier_history[it:] == 0).all()
    assert (d.dx_norm_history[:it] > 0).all() and (d.e2_history[it:] == 0).all()
    np.testing.assert_array_equal(d.e2_history[:it1].numpy(), fast.phase1.e2_history[:it1].numpy())
    # the phase-1 count equals the JAX package's
    fast_j = _record_phase1(jpcr.FastVPlaneICP(**kw))
    fast_j.set_target(scene)
    fast_j.align(scan)
    assert it1 == int(fast_j.phase1.iterations)


def test_fast_never_is_plain_and_target_required(scene):
    scan, _ = make_scan(np.random.RandomState(8), scene,
                        np.array([0.03, 0.01, -0.02, 0.0, 0.005, 0.0]))
    plain = pt.VPlaneICP(**PARAMS, device="cpu")
    plain.set_target(scene)
    fast = FastVPlaneICP(**PARAMS, coreset="never", device="cpu")
    fast.set_target(scene)
    np.testing.assert_array_equal(fast.align(scan), plain.align(scan))
    with pytest.raises(ValueError, match="Target is not set"):
        FastVPlaneICP(device="cpu").align(scan)
