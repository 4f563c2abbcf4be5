"""The resident Gauss-Newton loop of point_cloud_registration_tpu_torch on the
CPU: ``ops/kernels/gn_step.gn_step_reference`` (the plain version of the
``gn_step`` kernel) and the resident loops ``core.gn.gauss_newton_device`` /
``batched_gauss_newton_device`` that run it, against the JAX package's
``solve_6x6``, ``se3.plus``, ``gauss_newton`` and ``batched_gauss_newton``,
and against the port's own host loops (``core.gn.gauss_newton`` /
``batched_gauss_newton``).

Tolerances: a step within 1e-5 of JAX's solve, relative to its largest
entry, times the condition number of the Jacobi-scaled H over 100 (float32
Cholesky in two frameworks); a pose within 1e-6 of JAX's ``plus`` of the
same step; the synthetic loops' T within 1e-6 of JAX's with equal
iterations and flags; the solvers on the small test scenes within 1e-3 of
the JAX classes in as many iterations. Against the port's host loops every
output is equal bit for bit: the reference runs the same operations.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import point_cloud_registration_tpu as jpcr
from point_cloud_registration_tpu.core import gn as jgn
from point_cloud_registration_tpu.core.se3 import plus as jax_plus
from point_cloud_registration_tpu.models import _fused as jfused
import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.core.gn import GNStats, packed_from_stats
from point_cloud_registration_tpu_torch.ops.kernels import gn_step as gs
from oracles import make_scan, make_scene
from test_torch_batched import GN_MAX_ITER, GN_TOL, GN_WEIGHT, _gn_problems, _gn_stats_jax, _gn_stats_np
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL_SOLVE = 1e-5
TOL_PLUS = 1e-6
TOL_T_GN = 1e-6
TOL_JAX = 1e-3
NDT_TOL_JAX = 1e-3  # the JAX CPU NDT takes the icov form, the port the whitened one


# --- gn_step_reference against JAX's solve_6x6 and plus --------------------


def _systems():
    """Seeded (H, g) near a solution: SPD over three decades of scale,
    near-singular (one direction 1e-4 of the others) and singular (rank 5,
    and zero)."""
    rng = np.random.RandomState(0)
    A = rng.randn(6, 12, 6) * np.float32([1e-2, 1.0, 1e2, 1.0, 1.0, 1.0])[:, None, None]
    H = np.einsum("bki,bkj->bij", A, A)
    U, _, _ = np.linalg.svd(rng.randn(6, 6))
    H[3] = U @ np.diag([1.0, 1.0, 1.0, 1.0, 1.0, 1e-4]) @ U.T  # near-singular
    H[4] = U @ np.diag([1.0, 1.0, 1.0, 1.0, 1.0, 0.0]) @ U.T  # singular, rank 5
    H[5] = 0.0  # singular: no correspondence
    g = rng.randn(6, 6) * 1e-3  # steps of centimetres to decimetres, as near a solution
    g[3] *= 1e-2
    return H.astype(np.float32), g.astype(np.float32)


def _packed(H, g, e2=None, n=None):
    B = H.shape[0]
    e2 = np.zeros(B, np.float32) if e2 is None else e2
    n = np.full(B, 100.0, np.float32) if n is None else n
    return torch.stack([packed_from_stats(GNStats(torch.from_numpy(H[b]), torch.from_numpy(g[b]),
                                                  torch.tensor(e2[b]), torch.tensor(n[b])))
                        for b in range(B)])


def _poses(B, seed=1):
    rng = np.random.RandomState(seed)
    Ts = np.stack([np.asarray(jax_plus(jnp.eye(4), jnp.asarray(rng.randn(6) * 0.3, jnp.float32)))
                   for _ in range(B)]).astype(np.float32)
    return Ts


def test_step_matches_jax_solve_and_plus():
    H, g = _systems()
    Ts = _poses(6)
    state = gn.new_state(torch.from_numpy(Ts), 5, "cpu")
    dx = torch.zeros(6, 6)
    gs.gn_step_reference(_packed(H, g), state, 1e-12, dx)
    for b in range(4):  # the solvable systems
        want = np.asarray(jgn.solve_6x6(jnp.asarray(H[b]), jnp.asarray(g[b])))
        s = 1 / np.sqrt(np.diag(H[b]).astype(np.float64))
        cond = np.linalg.cond(H[b] * s[:, None] * s[None, :])
        err = np.abs(dx[b].numpy() - want).max() / np.abs(want).max()
        assert err <= TOL_SOLVE * max(1.0, cond / 100), (b, err, cond)
        T = np.asarray(jax_plus(jnp.asarray(Ts[b]), jnp.asarray(dx[b].numpy())))
        np.testing.assert_allclose(gn.transforms_of(state.poses)[b].numpy(), T, rtol=0,
                                   atol=TOL_PLUS)
        assert not state.failed[b] and not state.done[b] and int(state.it[b]) == 1
    for b in (4, 5):  # singular: a non-finite step fails the problem, T kept
        assert not np.isfinite(dx[b].numpy()).all()
        assert state.failed[b] and state.done[b] and not state.converged[b]
        assert int(state.it[b]) == 1 and not np.isfinite(float(state.dx_norm[b, 0]))
        np.testing.assert_array_equal(gn.transforms_of(state.poses)[b].numpy(), Ts[b])


def test_step_equals_host_solve_norm_and_plus():
    """Row for row what the host loop computes, bit for bit."""
    H, g = _systems()
    Ts = _poses(6, seed=2)
    state = gn.new_state(torch.from_numpy(Ts), 3, "cpu")
    dx = torch.zeros(6, 6)
    gs.gn_step_reference(_packed(H, g), state, 1e-12, dx)
    for b in range(6):
        want = gn.solve_6x6(torch.from_numpy(H[b]), torch.from_numpy(g[b]))
        np.testing.assert_array_equal(dx[b].numpy(), want.numpy())
        assert state.dx_norm[b, 0].numpy().tobytes() == gn.step_norm(want).numpy().tobytes()
        if b < 4:
            T = pt.plus(torch.from_numpy(Ts[b]), want)
            np.testing.assert_array_equal(gn.transforms_of(state.poses)[b].numpy(), T.numpy())


def test_breaking_step_keeps_the_pose():
    """A step below tol converges without moving T; the histories take it."""
    H = np.broadcast_to(np.eye(6, dtype=np.float32), (2, 6, 6)).copy()
    g = np.float32([[1e-5, 0, 0, 0, 0, 0], [0.0, 0.0, 0.0, 0.02, 0.0, 0.0]])
    Ts = _poses(2, seed=3)
    state = gn.new_state(torch.from_numpy(Ts), 4, "cpu")
    gs.gn_step_reference(_packed(H, g, e2=np.float32([3.0, 4.0])), state, 1e-4)
    assert bool(state.converged[0]) and bool(state.done[0]) and not state.failed[0]
    np.testing.assert_array_equal(gn.transforms_of(state.poses)[0].numpy(), Ts[0])
    assert float(state.dx_norm[0, 0]) == np.float32(1e-5) and float(state.final_e2[0]) == 3.0
    # the other problem moved and goes on
    assert not state.done[1] and not np.array_equal(gn.transforms_of(state.poses)[1].numpy(),
                                                     Ts[1])


def test_done_problems_are_frozen():
    """A problem that is done ignores every later step, whatever its stats."""
    H, g = _systems()
    state = gn.new_state(torch.from_numpy(_poses(6)), 3, "cpu")
    gs.gn_step_reference(_packed(H, g), state, 1e-12)
    before = state.words.clone()
    rng = np.random.RandomState(9)
    H2, g2 = H[::-1].copy(), (rng.randn(6, 6) * 0.05).astype(np.float32)
    gs.gn_step_reference(_packed(H2, g2, e2=np.full(6, 7.0, np.float32)), state, 1e-12)
    B, M = 6, 3
    after = gn._fields(state.words, B, M)
    old = gn._fields(before, B, M)
    for b in (4, 5):  # failed at once
        for f in range(1, len(old)):
            np.testing.assert_array_equal(after[f][b].numpy(), old[f][b].numpy())
    assert (after.it[:4] == 2).all() and (after.it[4:] == 1).all()


def test_max_iter_reached_and_zero():
    H, g = _systems()
    init = torch.from_numpy(_poses(1))
    stats = _packed(H[:1], g[:1])
    T, d = gn.gauss_newton_device(lambda poses, done: lambda: stats, init[0], 3, 1e-12, "cpu")
    assert d.iterations == 3 and not d.converged and not d.solver_failed
    assert d.e2_history.shape == (3,) and (d.inlier_history == 100).all()
    T0, d0 = gn.gauss_newton_device(lambda poses, done: lambda: stats, init[0], 0, 1e-3, "cpu")
    assert d0.iterations == 0 and d0.e2_history.shape == (0,) and d0.final_e2 == 0.0
    np.testing.assert_array_equal(T0.numpy(), init[0].numpy())
    Tb, db = gn.batched_gauss_newton_device(lambda poses, done: lambda: stats, init, 0, 1e-3,
                                            "cpu")
    assert db.iterations.tolist() == [0] and db.e2_history.shape == (1, 0)


# --- the resident loops on the synthetic quadratic ----------------------------


def _resident_stats(P, Q, select=None, calls=None):
    """The synthetic problems' stats as a resident loop binds them: all four,
    or problem ``select`` alone (its pose given to every problem, its row
    taken); ``calls`` gets the done flags each launch sees."""
    n_in = np.float32(P.shape[1]) * GN_WEIGHT

    def stats_fn(poses, done):
        def launch():
            if calls is not None:
                calls.append(done.clone())
            Ts = gn.transforms_of(poses).numpy()
            if select is not None:
                Ts = np.repeat(Ts, len(P), axis=0)
            packed = _packed(*_gn_stats_np(P, Q, Ts), n_in)
            return packed if select is None else packed[select:select + 1]

        return launch

    return stats_fn


def _assert_same(T1, d1, T2, d2):
    np.testing.assert_array_equal(np.asarray(T1), np.asarray(T2))
    for f in d1._fields:
        np.testing.assert_array_equal(np.asarray(getattr(d1, f)), np.asarray(getattr(d2, f)))


def test_batched_resident_loop_matches_jax_and_the_host_loop():
    P, Q = _gn_problems()
    init = np.broadcast_to(np.eye(4, dtype=np.float32), (4, 4, 4)).copy()
    stats_fn = _resident_stats(P, Q)
    T_d, d_d = gn.batched_gauss_newton_device(stats_fn, torch.from_numpy(init), GN_MAX_ITER,
                                              GN_TOL, "cpu")
    T_h, d_h = gn.batched_gauss_newton_host(stats_fn, torch.from_numpy(init), GN_MAX_ITER,
                                            GN_TOL, "cpu")
    _assert_same(T_d, d_d, T_h, d_h)
    n_in = np.float32(P.shape[1]) * GN_WEIGHT

    def stats_jax(Ts):
        H, g, e2 = _gn_stats_jax(P, Q, Ts)
        return jgn.GNStats(H=H, g=g, e2=e2, n_inliers=jnp.asarray(n_in))

    T_j, d_j = jax.jit(lambda T0: jfused.batched_gauss_newton(
        stats_jax, T0, GN_MAX_ITER, GN_TOL))(jnp.asarray(init))
    np.testing.assert_array_equal(d_d.iterations.numpy(), np.asarray(d_j.iterations))
    np.testing.assert_array_equal(d_d.converged.numpy(), np.asarray(d_j.converged))
    np.testing.assert_array_equal(d_d.solver_failed.numpy(), np.asarray(d_j.solver_failed))
    np.testing.assert_allclose(T_d.numpy(), np.asarray(T_j), rtol=0, atol=TOL_T_GN)
    # converged, converged later, max_iter reached, failed at once
    assert d_d.converged.tolist() == [True, True, False, False]
    assert d_d.solver_failed.tolist() == [False, False, False, True]
    assert int(d_d.iterations[2]) == GN_MAX_ITER


@pytest.mark.parametrize("b", range(4))
def test_single_resident_loop_matches_jax_and_the_host_loop(b):
    P, Q = _gn_problems()
    stats_fn = _resident_stats(P, Q, select=b)
    T_d, d_d = gn.gauss_newton_device(stats_fn, torch.eye(4), GN_MAX_ITER, GN_TOL, "cpu")
    T_h, d_h = gn.gauss_newton_host(stats_fn, torch.eye(4), GN_MAX_ITER, GN_TOL, "cpu")
    _assert_same(T_d, d_d, T_h, d_h)
    assert isinstance(d_d.iterations, int) and isinstance(d_d.final_e2, float)
    n_in = np.float32(P.shape[1]) * GN_WEIGHT[b]

    def stats_jax(T):
        H, g, e2 = _gn_stats_jax(P, Q, jnp.broadcast_to(T, (len(P), 4, 4)))
        return jgn.GNStats(H=H[b], g=g[b], e2=e2[b], n_inliers=jnp.asarray(n_in))

    T_j, d_j = jax.jit(lambda T0: jgn.gauss_newton(stats_jax, T0, GN_MAX_ITER, GN_TOL))(
        jnp.eye(4, dtype=jnp.float32))
    assert d_d.iterations == int(d_j.iterations)
    assert d_d.converged == bool(d_j.converged) and d_d.solver_failed == bool(d_j.solver_failed)
    np.testing.assert_allclose(T_d.numpy(), np.asarray(T_j), rtol=0, atol=TOL_T_GN)


@pytest.mark.parametrize("chunk", [1, 3, GN_MAX_ITER])
def test_chunks_past_convergence_change_nothing(monkeypatch, chunk):
    """Whatever the chunk, the result is the host loop's; the steps enqueued
    after a problem stopped see it done and leave it as it was."""
    P, Q = _gn_problems()
    init = torch.from_numpy(np.broadcast_to(np.eye(4, dtype=np.float32), (4, 4, 4)).copy())
    T_h, d_h = gn.batched_gauss_newton_host(_resident_stats(P, Q), init, GN_MAX_ITER, GN_TOL,
                                            "cpu")
    monkeypatch.setattr(gn, "GN_CHUNK", chunk)
    calls = []
    T_d, d_d = gn.batched_gauss_newton_device(_resident_stats(P, Q, calls=calls), init, GN_MAX_ITER,
                                              GN_TOL, "cpu")
    _assert_same(T_d, d_d, T_h, d_h)
    assert len(calls) == gn.enqueued_iterations(int(d_d.iterations.max()), GN_MAX_ITER)
    # the stats see each problem's flag as it stood: 0 until the problem stopped
    for i, done in enumerate(calls):
        np.testing.assert_array_equal(done.numpy(), (d_h.iterations.numpy() <= i).astype(np.int32))


def test_enqueued_iterations():
    assert gn.enqueued_iterations(3, 30) == min(30, -(-3 // gn.GN_CHUNK) * gn.GN_CHUNK)
    assert gn.enqueued_iterations(30, 30) == 30 and gn.enqueued_iterations(5, 0) == 0


# --- the solvers on the small test scenes ------------------------------------


def _scene_normals(pts):
    rng = np.random.RandomState(len(pts))
    n = np.where((np.abs(pts[:, 2]) < 0.05)[:, None], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    n = n + rng.randn(len(pts), 3) * 0.05
    return (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)


SOLVERS = {
    "VPlaneICP": dict(voxel_size=1.0),
    "NDT": dict(voxel_size=1.0),
    "ICP": {},
    "PlaneICP": {},
}


@pytest.fixture(scope="module")
def scene():
    pts = make_scene(np.random.RandomState(0))
    scan, _ = make_scan(np.random.RandomState(1), pts, np.array([0.1, -0.05, 0.05, 0.01, -0.01, 0.02]))
    return pts, scan


def _align(cls, pts, scan, normals, **kw):
    s = cls(**kw)
    if normals is None:
        s.set_target(pts)
    else:
        s.set_target(pts, norm=normals)
    return s.align(scan), s.last_diagnostics


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_solvers_match_jax_and_the_host_loop(monkeypatch, scene, name):
    pts, scan = scene
    normals = _scene_normals(pts) if name == "PlaneICP" else None
    T_d, d_d = _align(getattr(pt, name), pts, scan, normals, device="cpu", **SOLVERS[name])
    T_j, d_j = _align(getattr(jpcr, name), pts, scan, normals, **SOLVERS[name])
    assert d_d.converged and not d_d.solver_failed
    assert d_d.iterations == int(d_j.iterations)
    np.testing.assert_allclose(T_d, T_j, rtol=0, atol=NDT_TOL_JAX if name == "NDT" else TOL_JAX)
    monkeypatch.setattr(gn, "gauss_newton_device", gn.gauss_newton_host)
    T_h, d_h = _align(getattr(pt, name), pts, scan, normals, device="cpu", **SOLVERS[name])
    _assert_same(T_d, d_d, T_h, d_h)


@pytest.mark.parametrize("name", ["ICP", "PlaneICP"])
def test_packed_targets_match_the_host_loop(monkeypatch, scene, name):
    """The packed-grid stats (the kernels' plain versions here) in the
    resident loop, against the host loop on the same target."""
    import dataclasses

    from point_cloud_registration_tpu_torch.core.config import CorrespondenceConfig

    pts, scan = scene
    normals = _scene_normals(pts) if name == "PlaneICP" else None

    def run():
        s = getattr(pt, name)(device="cpu")
        s.cfg = dataclasses.replace(s.cfg, corr=CorrespondenceConfig(method="packed"))
        s.set_target(pts) if normals is None else s.set_target(pts, norm=normals)
        assert getattr(s._target, "corr", s._target).packed is not None
        return s.align(scan), s.last_diagnostics

    T_d, d_d = run()
    assert d_d.converged and not d_d.solver_failed
    monkeypatch.setattr(gn, "gauss_newton_device", gn.gauss_newton_host)
    T_h, d_h = run()
    _assert_same(T_d, d_d, T_h, d_h)


def test_plain_stats_stop_with_the_problem(monkeypatch, scene):
    """On a grid target the stats stop with the problem: the align's loop
    (``gn_loop.grid_loop``, its plain version on the CPU, as the loop kernel
    on the card) computes them once per iteration, none after the problem
    stopped. (The two-launch loop's grid launcher, which computes none for
    the iterations enqueued after the stop, is held in
    test_torch_grid_align.py.)"""
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align

    pts, scan = scene
    calls = []
    inner = grid_align.grid_point_stats_reference

    def counted(*args):
        calls.append(1)
        return inner(*args)

    monkeypatch.setattr(grid_align, "grid_point_stats_reference", counted)
    monkeypatch.setattr(gn, "GN_CHUNK", 30)
    s = pt.ICP(device="cpu")
    s.set_target(pts)
    assert s._target.packed is None  # the grid method
    s.align(scan)
    d = s.last_diagnostics
    assert d.converged and d.iterations < 30 and len(calls) == d.iterations
