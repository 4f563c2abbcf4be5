"""Port parity: SE(3) math, the 6x6 solve and the Gauss-Newton loop of
point_cloud_registration_tpu_torch against the JAX package, on seeded NumPy
inputs fed to both.

Tolerance: float32 on both sides, atol 1e-6 for single elementwise formulas
and 1e-5 where a result goes through a chain of products (exp map, solve,
GN trajectory); both stem from float32 rounding (eps 1.2e-7) of O(1)
values, and the libm functions (sin, cos, arccos) of the two frameworks may
differ in the last ulp.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import point_cloud_registration_tpu.core.gn as jgn
import point_cloud_registration_tpu.core.se3 as jse3
import point_cloud_registration_tpu_torch.core.gn as tgn
import point_cloud_registration_tpu_torch.core.se3 as tse3

ATOL_ELEM = 1e-6
ATOL_CHAIN = 1e-5


def _both(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(j, t, atol):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def rng():
    return np.random.RandomState(0)


def test_skew_matches_jax(rng):
    j, t = _both(rng.randn(5, 4, 3))
    _close(jse3.skew(j), tse3.skew(t), 0.0)
    _close(jse3.skews(j), tse3.skews(t), 0.0)


def test_skew_time_vector_matches_jax(rng):
    (j1, t1), (j2, t2) = _both(rng.randn(50, 3)), _both(rng.randn(50, 3))
    _close(jse3.skew_time_vector(j1, j2), tse3.skew_time_vector(t1, t2), ATOL_ELEM)


@pytest.mark.parametrize("weighted", [False, True])
def test_skew2_matches_jax(rng, weighted):
    j, t = _both(rng.randn(200, 3))
    if weighted:
        jw, tw = _both(rng.rand(200))
        _close(jse3.skew2(j, jw), tse3.skew2(t, tw), 1e-4)
    else:
        _close(jse3.skew2(j), tse3.skew2(t), 1e-4)


def test_huber_weight_matches_jax(rng):
    j, t = _both(np.abs(rng.randn(300)) * 2)
    for d in (0.5, 1.0, 3.0):
        _close(jse3.huber_weight(j, d), tse3.huber_weight(t, d), ATOL_ELEM)


@pytest.mark.parametrize(
    "theta2", [0.0, 2e-6, 0.99e-5, 1.01e-5, 4e-5, 0.3, 2.5],
    ids=["zero", "tiny", "below_eps", "above_eps", "small", "mid", "large"],
)
def test_expSO3_matches_jax_both_sides_of_eps(rng, theta2):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    omega = (axis * np.sqrt(theta2)).astype(np.float32)
    j, t = _both(omega)
    _close(jse3.expSO3(j), tse3.expSO3(t), ATOL_CHAIN)


def test_expSO3_batched_matches_jax(rng):
    j, t = _both(rng.randn(7, 3) * 0.5)
    _close(jse3.expSO3(j), tse3.expSO3(t), ATOL_CHAIN)


def test_logSO3_matches_jax(rng):
    omegas = np.concatenate([rng.randn(6, 3) * 0.7, rng.randn(2, 3) * 1e-6])
    jR = jse3.expSO3(jnp.asarray(omegas, jnp.float32))
    tR = torch.from_numpy(np.asarray(jR).copy())
    _close(jse3.logSO3(jR), tse3.logSO3(tR), ATOL_CHAIN)


def test_makeT_makeRt_match_jax(rng):
    (jR, tR), (jt, tt) = _both(rng.randn(3, 3, 3)), _both(rng.randn(3, 3))
    jT, tT = jse3.makeT(jR, jt), tse3.makeT(tR, tt)
    _close(jT, tT, 0.0)
    for a, b in zip(jse3.makeRt(jT), tse3.makeRt(tT)):
        _close(a, b, 0.0)


def test_plus_matches_jax(rng):
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = np.asarray(jse3.expSO3(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    T0[:3, 3] = [1.0, -2.0, 0.5]
    jT, tT = _both(T0)
    for dx in (rng.randn(6) * 0.1, rng.randn(6) * 1e-4):
        jd, td = _both(dx)
        _close(jse3.plus(jT, jd), tse3.plus(tT, td), ATOL_CHAIN)


def test_transform_points_matches_jax(rng):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(jse3.expSO3(jnp.asarray([0.3, 0.1, -0.2], jnp.float32)))
    T[:3, 3] = [10.0, -3.0, 2.0]
    (jT, tT), (jp, tp) = _both(T), _both(rng.randn(100, 3) * 20)
    _close(jse3.transform_points(jT, jp), tse3.transform_points(tT, tp), 1e-4)


def test_numerical_derivative_matches_jax():
    def f(x, a):
        return np.array([np.sin(x[0]) * a, x[0] * x[1], np.exp(x[1])])

    x = np.array([0.3, -0.2])
    Jj = jse3.numerical_derivative(f, [x, 2.0], 0)
    Jt = tse3.numerical_derivative(f, [x, 2.0], 0)
    np.testing.assert_array_equal(Jj, Jt)


def _spd(rng, scale_rot=1e3):
    A = rng.randn(6, 12)
    H = (A @ A.T).astype(np.float32)
    # translation and rotation blocks of different magnitude, as in a scan
    s = np.array([1, 1, 1, scale_rot, scale_rot, scale_rot], np.float32) ** 0.5
    return H * s[:, None] * s[None, :]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_solve_6x6_matches_jax(seed):
    rng = np.random.RandomState(seed)
    H = _spd(rng)
    g = (rng.randn(6) * 10).astype(np.float32)
    dj = np.asarray(jgn.solve_6x6(jnp.asarray(H), jnp.asarray(g)))
    dt = tgn.solve_6x6(torch.from_numpy(H), torch.from_numpy(g)).numpy()
    scale = np.abs(dj).max()
    np.testing.assert_allclose(dt / scale, dj / scale, rtol=0, atol=ATOL_CHAIN)
    # and it solves H dx = -g
    np.testing.assert_allclose(H.astype(np.float64) @ dt, -g, rtol=0,
                               atol=1e-3 * np.abs(g).max())


def test_solve_6x6_singular_gives_nan_not_exception():
    H = np.zeros((6, 6), np.float32)
    g = np.ones(6, np.float32)
    dt = tgn.solve_6x6(torch.from_numpy(H), torch.from_numpy(g))
    dj = np.asarray(jgn.solve_6x6(jnp.asarray(H), jnp.asarray(g)))
    assert not np.isfinite(dt.numpy()).all()
    assert not np.isfinite(dj).all()


# --- Gauss-Newton loop on a toy stats function ----------------------------
#
# Point-to-point alignment with known correspondences, computed in float32
# NumPy on the host, so both loops see identical stats for identical T.


def _toy_problem():
    rng = np.random.RandomState(4)
    src = (rng.randn(40, 3) * 2).astype(np.float32)
    T_true = np.eye(4)
    T_true[:3, :3] = np.asarray(jse3.expSO3(jnp.asarray([0.05, -0.03, 0.08], jnp.float32)))
    T_true[:3, 3] = [0.3, -0.2, 0.1]
    dst = (src @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    return src, dst


def _toy_stats_np(T, src, dst):
    T = np.asarray(T, np.float32)
    R, t = T[:3, :3], T[:3, 3]
    q = src @ R.T + t
    r = q - dst
    H = np.zeros((6, 6), np.float32)
    g = np.zeros(6, np.float32)
    for p, ri in zip(src, r):
        S = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]], np.float32)
        J = np.hstack([np.eye(3, dtype=np.float32), -R @ S])
        H += J.T @ J
        g += J.T @ ri
    return H, g, np.float32((r * r).sum()), np.float32(len(src))


def _run_both(stats_np, max_iter, tol):
    def jstats(T):
        H, g, e2, n = stats_np(np.asarray(T))
        return jgn.GNStats(jnp.asarray(H), jnp.asarray(g), jnp.asarray(e2), jnp.asarray(n))

    seen = []

    def tstats(T):
        seen.append(T.clone())
        H, g, e2, n = stats_np(T.numpy())
        return tgn.GNStats(torch.from_numpy(H), torch.from_numpy(g),
                           torch.tensor(e2), torch.tensor(n))

    import jax

    def jloop(T0):
        # jax.pure_callback keeps the NumPy stats inside the while_loop
        def cb(T):
            return jstats(T)

        shapes = jgn.GNStats(
            jax.ShapeDtypeStruct((6, 6), jnp.float32), jax.ShapeDtypeStruct((6,), jnp.float32),
            jax.ShapeDtypeStruct((), jnp.float32), jax.ShapeDtypeStruct((), jnp.float32),
        )
        return jgn.gauss_newton(
            lambda T: jax.pure_callback(cb, shapes, T), T0, max_iter, tol
        )

    Tj, dj = jloop(jnp.eye(4, dtype=jnp.float32))
    Tt, dt = tgn.gauss_newton(tstats, np.eye(4, dtype=np.float32), max_iter, tol)
    return (np.asarray(Tj), dj), (Tt, dt), seen


def test_gauss_newton_matches_jax_on_toy():
    src, dst = _toy_problem()
    (Tj, dj), (Tt, dt), seen = _run_both(lambda T: _toy_stats_np(T, src, dst), 30, 1e-4)
    assert dt.iterations == int(dj.iterations)
    assert dt.converged == bool(dj.converged) is True
    assert dt.solver_failed == bool(dj.solver_failed) is False
    np.testing.assert_allclose(Tt.numpy(), Tj, rtol=0, atol=ATOL_CHAIN)
    np.testing.assert_allclose(dt.e2_history.numpy(), np.asarray(dj.e2_history),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(dt.inlier_history.numpy(), np.asarray(dj.inlier_history))
    # T is not updated on the step that breaks the loop
    torch.testing.assert_close(Tt, seen[-1], rtol=0, atol=0)
    assert dt.e2_history.shape == (30,) and dt.dx_norm_history.shape == (30,)


def test_gauss_newton_runs_to_max_iter_like_jax():
    src, dst = _toy_problem()
    (Tj, dj), (Tt, dt), _ = _run_both(lambda T: _toy_stats_np(T, src, dst), 3, 0.0)
    assert dt.iterations == int(dj.iterations) == 3
    assert dt.converged == bool(dj.converged) is False
    np.testing.assert_allclose(Tt.numpy(), Tj, rtol=0, atol=ATOL_CHAIN)


def test_gauss_newton_singular_sets_solver_failed():
    def singular(T):
        return (np.zeros((6, 6), np.float32), np.ones(6, np.float32),
                np.float32(1.0), np.float32(0.0))

    (Tj, dj), (Tt, dt), _ = _run_both(singular, 10, 1e-3)
    assert dt.solver_failed is True and bool(dj.solver_failed) is True
    assert dt.iterations == int(dj.iterations) == 1
    assert dt.converged is False
    np.testing.assert_array_equal(Tt.numpy(), np.eye(4, dtype=np.float32))
    assert np.isfinite(Tj).all()
