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
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

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


# -- which device an entry point builds on -----------------------------------


def _device_cases():
    from point_cloud_registration_tpu_torch import models
    from point_cloud_registration_tpu_torch.core.config import (
        CorrespondenceConfig,
        ICPConfig,
        NDTConfig,
        PlaneICPConfig,
        VPlaneICPConfig,
    )
    from point_cloud_registration_tpu_torch.ops.normals import estimate_normals

    packed = CorrespondenceConfig(method="packed")
    up = np.tile(np.float32([0.0, 0.0, 1.0]), (1200, 1))
    return {
        "build_vplane_target": lambda p, **kw: models.build_vplane_target(
            p, VPlaneICPConfig(min_points=3), **kw).cells.centers,
        "build_ndt_target": lambda p, **kw: models.build_ndt_target(
            p, NDTConfig(min_points=3), **kw).cells.feats,
        "build_icp_target": lambda p, **kw: models.build_icp_target(
            p, ICPConfig(corr=packed), **kw).points,
        "build_plane_icp_target": lambda p, **kw: models.build_plane_icp_target(
            p, PlaneICPConfig(corr=packed), normals=up, **kw).normals,
        "estimate_normals": lambda p, **kw: estimate_normals(p, k=5, backend="gather", **kw),
    }


@pytest.mark.parametrize("entry", ["build_vplane_target", "build_ndt_target", "build_icp_target",
                                   "build_plane_icp_target", "estimate_normals"])
def test_numpy_input_builds_on_the_default_device(monkeypatch, entry):
    """With no ``device``: a NumPy input goes to ``default_device()`` (the
    card, or an error without one), a tensor keeps its device, and a named
    device wins. Pinned without a card by counting the calls of ``default_device``."""
    from point_cloud_registration_tpu_torch.core import device as device_mod

    calls = []

    def fake_default():
        calls.append(1)
        return torch.device("cpu")

    monkeypatch.setattr(device_mod, "default_device", fake_default)
    fn = _device_cases()[entry]
    pts = (np.random.RandomState(0).rand(1200, 3) * np.float32([6, 6, 0.1])).astype(np.float32)
    out = fn(pts)
    assert len(calls) >= 1 and out.device.type == "cpu"
    calls.clear()
    assert fn(torch.from_numpy(pts)).device.type == "cpu" and not calls
    assert fn(pts, device="cpu").device.type == "cpu" and not calls


def test_solver_classes_default_to_the_default_device(monkeypatch):
    import point_cloud_registration_tpu_torch as port
    from point_cloud_registration_tpu_torch.core import device as device_mod

    monkeypatch.setattr(device_mod, "default_device", lambda: torch.device("meta"))
    for cls in (port.VPlaneICP, port.NDT, port.ICP, port.PlaneICP):
        assert cls().device.type == "meta"
        assert cls(device="cpu").device.type == "cpu"
    assert device_mod.resolve_device(torch.zeros(2, 3)).type == "cpu"


def _converter_cases():
    from point_cloud_registration_tpu_torch.ops.pointgrid import build_packed_grid_and_proxy
    from point_cloud_registration_tpu_torch.utils import convert

    one = lambda *shape: np.ones(shape, np.float32)
    voxel = (one(1, 3), one(1, 3, 3), one(1, 3), np.int32([5]), np.array([True]),
             (0, 0, 0), (1, 1, 1), 1.0)
    pts = torch.from_numpy(
        (np.random.RandomState(0).rand(300, 3) * np.float32([4, 4, 1])).astype(np.float32))
    up = torch.tensor([0.0, 0.0, 1.0]).expand(300, 3)
    pg, px = build_packed_grid_and_proxy(pts, 0.5, 8, min_points=3, with_normals=True, feats=up)
    packed = tuple(np.asarray(a) for a in (
        pg.origin_fine, pg.cell_fine, pg.nb_dims, pg.block_row, pg.row_key, pg.pts_packed,
        pg.idx_packed, pg.row_over, px.means, px.counts, px.valid))
    normals = px.normals.numpy()
    return {
        "voxel_map": lambda **kw: convert.voxel_map_from_numpy(*voxel, **kw).cells.centers,
        "ndt_map": lambda **kw: convert.ndt_map_from_numpy(
            *voxel, one(1, 3, 3), one(1, 6), **kw).cells.feats,
        "packed_grid": lambda **kw: convert.packed_grid_from_numpy(*packed, **kw)[0].pts_packed,
        "plane_icp_target": lambda **kw: convert.plane_icp_target_from_numpy(
            pts.numpy(), up.numpy(), *packed, proxy_normals=normals, **kw).normals,
    }


@pytest.mark.parametrize("converter", ["voxel_map", "ndt_map", "packed_grid", "plane_icp_target"])
def test_converters_land_on_the_default_device(monkeypatch, converter):
    """The converters of ``utils.convert`` follow the entry points' rule: no
    ``device`` means ``default_device()``, a named device wins."""
    from point_cloud_registration_tpu_torch.core import device as device_mod

    calls = []

    def fake_default():
        calls.append(1)
        return torch.device("cpu")

    fn = _converter_cases()[converter]
    monkeypatch.setattr(device_mod, "default_device", fake_default)
    assert fn().device.type == "cpu" and calls
    calls.clear()
    assert fn(device="cpu").device.type == "cpu" and not calls


def _no_card_entries():
    import point_cloud_registration_tpu_torch as port

    cases = _device_cases()
    return {
        "build_vplane_target": cases["build_vplane_target"],
        "build_icp_target": cases["build_icp_target"],
        "ops.estimate_normals": cases["estimate_normals"],
        "root.estimate_normals": lambda p: port.estimate_normals(p, k=5),
        "root.estimate_norm_with_tree": lambda p: port.estimate_norm_with_tree(p, None, k=5),
        "VPlaneICP": lambda p: port.VPlaneICP(),
        "voxel_filter": lambda p: port.voxel_filter(p, 0.5),
    }


_NO_CARD_ENTRIES = ["build_vplane_target", "build_icp_target", "ops.estimate_normals",
                    "root.estimate_normals", "root.estimate_norm_with_tree", "VPlaneICP",
                    "voxel_filter"]


@pytest.mark.parametrize("entry", _NO_CARD_ENTRIES)
def test_numpy_input_without_a_card_raises(monkeypatch, entry):
    """With no usable CUDA device, an entry point given NumPy and no
    ``device`` raises; it never runs on the CPU on its own. Naming
    ``device="cpu"`` is the way to the CPU."""
    from point_cloud_registration_tpu_torch.core import device as device_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = (np.random.RandomState(0).rand(1200, 3) * np.float32([6, 6, 0.1])).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _no_card_entries()[entry](pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.default_device()
    assert device_mod.resolve_device(pts, "cpu").type == "cpu"
