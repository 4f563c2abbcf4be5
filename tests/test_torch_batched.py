"""Port parity of the batched multi-scan streams: the batched ``solve_6x6``,
``core/gn.batched_gauss_newton``, ``fused_voxel_align_batched``
(kinds plane and ndt) and ``fused_point_align_batched`` (kinds point and
plane_pt) of point_cloud_registration_tpu_torch, against the JAX package and
against the port's own single-problem aligns, on ``oracles.make_scene``.

The port's batched wrappers run their plain versions on the CPU (the
single-problem plain version of each problem), so a problem of a batched
align is its single align bit for bit here; on the card the kernel's rows
of one problem are those of its single launch, which ``chip_smoke.py``
checks. Tolerances: T within 1e-5 of the JAX package's with equal
iterations and flags (the JAX batched functions in interpret mode at B = 2,
n = 300; the JAX class API per problem at B = 3, n = 500); the synthetic GN
loop's T within 1e-6 of JAX's (float32 solves in two frameworks).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import point_cloud_registration_tpu as jpcr
from point_cloud_registration_tpu.core import gn as jgn
from point_cloud_registration_tpu.core.config import CorrespondenceConfig as JaxCorr
from point_cloud_registration_tpu.core.config import ICPConfig as JaxICPConfig
from point_cloud_registration_tpu.core.config import VPlaneICPConfig as JaxVPlaneConfig
from point_cloud_registration_tpu.core.se3 import plus as jax_plus
from point_cloud_registration_tpu.models import _fused as jfused
from point_cloud_registration_tpu.models import _point_fused as jpoint_fused
from point_cloud_registration_tpu.models.icp import build_icp_target as jax_build_icp_target
from point_cloud_registration_tpu.ops.pallas.fused_align import voxel_fused_spec
from point_cloud_registration_tpu.ops.pallas.point_align import point_fused_spec
from point_cloud_registration_tpu.ops.voxelize import build_voxel_map as jax_build_voxel_map
import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.core.config import (
    CorrespondenceConfig,
    ICPConfig,
    NDTConfig,
    PlaneICPConfig,
    VPlaneICPConfig,
)
from point_cloud_registration_tpu_torch.core.gn import (
    GNStats,
    batched_gauss_newton,
    solve_6x6,
    solve_6x6_batched,
)
from point_cloud_registration_tpu_torch.core.se3 import makeRt
from point_cloud_registration_tpu_torch.models._fused import (
    fused_voxel_align,
    fused_voxel_align_batched,
)
from point_cloud_registration_tpu_torch.models._point_fused import (
    fused_point_align,
    fused_point_align_batched,
)
from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius
from point_cloud_registration_tpu_torch.models.icp import build_icp_target
from point_cloud_registration_tpu_torch.models.ndt import build_ndt_target
from point_cloud_registration_tpu_torch.models.plane_icp import build_plane_icp_target
from point_cloud_registration_tpu_torch.models.voxelized_plane_icp import build_vplane_target
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa
from oracles import make_scene

TOL_T = 1e-5  # batched vs JAX, and vs the port's single aligns (equal on the CPU)
# NDT against the JAX class: its CPU path takes the icov form and the port the
# whitened one, equal in exact arithmetic (T within 2e-5 on this scene)
TOL_T_NDT_CLASS = 1e-4
TOL_T_GN = 1e-6  # the synthetic GN loop against JAX's
PACKED = dict(method="packed")
# distinct initial transforms of the problems (6-dof, translation first)
INIT_DX = [
    [0.01, 0.0, 0.0, 0.002, 0.0, 0.0],
    [0.0, -0.02, 0.01, 0.0, 0.003, -0.002],
    [-0.015, 0.01, -0.01, -0.002, 0.0, 0.003],
]
OFFSETS = [[0.04, -0.02, 0.06], [-0.03, 0.05, 0.02], [0.0, 0.0, 0.1]]


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.RandomState(5)).astype(np.float32)


def _scans(pts, B, n, seed, noise=0.0):
    rng = np.random.RandomState(seed)
    return np.stack([
        pts[rng.choice(len(pts), n, replace=False)] + np.float32(OFFSETS[b])
        + (rng.randn(n, 3) * noise).astype(np.float32) for b in range(B)
    ]).astype(np.float32)


def _init_Ts(B):
    return np.stack([np.asarray(jax_plus(jnp.eye(4), jnp.asarray(d, jnp.float32)))
                     for d in INIT_DX[:B]]).astype(np.float32)


def _check_against(Ts, diag, refs, atol=TOL_T):
    """Hold batched ``(Ts, diag)`` to per-problem ``refs`` [(T, iterations,
    converged)]."""
    for b, (T_r, it_r, conv_r) in enumerate(refs):
        np.testing.assert_allclose(np.asarray(Ts[b]), np.asarray(T_r), rtol=0, atol=atol)
        assert int(diag.iterations[b]) == int(it_r)
        assert bool(diag.converged[b]) == bool(conv_r)


# --- batched solve ---------------------------------------------------------


def test_solve_6x6_batched_rows_equal_single():
    rng = np.random.RandomState(0)
    A = rng.randn(9, 12, 6).astype(np.float32) * np.float32([1e-3, 1.0, 1e3])[rng.randint(0, 3, 9),
                                                                            None, None]
    H = np.einsum("bki,bkj->bij", A, A).astype(np.float32)
    H[4] = 0.0  # singular: a NaN row, never an exception
    g = (rng.randn(9, 6) * 10).astype(np.float32)
    dx = solve_6x6_batched(torch.from_numpy(H), torch.from_numpy(g))
    assert dx.shape == (9, 6) and dx.dtype == np.float32
    for b in range(9):
        single = solve_6x6(torch.from_numpy(H[b]), torch.from_numpy(g[b])).numpy()
        np.testing.assert_array_equal(dx[b], single)
    assert not np.isfinite(dx[4]).any()
    assert np.isfinite(np.delete(dx, 4, axis=0)).all()


# --- the batched GN loop on a synthetic quadratic ---------------------------
#
# Point-to-point with known correspondences per problem, written in NumPy for
# the port and in jax.numpy for the JAX loop. Problem 0 converges fast, 1
# later (another offset), 2 is damped (H x 25: steps of 1/25) and reaches
# max_iter, 3 has zero weights (H = 0: a non-finite step at once).

GN_MAX_ITER, GN_TOL = 12, 1e-4
GN_DAMP = np.float32([1.0, 1.0, 25.0, 1.0])
GN_WEIGHT = np.float32([1.0, 1.0, 1.0, 0.0])


def skew_np(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices, float32."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = np.zeros_like(x)
    return np.stack([np.stack([zero, -z, y], -1), np.stack([z, zero, -x], -1),
                     np.stack([-y, x, zero], -1)], -2).astype(np.float32)


def _gn_problems():
    rng = np.random.RandomState(3)
    P = rng.randn(4, 40, 3).astype(np.float32) * 3
    dx_true = np.float32([[0.1, -0.05, 0.2, 0.02, -0.01, 0.03],
                          [0.5, 0.3, -0.4, 0.1, 0.05, -0.08],
                          [0.2, 0.1, 0.0, 0.01, 0.02, 0.0],
                          [0.1, 0.1, 0.1, 0.0, 0.0, 0.0]])
    T_true = np.stack([np.asarray(jax_plus(jnp.eye(4), jnp.asarray(d))) for d in dx_true])
    Q = np.einsum("bij,bnj->bni", T_true[:, :3, :3], P) + T_true[:, None, :3, 3]
    return P, Q.astype(np.float32)


def _gn_stats_np(P, Q, Ts):
    R, t = Ts[:, :3, :3], Ts[:, :3, 3]
    r = np.einsum("bij,bnj->bni", R, P) + t[:, None, :] - Q  # (B, n, 3)
    K = -np.einsum("bij,bnjk->bnik", R, skew_np(P))  # (B, n, 3, 3)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), K.shape)
    J = np.concatenate([eye, K], axis=-1)  # (B, n, 3, 6)
    w = GN_WEIGHT[:, None, None]
    H = np.einsum("bnki,bnkj->bij", J, J) * w * GN_DAMP[:, None, None]
    g = np.einsum("bnki,bnk->bi", J, r) * w[:, :, 0]
    e2 = np.einsum("bnk,bnk->b", r, r) * GN_WEIGHT
    return H.astype(np.float32), g.astype(np.float32), e2.astype(np.float32)


def _gn_stats_jax(P, Q, Ts):
    R, t = Ts[:, :3, :3], Ts[:, :3, 3]
    r = jnp.einsum("bij,bnj->bni", R, P) + t[:, None, :] - Q
    K = -jnp.einsum("bij,bnjk->bnik", R, jnp.asarray(skew_np(P)))
    J = jnp.concatenate([jnp.broadcast_to(jnp.eye(3), K.shape), K], axis=-1)
    w = jnp.asarray(GN_WEIGHT)[:, None, None]
    H = jnp.einsum("bnki,bnkj->bij", J, J) * w * jnp.asarray(GN_DAMP)[:, None, None]
    g = jnp.einsum("bnki,bnk->bi", J, r) * w[:, :, 0]
    e2 = jnp.einsum("bnk,bnk->b", r, r) * jnp.asarray(GN_WEIGHT)
    return H, g, e2


def test_batched_gauss_newton_matches_jax():
    P, Q = _gn_problems()
    n_in = np.float32(P.shape[1]) * GN_WEIGHT
    init = np.broadcast_to(np.eye(4, dtype=np.float32), (4, 4, 4)).copy()

    def stats_port(Ts):
        H, g, e2 = _gn_stats_np(P, Q, Ts.numpy())
        return GNStats(H=torch.from_numpy(H), g=torch.from_numpy(g), e2=torch.from_numpy(e2),
                       n_inliers=torch.from_numpy(n_in))

    def stats_jax(Ts):
        H, g, e2 = _gn_stats_jax(P, Q, Ts)
        return jgn.GNStats(H=H, g=g, e2=e2, n_inliers=jnp.asarray(n_in))

    T_t, d_t = batched_gauss_newton(stats_port, torch.from_numpy(init), GN_MAX_ITER, GN_TOL)
    T_j, d_j = jax.jit(lambda T0: jfused.batched_gauss_newton(
        stats_jax, T0, GN_MAX_ITER, GN_TOL))(jnp.asarray(init))
    it = d_t.iterations.numpy()
    # the four behaviours the problems were built for
    assert it[0] < it[1] < GN_MAX_ITER and it[2] == GN_MAX_ITER and it[3] == 1
    assert d_t.converged.tolist() == [True, True, False, False]
    assert d_t.solver_failed.tolist() == [False, False, False, True]
    np.testing.assert_array_equal(it, np.asarray(d_j.iterations))
    np.testing.assert_array_equal(d_t.converged.numpy(), np.asarray(d_j.converged))
    np.testing.assert_array_equal(d_t.solver_failed.numpy(), np.asarray(d_j.solver_failed))
    np.testing.assert_array_equal(d_t.inlier_history.numpy(), np.asarray(d_j.inlier_history))
    # the float histories: the same entries written; values within 1e-4 or
    # 1e-6 of the problem's largest (the float32 solves and sums of two
    # frameworks; near convergence e2 is rounding noise of its first value)
    e2_scale = np.abs(np.asarray(d_j.e2_history)).max(axis=1, keepdims=True)
    dx_hist_j = np.nan_to_num(np.asarray(d_j.dx_norm_history), nan=0.0)
    for got, want, scale in (
            (d_t.e2_history, d_j.e2_history, e2_scale),
            (d_t.final_e2[:, None], np.asarray(d_j.final_e2)[:, None], e2_scale),
            (d_t.dx_norm_history, d_j.dx_norm_history, dx_hist_j.max(axis=1, keepdims=True))):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = np.isnan(want) | (np.abs(got - want) <= np.maximum(1e-4 * np.abs(want), 1e-6 * scale))
        assert ok.all(), (got, want)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=0, atol=TOL_T_GN)
    # the failed problem kept its initial transform; each row is its single loop's
    np.testing.assert_array_equal(T_t[3].numpy(), init[3])
    for b in range(4):
        T_1, d_1 = pt.gauss_newton(lambda T: GNStats(*(x[b] for x in stats_port(
            torch.stack([T] * 4)))), torch.from_numpy(init[b]), GN_MAX_ITER, GN_TOL)
        np.testing.assert_array_equal(T_1.numpy(), T_t[b].numpy())
        assert d_1.iterations == it[b]
        np.testing.assert_array_equal(d_1.e2_history.numpy(), d_t.e2_history[b].numpy())


# --- the batched voxel stream ------------------------------------------------


def _voxel_target(pts, kind):
    if kind == "plane":
        return build_vplane_target(pts, VPlaneICPConfig(), device="cpu"), VPlaneICPConfig()
    return build_ndt_target(pts, NDTConfig(), device="cpu"), NDTConfig()


def test_voxel_batched_matches_jax_interpret(scene):
    """The JAX batched function with its kernel in interpret mode, kind plane."""
    B, n = 2, 300
    src = _scans(scene, B, n, seed=7)
    w = np.ones((B, n), np.float32)
    T0 = _init_Ts(B)
    cfg = JaxVPlaneConfig()
    jm = jax_build_voxel_map(scene, 1.0, min_points=10, rich="normals")
    spec = voxel_fused_spec(jm, "plane", max_dist=cfg.max_dist, tq=256)
    T_j, d_j = jfused.fused_voxel_align_batched(jm, jnp.asarray(src), jnp.asarray(w),
                                                jnp.asarray(T0), cfg, spec, interpret=True)
    vm, tcfg = _voxel_target(scene, "plane")
    T_t, d_t = fused_voxel_align_batched(vm, src, w, T0, tcfg, "plane")
    _check_against(T_t, d_t, [(T_j[b], d_j.iterations[b], d_j.converged[b]) for b in range(B)])
    assert not bool(d_t.solver_failed.any())


@pytest.mark.parametrize("kind", ["plane", "ndt"])
def test_voxel_batched_matches_jax_class(scene, kind):
    """The JAX class API per problem (VPlaneICP, NDT) at B = 3, n = 500."""
    B, n = 3, 500
    src = _scans(scene, B, n, seed=11)
    T0 = _init_Ts(B)
    solver = (jpcr.VPlaneICP if kind == "plane" else jpcr.NDT)(voxel_size=1.0)
    solver.set_target(scene)
    refs = []
    for b in range(B):
        T = solver.align(src[b], T0[b])
        d = solver.last_diagnostics
        refs.append((T, d.iterations, d.converged))
    vm, cfg = _voxel_target(scene, kind)
    T_t, d_t = fused_voxel_align_batched(vm, src, np.ones((B, n), np.float32), T0, cfg, kind)
    _check_against(T_t, d_t, refs, TOL_T if kind == "plane" else TOL_T_NDT_CLASS)


# --- the batched point stream ------------------------------------------------


def _point_target(pts, kind, normals=None):
    corr = CorrespondenceConfig(**PACKED)
    if kind == "point":
        cfg = ICPConfig(corr=corr, max_iter=10)
        return build_icp_target(pts, cfg, device="cpu"), None, cfg
    cfg = PlaneICPConfig(corr=corr, max_iter=10)
    tg = build_plane_icp_target(pts, cfg, normals=normals, device="cpu")
    return tg.corr, tg.normals, cfg


def test_point_batched_matches_jax_interpret(scene):
    """The JAX batched function with its kernel in interpret mode, kind point."""
    B, n = 2, 300
    src = _scans(scene, B, n, seed=21, noise=0.004)
    w = np.ones((B, n), np.float32)
    T0 = _init_Ts(B)
    cfg = JaxICPConfig(corr=JaxCorr(**PACKED), max_iter=10)
    jt = jax_build_icp_target(scene, cfg)
    spec = point_fused_spec(jt.packed, "point", cfg.max_dist)
    T_j, d_j = jpoint_fused.fused_point_align_batched(
        jt, None, jnp.asarray(src), jnp.asarray(w), jnp.asarray(T0), cfg, spec, interpret=True)
    target, normals, tcfg = _point_target(scene, "point")
    T_t, d_t = fused_point_align_batched(target, normals, src, w, T0, tcfg, "point")
    _check_against(T_t, d_t, [(T_j[b], d_j.iterations[b], d_j.converged[b]) for b in range(B)])


@pytest.mark.parametrize("kind", ["point", "plane_pt"])
def test_point_batched_matches_jax_class(scene, kind):
    """The JAX class API per problem (ICP, PlaneICP on the same normals) at
    B = 3, n = 500."""
    B, n = 3, 500
    src = _scans(scene, B, n, seed=22, noise=0.004)
    T0 = _init_Ts(B)
    normals = pt.estimate_normals(scene, device="cpu") if kind == "plane_pt" else None
    solver = jpcr.ICP(max_iter=10) if kind == "point" else jpcr.PlaneICP(max_iter=10)
    solver.cfg = dataclasses.replace(solver.cfg, corr=JaxCorr(**PACKED))
    solver.set_target(scene) if kind == "point" else solver.set_target(scene, norm=normals)
    refs = []
    for b in range(B):
        T = solver.align(src[b], T0[b])
        d = solver.last_diagnostics
        refs.append((T, d.iterations, d.converged))
    target, tnormals, cfg = _point_target(scene, kind, normals)
    T_t, d_t = fused_point_align_batched(target, tnormals, src, np.ones((B, n), np.float32), T0,
                                         cfg, kind)
    _check_against(T_t, d_t, refs)


# --- batched against the port's single aligns, on a mixed batch --------------


def _mixed_batch(pts, n):
    """Three problems: a clean scan, a scan moved 100 m away (all outliers)
    and a scan with half its weights 0; distinct initial transforms."""
    src = _scans(pts, 3, n, seed=31)
    src[1] += np.float32([100.0, 0.0, 0.0])
    w = np.ones((3, n), np.float32)
    w[2, ::2] = 0.0
    return src, w, _init_Ts(3)


@pytest.mark.parametrize("kind", ["plane", "ndt", "point", "plane_pt"])
def test_batched_equals_single_aligns(scene, kind):
    n = 257  # no multiple of 8 or of a block
    src, w, T0 = _mixed_batch(scene, n)
    if kind in ("plane", "ndt"):
        vm, cfg = _voxel_target(scene, kind)
        T_b, d_b = fused_voxel_align_batched(vm, src, w, T0, cfg, kind)
        single = lambda b: fused_voxel_align(vm, torch.from_numpy(src[b]),  # noqa: E731
                                             torch.from_numpy(w[b]), torch.from_numpy(T0[b]),
                                             cfg, kind)
    else:
        target, normals, cfg = _point_target(scene, kind)
        T_b, d_b = fused_point_align_batched(target, normals, src, w, T0, cfg, kind)
        single = lambda b: fused_point_align(target, torch.from_numpy(src[b]),  # noqa: E731
                                             torch.from_numpy(w[b]), torch.from_numpy(T0[b]),
                                             cfg, kind, normals)
    assert T_b.shape == (3, 4, 4) and d_b.iterations.shape == (3,)
    assert d_b.e2_history.shape == (3, cfg.max_iter)
    for b in range(3):
        T_1, d_1 = single(b)
        np.testing.assert_array_equal(T_b[b].numpy(), T_1.numpy())
        assert int(d_b.iterations[b]) == d_1.iterations
        assert bool(d_b.converged[b]) == d_1.converged
        assert bool(d_b.solver_failed[b]) == d_1.solver_failed
        np.testing.assert_array_equal(d_b.e2_history[b].numpy(), d_1.e2_history.numpy())
        assert float(d_b.final_e2[b]) == np.float32(d_1.final_e2)
    # the all-outlier problem fails at once and keeps its initial transform
    assert bool(d_b.solver_failed[1]) and int(d_b.iterations[1]) == 1
    np.testing.assert_array_equal(T_b[1].numpy(), T0[1])
    assert bool(d_b.converged[0]) and bool(d_b.converged[2])


# --- what the batched paths refuse --------------------------------------------


def test_hashed_map_and_grid_target_raise(scene):
    src = _scans(scene, 2, 50, seed=1)
    w = np.ones((2, 50), np.float32)
    T0 = _init_Ts(2)
    hashed = pt.build_voxel_map(scene, 1.0, capacity=4096, device="cpu")
    assert hashed.hashed
    with pytest.raises(ValueError, match="hashed"):
        fused_voxel_align_batched(hashed, src, w, T0, VPlaneICPConfig())
    grid = build_icp_target(scene, ICPConfig(), device="cpu")  # 10k points: the grid method
    assert grid.packed is None
    with pytest.raises(ValueError, match="grid target"):
        fused_point_align_batched(grid, None, src, w, T0, ICPConfig())


def test_batched_launch_checks():
    R, t = torch.eye(3).expand(2, 3, 3), torch.zeros(2, 3)
    fa.check_batched(torch.zeros(2, 5, 3), torch.zeros(2, 5), R, t)
    with pytest.raises(ValueError, match="problems"):
        fa.check_batched(torch.zeros(fa.MAX_PROBLEMS + 1, 0, 3), torch.zeros(fa.MAX_PROBLEMS + 1, 0),
                         torch.eye(3).expand(fa.MAX_PROBLEMS + 1, 3, 3),
                         torch.zeros(fa.MAX_PROBLEMS + 1, 3))
    with pytest.raises(ValueError, match="are not"):
        fa.check_batched(torch.zeros(2, 5, 3), torch.zeros(2, 4), R, t)
    poses = fa.pose_rows(torch.stack([torch.eye(3), 2 * torch.eye(3)]),
                         torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]), "cpu")
    assert poses.shape == (2, 12)
    assert poses[1].tolist() == [2.0, 0, 0, 0, 2.0, 0, 0, 0, 2.0, 4.0, 5.0, 6.0]
    # per-problem sums of (B, n_blocks, 29) partials, as a single launch sums its rows
    parts = torch.randn(3, 7, fa.STATS_WIDTH)
    np.testing.assert_array_equal(fa.sum_partials(parts)[2].numpy(), parts[2].sum(dim=0).numpy())


@pytest.mark.parametrize("kind", ["plane", "ndt", "point", "plane_pt"])
def test_batched_wrapper_rows_equal_single_wrapper(scene, kind):
    """The batched wrappers' rows are the single wrappers' stats of each
    problem; each batched wrapper counts its own launches, none on the CPU."""
    src, w, T0 = _mixed_batch(scene, 64)
    R, t = makeRt(torch.from_numpy(T0))
    src_t, w_t = torch.from_numpy(src), torch.from_numpy(w)
    if kind in ("plane", "ndt"):
        vm, cfg = _voxel_target(scene, kind)
        args = (vm.cells, vm.origin_cell, vm.dims, vm.cell_size)
        tail = (cfg.max_dist, cfg.huber_delta)
        batched = getattr(fa, f"fused_{kind}_stats_batched")
        single = getattr(fa, f"fused_{kind}_stats")
    else:
        target, _, cfg = _point_target(scene, kind)
        args = (target.packed, target.proxy)
        tail = (cfg.max_dist, proxy_radius(cfg.corr, cfg.max_dist), cfg.huber_delta)
        name = "point_stats" if kind == "point" else "plane_point_stats"
        batched, single = getattr(pa, f"{name}_batched"), getattr(pa, name)
    before = batched.launches
    out = batched(*args, src_t, w_t, R, t, *tail)
    assert out.shape == (3, fa.STATS_WIDTH) and batched.launches == before
    for b in range(3):
        np.testing.assert_array_equal(out[b].numpy(),
                                      single(*args, src_t[b], w_t[b], R[b], t[b], *tail).numpy())
