"""Port parity of PlaneICP on the packed point grid: the target build (packed
rows of width 6 with the normals, proxy voxels with their planes), the plain
version of the "plane_pt" stats kernel and the whole ``PlaneICP.set_target``
+ ``align`` of point_cloud_registration_tpu_torch against the JAX package
(both with ``CorrespondenceConfig(method="packed")``) and against the
float64 oracle.

With injected normals both packages hold bit-equal packed rows, so
correspondences agree one for one and the stats differ by float32 summation
order only: normalised by their largest entry within 1e-5; T within 1e-4 of
JAX's with equal iteration counts. With each package's own normals (equal on
the certified points, free on the approximate tail) T agrees within 1e-3.
H / g / e2 lie within 1e-3 (relative to their largest entry) of the float64
kd-tree oracle where every query resolves within ``cell_fine``: the
reference's own test bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

from point_cloud_registration_tpu import PlaneICP as JaxPlaneICP
from point_cloud_registration_tpu.core.config import CorrespondenceConfig as JaxCorr
from point_cloud_registration_tpu.core.config import PlaneICPConfig as JaxPlaneICPConfig
from point_cloud_registration_tpu.models.plane_icp import (
    build_plane_icp_target as jax_build_plane_icp_target,
)
from point_cloud_registration_tpu_torch import CorrespondenceConfig, PlaneICP, PlaneICPConfig
from point_cloud_registration_tpu_torch.models import (
    build_plane_icp_target,
    pad_points,
    plane_icp_align,
    plane_icp_stats,
)
from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import stats_from_packed
from point_cloud_registration_tpu_torch.ops.kernels.point_align import (
    plane_point_stats,
    plane_point_stats_reference,
    point_stats,
)
from point_cloud_registration_tpu_torch.utils.convert import plane_icp_target_from_numpy
from oracles import gn_align_np, make_scan, make_scene, plane_stats_np, plus_np, transform_np
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_DIST = 2.0
PACKED = dict(method="packed")
PARAMS = dict(max_iter=30, max_dist=MAX_DIST, tol=1e-3)

# (scene seed, scan seed, 6-dof offset)
SCANS = {
    "small_offset": (0, 1, [0.02, -0.02, 0.04, 0.008, -0.01, 0.012]),
    "scene_offset": (0, 2, [0.05, -0.04, 0.1, 0.01, -0.015, 0.02]),
    "large_offset": (3, 4, [0.3, -0.25, 0.2, 0.02, -0.03, 0.05]),
}


def _port_picp(**kw) -> PlaneICP:
    """The port's PlaneICP on the packed engine whatever the target size."""
    s = PlaneICP(device="cpu", **kw)
    s.cfg = dataclasses.replace(s.cfg, corr=CorrespondenceConfig(**PACKED))
    return s


def _jax_picp(**kw) -> JaxPlaneICP:
    s = JaxPlaneICP(**kw)
    s.cfg = dataclasses.replace(s.cfg, corr=JaxCorr(**PACKED), backend="xla")
    return s


def _scene_normals(pts):
    """Analytic normals of oracles.make_scene (z for the floor, else
    horizontal), perturbed a little so that they are generic unit vectors."""
    rng = np.random.RandomState(len(pts))
    n = np.where((np.abs(pts[:, 2]) < 0.05)[:, None], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    n = n + rng.randn(len(pts), 3) * 0.05
    return (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)


def _normalised_close(got, want, atol):
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol)


def _carry(jt):
    """The JAX target as the port's, through NumPy."""
    pg, px = jt.corr.packed, jt.corr.proxy
    return plane_icp_target_from_numpy(
        jt.corr.points, jt.normals, pg.origin_fine, pg.cell_fine, pg.nb_dims, pg.block_row,
        pg.row_key, pg.pts_packed, pg.idx_packed, pg.row_over, px.means, px.counts, px.valid,
        device="cpu", proxy_normals=px.normals,
    )


@pytest.fixture(scope="module")
def targets():
    pts = make_scene(np.random.RandomState(0))
    normals = _scene_normals(pts)
    jt = jax_build_plane_icp_target(pts, JaxPlaneICPConfig(**PARAMS, corr=JaxCorr(**PACKED)),
                                    normals=normals)
    tt = build_plane_icp_target(pts, PlaneICPConfig(**PARAMS, corr=CorrespondenceConfig(**PACKED)),
                                normals=normals, device="cpu")
    return pts, normals, jt, tt


def test_target_matches_jax(targets):
    pts, normals, jt, tt = targets
    pg, jpg = tt.corr.packed, jt.corr.packed
    n = pg.pts_packed.shape[0] - 1
    assert pg.width == 6 and pg.cap == jpg.cap == 32
    np.testing.assert_array_equal(pg.pts_packed.numpy()[:n], np.asarray(jpg.pts_packed)[:n])
    np.testing.assert_array_equal(pg.idx_packed.numpy()[:n], np.asarray(jpg.idx_packed)[:n])
    np.testing.assert_array_equal(tt.normals.numpy(), normals)
    np.testing.assert_array_equal(tt.corr.proxy.valid.numpy()[:n],
                                  np.asarray(jt.corr.proxy.valid)[:n])
    np.testing.assert_array_equal(tt.corr.proxy.valid.numpy(),
                                  tt.corr.proxy.counts.numpy() >= 3)  # proxy_min_points
    valid = tt.corr.proxy.valid.numpy()[:n] & (tt.corr.proxy.counts.numpy()[:n] >= 8)
    dots = np.abs((tt.corr.proxy.normals.numpy()[:n] * np.asarray(jt.corr.proxy.normals)[:n])
                  .sum(1))
    assert np.median(dots[valid]) > 1 - 1e-6 and (dots[valid] > 1 - 1e-4).mean() > 0.95


def test_carried_target_equals_port_build(targets):
    _, _, jt, tt = targets
    ct = _carry(jt)
    for name in ("block_row", "row_key", "pts_packed", "idx_packed", "row_over", "row_count"):
        torch.testing.assert_close(getattr(ct.corr.packed, name), getattr(tt.corr.packed, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(ct.normals, tt.normals, rtol=0, atol=0)
    torch.testing.assert_close(ct.corr.proxy.table[:, :4], tt.corr.proxy.table[:, :4],
                               rtol=0, atol=2e-5)
    np.testing.assert_array_equal(ct.corr.proxy.normals.numpy()[:-1],
                                  np.asarray(jt.corr.proxy.normals)[:len(ct.corr.proxy.normals) - 1])


POSES = {
    "identity": np.zeros(6),
    "near": np.array([0.03, -0.02, 0.04, 0.01, -0.008, 0.012]),
    "offset": np.array([0.3, -0.2, 0.15, 0.02, -0.03, 0.04]),
}


@pytest.mark.parametrize("huber_delta", [None, 0.05], ids=["plain", "huber"])
@pytest.mark.parametrize("pose", sorted(POSES))
def test_plane_point_stats_reference_matches_jax(targets, pose, huber_delta):
    """Against ``PlaneICP.calc_H_g_e2`` of the JAX package on the carried
    (shared) target, so that proxy matches see the same voxel normals."""
    pts, normals, jt, _ = targets
    rng = np.random.RandomState(5)
    scan = (pts[rng.choice(len(pts), 2000, replace=False)]
            + rng.randn(2000, 3) * 0.01).astype(np.float32)
    T = plus_np(np.eye(4), POSES[pose])
    js = _jax_picp(**PARAMS, huber_delta=huber_delta)
    js._target = jt
    want = js.calc_H_g_e2(T, scan)
    ps = _port_picp(**PARAMS, huber_delta=huber_delta)
    ps._target = _carry(jt)
    got = ps.calc_H_g_e2(T, scan)
    _normalised_close(got, want, atol=1e-5)
    # the class goes through the wrapper; the plain version is what it runs here
    src, w = pad_points(scan, device="cpu")
    Tt = torch.as_tensor(T, dtype=torch.float32)
    packed = plane_point_stats_reference(
        ps._target.corr.packed, ps._target.corr.proxy, src, w, Tt[:3, :3], Tt[:3, 3], MAX_DIST,
        proxy_radius(ps.cfg.corr, MAX_DIST), huber_delta)
    st = stats_from_packed(packed)
    np.testing.assert_allclose(st.H.numpy(), got[0], rtol=0, atol=0)
    np.testing.assert_allclose(st.g.numpy(), got[1], rtol=0, atol=0)


def test_proxy_matches_use_the_voxel_normal(targets):
    """At a large offset some queries leave the packed tier: their rows use
    the proxy voxel's plane, and the stats still match the JAX package's."""
    pts, _, jt, tt = targets
    from point_cloud_registration_tpu_torch.models._point_corr import match_points

    scan = torch.from_numpy(pts[::3].copy()) + torch.tensor([0.9, -0.7, 0.8])
    m = match_points(tt.corr, scan, CorrespondenceConfig(**PACKED), MAX_DIST)
    proxy = (m.proxy_slot >= 0) & (m.weight > 0)
    raw = m.point_idx >= 0
    assert int(proxy.sum()) > 20 and int(raw.sum()) > 20
    torch.testing.assert_close(m.feat[raw], tt.normals[m.point_idx[raw]], rtol=0, atol=0)


@pytest.fixture(scope="module")
def sparse_cube():
    """600 random points in a 4 m cube with random unit normals: about 9 per
    block, none over the cap, so a match within cell_fine is the exact
    nearest neighbour, as the kd-tree oracle finds it."""
    rng = np.random.RandomState(43)
    pts = (rng.rand(600, 3) * 4).astype(np.float32)
    normals = rng.randn(600, 3)
    return pts, (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)


SMALL_DX = np.array([0.02, -0.03, 0.01, 0.01, -0.005, 0.008])


@pytest.mark.parametrize("at", ["identity", "moved"])
def test_plane_stats_match_float64_oracle(sparse_cube, at):
    pts, normals = sparse_cube
    src = transform_np(plus_np(np.eye(4), SMALL_DX), pts).astype(np.float32)
    T = np.eye(4) if at == "identity" else plus_np(np.eye(4), -0.5 * SMALL_DX)
    ps = _port_picp(max_iter=10, max_dist=MAX_DIST, tol=1e-3)
    ps.set_target(pts, norm=normals)
    assert not bool(ps._target.corr.packed.row_over.any())
    H1, g1, e2_1 = ps.calc_H_g_e2(T, src)
    H2, g2, e2_2, _ = plane_stats_np(pts, normals, src, T, MAX_DIST)
    assert H1.dtype == np.float64
    _normalised_close([H1, g1, np.float64(e2_1)], [H2, g2, np.float64(e2_2)], atol=1e-3)


def test_align_matches_reference_loop(sparse_cube):
    pts, normals = sparse_cube
    src = transform_np(plus_np(np.eye(4), SMALL_DX), pts).astype(np.float32)
    ps = _port_picp(**PARAMS)
    ps.set_target(pts, norm=normals)
    T_ours = ps.align(src)
    T_ref, _ = gn_align_np(lambda T: plane_stats_np(pts, normals, src, T, MAX_DIST),
                           max_iter=30, tol=1e-3)
    np.testing.assert_allclose(T_ours, T_ref, atol=2e-3)


@pytest.mark.parametrize("scan_name", sorted(SCANS))
def test_align_with_injected_normals_matches_jax(scan_name):
    scene_seed, scan_seed, dx = SCANS[scan_name]
    pts = make_scene(np.random.RandomState(scene_seed))
    normals = _scene_normals(pts)
    scan, T_true = make_scan(np.random.RandomState(scan_seed), pts, np.array(dx))
    js = _jax_picp(**PARAMS)
    js.set_target(pts, norm=normals)
    Tj = js.align(scan)
    ps = _port_picp(**PARAMS)
    ps.set_target(pts, norm=normals)
    Tp = ps.align(scan)
    assert ps.last_diagnostics.converged
    assert ps.last_diagnostics.iterations == int(js.last_diagnostics.iterations)
    assert np.abs(Tp - Tj).max() < 1e-4
    assert np.abs(Tp @ T_true - np.eye(4)).max() < 0.03


@pytest.mark.parametrize("scan_name", ["small_offset", "scene_offset"])
def test_align_with_own_normals_matches_jax(scan_name):
    """Each package estimates the target's normals itself (k = 15)."""
    scene_seed, scan_seed, dx = SCANS[scan_name]
    pts = make_scene(np.random.RandomState(scene_seed))
    scan, T_true = make_scan(np.random.RandomState(scan_seed), pts, np.array(dx))
    js = _jax_picp(**PARAMS)
    js.set_target(pts)
    Tj = js.align(scan)
    ps = _port_picp(**PARAMS)
    ps.set_target(pts)
    Tp = ps.align(scan)
    assert ps.last_diagnostics.iterations == int(js.last_diagnostics.iterations)
    assert np.abs(Tp - Tj).max() < 1e-3
    assert np.abs(Tp @ T_true - np.eye(4)).max() < 0.03
    assert ps.normal.shape == (len(pts), 3)
    assert float((ps.normal.norm(dim=1) - 1).abs().max()) < 1e-4


def test_functional_align_equals_class(targets):
    pts, normals, _, tt = targets
    scan, _ = make_scan(np.random.RandomState(2), pts, np.array(SCANS["scene_offset"][2]))
    cfg = PlaneICPConfig(**PARAMS, corr=CorrespondenceConfig(**PACKED))
    src, w = pad_points(scan, device="cpu")
    res = plane_icp_align(tt, src, w, torch.eye(4), cfg)
    ps = _port_picp(**PARAMS)
    ps.set_target(pts, kdree="ignored", norm=normals)
    np.testing.assert_array_equal(ps.align(scan), res.T.numpy().astype(np.float64))
    np.testing.assert_array_equal(ps.normal.numpy(), normals)
    st = plane_icp_stats(tt, src, w, torch.eye(4), cfg)
    assert float(st.n_inliers) == len(scan) and st.H.shape == (6, 6)


def test_wrapper_takes_the_plain_version_on_the_cpu(targets):
    pts, _, _, tt = targets
    src, w = pad_points(pts[::5], device="cpu")
    R, t = torch.eye(3), torch.zeros(3)
    before = plane_point_stats.launches
    a = plane_point_stats(tt.corr.packed, tt.corr.proxy, src, w, R, t, MAX_DIST, 2)
    b = plane_point_stats_reference(tt.corr.packed, tt.corr.proxy, src, w, R, t, MAX_DIST, 2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert plane_point_stats.launches == before
    # the "point" kind reads xyz at the slot stride too: the same matches on
    # a width-6 grid as ICP finds on its own
    c = point_stats(tt.corr.packed, tt.corr.proxy, src, w, R, t, MAX_DIST, 2)
    assert float(c[28]) == float(a[28])


def test_align_before_set_target_raises():
    with pytest.raises(ValueError, match="Target is not set"):
        _port_picp().align(np.zeros((10, 3), np.float32))


def test_small_target_needs_the_packed_method():
    # A small target takes the CSR grid (its parity with the JAX package is
    # in tests/test_torch_icp_grid.py): no packed rows, the given normals kept.
    pts = np.random.RandomState(0).rand(500, 3).astype(np.float32)
    picp = PlaneICP(device="cpu")
    picp.set_target(pts, norm=np.tile([0.0, 0.0, 1.0], (500, 1)))
    assert picp._target.corr.packed is None and picp._target.corr.grid is not None
    assert bool((picp.normal[:, 2] == 1.0).all())
    # one normal for all points leaves H of rank 3: the solver stops, flagged
    T = picp.align(pts + np.float32([0.0, 0.0, 0.01]))
    assert np.isfinite(T).all() and picp.last_diagnostics.solver_failed


@pytest.mark.parametrize("kind", ["two_blocks", "one_block", "two_proxies"])
def test_ties_take_the_first_candidate_in_probe_order(kind):
    """The tie scene of tests/test_torch_icp.py with a random unit normal per
    point: at equal distance the plain "plane_pt" version takes the candidate
    the JAX package takes (the first block in probe order, the first slot of a
    block, the first proxy voxel), seen in r = n . (q - t) of the winner."""
    from test_torch_icp import tie_scene, tie_winner

    pts, ties = tie_scene()
    q, tied = ties[kind]
    rng = np.random.RandomState(7)
    normals = rng.randn(len(pts), 3)
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    jt = jax_build_plane_icp_target(pts, JaxPlaneICPConfig(**PARAMS, corr=JaxCorr(**PACKED)),
                                    normals=normals)
    js = _jax_picp(**PARAMS)
    js._target = jt
    ps = _port_picp(**PARAMS)
    ps._target = _carry(jt)
    want = js.calc_H_g_e2(np.eye(4), q)
    got = ps.calc_H_g_e2(np.eye(4), q)
    _normalised_close(got, want, atol=1e-6)
    own = _port_picp(**PARAMS)
    own.set_target(pts, norm=normals)  # the port's own build: the same rows
    _normalised_close(own.calc_H_g_e2(np.eye(4), q), want, atol=1e-6)
    if kind != "two_proxies":
        winner = tie_winner(ps._target.corr.packed, pts, kind, tied)
        r = {tuple(t): float(normals[np.flatnonzero((pts == t).all(axis=1))[0]] @ (q[1] - t))
             for t in tied}
        loser = tied[1] if (winner == tied[0]).all() else tied[0]
        assert abs(r[tuple(winner)] ** 2 - r[tuple(loser)] ** 2) > 1e-4
        np.testing.assert_allclose(got[2], r[tuple(winner)] ** 2, rtol=1e-5)
