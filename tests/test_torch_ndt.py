"""Port parity of NDT: the Cholesky features, the whitened / Mahalanobis
reductions, the plain version of the fused NDT kernel and the whole
``NDT.set_target`` + ``align`` of point_cloud_registration_tpu_torch against
the JAX package (Pallas in interpret mode, as the JAX package's own tests run
it on the CPU) and against the float64 oracles.

Tolerances: the closed forms within float32 rounding (rtol 1e-4 on
Cholesky factors, whose last pivot cancels; stats normalised by their
largest entry within 1e-4: thin planar voxels give inverse covariances of
condition ~1e4); the fused kind against the JAX kernel within 1e-4 of
max |H| per entry and equal inlier counts; T within 1e-3 of JAX's with equal iteration counts (the JAX
NDT takes the icov form on the CPU and the port the whitened form, equal in
exact arithmetic); H / g / e2 within 1e-3 of the float64 oracle, each
normalised by its largest entry.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_registration_tpu.core.config import NDTConfig as JaxNDTConfig
from point_cloud_registration_tpu.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu.models.base import pad_points as jax_pad_points
from point_cloud_registration_tpu.models.ndt import build_ndt_target as jax_build_ndt_target
from point_cloud_registration_tpu.models.ndt import ndt_align as jax_ndt_align
from point_cloud_registration_tpu.ops.pallas.fused_align import (
    band_layout,
    fused_stats_call,
    scatter_banded,
    voxel_fused_spec,
)
from point_cloud_registration_tpu.ops.reduce import ndt_stats as jax_ndt_stats
from point_cloud_registration_tpu.ops.reduce import whitened_stats as jax_whitened_stats
from point_cloud_registration_tpu.ops.voxelize import build_voxel_map as jax_build_voxel_map
from point_cloud_registration_tpu.ops.voxelize import sqrt_icov_packed as jax_sqrt_icov_packed
from point_cloud_registration_tpu.ops.voxelize import sqrt_icov_u6 as jax_sqrt_icov_u6
from point_cloud_registration_tpu_torch import NDT
from point_cloud_registration_tpu_torch.core.config import NDTConfig
from point_cloud_registration_tpu_torch.models import ndt_align, pad_points
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    STATS_WIDTH,
    fused_ndt_stats,
    fused_ndt_stats_reference,
    stats_from_packed,
)
from point_cloud_registration_tpu_torch.ops.reduce import ndt_stats, whitened_stats
from point_cloud_registration_tpu_torch.ops.voxelize import (
    build_voxel_map,
    sqrt_icov_packed,
    sqrt_icov_u6,
)
from point_cloud_registration_tpu_torch.utils.convert import ndt_map_from_numpy
from oracles import gn_align_np, make_scan, make_scene, ndt_stats_np, plus_np, voxel_map_np
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_DIST = 2.0
PARAMS = dict(voxel_size=1.0, max_iter=30, max_dist=MAX_DIST, tol=1e-3)

# (scene seed, scan seed, 6-dof offset); the first three are the scans of
# tests/test_ndt.py
SCANS = {
    "small_offset": (9, 11, [0.02, -0.02, 0.04, 0.008, -0.01, 0.012]),
    "calc_offset": (9, 10, [0.03, -0.02, 0.05, 0.01, 0.0, -0.01]),
    "large_offset": (9, 12, [0.1, -0.08, 0.2, 0.02, -0.02, 0.03]),
    "other_scene": (5, 7, [0.05, 0.03, -0.06, -0.01, 0.02, 0.015]),
}


def _spd_icovs(rng, n, dtype=np.float32):
    """Packed inverse covariances of thin, plane-like Gaussians, plus the
    guard value of a singular covariance."""
    A = rng.randn(n, 3, 3)
    cov = (A * np.array([1.0, 1.0, 1e-3])) @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3)
    icov = np.linalg.inv(cov)
    packed = np.stack([icov[:, 0, 0], icov[:, 1, 1], icov[:, 2, 2],
                       icov[:, 0, 1], icov[:, 0, 2], icov[:, 1, 2]], axis=-1)
    packed[0] = [1e6, 1e6, 1e6, 0.0, 0.0, 0.0]
    return packed.astype(dtype)


def _unpack(p):
    return np.stack([p[:, [0, 3, 4]], p[:, [3, 1, 5]], p[:, [4, 5, 2]]], axis=1)


@pytest.mark.parametrize("fn_pair", ["packed", "u6"])
def test_sqrt_icov_matches_jax(fn_pair):
    icovs = _spd_icovs(np.random.RandomState(0), 200)
    if fn_pair == "packed":
        ours, theirs = sqrt_icov_packed, jax_sqrt_icov_packed
    else:
        ours, theirs = sqrt_icov_u6, jax_sqrt_icov_u6
    got = ours(torch.from_numpy(icovs)).numpy()
    want = np.asarray(theirs(jnp.asarray(icovs)))
    # the last pivot of a thin Gaussian is a difference of large terms, which
    # float32 rounds differently in the two frameworks
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


def test_sqrt_icov_is_a_cholesky_factor():
    # in float64, where the thin Gaussians stay positive definite
    icovs = _spd_icovs(np.random.RandomState(1), 50, np.float64)
    U = sqrt_icov_packed(torch.from_numpy(icovs)).numpy()
    full = _unpack(icovs)
    np.testing.assert_allclose(U.transpose(0, 2, 1) @ U, full, rtol=1e-9,
                               atol=1e-12 * np.abs(full).max())
    assert np.all(np.tril(U, -1) == 0)


def test_sqrt_icov_clamps_indefinite_pivots():
    # a negative pivot is clamped to 1e-20, as in the JAX package
    icov = torch.tensor([[-1.0, 1.0, 1.0, 0.0, 0.0, 0.0]])
    U = sqrt_icov_packed(icov)
    assert torch.isfinite(U).all() and float(U[0, 0, 0]) == pytest.approx(1e-10)


def _random_linearization(seed, n=500):
    rng = np.random.RandomState(seed)
    src = (rng.rand(n, 3) * 10).astype(np.float32)
    T = plus_np(np.eye(4), rng.randn(6) * 0.05).astype(np.float32)
    q = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    means = (q + rng.randn(n, 3) * 0.2).astype(np.float32)
    icovs = _spd_icovs(rng, n)
    w = (rng.rand(n) > 0.2).astype(np.float32)
    return src, q, means, icovs, w, T[:3, :3]


def _normalised_close(got, want, atol):
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol)


@pytest.mark.parametrize("huber_delta", [None, 0.5], ids=["plain", "huber"])
@pytest.mark.parametrize("form", ["ndt_stats", "whitened_stats"])
def test_ndt_reductions_match_jax(form, huber_delta):
    src, q, means, icovs, w, R = _random_linearization(2)
    if form == "ndt_stats":
        feats, ours, theirs = icovs, ndt_stats, jax_ndt_stats
    else:
        feats = np.asarray(jax_sqrt_icov_u6(jnp.asarray(icovs)))
        ours, theirs = whitened_stats, jax_whitened_stats
    # np.array copies: arrays handed out by JAX are read-only
    got = ours(*(torch.from_numpy(np.array(a)) for a in (src, q, means, feats, w, R)),
               huber_delta=huber_delta)
    want = theirs(*(jnp.asarray(a) for a in (src, q, means, feats, w, R)),
                  huber_delta=huber_delta)
    _normalised_close([x.numpy() for x in got], want, atol=1e-4)


def test_whitened_equals_mahalanobis_form():
    src, q, means, _, w, R = _random_linearization(3)
    args = [torch.from_numpy(np.ascontiguousarray(a)).double() for a in (src, q, means)]
    icov_t = torch.from_numpy(_spd_icovs(np.random.RandomState(3), len(src), np.float64))
    tail = [torch.from_numpy(w).double(), torch.from_numpy(np.ascontiguousarray(R)).double()]
    a = ndt_stats(*args, icov_t, *tail)
    b = whitened_stats(*args, sqrt_icov_u6(icov_t), *tail)
    _normalised_close([x.numpy() for x in b], [x.numpy() for x in a], atol=1e-9)


@pytest.fixture(scope="module")
def blob_scene():
    rng = np.random.RandomState(0)
    centers = rng.rand(60, 3) * 18
    pts = (centers[:, None, :] + rng.randn(60, 80, 3) * 0.5).reshape(-1, 3).astype(np.float32)
    scan = pts[rng.choice(len(pts), 1500, replace=False)] + np.float32([0.05, -0.03, 0.08])
    jm = jax_build_voxel_map(pts, 1.0, min_points=5, with_icov=True, rich="sqrt_icov")
    tm = ndt_map_from_numpy(
        jm.means, jm.covs, jm.normals, jm.counts, jm.valid, jm.grid.origin_cell,
        jm.grid.dims, jm.grid.cell_size, jm.icovs, jax_sqrt_icov_u6(jm.icovs),
        device="cpu",
    )
    return jm, tm, scan


POSES = {
    "identity": np.zeros(6),
    "perturbed": np.array([0.04, -0.05, 0.03, 0.01, -0.015, 0.02]),
}


def _jax_fused_ndt(jm, scan, T, huber_delta):
    spec = voxel_fused_spec(jm, "ndt", max_dist=MAX_DIST, huber_delta=huber_delta, tq=256)
    Tj = jnp.asarray(T, jnp.float32)
    q = transform_points(Tj, jnp.asarray(scan))
    pos = band_layout(spec, q)
    q_s, p_s, w_s = scatter_banded(
        spec, pos, q, jnp.asarray(scan), jnp.ones((len(scan),), jnp.float32)
    )
    R, _ = makeRt(Tj)
    C, unres = fused_stats_call(spec, jm.dense_blocks, q_s, p_s, w_s, R.reshape(9),
                                interpret=True)
    assert int(np.asarray(unres).sum()) == 0
    return np.asarray(C)


def _port_ndt(tm, scan, T, huber_delta=None):
    T = torch.as_tensor(T, dtype=torch.float32)
    return fused_ndt_stats_reference(
        tm.cells, tm.origin_cell, tm.dims, tm.cell_size, torch.from_numpy(scan),
        torch.ones(len(scan)), T[:3, :3], T[:3, 3], MAX_DIST, huber_delta,
    )


@pytest.mark.parametrize("huber_delta", [None, 1.0], ids=["plain", "huber"])
@pytest.mark.parametrize("pose", sorted(POSES))
def test_ndt_reference_matches_jax_fused_kernel(blob_scene, pose, huber_delta):
    jm, tm, scan = blob_scene
    T = plus_np(np.eye(4), POSES[pose]).astype(np.float32)
    C = _jax_fused_ndt(jm, scan, T, huber_delta)
    st = stats_from_packed(_port_ndt(tm, scan, T, huber_delta))
    scale = np.abs(C[:6, :6]).max()
    np.testing.assert_allclose(st.H.numpy() / scale, C[:6, :6] / scale, rtol=0, atol=1e-4)
    gs = np.abs(C[:6, 6]).max()
    np.testing.assert_allclose(st.g.numpy() / gs, C[:6, 6] / gs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(st.e2), C[6, 6], rtol=1e-4)
    np.testing.assert_allclose(float(st.n_inliers), C[7, 7], rtol=1e-6)


def test_ndt_reference_matches_float64_oracle(blob_scene):
    jm, tm, scan = blob_scene
    T = plus_np(np.eye(4), POSES["perturbed"])
    st = stats_from_packed(_port_ndt(tm, scan, T.astype(np.float32)))
    valid = np.asarray(jm.valid)
    H2, g2, e2_2, n = ndt_stats_np(
        np.asarray(jm.means, np.float64)[valid],
        _unpack(np.asarray(jm.icovs, np.float64)[valid]), scan, T, MAX_DIST,
    )
    assert int(st.n_inliers) == n
    _normalised_close([st.H.numpy(), st.g.numpy(), st.e2.numpy()], [H2, g2, e2_2], atol=1e-3)


def test_ndt_table_layout(blob_scene):
    jm, _, _ = blob_scene
    pts = np.asarray(jm.means)[np.asarray(jm.valid)]
    vm = build_voxel_map(np.repeat(pts, 12, axis=0) + np.random.RandomState(4).randn(
        len(pts) * 12, 3).astype(np.float32) * 0.1, 1.0, with_icov=True, rich="sqrt_icov",
        device="cpu")
    v = vm.valid
    centers, feats = vm.cells.centers, vm.cells.feats
    assert centers.shape == (int(v.sum()) + 1, 4) and feats.shape == (int(v.sum()) + 1, 8)
    assert vm.cells.occ.shape == (-(-int(np.prod(vm.dims)) // 32), 2)
    torch.testing.assert_close(centers[:-1, 0:3], vm.means[v], rtol=0, atol=0)
    torch.testing.assert_close(feats[:-1, 0:6], sqrt_icov_u6(vm.icovs)[v], rtol=0, atol=0)
    assert float(centers[-1].abs().sum()) == 0.0 and float(centers[:-1, 3].min()) == 1.0
    assert float(feats[-1].abs().sum()) == 0.0 and float(feats[:, 6:].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="with_icov"):
        build_voxel_map(pts, 1.0, rich="sqrt_icov", device="cpu")


def test_cpu_wrapper_runs_plain_version_without_launching(blob_scene):
    _, tm, scan = blob_scene
    T = torch.eye(4)
    out = fused_ndt_stats(tm.cells, tm.origin_cell, tm.dims, tm.cell_size,
                          torch.from_numpy(scan), torch.ones(len(scan)),
                          T[:3, :3], T[:3, 3], MAX_DIST)
    assert fused_ndt_stats.launches == 0
    assert out.shape == (STATS_WIDTH,)
    torch.testing.assert_close(out, _port_ndt(tm, scan, T), rtol=0, atol=0)


def test_wrapper_rejects_plane_table(blob_scene):
    _, tm, scan = blob_scene
    with pytest.raises(ValueError, match="ndt"):
        fused_ndt_stats(tm.cells._replace(feats=tm.cells.feats[:, :4].contiguous()),
                        tm.origin_cell, tm.dims, tm.cell_size,
                        torch.from_numpy(scan), torch.ones(len(scan)),
                        torch.eye(3), torch.zeros(3), MAX_DIST)


def _jax_ndt_align(pts, scan):
    cfg = JaxNDTConfig(**PARAMS)
    vm = jax_build_ndt_target(pts, cfg)
    src, w = jax_pad_points(scan)
    res = jax_ndt_align(vm, src, w, jnp.eye(4, dtype=jnp.float32), cfg)
    d = res.diagnostics
    return np.asarray(res.T), int(d.iterations), bool(d.converged), vm


@pytest.fixture(scope="module")
def scenes():
    return {seed: make_scene(np.random.RandomState(seed)) for seed in (5, 9)}


@pytest.mark.parametrize("scan_name", sorted(SCANS))
def test_ndt_align_matches_jax(scenes, scan_name):
    scene_seed, seed, dx = SCANS[scan_name]
    pts = scenes[scene_seed]
    scan, _ = make_scan(np.random.RandomState(seed), pts, np.array(dx))
    T_j, it_j, conv_j, _ = _jax_ndt_align(pts, scan)
    ndt = NDT(**PARAMS, device="cpu")
    ndt.set_target(pts)
    T_t = ndt.align(scan)
    d = ndt.last_diagnostics
    assert T_t.dtype == np.float64 and T_t.shape == (4, 4)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-3)
    assert d.iterations == it_j
    assert d.converged == conv_j
    assert not d.solver_failed


def test_align_on_carried_map_matches_jax(scenes):
    pts = scenes[9]
    _, seed, dx = SCANS["small_offset"]
    scan, _ = make_scan(np.random.RandomState(seed), pts, np.array(dx))
    T_j, it_j, _, jm = _jax_ndt_align(pts, scan)
    tm = ndt_map_from_numpy(jm.means, jm.covs, jm.normals, jm.counts, jm.valid,
                            jm.grid.origin_cell, jm.grid.dims, jm.grid.cell_size, jm.icovs,
                            jax_sqrt_icov_u6(jm.icovs), device="cpu")
    src, w = pad_points(scan)
    res = ndt_align(tm, src, w, torch.eye(4), NDTConfig(**PARAMS))
    np.testing.assert_allclose(res.T.numpy(), T_j, rtol=0, atol=1e-4)
    assert res.diagnostics.iterations == it_j


def test_align_recovers_transform_like_oracle(scenes):
    pts = scenes[9]
    _, seed, dx = SCANS["large_offset"]
    scan, T_true = make_scan(np.random.RandomState(seed), pts, np.array(dx))
    ndt = NDT(**PARAMS, device="cpu")
    ndt.set_target(pts)
    T_est = ndt.align(scan)
    assert np.abs(T_est @ T_true - np.eye(4)).max() < 0.02
    means, _, _, icovs = voxel_map_np(pts, 1.0, min_points=10)
    T_ref, _ = gn_align_np(lambda T: ndt_stats_np(means, icovs, scan, T, MAX_DIST),
                           max_iter=30, tol=1e-3)
    np.testing.assert_allclose(T_est, T_ref, atol=5e-3)


def test_calc_H_g_e2_matches_oracle(scenes):
    pts = scenes[9]
    _, seed, dx = SCANS["calc_offset"]
    scan, _ = make_scan(np.random.RandomState(seed), pts, np.array(dx))
    ndt = NDT(voxel_size=1.0, max_iter=10, max_dist=MAX_DIST, tol=1e-3, device="cpu")
    ndt.set_target(pts)
    H1, g1, e2_1 = ndt.calc_H_g_e2(np.eye(4), scan)
    means, _, _, icovs = voxel_map_np(pts, 1.0, min_points=10)
    H2, g2, e2_2, _ = ndt_stats_np(means, icovs, scan, np.eye(4), MAX_DIST)
    assert H1.dtype == np.float64
    _normalised_close([H1, g1, np.float64(e2_1)], [H2, g2, np.float64(e2_2)], atol=1e-3)


def test_voxels_and_unported_update(scenes):
    ndt = NDT(device="cpu")
    with pytest.raises(ValueError, match="Target is not set"):
        ndt.align(np.zeros((10, 3), np.float32))
    ndt.set_target(scenes[9])
    assert ndt.voxels.icovs is not None and ndt.voxels.cells.feats.shape[1] == 8
    # update_target merges into the map (parity in tests/test_torch_voxel_sparse.py)
    counts = ndt.voxels.counts.clone()
    ndt.update_target(scenes[9])
    assert torch.equal(ndt.voxels.counts, 2 * counts)
    assert ndt.voxels.cells.feats.shape[1] == 8
    with pytest.raises(ValueError):
        NDTConfig(backend="pallas")
