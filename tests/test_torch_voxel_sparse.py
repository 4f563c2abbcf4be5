"""Port parity of the hashed voxel map (the build of boxes over the dense
budget, or with a ``capacity``), ``query_nearest_voxel``,
``update_voxel_map`` / ``update_target``, ``voxel_filter`` and
``color_by_voxel`` against the JAX package, on seeded NumPy inputs (the
cases of tests/test_voxel.py:81-163 and :185-230).

A hashed map is forced at small size with ``capacity=`` or a dense budget
of one cell (the JAX side: ``build_grid(..., dense_budget=1)`` and
``_finish_voxel_map``, as tests/test_boundary_guard.py:57 does), or built
for real from two copies of a scene 1 km apart, whose box is over the dense
budget.

Tolerances: counts and valid masks equal; means, covariances and centroids
within 1e-5 relative to the largest entry (the port's sums are exact, the
JAX package's float32); normals within 1e-4 in |cos|; T within 1e-3 of the
JAX package's with equal iteration counts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import point_cloud_registration_tpu as jpcr
from point_cloud_registration_tpu.core.config import NDTConfig as JaxNDTConfig
from point_cloud_registration_tpu.core.config import VPlaneICPConfig as JaxVPlaneConfig
from point_cloud_registration_tpu.models.base import pad_points as jax_pad_points
from point_cloud_registration_tpu.models.ndt import ndt_align as jax_ndt_align
from point_cloud_registration_tpu.models.voxelized_plane_icp import vplane_align as jax_vplane_align
from point_cloud_registration_tpu.ops import hashgrid as jgrid
from point_cloud_registration_tpu.ops import voxelize as jvox
from point_cloud_registration_tpu_torch import NDT, VPlaneICP
from point_cloud_registration_tpu_torch.ops import voxelize as tvox
from point_cloud_registration_tpu_torch.ops.knn import cell_index
from point_cloud_registration_tpu_torch.utils.convert import (
    grid_from_numpy,
    hashed_voxel_map_from_numpy,
)
from oracles import make_scan, make_scene, voxel_stats_np
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PARAMS = dict(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)
DX = np.array([0.05, -0.04, 0.1, 0.01, -0.015, 0.02])
FAR = np.float32([1000.0, 1000.0, 100.0])  # a second copy this far: over the budget


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(11)
    centers = rng.rand(40, 3) * 10
    return (centers[:, None, :] + rng.randn(40, 60, 3) * 0.4).reshape(-1, 3).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    pts = make_scene(np.random.RandomState(5))
    scan, _ = make_scan(np.random.RandomState(6), pts, DX)
    return pts, scan


def _np(x):
    return np.asarray(jax.device_get(x))


def _rel_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol)


def _hashed(pts, cell=1.0, **kw):
    """The port's map of ``pts`` with a dense budget of one cell: hashed, no
    dense key table."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvox, "DENSE_CELL_BUDGET", 1)
        return tvox.build_voxel_map(pts, cell, device="cpu", **kw)


def _jax_hashed(pts, with_icov=False, min_points=5, **kw):
    jg, jinv, _ = jgrid.build_grid(pts, 1.0, **kw)
    return jvox._finish_voxel_map(jnp.asarray(pts), jg, jinv, min_points=min_points,
                                  with_icov=with_icov)


def _assert_maps_match(tvm, jvm):
    np.testing.assert_array_equal(tvm.grid.keys.numpy(), _np(jvm.grid.keys))
    np.testing.assert_array_equal(tvm.counts.numpy(), _np(jvm.counts))
    np.testing.assert_array_equal(tvm.valid.numpy(), _np(jvm.valid))
    occ = tvm.counts.numpy() > 0
    _rel_close(tvm.means.numpy()[occ], _np(jvm.means)[occ])
    _rel_close(tvm.covs.numpy()[occ], _np(jvm.covs)[occ])
    valid = tvm.valid.numpy()
    cos = np.abs(np.sum(tvm.normals.numpy()[valid] * _np(jvm.normals)[valid], axis=-1))
    assert cos.min() > 1 - 1e-4
    if jvm.icovs is not None:
        icov_t, icov_j = tvm.icovs.numpy()[valid], _np(jvm.icovs)[valid]
        scale = np.abs(icov_j).max(axis=1, keepdims=True)
        np.testing.assert_allclose(icov_t / scale, icov_j / scale, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kw", [{"dense_budget": 1}, {"capacity": 4096}],
                         ids=["over_budget", "capacity"])
@pytest.mark.parametrize("with_icov", [False, True], ids=["plane", "ndt"])
def test_hashed_build_matches_jax(cloud, kw, with_icov):
    jvm = _jax_hashed(cloud, with_icov=with_icov, **kw)
    if "capacity" in kw:
        tvm = tvox.build_voxel_map(cloud, 1.0, min_points=5, with_icov=with_icov,
                                   capacity=4096, device="cpu")
    else:
        tvm = _hashed(cloud, min_points=5, with_icov=with_icov,
                      capacity=int(jvm.means.shape[0]))
    assert tvm.hashed and tvm.cells is None
    assert (tvm.grid.dense is None) == (jvm.grid.dense is None)
    _assert_maps_match(tvm, jvm)


def test_hashed_build_matches_oracle(cloud):
    vm = _hashed(cloud, min_points=1)
    oracle = voxel_stats_np(cloud, 1.0)
    assert vm.grid.n_cells == len(oracle)
    keys = vm.grid.keys.numpy()
    nx, ny, _ = vm.dims
    cells = np.stack([keys % nx, (keys // nx) % ny, keys // (nx * ny)], -1) + vm.origin_cell
    slot_of = {tuple(c): i for i, c in enumerate(cells[:vm.grid.n_cells])}
    covs = vm.covs.numpy()
    for cell, (n, mean, cov) in oracle.items():
        s = slot_of[tuple(int(x) for x in cell)]
        assert vm.counts[s] == n
        np.testing.assert_allclose(vm.means[s].numpy(), mean, atol=1e-4)
        full = covs[s][[0, 3, 4, 3, 1, 5, 4, 5, 2]].reshape(3, 3)
        np.testing.assert_allclose(full, cov, atol=1e-4)


def test_hashed_and_dense_builds_agree_bit_for_bit(cloud):
    dense = tvox.build_voxel_map(cloud, 1.0, min_points=5, with_icov=True, device="cpu")
    hashed = _hashed(cloud, min_points=5, with_icov=True)
    keys = hashed.grid.keys[:hashed.grid.n_cells].long()
    n = hashed.grid.n_cells
    for a, b in ((hashed.means, dense.means), (hashed.covs, dense.covs),
                 (hashed.counts, dense.counts), (hashed.normals, dense.normals),
                 (hashed.icovs, dense.icovs)):
        assert torch.equal(a[:n], b[keys])
    assert int(dense.counts.sum()) == int(hashed.counts[:n].sum()) == len(cloud)


def test_hashed_build_repeats_its_bits_for_any_point_order(cloud):
    perm = np.random.RandomState(3).permutation(len(cloud))
    a = _hashed(cloud, min_points=5)
    b = _hashed(cloud[perm], min_points=5)
    for x, y in ((a.means, b.means), (a.covs, b.covs), (a.counts, b.counts)):
        assert torch.equal(x, y)


def _two_tiles(scene):
    pts, scan = scene
    return np.vstack([pts, pts + FAR]), scan


@pytest.mark.parametrize("solver", ["vplane", "ndt"])
def test_over_budget_map_aligns_as_jax(scene, solver):
    """Two copies of a scene 1 km apart: a box of about 1e8 cells, hashed in
    both packages through the class API."""
    pts, scan = _two_tiles(scene)
    J, P = (jpcr.VPlaneICP, VPlaneICP) if solver == "vplane" else (jpcr.NDT, NDT)
    js, ts = J(**PARAMS), P(device="cpu", **PARAMS)
    js.set_target(pts)
    ts.set_target(pts)
    T_j, T_t = js.align(scan), ts.align(scan)
    assert js.voxels.grid.dense is None
    assert ts.voxels.hashed and ts.voxels.grid.dense is None
    assert ts.voxels.grid.n_cells == int(js.voxels.grid.n_cells)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-3)
    d, dj = ts.last_diagnostics, js.last_diagnostics
    assert (d.iterations, d.converged, d.solver_failed) == (
        int(dj.iterations), bool(dj.converged), bool(dj.solver_failed))
    assert d.converged


@pytest.mark.parametrize("solver", ["vplane", "ndt"])
def test_forced_hashed_map_align_matches_jax(scene, solver):
    """A hashed map of one scene, built by each package and carried from the
    JAX package, against the JAX package's align on its hashed map."""
    pts, scan = scene
    with_icov = solver == "ndt"
    jvm = _jax_hashed(pts, with_icov=with_icov, min_points=10, dense_budget=1)
    src, w = jax_pad_points(scan)
    if solver == "vplane":
        res = jax_vplane_align(jvm, src, w, jnp.eye(4, dtype=jnp.float32),
                               JaxVPlaneConfig(**PARAMS))
        port = VPlaneICP(device="cpu", **PARAMS)
    else:
        res = jax_ndt_align(jvm, src, w, jnp.eye(4, dtype=jnp.float32), JaxNDTConfig(**PARAMS))
        port = NDT(device="cpu", **PARAMS)
    built = _hashed(pts, min_points=10, with_icov=with_icov)
    g = jvm.grid
    carried = hashed_voxel_map_from_numpy(
        grid_from_numpy(g.origin_cell, g.cell_size, g.dims, _np(g.keys), _np(g.n_cells),
                        device="cpu"),
        _np(jvm.means), _np(jvm.covs), _np(jvm.normals), _np(jvm.counts), _np(jvm.valid),
        None if jvm.icovs is None else _np(jvm.icovs), device="cpu")
    for vm in (built, carried):
        port._target = vm
        np.testing.assert_allclose(port.align(scan), _np(res.T), rtol=0, atol=1e-3)
        assert port.last_diagnostics.iterations == int(res.diagnostics.iterations)


def test_query_nearest_voxel_dense_matches_jax(cloud):
    jvm = jvox.build_voxel_map(cloud, 1.0, min_points=5)
    tvm = tvox.build_voxel_map(cloud, 1.0, min_points=5, device="cpu")
    rng = np.random.RandomState(4)
    q = (cloud[rng.choice(len(cloud), 300)] + rng.randn(300, 3) * 0.8).astype(np.float32)
    q[0] = [1e3, 1e3, 1e3]
    want = jvox.query_nearest_voxel(jvm, jnp.asarray(q), voxel_size=1.0, max_dist=2.0)
    got = tvox.query_nearest_voxel(tvm, torch.from_numpy(q), voxel_size=1.0, max_dist=2.0)
    gated = _np(want.dist) < 2.0
    np.testing.assert_array_equal(got.idx.numpy()[gated], _np(want.idx)[gated])
    np.testing.assert_allclose(got.dist.numpy()[gated], _np(want.dist)[gated], rtol=1e-5)
    assert int(got.idx[0]) == -1 and gated.sum() > 200


def _parts(cloud):
    # part A spans the whole box (a dense grid cannot grow): the extremes in it
    extremes = np.unique(np.concatenate([np.argmin(cloud, axis=0), np.argmax(cloud, axis=0)]))
    mask_a = np.zeros(len(cloud), bool)
    mask_a[: len(cloud) // 2] = True
    mask_a[extremes] = True
    return cloud[mask_a], cloud[~mask_a]


def test_update_voxel_map_matches_rebuild_and_jax(cloud):
    part_a, part_b = _parts(cloud)
    inc, dropped = tvox.update_voxel_map(
        tvox.build_voxel_map(part_a, 1.0, min_points=5, with_icov=True, rich="sqrt_icov",
                             device="cpu"), part_b, min_points=5, return_dropped=True)
    full = tvox.build_voxel_map(cloud, 1.0, min_points=5, with_icov=True, rich="sqrt_icov",
                                device="cpu")
    j_inc = jvox.update_voxel_map(jvox.build_voxel_map(part_a, 1.0, min_points=5, with_icov=True),
                                  part_b, min_points=5)
    assert dropped == 0
    assert torch.equal(inc.counts, full.counts) and torch.equal(inc.valid, full.valid)
    np.testing.assert_array_equal(inc.counts.numpy(), _np(j_inc.counts))
    valid = full.valid
    _rel_close(inc.means[valid], full.means[valid])
    _rel_close(inc.covs[valid], full.covs[valid])
    _rel_close(inc.means[valid], _np(j_inc.means)[valid.numpy()])
    _rel_close(inc.covs[valid], _np(j_inc.covs)[valid.numpy()])
    # the cell index is rebuilt from the merged cells, with NDT's features
    want = cell_index(inc.means, inc.valid, tvox.sqrt_icov_u6(inc.icovs))
    for a, b in zip(inc.cells, want):
        assert torch.equal(a, b)
    # points outside the box are dropped and counted
    far, n_far = tvox.update_voxel_map(inc, np.float32([[1e4, 1e4, 1e4]]), min_points=5,
                                       return_dropped=True)
    assert n_far == 1 and torch.equal(far.counts, inc.counts)


def test_update_voxel_map_repeats_its_bits_for_any_point_order(cloud):
    part_a, part_b = _parts(cloud)
    base = tvox.build_voxel_map(part_a, 1.0, min_points=5, device="cpu")
    perm = np.random.RandomState(9).permutation(len(part_b))
    a = tvox.update_voxel_map(base, part_b, min_points=5)
    b = tvox.update_voxel_map(base, part_b[perm], min_points=5)
    for x, y in ((a.means, b.means), (a.covs, b.covs), (a.normals, b.normals)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("solver", ["vplane", "ndt"])
def test_update_target_align_matches_jax(scene, solver):
    pts, scan = scene
    perm = np.random.RandomState(7).permutation(len(pts))
    half_a, half_b = pts[perm[: len(pts) // 2]], pts[perm[len(pts) // 2:]]
    J, P = (jpcr.VPlaneICP, VPlaneICP) if solver == "vplane" else (jpcr.NDT, NDT)
    js, ts = J(**PARAMS), P(device="cpu", **PARAMS)
    for s in (js, ts):
        s.set_target(half_a)
        s.update_target(half_b)
    full = P(device="cpu", **PARAMS)
    full.set_target(pts)
    assert ts.voxels.dims == full.voxels.dims
    assert torch.equal(ts.voxels.counts, full.voxels.counts)
    assert torch.equal(ts.voxels.valid, full.voxels.valid)
    T_t, T_j = ts.align(scan), js.align(scan)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-3)
    assert ts.last_diagnostics.iterations == int(js.last_diagnostics.iterations)


def test_update_target_on_a_hashed_map_raises(scene):
    pts, _ = _two_tiles(scene)
    vp = VPlaneICP(device="cpu", **PARAMS)
    vp.set_target(pts)
    with pytest.raises(NotImplementedError):
        vp.update_target(pts[:10])


def test_solver_update_target_grows_the_map(cloud):
    vp = VPlaneICP(voxel_size=1.0, device="cpu")
    vp.set_target(cloud[:1500])
    n1 = vp.voxels.num_voxels
    vp.update_target(cloud[1500:])
    assert vp.voxels.num_voxels >= n1
    assert np.isfinite(vp.align(cloud[:800] + np.float32(0.05))).all()


@pytest.mark.parametrize("budget", ["dense", "sparse"])
def test_voxel_filter_device_matches_jax(cloud, budget, monkeypatch):
    vs = 0.8
    if budget == "sparse":
        monkeypatch.setattr(jvox, "DENSE_CELL_BUDGET", 1)
        monkeypatch.setattr(tvox, "DENSE_CELL_BUDGET", 1)
    jm, jn = jvox.voxel_filter_device(cloud, vs)
    tm, tn = tvox.voxel_filter_device(cloud, vs, device="cpu")
    assert tn == int(jn)
    _rel_close(tm[:tn].numpy(), _np(jm)[:tn])
    assert not torch.isfinite(tm[tn:]).any()


def test_voxel_filter_matches_oracle_and_repeats_its_bits(cloud):
    vs = 0.8
    ours = tvox.voxel_filter(cloud, vs, device="cpu")
    oracle = voxel_stats_np(cloud, vs)
    assert ours.shape == (len(oracle), 3) and ours.dtype == np.float32
    ref = np.stack([m for (_, m, _) in oracle.values()])
    np.testing.assert_allclose(ours[np.lexsort(ours.T)], ref[np.lexsort(ref.T)], atol=1e-4)
    perm = np.random.RandomState(2).permutation(len(cloud))
    np.testing.assert_array_equal(tvox.voxel_filter(cloud[perm], vs, device="cpu"), ours)
    np.testing.assert_allclose(ours, jpcr.voxel_filter(cloud, vs), rtol=0, atol=1e-5)


def test_color_by_voxel_matches_jax(cloud):
    got = tvox.color_by_voxel(cloud, 1.0, device="cpu")
    want = jpcr.color_by_voxel(cloud, 1.0)
    assert got.dtype == want.dtype and got.shape == (len(cloud),)
    np.testing.assert_array_equal(got["xyz"], want["xyz"])
    np.testing.assert_array_equal(got["irgb"], want["irgb"])


def test_hashed_map_boundary_point_lands_in_no_cell():
    rng = np.random.RandomState(3)
    pts = (rng.rand(4000, 3) * 30).astype(np.float32)
    pts[0] = [30.2553, 0.94, 0.05]
    pts[1:, 0] = np.minimum(pts[1:, 0], 30.0)
    cell = 0.88986
    vm = _hashed(pts, cell, min_points=1)
    n = vm.grid.n_cells
    keys = vm.grid.keys[:n].numpy().astype(np.int64)
    nx, ny, _ = vm.dims
    lo = (np.stack([keys % nx, (keys // nx) % ny, keys // (nx * ny)], -1) + vm.origin_cell) * cell
    m = vm.means[:n].numpy()
    assert np.all(m >= lo - 1e-3) and np.all(m <= lo + cell + 1e-3)
    assert int(vm.counts[:n].sum()) in (len(pts), len(pts) - 1)
