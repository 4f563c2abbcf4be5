"""Port parity of the compat shims, ``KDTree`` (``NeighborIndex``) and
``VoxelGrid``, against the JAX package and scipy's kd-tree (the cases of
tests/test_compat_exact.py).

Both shims are exact: the grid windows are fast paths whose escapes
(exhaustive search) restore exactness on sparse clouds, far queries and
large k. Tolerances: distances within 1e-6 relative of the JAX package's
(1e-4 of scipy's float64), indices equal except on exact ties; voxel fields
within 1e-5 relative to the largest entry.
"""

import numpy as np
import jax
import pytest
import torch
from scipy.spatial import cKDTree

from point_cloud_registration_tpu.compat import NeighborIndex as JaxNeighborIndex
from point_cloud_registration_tpu.compat import VoxelGrid as JaxVoxelGrid
from point_cloud_registration_tpu_torch import KDTree, NeighborIndex, VoxelGrid
from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def sparse_cloud():
    rng = np.random.RandomState(7)
    # two well-separated clusters plus isolated outliers: plenty of sparse
    # regions where a one-cell window cannot cover the true neighbour
    a = rng.randn(3000, 3) * 0.5
    b = rng.randn(3000, 3) * 0.5 + np.array([25.0, 0.0, 0.0])
    outliers = rng.rand(50, 3) * 60 - 15
    return np.vstack([a, b, outliers]).astype(np.float32)


@pytest.fixture(scope="module")
def queries(sparse_cloud):
    rng = np.random.RandomState(8)
    return np.vstack([
        sparse_cloud[rng.choice(len(sparse_cloud), 200)] + rng.randn(200, 3) * 0.1,
        rng.rand(50, 3) * 100 - 20,
    ]).astype(np.float32)


def _ties_only(cloud, q, i_got, i_want, d_want):
    """Indices may differ only where both name a point at the same distance."""
    diff = i_got != i_want
    if diff.any():
        d = np.linalg.norm(q[diff] - cloud[i_got[diff]], axis=-1)
        np.testing.assert_allclose(d, d_want[diff], rtol=1e-6)


@pytest.mark.parametrize("exact_threshold", [20_000, 0], ids=["brute_force", "grid"])
def test_1nn_matches_jax_and_scipy(sparse_cloud, queries, exact_threshold):
    cell = 0.3
    port = NeighborIndex(sparse_cloud, cell_size=cell, exact_threshold=exact_threshold,
                         device="cpu")
    jidx = JaxNeighborIndex(sparse_cloud, cell_size=cell, exact_threshold=exact_threshold)
    d, i = port.query(queries)
    jd, ji = jidx.query(queries)
    assert d.dtype == np.float32 and i.dtype == np.int32
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=0)
    ref_d, ref_i = cKDTree(sparse_cloud.astype(np.float64)).query(queries.astype(np.float64))
    np.testing.assert_allclose(d, ref_d, rtol=1e-4, atol=1e-4)
    _ties_only(sparse_cloud, queries, i, ref_i, ref_d)


def test_1nn_escapes_equal_the_exact_oracle(sparse_cloud, queries, monkeypatch):
    """The grid path's escapes go through ``exact_nn`` (its plain version on
    the CPU): the whole answer equals exhaustive search, first index on ties."""
    calls = []
    real = en.exact_nn

    def spy(q, ref):
        calls.append(q.shape[0])
        return real(q, ref)

    import point_cloud_registration_tpu_torch.compat as compat

    monkeypatch.setattr(compat, "exact_nn", spy)
    port = KDTree(sparse_cloud, exact_threshold=0, device="cpu")
    d, i = port.query(queries)
    assert calls and 0 < calls[0] < len(queries)
    od, oi = en.exact_nn_reference(torch.from_numpy(queries), torch.from_numpy(sparse_cloud))
    np.testing.assert_array_equal(d, od.numpy())
    np.testing.assert_array_equal(i, oi.numpy())


@pytest.mark.parametrize("k", [8, 30], ids=["window", "beyond_radius_k"])
def test_knn_matches_jax_and_scipy(sparse_cloud, k):
    rng = np.random.RandomState(9)
    q = sparse_cloud[rng.choice(len(sparse_cloud), 128)].astype(np.float32)
    cell = 0.45
    port = NeighborIndex(sparse_cloud, cell_size=cell, exact_threshold=0, device="cpu")
    jidx = JaxNeighborIndex(sparse_cloud, cell_size=cell, exact_threshold=0)
    d, i = port.query(q, k=k)
    jd, ji = jidx.query(q, k=k)
    assert d.shape == (128, k)
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(i, ji)
    ref_d, _ = cKDTree(sparse_cloud.astype(np.float64)).query(q.astype(np.float64), k=k)
    np.testing.assert_allclose(d, ref_d, rtol=1e-4, atol=1e-4)


def test_default_cell_size_is_the_sampled_radius(sparse_cloud):
    port = KDTree(sparse_cloud, device="cpu")
    jidx = JaxNeighborIndex(sparse_cloud)
    np.testing.assert_allclose(port.cell_size, jidx.cell_size, rtol=1e-5)


@pytest.fixture(scope="module")
def voxel_grids(sparse_cloud):
    vg = VoxelGrid(1.0, min_points=1, device="cpu")
    vg.set_points(sparse_cloud)
    jvg = JaxVoxelGrid(1.0, min_points=1)
    jvg.set_points(sparse_cloud)
    return vg, jvg


def _rel_close(got, want, rtol=1e-5):
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol)


@pytest.mark.parametrize("field", ["mean", "cov", "icov"])
def test_voxelgrid_fields_match_jax(voxel_grids, field):
    vg, jvg = voxel_grids
    vg.calc_icov()
    jvg.calc_icov()
    got, want = getattr(vg, field), getattr(jvg, field)
    assert got.shape == want.shape
    if field == "icov":
        ok = vg._compacted("count") >= 10  # cells of a few points are near-singular
        got, want = got[ok], want[ok]
        scale = np.abs(want).reshape(len(want), -1).max(axis=1)[:, None, None]
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-3)
    else:
        _rel_close(got, want)
    vg_norm = vg.norm
    assert vg_norm.shape == (len(vg.mean), 3)


def test_voxelgrid_query_far_points_get_true_nearest(voxel_grids):
    vg, jvg = voxel_grids
    q = np.array([[60.0, 60.0, 60.0], [-30.0, 5.0, 0.0]], np.float32)
    out = vg.query(q, ["mean"])
    assert np.all(np.isfinite(out["dist"])), "far queries must fall back to exact search"
    ref = np.linalg.norm(q[:, None, :] - vg.mean[None], axis=-1).min(axis=1)
    np.testing.assert_allclose(out["dist"], ref, rtol=1e-4, atol=1e-4)
    jout = jvg.query(q, ["mean"])
    np.testing.assert_allclose(out["dist"], jout["dist"], rtol=1e-5)
    _rel_close(out["mean"], jout["mean"])


def test_voxelgrid_query_caller_max_dist_matches_jax(sparse_cloud):
    vg = VoxelGrid(1.0, min_points=1, query_max_dist=6.0, device="cpu")
    vg.set_points(sparse_cloud)
    jvg = JaxVoxelGrid(1.0, min_points=1, query_max_dist=6.0)
    jvg.set_points(sparse_cloud)
    rng = np.random.RandomState(10)
    q = (sparse_cloud[rng.choice(len(sparse_cloud), 100)] + rng.randn(100, 3)).astype(np.float32)
    out = vg.query(q, ["mean", "norm"], max_dist=4.0)
    ref = np.linalg.norm(q[:, None, :] - vg.mean[None], axis=-1).min(axis=1)
    np.testing.assert_allclose(out["dist"], ref, rtol=1e-4, atol=1e-4)
    jout = jvg.query(q, ["mean", "norm"], max_dist=4.0)
    np.testing.assert_allclose(out["dist"], jout["dist"], rtol=1e-5)
    _rel_close(out["mean"], jout["mean"])
    # normals of cells of at least 10 points (a cell of two or three points
    # has no unique smallest eigenvector)
    cell = np.argmin(np.linalg.norm(out["mean"][:, None] - vg.mean[None], axis=-1), axis=1)
    planar = vg._compacted("count")[cell] >= 10
    cos = np.abs(np.sum(out["norm"] * jout["norm"], axis=-1))
    assert planar.sum() > 50 and cos[planar].min() > 1 - 1e-3


def test_voxelgrid_calc_sqrt_icov(sparse_cloud):
    vg = VoxelGrid(1.0, device="cpu")
    vg.set_points(sparse_cloud)
    vg.calc_sqrt_icov()
    assert vg.sqrt_icov.shape == (len(vg.mean), 3, 3)
    assert np.allclose(vg.sqrt_icov[:, 1, 0], 0) and np.allclose(vg.sqrt_icov[:, 2, 0], 0)
    U = vg.sqrt_icov.astype(np.float64)
    icov = vg.icov.astype(np.float64)
    scale = np.abs(icov).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(np.einsum("nji,njk->nik", U, U) / scale, icov / scale,
                               atol=2e-3)


def test_voxelgrid_update_points_matches_jax(sparse_cloud):
    a = sparse_cloud[::2]
    b = sparse_cloud[1::2]
    # keep part a's box the whole cloud's: the extremes go in first
    ext = np.unique(np.concatenate([np.argmin(sparse_cloud, 0), np.argmax(sparse_cloud, 0)]))
    a = np.vstack([a, sparse_cloud[ext]])
    vg = VoxelGrid(1.0, min_points=3, device="cpu")
    vg.set_points(a)
    vg.update_points(b)
    jvg = JaxVoxelGrid(1.0, min_points=3)
    jvg.set_points(a)
    jvg.update_points(b)
    assert vg.mean.shape == jvg.mean.shape
    _rel_close(vg.mean, jvg.mean)
    _rel_close(vg.cov, jvg.cov, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(vg.voxel_map.counts),
                                  np.asarray(jax.device_get(jvg.voxel_map.counts)))


def test_voxelgrid_errors():
    vg = VoxelGrid(1.0, device="cpu")
    with pytest.raises(ValueError):
        vg.voxel_map
    vg.set_points(np.random.RandomState(0).rand(200, 3).astype(np.float32) * 3)
    with pytest.raises(ValueError):
        vg.icov
    with pytest.raises(KeyError):
        vg.query(np.zeros((1, 3), np.float32), ["bogus"])
