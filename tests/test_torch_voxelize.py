"""Port parity: the dense-direct voxel-map build, the closed-form 3x3
eigensolver and the analytic inverse of point_cloud_registration_tpu_torch
against the JAX package on the same seeded points.

Tolerances (float32 both sides, sums taken in another order):
* counts and valid: equal;
* means: 1e-5 absolute (cell-local float32 means of O(1 m) cells);
* covs: 1e-5 * max|cov|;
* normals: |dot| > 1 - 1e-4 on cells whose two smallest eigenvalues are
  well separated (the sign is arbitrary in both packages);
* icovs: the analytic inverse within 1e-5 of JAX's on the same float32
  covariances; a map's icovs (the port inverts its exact float64
  statistics) within 1e-5 of the float64 inverse of each valid cell's
  covariance.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import point_cloud_registration_tpu.ops.eigh3 as jeig
import point_cloud_registration_tpu.ops.hashgrid as jgrid
import point_cloud_registration_tpu.ops.voxelize as jvox
import point_cloud_registration_tpu_torch.ops.eigh3 as teig
import point_cloud_registration_tpu_torch.ops.hashgrid as tgrid
import point_cloud_registration_tpu_torch.ops.voxelize as tvox
from oracles import make_scene, voxel_stats_np
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _blobs():
    rng = np.random.RandomState(0)
    centers = rng.rand(60, 3) * 18
    return (centers[:, None, :] + rng.randn(60, 80, 3) * 0.5).reshape(-1, 3).astype(np.float32)


SCENES = {
    "room": (lambda: make_scene(np.random.RandomState(5)), 1.0, 10),
    "blobs": (_blobs, 1.0, 5),
    "room_fine": (lambda: make_scene(np.random.RandomState(9)), 0.7, 6),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def built(request):
    make, voxel, min_points = SCENES[request.param]
    pts = make()
    jm = jvox.build_voxel_map(pts, voxel, min_points=min_points, with_icov=True)
    tm = tvox.build_voxel_map(pts, voxel, min_points=min_points, with_icov=True, device="cpu")
    return jm, tm, pts


def exact_icovs(pts, tm) -> np.ndarray:
    """Packed float64 inverses of the valid cells' covariances (two-pass,
    ``oracles.voxel_stats_np``), in the map's slot order."""
    nx, ny, _ = tm.dims
    ox, oy, oz = tm.origin_cell
    covs = np.zeros((int(np.prod(tm.dims)), 3, 3))
    for (cx, cy, cz), (n, _, cov) in voxel_stats_np(pts, tm.cell_size).items():
        slot = (cx - ox) + nx * ((cy - oy) + ny * (cz - oz))
        assert n == int(tm.counts[slot])
        covs[slot] = cov
    inv = np.linalg.inv(covs[tm.valid.numpy()])
    return np.stack([inv[:, 0, 0], inv[:, 1, 1], inv[:, 2, 2], inv[:, 0, 1], inv[:, 0, 2],
                     inv[:, 1, 2]], axis=-1)


def test_build_geometry_matches_jax(built):
    jm, tm, _ = built
    assert tm.dims == tuple(int(x) for x in np.asarray(jm.grid.dims))
    assert tm.origin_cell == tuple(int(x) for x in np.asarray(jm.grid.origin_cell))
    assert tm.cell_size == float(jm.grid.cell_size)


def test_build_counts_valid_equal(built):
    jm, tm, _ = built
    np.testing.assert_array_equal(tm.counts.numpy(), np.asarray(jm.counts))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    assert tm.num_voxels == int(jm.num_voxels) > 0


def test_build_means_covs_match_jax(built):
    jm, tm, pts = built
    occ = np.asarray(jm.counts) > 0
    np.testing.assert_allclose(tm.means.numpy()[occ], np.asarray(jm.means)[occ],
                               rtol=0, atol=1e-5)
    jc = np.asarray(jm.covs)
    np.testing.assert_allclose(tm.covs.numpy(), jc, rtol=0, atol=1e-5 * np.abs(jc).max())
    # icovs of near-flat cells amplify the covariance rounding, so the
    # analytic inverse is held to JAX's inverse of the same covariances ...
    np.testing.assert_allclose(
        tvox.invert_cov_packed(tm.covs).numpy(),
        np.asarray(jvox.invert_cov_packed(jnp.asarray(tm.covs.numpy()))), rtol=1e-5, atol=0,
    )
    # ... and the map's, from exact statistics, to the float64 inverse
    np.testing.assert_allclose(tm.icovs.numpy()[tm.valid.numpy()], exact_icovs(pts, tm),
                               rtol=1e-5, atol=0)


def test_build_normals_match_jax(built):
    jm, tm, _ = built
    valid = np.asarray(jm.valid)
    lam = np.linalg.eigvalsh(np.asarray(jeig.unpack_sym3(jm.covs), np.float64))
    separated = valid & (lam[:, 1] - lam[:, 0] > 1e-2 * np.maximum(lam[:, 2], 1e-12))
    assert separated.sum() > 10
    dots = np.abs(np.sum(tm.normals.numpy() * np.asarray(jm.normals), axis=-1))
    assert dots[separated].min() > 1 - 1e-4
    # zero on invalid cells; the cell index carries the valid cells' rows in
    # key order, then a sentinel row
    assert np.all(tm.normals.numpy()[~valid] == 0)
    centers, feats = tm.cells.centers.numpy(), tm.cells.feats.numpy()
    assert centers.shape == (valid.sum() + 1, 4) and feats.shape == (valid.sum() + 1, 4)
    np.testing.assert_array_equal(centers[:-1, 3], np.ones(valid.sum(), np.float32))
    np.testing.assert_array_equal(feats[:-1, 0:3], tm.normals.numpy()[valid])
    np.testing.assert_array_equal(centers[:-1, 0:3], tm.means.numpy()[valid])
    assert not centers[-1].any() and not feats[-1].any() and not feats[:, 3].any()


def test_build_from_tensor_equals_from_numpy():
    pts = make_scene(np.random.RandomState(5))
    a = tvox.build_voxel_map(pts, 1.0, device="cpu")
    b = tvox.build_voxel_map(torch.from_numpy(pts), 1.0)
    assert a.dims == b.dims and a.origin_cell == b.origin_cell
    for x, y in zip(a.cells, b.cells):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_build_is_bitwise_independent_of_point_order():
    """The per-cell sums are exact, so any order of the points (or of the
    atomic adds on a card) gives the same map bits."""
    pts = make_scene(np.random.RandomState(5))
    a = tvox.build_voxel_map(pts, 1.0, device="cpu")
    b = tvox.build_voxel_map(pts[np.random.RandomState(1).permutation(len(pts))], 1.0,
                              device="cpu")
    for x, y in zip(b.cells, a.cells):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    torch.testing.assert_close(b.covs, a.covs, rtol=0, atol=0)


def _random_covs(rng, n=500):
    A = rng.randn(n, 3, 3)
    evals = np.sort(rng.rand(n, 3) * [1e-3, 0.3, 1.0], axis=1)
    Q, _ = np.linalg.qr(A)
    C = np.einsum("nij,nj,nkj->nik", Q, evals, Q)
    return np.array(jeig.pack_sym3(jnp.asarray(C, jnp.float32)))


def test_smallest_eigvec_matches_jax():
    s = _random_covs(np.random.RandomState(1))
    jv = np.asarray(jeig.smallest_eigvec_sym3(jnp.asarray(s)))
    tv = teig.smallest_eigvec_sym3(torch.from_numpy(s)).numpy()
    assert np.abs(np.sum(jv * tv, axis=-1)).min() > 1 - 1e-4
    # isotropic and zero inputs take the +z fallback in both
    iso = np.array([[1, 1, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0]], np.float32)
    np.testing.assert_array_equal(
        teig.smallest_eigvec_sym3(torch.from_numpy(iso)).numpy(),
        np.asarray(jeig.smallest_eigvec_sym3(jnp.asarray(iso))),
    )


def test_eigh_sym3_matches_jax():
    s = _random_covs(np.random.RandomState(2))
    jl, jV = (np.asarray(a) for a in jeig.eigh_sym3(jnp.asarray(s)))
    tl, tV = (a.numpy() for a in teig.eigh_sym3(torch.from_numpy(s)))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
    dots = np.abs(np.einsum("nij,nij->nj", tV, jV))
    assert dots[:, 0].min() > 1 - 1e-4 and dots[:, 2].min() > 1 - 1e-4


def test_pack_unpack_match_jax():
    s = _random_covs(np.random.RandomState(3), 20)
    full_j = np.asarray(jeig.unpack_sym3(jnp.asarray(s)))
    full_t = teig.unpack_sym3(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(full_t, full_j)
    np.testing.assert_array_equal(teig.pack_sym3(torch.from_numpy(full_t)).numpy(), s)


def test_invert_cov_packed_matches_jax():
    s = _random_covs(np.random.RandomState(4), 200).copy()
    s[0] = 0.0  # det == 0 -> the reference's 1e6 guard
    ji = np.asarray(jvox.invert_cov_packed(jnp.asarray(s)))
    ti = tvox.invert_cov_packed(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(ti, ji, rtol=1e-5, atol=0)


def test_cell_coords_and_bbox_match_jax():
    rng = np.random.RandomState(6)
    pts = (rng.randn(2000, 3) * 30).astype(np.float32)
    for cell in (1.0, 0.3, 2.5):
        np.testing.assert_array_equal(
            tgrid.cell_coords(torch.from_numpy(pts), cell).numpy(),
            np.asarray(jgrid.cell_coords(jnp.asarray(pts), jnp.float32(cell))),
        )
        for a, b in zip(tgrid._bbox_cells(pts, cell), jgrid._bbox_cells(pts, cell)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tgrid._bbox_cells(torch.from_numpy(pts), cell),
                        jgrid._bbox_cells(pts, cell)):
            np.testing.assert_array_equal(a, b)
    assert tgrid.DENSE_CELL_BUDGET == jgrid.DENSE_CELL_BUDGET
    assert tgrid.INVALID_KEY == jgrid.INVALID_KEY


def test_over_budget_map_raises_not_implemented():
    # A box over the dense budget is hashed (its build and align are in
    # tests/test_torch_voxel_sparse.py); only merging points into it, as in
    # the JAX package, and a box past the int32 keyspace raise.
    pts = np.array([[0, 0, 0], [500, 500, 500]], np.float32)
    vm = tvox.build_voxel_map(pts, 1.0, min_points=1, device="cpu")
    assert vm.hashed and vm.grid.dense is None and vm.grid.n_cells == 2
    with pytest.raises(NotImplementedError):
        tvox.update_voxel_map(vm, pts)
    with pytest.raises(ValueError, match="int32"):
        tvox.build_voxel_map(np.array([[0, 0, 0], [2e3, 2e3, 1e3]], np.float32), 1.0,
                             device="cpu")


def test_empty_cloud_raises():
    with pytest.raises(ValueError):
        tvox.build_voxel_map(np.zeros((0, 3), np.float32), 1.0, device="cpu")
