"""Port parity of the hashed grid (``ops/hashgrid.py``) and its queries
(``ops/knn.py``: ``nearest_voxel``, ``nearest_point``, ``knn_points``)
against the JAX package, on seeded NumPy inputs (the cases of
tests/test_grid.py and tests/test_boundary_guard.py:30-77).

Tolerances: keys, slots, buckets, indices and overflow flags equal;
distances within 1e-6 relative (both packages sum three float32 squares).
The tie cases put candidates at exactly equal distances: the first in probe
order (offset, then bucket position) must win in both.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from point_cloud_registration_tpu.ops import hashgrid as jgrid
from point_cloud_registration_tpu.ops import knn as jknn
from point_cloud_registration_tpu.ops import voxelize as jvox
from point_cloud_registration_tpu_torch.ops import hashgrid as tgrid
from point_cloud_registration_tpu_torch.ops import knn as tknn
from point_cloud_registration_tpu_torch.ops import voxelize as tvox
from point_cloud_registration_tpu_torch.utils.convert import (
    buckets_from_numpy,
    grid_from_numpy,
)
from oracles import knn_np
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# The float32/float64 boundary case of tests/test_boundary_guard.py: x / cell
# lies within an ulp of an integer.
_CELL = 0.88986
_ADVERSARIAL_X = 30.2553


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(7)
    return (rng.rand(3000, 3) * np.array([20.0, 20.0, 5.0]) - 2.0).astype(np.float32)


def _np(x):
    return np.asarray(jax.device_get(x))


def _both_grids(pts, cell, **kw):
    jg, jinv, jb = jgrid.build_grid(pts, cell, **kw)
    tg, tinv, tb = tgrid.build_grid(pts, cell, device="cpu", **kw)
    return (jg, jinv, jb), (tg, tinv, tb)


@pytest.mark.parametrize("kw", [{}, {"dense_budget": 1}, {"capacity": 4096},
                                {"with_buckets": True, "dense_budget": 1}],
                         ids=["dense", "sparse", "capacity", "buckets"])
def test_build_grid_matches_jax(cloud, kw):
    (jg, jinv, jb), (tg, tinv, tb) = _both_grids(cloud, 1.0, **kw)
    np.testing.assert_array_equal(tg.keys.numpy(), _np(jg.keys))
    assert tg.n_cells == int(jg.n_cells)
    assert tg.origin_cell == tuple(_np(jg.origin_cell)) and tg.dims == tuple(_np(jg.dims))
    np.testing.assert_array_equal(tinv.numpy(), _np(jinv))
    assert (tg.dense is None) == (jg.dense is None)
    if tg.dense is not None:
        np.testing.assert_array_equal(tg.dense.numpy(), _np(jg.dense))
    if kw.get("with_buckets"):
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.numpy(), _np(b))


def test_lookup_own_cells(cloud):
    grid, inverse, _ = tgrid.build_grid(cloud, 1.0, device="cpu")
    pts = torch.from_numpy(cloud)
    keys = tgrid.coords_to_key(tgrid.cell_coords(pts, 1.0), grid.origin_cell, grid.dims)
    slots = tgrid.lookup_slots(grid, keys)
    assert bool((slots >= 0).all())
    assert torch.equal(slots, inverse)


def test_lookup_miss_returns_minus_one(cloud):
    for budget in (tgrid.DENSE_CELL_BUDGET, 1):
        grid, _, _ = tgrid.build_grid(cloud, 1.0, dense_budget=budget, device="cpu")
        far = torch.tensor([[1e4, 1e4, 1e4], [1e12, -1e12, 0.0]])
        keys = tgrid.coords_to_key(tgrid.query_cells(far, grid.cell_size), grid.origin_cell,
                                   grid.dims)
        assert keys.tolist() == [-1, -1]
        assert tgrid.lookup_slots(grid, keys).tolist() == [-1, -1]


def test_sparse_and_dense_lookup_agree_with_jax(cloud):
    grid_d, _, _ = tgrid.build_grid(cloud, 1.0, device="cpu")
    assert grid_d.dense is not None
    grid_s = grid_d._replace(dense=None)
    q = np.random.RandomState(1).rand(500, 3).astype(np.float32) * 25 - 3
    keys = tgrid.coords_to_key(tgrid.cell_coords(torch.from_numpy(q), 1.0), grid_d.origin_cell,
                               grid_d.dims)
    dense, sparse = tgrid.lookup_slots(grid_d, keys), tgrid.lookup_slots(grid_s, keys)
    assert torch.equal(dense, sparse) and int((dense >= 0).sum()) > 20
    jg, _, _ = jgrid.build_grid(cloud, 1.0)
    jkeys = jgrid.coords_to_key(jgrid.cell_coords(jnp.asarray(q), jnp.float32(1.0)),
                                jg.origin_cell, jg.dims)
    np.testing.assert_array_equal(keys.numpy(), _np(jkeys))
    np.testing.assert_array_equal(dense.numpy(), _np(jgrid.lookup_slots(jg, jkeys)))


OFFSET_CASES = [(2.0, 2.0), (2.0, 1.0), (1.5, 1.0), (0.7, 0.5)]


@pytest.mark.parametrize("max_dist,cell", OFFSET_CASES)
def test_search_offsets_match_jax_and_cover_gated_radius(max_dist, cell):
    offs = tgrid.search_offsets(max_dist, cell)
    np.testing.assert_array_equal(offs, jgrid.search_offsets(max_dist, cell))
    # any point within max_dist of a query lies in a window cell (randomized)
    offs_set = set(map(tuple, offs))
    rng = np.random.RandomState(0)
    q = rng.rand(20000, 3) * 4 * cell
    d = rng.randn(20000, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = q + d * (rng.rand(20000, 1) * max_dist * 0.999)
    rel = np.floor(p / cell).astype(int) - np.floor(q / cell).astype(int)
    for r in np.unique(rel, axis=0):
        assert tuple(r) in offs_set, f"offset {r} not covered"


def _carried_grid(jg, jb=None):
    g = grid_from_numpy(jg.origin_cell, jg.cell_size, jg.dims, _np(jg.keys), _np(jg.n_cells),
                        None if jg.dense is None else _np(jg.dense), device="cpu")
    return g, (None if jb is None else buckets_from_numpy(*(_np(a) for a in jb), device="cpu"))


def _assert_nn_equal(got, want, over_got=None, over_want=None):
    np.testing.assert_array_equal(got.idx.numpy(), _np(want.idx))
    np.testing.assert_allclose(got.dist.numpy(), _np(want.dist), rtol=1e-6, atol=0)
    if over_got is not None:
        np.testing.assert_array_equal(over_got.numpy(), _np(over_want))


@pytest.mark.parametrize("cap", [512, 2], ids=["whole_buckets", "capped"])
@pytest.mark.parametrize("budget", [tgrid.DENSE_CELL_BUDGET, 1], ids=["dense", "sparse"])
def test_nearest_point_matches_jax(cloud, cap, budget, monkeypatch):
    max_dist = 2.0
    (jg, _, jb), (tg, _, tb) = _both_grids(cloud, max_dist / 2, with_buckets=True,
                                           dense_budget=budget)
    rng = np.random.RandomState(3)
    q = (cloud[rng.choice(len(cloud), 400)] + rng.randn(400, 3) * 0.6).astype(np.float32)
    q[0] = [1e4, 1e4, 1e4]  # outside the grid: no candidate
    offs = tgrid.search_offsets(max_dist, max_dist / 2)
    want, over_w = jknn.nearest_point(jg, jb, jnp.asarray(cloud), jnp.asarray(q), offs,
                                      cap=cap, with_overflow=True)
    monkeypatch.setattr(tknn, "SCAN_BUDGET", 1 << 12)  # several chunks
    got, over_g = tknn.nearest_point(tg, tb, torch.from_numpy(cloud), torch.from_numpy(q),
                                     offs, cap=cap, with_overflow=True)
    _assert_nn_equal(got, want, over_g, over_w)
    assert int(got.idx[0]) == -1 and float(got.dist[0]) == float("inf")
    assert bool(over_g.any()) == (cap == 2)
    # on the JAX package's own grid and buckets, carried over
    cg, cb = _carried_grid(jg, jb)
    _assert_nn_equal(tknn.nearest_point(cg, cb, torch.from_numpy(cloud), torch.from_numpy(q),
                                        offs, cap=cap), want)


def test_nearest_point_matches_kdtree(cloud):
    """With whole buckets the grid 1-NN is exact within max_dist."""
    max_dist = 2.0
    grid, _, buckets = tgrid.build_grid(cloud, max_dist, with_buckets=True, device="cpu")
    rng = np.random.RandomState(3)
    q = (cloud[rng.choice(len(cloud), 400)] + rng.randn(400, 3) * 0.3).astype(np.float32)
    res = tknn.nearest_point(grid, buckets, torch.from_numpy(cloud), torch.from_numpy(q),
                             tgrid.search_offsets(max_dist, max_dist), cap=512)
    d_ref, i_ref = knn_np(cloud, q, k=1)
    gated = d_ref[:, 0] < max_dist
    np.testing.assert_allclose(res.dist.numpy()[gated], d_ref[gated, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(res.idx.numpy()[gated], i_ref[gated, 0])


@pytest.mark.parametrize("budget", [tgrid.DENSE_CELL_BUDGET, 1], ids=["dense", "sparse"])
def test_nearest_voxel_matches_jax(cloud, budget, monkeypatch):
    jg, jinv, _ = jgrid.build_grid(cloud, 1.0, dense_budget=budget)
    jvm = jvox._finish_voxel_map(jnp.asarray(cloud), jg, jinv, min_points=5, with_icov=False)
    monkeypatch.setattr(tvox, "DENSE_CELL_BUDGET", budget)
    monkeypatch.setattr(tknn, "VOXEL_CHUNK", 64)  # several chunks
    tvm = tvox.build_voxel_map(cloud, 1.0, min_points=5, capacity=int(jg.keys.shape[0]),
                               device="cpu")
    np.testing.assert_array_equal(tvm.valid.numpy(), _np(jvm.valid))
    rng = np.random.RandomState(4)
    q = (cloud[rng.choice(len(cloud), 300)] + rng.randn(300, 3) * 0.5).astype(np.float32)
    offs = tgrid.search_offsets(2.0, 1.0)
    want = jknn.nearest_voxel(jg, jvm.means, jvm.valid, jnp.asarray(q), offs)
    got = tknn.nearest_voxel(tvm.grid, tvm.means, tvm.valid, torch.from_numpy(q), offs)
    np.testing.assert_array_equal(got.idx.numpy(), _np(want.idx))
    # the centroids differ by float32 rounding of their sums (the port's are exact)
    np.testing.assert_allclose(got.dist.numpy(), _np(want.dist), rtol=1e-5, atol=1e-6)
    ref = tknn.brute_force_nn(torch.from_numpy(q), tvm.means, tvm.valid)
    gated = ref[0].numpy() < 2.0
    np.testing.assert_array_equal(got.idx.numpy()[gated], ref[1].numpy()[gated])


@pytest.mark.parametrize("k,cap", [(10, 256), (5, 2)], ids=["whole_buckets", "capped"])
def test_knn_points_matches_jax(cloud, k, cap):
    cell = 1.6
    (jg, _, jb), (tg, _, tb) = _both_grids(cloud, cell, with_buckets=True)
    q = cloud[:200]
    offs = tgrid.search_offsets(cell, cell)
    jd, ji, jo = jknn.knn_points(jg, jb, jnp.asarray(cloud), jnp.asarray(q), offs, cap=cap,
                                 k=k, chunk=128, with_overflow=True)
    td, ti, to = tknn.knn_points(tg, tb, torch.from_numpy(cloud), torch.from_numpy(q), offs,
                                 cap=cap, k=k, with_overflow=True)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(to.numpy(), _np(jo))
    # where the window holds every candidate within one cell, the k-NN is exact
    d_ref, _ = knn_np(cloud, q, k=k)
    ok = ~to.numpy() & (d_ref[:, -1] < cell)
    assert ok.sum() > 20 or cap == 2
    np.testing.assert_allclose(td.numpy()[ok], d_ref[ok], rtol=1e-5, atol=1e-6)


def _tie_setup(points, cell, cap, queries, k=2):
    pts = np.asarray(points, np.float32)
    q = np.asarray(queries, np.float32)
    (jg, _, jb), (tg, _, tb) = _both_grids(pts, cell, with_buckets=True)
    offs = tgrid.search_offsets(2 * cell, cell)
    jnn = jknn.nearest_point(jg, jb, jnp.asarray(pts), jnp.asarray(q), offs, cap=cap,
                             with_overflow=True)
    tnn = tknn.nearest_point(tg, tb, torch.from_numpy(pts), torch.from_numpy(q), offs,
                             cap=cap, with_overflow=True)
    jk = jknn.knn_points(jg, jb, jnp.asarray(pts), jnp.asarray(q), offs, cap=cap, k=k)
    tk = tknn.knn_points(tg, tb, torch.from_numpy(pts), torch.from_numpy(q), offs, cap=cap,
                         k=k)
    _assert_nn_equal(tnn[0], jnn[0], tnn[1], jnn[1])
    np.testing.assert_array_equal(tk[1].numpy(), _np(jk[1]))
    np.testing.assert_array_equal(tk[0].numpy(), _np(jk[0]))
    return tnn, tk


def test_tie_in_one_cell_takes_the_first_in_the_bucket():
    # points 2 and 0 lie in one cell, 0.25 from the query each; 2 comes first
    # in neither index order nor bucket order: the bucket keeps input order
    pts = [[0.25, 0.5, 0.5], [3.5, 3.5, 3.5], [0.75, 0.5, 0.5]]
    (nn, over), (kd, ki) = _tie_setup(pts, 1.0, 8, [[0.5, 0.5, 0.5]])
    assert int(nn.idx[0]) == 0 and float(nn.dist[0]) == 0.25 and not bool(over[0])
    assert ki[0].tolist() == [0, 2]


def test_tie_across_two_offsets_takes_the_first_offset():
    # the query sits on the border of cells x = 0 and x = 1, 0.5 from a point
    # in each: its own cell (offset 0) is probed before its neighbour
    pts = [[1.5, 0.5, 0.5], [0.5, 0.5, 0.5], [3.5, 3.5, 3.5]]
    (nn, _), (kd, ki) = _tie_setup(pts, 1.0, 8, [[1.0, 0.5, 0.5]])
    assert int(nn.idx[0]) == 0 and float(nn.dist[0]) == 0.5
    assert ki[0].tolist() == [0, 1]
    # the same pair seen from the other cell: now the x = 0 point comes first
    (nn, _), (kd, ki) = _tie_setup(pts, 1.0, 8, [[0.9999999, 0.5, 0.5]])
    assert int(nn.idx[0]) == 1


def test_bucket_past_cap_scans_the_first_cap_points():
    # five points in one cell, the nearest last in input order: with cap 4 it
    # is not scanned, the window is flagged, and both packages agree
    pts = [[0.1, 0.1, 0.1], [0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.9, 0.9, 0.9],
           [0.5, 0.5, 0.5], [3.5, 3.5, 3.5]]
    (nn, over), _ = _tie_setup(pts, 1.0, 4, [[0.5, 0.5, 0.45]], k=3)
    assert int(nn.idx[0]) != 4 and bool(over[0])
    (nn, over), _ = _tie_setup(pts, 1.0, 5, [[0.5, 0.5, 0.45]], k=3)
    assert int(nn.idx[0]) == 4 and not bool(over[0])


def _cloud_with_boundary_point():
    rng = np.random.RandomState(3)
    pts = (rng.rand(4000, 3) * 30).astype(np.float32)
    pts[0] = [_ADVERSARIAL_X, 0.94, 0.05]
    pts[1:, 0] = np.minimum(pts[1:, 0], 30.0)
    return pts


def test_sparse_grid_boundary_point_unreachable_not_corrupting():
    pts = _cloud_with_boundary_point()
    (jg, jinv, _), (tg, tinv, _) = _both_grids(pts, _CELL, dense_budget=1)
    assert tg.dense is None
    keys = tg.keys.numpy()
    assert np.all(keys[:tg.n_cells] >= 0)
    np.testing.assert_array_equal(keys, _np(jg.keys))
    np.testing.assert_array_equal(tinv.numpy(), _np(jinv))
    assert tg.n_cells == int(jg.n_cells)


def test_dense_voxel_build_no_boundary_corruption():
    pts = _cloud_with_boundary_point()
    vm = tvox.build_voxel_map(pts, _CELL, min_points=1, device="cpu")
    counts, means = vm.counts.numpy(), vm.means.numpy()
    slots = np.flatnonzero(counts > 0)
    nx, ny, _ = vm.dims
    cell = np.stack([slots % nx, (slots // nx) % ny, slots // (nx * ny)], axis=-1)
    lo = (cell + np.asarray(vm.origin_cell)) * _CELL
    assert np.all(means[slots] >= lo - 1e-3) and np.all(means[slots] <= lo + _CELL + 1e-3)
    assert counts.sum() in (len(pts), len(pts) - 1)
