"""Port parity of k-NN PCA normals: ``ops/kernels/knn_normals.py`` (the plain
version of the k-NN moments kernel), ``ops/pointgrid.knn_packed`` and
``ops/normals.py`` of point_cloud_registration_tpu_torch against the JAX
package, whose Pallas kernel runs in interpret mode.

Both packages build bit-equal packed grids, and the port's kernel walks the
JAX kernel's candidate box, so per query the flags (``unresolved``,
``exact``) and the selected count are equal. ``rk2`` and ``cov6`` differ by
float32 rounding only (the JAX kernel gathers coordinates through three bf16
parts and sums in lane order): within 1e-5 of the query's k-th squared
distance, resp. of its largest covariance entry. Normals are defined up to
sign and are unstable where the two smallest eigenvalues are close, so they
are compared by ``|n . n'|`` on points with a clear eigen-gap.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import point_cloud_registration_tpu as jax_pkg
import point_cloud_registration_tpu_torch as port
from point_cloud_registration_tpu.ops import normals as jax_normals
from point_cloud_registration_tpu.ops.pallas.knn_normals import (
    knn_moments_call,
    knn_moments_spec,
)
from point_cloud_registration_tpu.ops.pallas.point_align import (
    build_fused_rows,
    build_tile_tables,
    morton_layout,
    padded_point_capacity,
)
from point_cloud_registration_tpu.ops.pointgrid import build_packed_grid as jax_build_packed_grid
from point_cloud_registration_tpu.ops.pointgrid import knn_packed as jax_knn_packed
from point_cloud_registration_tpu_torch.ops import normals as port_normals
from point_cloud_registration_tpu_torch.ops.eigh3 import eigh_sym3
from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn
from point_cloud_registration_tpu_torch.ops.kernels import normals_chain as nc
from point_cloud_registration_tpu_torch.ops.knn import FOUND_MAX, brute_force_knn
from point_cloud_registration_tpu_torch.ops.pointgrid import build_packed_grid, knn_packed
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

K = 15
REL = 1e-5


def _scene(n, seed=9):
    """A floor and a wall (tests/test_knn_normals.py)."""
    rng = np.random.RandomState(seed)
    h = n // 2
    floor = np.stack([rng.rand(h) * 15, rng.rand(h) * 15, rng.randn(h) * 0.01], 1)
    wall = np.stack([rng.rand(h) * 15, np.full(h, 7.0) + rng.randn(h) * 0.01, rng.rand(h) * 4], 1)
    return np.vstack([floor, wall]).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    return _scene(12000)


def _jax_moments(pts, k, cell, radius, cap=32, tq=128, cb=384):
    """The JAX kernel over all of ``pts`` in interpret mode, un-scattered:
    numpy ``(cov6, count, rk2, unresolved, exact)``."""
    pg = jax_build_packed_grid(pts, cell, cap=cap)
    spec = knn_moments_spec(pg, radius=radius, tq=tq, cb=cb)
    assert spec is not None
    n = len(pts)
    pos = morton_layout(spec, jnp.asarray(pts))
    n_cap = padded_point_capacity(spec, n)
    q_s = jnp.zeros((n_cap, 3), jnp.float32).at[pos].set(pts)
    w_s = jnp.zeros((n_cap,), jnp.float32).at[pos].set(1.0)
    keys, flags, tab = build_tile_tables(spec, pg, q_s, w_s)
    out = knn_moments_call(spec, k, keys, flags, tab, q_s, w_s, interpret=True)
    pos = np.asarray(pos)
    return [np.asarray(o)[pos] for o in out]


def _port_moments(pts, k, cell, radius, cap=32):
    pg = build_packed_grid(torch.from_numpy(pts), cell, cap)
    out = kn.knn_moments_reference(pg, torch.from_numpy(pts), torch.ones(len(pts)), k, radius,
                                   chunk=700)
    return [o.numpy() for o in out]


def _assert_moments_equal(j, p):
    """Flags and counts equal; rk2 and cov6 to float32 rounding, on the
    queries that both resolved."""
    np.testing.assert_array_equal(p[3], j[3])  # unresolved
    np.testing.assert_array_equal(p[4], j[4])  # exact
    np.testing.assert_array_equal(p[1], j[1])  # count
    ok = ~p[3]
    np.testing.assert_allclose(p[2][ok], j[2][ok], rtol=REL)
    np.testing.assert_array_equal(p[2][~ok], j[2][~ok])  # the miss value, 1e30
    scale = np.abs(j[0]).max(axis=1, keepdims=True)
    assert (np.abs(p[0] - j[0]) <= REL * scale + 1e-12).all()


@pytest.mark.parametrize("radius,k,cell", [(2, 15, 0.4), (4, 15, 0.4), (2, 10, 0.3), (4, 7, 0.1)])
def test_knn_moments_reference_matches_jax_kernel(scene, radius, k, cell):
    pts = _scene(5000)
    # small cells spread a tile over many blocks: a deeper key list keeps
    # the JAX kernel free of misses, which the port does not have
    j = _jax_moments(pts, k, cell, radius, cb=1024 if cell == 0.1 else 384)
    p = _port_moments(pts, k, cell, radius)
    if cell == 0.4:
        assert p[4].mean() > 0.2 and (~p[4]).mean() > 0.02, "both outcomes of the certificate"
    if cell == 0.1:
        assert p[3].sum() > 10, "some queries with fewer than k candidates"
    _assert_moments_equal(j, p)


@pytest.mark.parametrize("radius", [2, 4])
def test_knn_moments_reference_matches_jax_tier(scene, radius):
    """Against ``ops/normals.py::_knn_tier``, which the JAX package's
    ``_fused_normals_jit`` calls: a query subset with dead (w = 0) slots."""
    pts = _scene(4000)
    k, cell = 15, 0.4
    jpg = jax_build_packed_grid(pts, cell, cap=32)
    spec = knn_moments_spec(jpg, radius=radius, tq=128, cb=384)
    ftab, fover = build_fused_rows(spec, jpg)
    rng = np.random.RandomState(radius)
    sub = np.sort(rng.choice(len(pts), 1500, replace=False))
    w = (rng.rand(1500) > 0.2).astype(np.float32)
    cov_j, rk2_j, unres_j, exact_j = (np.asarray(o) for o in jax_normals._knn_tier(
        ftab, fover, jnp.asarray(pts[sub]), jnp.asarray(w), k, spec, True))
    pg = build_packed_grid(torch.from_numpy(pts), cell, 32)
    cov_p, _, rk2_p, unres_p, exact_p = (o.numpy() for o in kn.knn_moments(
        pg, torch.from_numpy(pts[sub]), torch.from_numpy(w), k, radius))
    live = w > 0  # the JAX tile layout leaves dead queries out
    np.testing.assert_array_equal(unres_p[live], unres_j[live])
    np.testing.assert_array_equal(exact_p[live], exact_j[live])
    np.testing.assert_allclose(rk2_p[live], rk2_j[live], rtol=REL)
    scale = np.abs(cov_j[live]).max(axis=1, keepdims=True)
    assert (np.abs(cov_p[live] - cov_j[live]) <= REL * scale + 1e-12).all()
    assert not unres_p[~live].any()  # w = 0 is never unresolved


def test_isolated_points_are_unresolved_and_fall_back():
    """Far-flung points whose box holds fewer than k candidates are flagged
    unresolved (equal to the JAX kernel's flags) and the fallback search
    still gives them unit normals (tests/test_knn_normals.py:122)."""
    rng = np.random.RandomState(2)
    dense = rng.rand(3000, 3).astype(np.float32) * np.float32([5, 5, 0.02])
    lone = rng.rand(20, 3).astype(np.float32) * 3 + np.float32([40, 40, 0])
    pts = np.vstack([dense, lone]).astype(np.float32)
    j = _jax_moments(pts, K, 0.15, 2, tq=256, cb=256)
    p = _port_moments(pts, K, 0.15, 2)
    assert p[3][3000:].any() and not p[4][p[3]].any()
    _assert_moments_equal(j, p)
    nrm, info = port_normals.estimate_normals(pts, k=K, return_info=True, device="cpu")
    assert info["n_unresolved"] > 0
    assert torch.isfinite(nrm).all()
    assert float((nrm.norm(dim=1) - 1).abs().max()) < 1e-4
    nj = np.asarray(jax_normals.estimate_normals(pts, k=K, backend="pallas"))
    assert np.median(np.abs((nrm.numpy() * nj).sum(1))) > 1 - 1e-5


def test_over_cap_blocks_are_never_certified():
    """A clump far over the cap: its queries' candidates were truncated, so
    none is certified, while the sheet beside it certifies
    (tests/test_knn_normals.py:207)."""
    rng = np.random.RandomState(4)
    clump = (rng.randn(500, 3) * 0.05).astype(np.float32)
    spread = (rng.rand(4000, 3) * np.float32([8, 8, 0.2])).astype(np.float32)
    pts = np.vstack([clump, spread + np.float32([4, 4, 0])]).astype(np.float32)
    p = _port_moments(pts, 10, 0.3, 2)
    assert not p[4][:500].any()
    assert p[4][500:].mean() > 0.7
    _assert_moments_equal(_jax_moments(pts, 10, 0.3, 2), p)


def test_exact_flag_means_brute_force_neighbours(scene):
    """Where the certificate fires, the selected set is the true k-NN."""
    pts = _scene(2500)
    k = 10
    cov6, cnt, rk2, unres, exact = _port_moments(pts, k, 0.4, 2)
    t = torch.from_numpy(pts)
    d, idx = brute_force_knn(t, t, k)
    want = port_normals.normals_from_neighbors(t, idx.long(), t)
    got = port_normals.smallest_eigvec_sym3(torch.from_numpy(cov6))
    assert exact.mean() > 0.8
    np.testing.assert_allclose(np.sqrt(rk2[exact]), d[:, k - 1].numpy()[exact], rtol=1e-6)
    assert (cnt[exact] == k).all()
    gap_ok = _clear_gap(torch.from_numpy(cov6)).numpy() & exact
    assert np.abs((got * want).sum(1).numpy())[gap_ok].min() > 1 - 1e-4


def _clear_gap(cov6: torch.Tensor) -> torch.Tensor:
    """Points whose smallest eigenvalue is well separated from the next."""
    vals, _ = eigh_sym3(cov6)
    return (vals[:, 1] - vals[:, 0]) > 0.05 * vals[:, 2]


def test_knn_moments_wrapper_checks_and_counts():
    pts = torch.from_numpy(_scene(600))
    pg = build_packed_grid(pts, 0.5, 32)
    w = torch.ones(600)
    with pytest.raises(ValueError, match="at least 1"):
        kn.knn_moments(pg, pts, w, 0, 2)
    with pytest.raises(ValueError, match="radius"):
        kn.knn_moments(pg, pts, w, 5, 0)
    before = kn.knn_moments.launches
    out = kn.knn_moments(pg, pts, w, 5, 2)  # CPU tensors: the plain version
    ref = kn.knn_moments_reference(pg, pts, w, 5, 2)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kn.knn_moments.launches == before
    assert kn.box_blocks(2) == (4, 4, 3) and kn.box_blocks(4) == (6, 6, 5)


def _edge_queries(pts, seed):
    """The cloud itself plus queries on the grid's faces, just outside it
    and far outside it (so far that the cell index is clamped)."""
    rng = np.random.RandomState(seed)
    lo, hi = pts.min(0), pts.max(0)
    on_faces = lo + (hi - lo) * rng.randint(0, 2, size=(200, 3)) * rng.rand(200, 3).round(1)
    near = lo - 3 + (hi - lo + 6) * rng.rand(300, 3)
    far = np.float32([[1e12, 0, 0], [-1e12, -1e12, 5], [0, 3e10, -2e11], [np.inf, 1, 1]])
    return np.vstack([pts, on_faces, near, near + 40, far]).astype(np.float32)


def _assert_groups(pg, q, radius, order, starts, item):
    """Every query in exactly one work item; an item holds at most ``item``
    queries, all with the same candidate box, in the caller's order."""
    n = q.shape[0]
    assert order.dtype == torch.int64 and starts.dtype == torch.int64
    np.testing.assert_array_equal(np.sort(order.numpy()), np.arange(n))
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n)
    torch.testing.assert_close(q[order][inverse], q, rtol=0, atol=0, equal_nan=True)
    ends = torch.cat([starts[1:], torch.tensor([n])])
    size = ends - starts
    assert starts.numel() == 0 or (starts[0] == 0 and (size >= 1).all() and (size <= item).all())
    rows = kn.box_rows(pg, q, radius)[order]
    first = torch.repeat_interleave(starts, size)  # of each position's item
    assert (rows == rows[first]).all()
    assert (order[1:] > order[:-1])[first[1:] == first[:-1]].all()  # stable inside an item
    return size


@pytest.mark.parametrize("radius,item", [(2, kn.ITEM), (4, kn.ITEM), (2, 5), (4, 3)])
def test_box_groups_share_a_box(radius, item):
    pts = _scene(3000)
    pg = build_packed_grid(torch.from_numpy(pts), 0.4, 32)
    q = torch.from_numpy(_edge_queries(pts, radius))
    order, starts = kn.box_groups(pg, q, radius, item)
    size = _assert_groups(pg, q, radius, order, starts, item)
    assert (size == item).any() and (size < item).any()
    # a box with more queries than an item holds takes several items in a row
    # (told by its rows: only boxes off the grid have the same rows, none, under two keys)
    rows = kn.box_rows(pg, q, radius)[order[starts]]
    on_grid = (rows != pg.pts_packed.shape[0] - 1).any(dim=1)
    again = (rows[1:] == rows[:-1]).all(dim=1) & on_grid[1:]
    assert again.any() and (size[:-1][again] == item).all()
    n_boxes = torch.unique(kn._box_start(pg, q[:len(pts)], radius), dim=0).shape[0]
    assert starts.numel() >= n_boxes


@pytest.mark.parametrize("radius", [2, 4])
def test_box_groups_of_a_shuffled_subset(radius):
    """The wide tier's case: some of the points, in an order of their own."""
    pts = _scene(4000)
    pg = build_packed_grid(torch.from_numpy(pts), 0.4, 32)
    pick = np.random.RandomState(radius).permutation(len(pts))[:1500]
    q = torch.from_numpy(pts[pick])
    order, starts = kn.box_groups(pg, q, radius)
    size = _assert_groups(pg, q, radius, order, starts, kn.ITEM)
    # the same boxes as the sorted subset's, whatever the order of the queries
    q_s = torch.from_numpy(pts[np.sort(pick)])
    order_s, starts_s = kn.box_groups(pg, q_s, radius)
    size_s = _assert_groups(pg, q_s, radius, order_s, starts_s, kn.ITEM)
    np.testing.assert_array_equal(size.numpy(), size_s.numpy())
    np.testing.assert_array_equal(kn.box_rows(pg, q, radius)[order[starts]].numpy(),
                                  kn.box_rows(pg, q_s, radius)[order_s[starts_s]].numpy())


@pytest.mark.parametrize("radius", [2, 4])
def test_box_groups_of_a_key_space_beyond_int32(radius):
    """A block grid so large that a box key needs int64: the queries inside
    the real grid group as they do there (keys order the boxes alike)."""
    pts = _scene(3000)
    pg = build_packed_grid(torch.from_numpy(pts), 0.4, 32)
    vast = pg._replace(nb_dims=(1 << 12, 1 << 12, 1 << 11))
    assert kn._box_key_space(pg, radius)[2] <= kn._INT32_MAX < kn._box_key_space(vast, radius)[2]
    q = torch.from_numpy(pts[np.random.RandomState(radius).permutation(len(pts))])
    order, starts = kn.box_groups(vast, q, radius)
    _assert_groups(pg, q, radius, order, starts, kn.ITEM)
    for a, b in zip((order, starts), kn.box_groups(pg, q, radius)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n", [0, 1])
def test_box_groups_of_no_and_one_query(n):
    pts = torch.from_numpy(_scene(500))
    pg = build_packed_grid(pts, 0.4, 32)
    order, starts = kn.box_groups(pg, pts[:n], 2)
    assert order.tolist() == list(range(n)) and starts.tolist() == list(range(n))
    out = kn.knn_moments(pg, pts[:n], torch.ones(n), 5, 2)
    assert [tuple(o.shape) for o in out] == [(n, 6), (n,), (n,), (n,), (n,)]


@pytest.mark.parametrize("cap", [30, 45])
def test_knn_moments_takes_a_cap_that_is_no_multiple_of_four(cap):
    """Rows of such a cap do not start at multiples of 16 bytes; the wrapper's
    checks pass and the grouping and the plain version do not care."""
    pts = torch.from_numpy(_scene(2000))
    pg = build_packed_grid(pts, 0.4, cap)
    assert pg.cap == cap and (cap * pg.width * 4) % 16 != 0
    kn._check_grid(pg, pts)
    order, starts = kn.box_groups(pg, pts, 2)
    _assert_groups(pg, pts, 2, order, starts, kn.ITEM)
    ref = _port_moments(pts.numpy(), 10, 0.4, 2, cap=32)
    got = [o.numpy() for o in kn.knn_moments(pg, pts, torch.ones(len(pts)), 10, 2)]
    untruncated = ~pg.row_over[kn.box_rows(pg, pts, 2)].any(dim=1).numpy()
    assert untruncated.mean() > 0.5
    for a, b in zip(got[1:], ref[1:]):  # the same kept points wherever no row was cut
        np.testing.assert_array_equal(a[untruncated], b[untruncated])
    scale = np.abs(ref[0]).max(axis=1, keepdims=True)  # sums in another order
    assert (np.abs(got[0] - ref[0]) <= REL * scale + 1e-12)[untruncated].all()


@pytest.mark.parametrize("n,k", [(3000, 15), (300_000, 15), (200, 5), (5000, 40)])
def test_sample_knn_radius_matches_jax(n, k):
    """The same draws, the same k-th distances, the same median: the cell
    size decides every window, so it is held equal, not close. At k = 40
    below 2**18 points the sampler's kernel takes its select, not its
    tiles."""
    rng = np.random.RandomState(n)
    pts = (rng.rand(n, 3) * np.float32([30, 30, 3])).astype(np.float32)
    want = jax_normals.sample_knn_radius(pts, k)
    got = port_normals.sample_knn_radius(torch.from_numpy(pts), k)
    assert got == want


def test_normals_from_neighbors_matches_jax():
    rng = np.random.RandomState(5)
    pts = _scene(2000, seed=5)
    idx = rng.randint(0, 2000, size=(2000, K)).astype(np.int32)
    near = np.argsort(((pts[:400, None] - pts[None]) ** 2).sum(-1), axis=1)[:, :K]
    idx[:400] = near
    idx[rng.rand(2000, K) < 0.1] = -1
    want = np.asarray(jax_normals.normals_from_neighbors(
        jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(pts)))
    t = torch.from_numpy(pts)
    got = port_normals.normals_from_neighbors(t, torch.from_numpy(idx), t).numpy()
    dots = np.abs((got * want).sum(1))
    assert np.median(dots) > 1 - 1e-6 and (dots[:400] > 1 - 1e-4).mean() > 0.97


@pytest.mark.parametrize("exact_tail", [True, False])
def test_knn_packed_matches_jax(scene, exact_tail):
    """Equal distances, and equal neighbour sets where the k-th distance is
    not tied (the order among equal distances is unspecified)."""
    pts = _scene(6000)
    jd, ji = jax_knn_packed(jax_build_packed_grid(pts, 0.2, cap=45), jnp.asarray(pts), K,
                            exact_tail=exact_tail)
    t = torch.from_numpy(pts)
    d, i = knn_packed(build_packed_grid(t, 0.2, 45), t, K, chunk=1000, exact_tail=exact_tail)
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-6)
    np.testing.assert_array_equal(np.sort(i.numpy(), axis=1), np.sort(ji, axis=1))
    assert (ji == -1).sum() == (i.numpy() == -1).sum()
    if exact_tail:  # the tail tier found farther neighbours for some queries
        d1, _ = knn_packed(build_packed_grid(t, 0.2, 45), t, K, exact_tail=False)
        assert bool((d1[:, -1] > d[:, -1]).any())


@pytest.fixture(scope="module")
def fused_normals(scene):
    pts = _scene(8000)
    nj, info_j = jax_normals.estimate_normals(pts, k=K, backend="pallas", return_info=True)
    nt, info_t = port_normals.estimate_normals(pts, k=K, backend="auto", return_info=True,
                                               device="cpu")
    return pts, np.asarray(nj), np.asarray(info_j["exact"]), nt.numpy(), info_t


def test_estimate_normals_kernel_path_matches_jax_pallas(fused_normals):
    pts, nj, exact_j, nt, info = fused_normals
    exact_t = info["exact"].numpy()
    assert info["cell_size"] == float(np.float32(max(jax_normals.sample_knn_radius(pts, K), 1e-3)))
    assert info["n_base"] == len(pts) and info["n_wide"] > 0
    # The JAX kernel withholds the certificate where a tile's key list
    # overflowed (a miss); the port has no key lists.
    assert not (exact_j & ~exact_t).any()
    assert (exact_t & ~exact_j).mean() < 0.02
    assert exact_t.mean() > 0.7
    assert np.abs(np.linalg.norm(nt, axis=1) - 1).max() < 1e-5
    dots = np.abs((nt * nj).sum(1))
    assert dots[exact_t & exact_j].min() > 1 - 1e-4
    assert np.median(dots) > 1 - 1e-6


def test_wide_tier_raises_the_certified_fraction(fused_normals):
    pts, _, _, nt, info = fused_normals
    n0, info0 = port_normals.estimate_normals(pts, k=K, exact_tail=False, return_info=True,
                                              device="cpu")
    e0, e1 = info0["exact"].numpy(), info["exact"].numpy()
    assert info0["n_wide"] == 0 and e1.mean() > e0.mean()
    both = e0 & e1  # the same neighbour sets: the same normals
    assert np.abs((n0.numpy() * nt).sum(1))[both].min() > 1 - 1e-5
    exact_j = np.asarray(jax_normals.estimate_normals(
        pts, k=K, backend="pallas", exact_tail=False, return_info=True)[1]["exact"])
    assert not (exact_j & ~e0).any() and (e0 & ~exact_j).mean() < 0.02


K_ROUNDS = 40  # above kn.ROUND_K: the kernel selects in two rounds


def test_knn_moments_reference_matches_jax_kernel_in_rounds():
    """k above one walk's buffer: the order statistic, the selection and the
    flags still equal the JAX kernel's (k rounds of next-minimum ascent)."""
    pts = _scene(2000)
    assert K_ROUNDS > kn.ROUND_K
    p = _port_moments(pts, K_ROUNDS, 0.4, 2)
    assert p[4].any() and p[3].any(), "both certified and unresolved queries"
    _assert_moments_equal(_jax_moments(pts, K_ROUNDS, 0.4, 2), p)


def _rounds_model(d2, k, kmax=kn.ROUND_K):
    """The kernel's selection for ``k > kmax`` (``csrc/knn_normals.cu``,
    ``kRounds``) in NumPy, with the kernel's state: ``(done, rk, exit)`` of
    one query from the squared distances of its box. ``exit`` names the
    branch that ended the rounds."""
    found = np.float32(FOUND_MAX) ** 2
    cand = d2[d2 < found]

    def walk(v):  # the sorted buffer of kmax; its bar starts at found
        v = np.sort(v)[:kmax]
        return np.concatenate([v, np.full(kmax - len(v), found, np.float32)])

    buf = walk(cand)
    done = buf[-1] < found
    rk = buf[-1] if done else kn.MISS_D2
    need = k
    while True:
        if need <= kmax:
            v = buf[need - 1]
            done = v < found
            return done, (v if done else kn.MISS_D2), "pick"
        if not buf[-1] < found:  # fewer than k candidates
            return False, kn.MISS_D2, "short"
        lo = buf[-1]
        buf = walk(cand[cand > lo])
        need = k - int((cand <= lo).sum())
        if need <= 0:  # ties at lo reach the k-th
            return True, lo, "ties"


def _lattice(n_side=30, step=0.25):
    g = np.arange(n_side, dtype=np.float32) * np.float32(step)
    x, y = np.meshgrid(g, g, indexing="ij")
    return np.stack([x.ravel(), y.ravel(), np.zeros(x.size, np.float32)], 1)


@pytest.mark.parametrize("scene_name,k", [("floor and wall", 80), ("floor and wall", 100),
                                          ("lattice", 70)])
def test_rounds_model_matches_reference(scene_name, k):
    """A model of the kernel's rounds loop against the plain version's top-k,
    where boxes hold fewer than 32, between 32 and k, and more than k
    candidates (k = 100 takes three rounds; on the lattice, exact ties at a
    round's last distance reach the k-th)."""
    pts = _scene(2000) if scene_name == "floor and wall" else _lattice()
    q = torch.from_numpy(pts)
    pg = build_packed_grid(q, 0.4, 32)
    _, cnt, rk2, unres, _ = kn.knn_moments_reference(pg, q, torch.ones(len(pts)), k, 2)
    row = kn.box_rows(pg, q, 2)
    cand = pg.pts_packed[row].reshape(len(pts), -1, pg.cap, pg.width)[..., :3]
    kept = torch.arange(pg.cap)[None, None, :] < pg.row_count[row][..., None]
    d = q[:, None, None, :] - cand
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(kept, d2, float("inf")).reshape(len(pts), -1).numpy()
    exits = set()
    for i in range(len(pts)):
        done, rk, how = _rounds_model(d2[i], k)
        exits.add(how)
        assert done == (not unres[i]) and rk == rk2[i], (i, how)
        take = rk if done else np.float32(FOUND_MAX) ** 2
        assert int(((d2[i] <= take) & (d2[i] < np.float32(FOUND_MAX) ** 2)).sum()) == cnt[i]
    if scene_name == "lattice":
        assert "ties" in exits
    else:
        n_cand = np.isfinite(d2).sum(1)
        assert ((n_cand > kn.ROUND_K) & (n_cand < k)).any() and (n_cand > k).any()
        assert {"pick", "short"} <= exits


def test_estimate_normals_in_rounds_matches_jax_pallas():
    """``estimate_normals(k=40)`` on the kernel path: the JAX package's
    normals where both certify, the same certificate and tiers."""
    pts = _scene(2000)
    nj, info_j = jax_normals.estimate_normals(pts, k=K_ROUNDS, backend="pallas",
                                              return_info=True)
    nt, info = port_normals.estimate_normals(pts, k=K_ROUNDS, return_info=True, device="cpu")
    exact_j, exact_t = np.asarray(info_j["exact"]), info["exact"].numpy()
    assert info["n_wide"] > 0 and exact_t.any()
    np.testing.assert_array_equal(exact_t, exact_j)
    assert np.abs(np.linalg.norm(nt.numpy(), axis=1) - 1).max() < 1e-5
    dots = np.abs((nt.numpy() * np.asarray(nj)).sum(1))
    assert dots[exact_t].min() > 1 - 1e-4 and np.median(dots) > 1 - 1e-6


def test_plane_icp_in_rounds_matches_jax():
    """``PlaneICP(k=40)``: each package estimates the target's normals, the
    port on its kernel path; the same iteration count and T within 1e-3."""
    import dataclasses

    from point_cloud_registration_tpu import PlaneICP as JaxPlaneICP
    from point_cloud_registration_tpu.core.config import CorrespondenceConfig as JaxCorr
    from oracles import make_scan, make_scene

    pts = make_scene(np.random.RandomState(0), n_floor=1400, n_wall=300)
    scan, T_true = make_scan(np.random.RandomState(1), pts,
                             np.array([0.02, -0.02, 0.04, 0.008, -0.01, 0.012]))
    params = dict(max_iter=30, max_dist=2.0, tol=1e-3, k=K_ROUNDS)
    js = JaxPlaneICP(**params)
    js.cfg = dataclasses.replace(js.cfg, corr=JaxCorr(method="packed"), backend="xla")
    js.set_target(pts)
    Tj = js.align(scan)
    ps = port.PlaneICP(**params, device="cpu")
    ps.cfg = dataclasses.replace(ps.cfg, corr=port.CorrespondenceConfig(method="packed"))
    ps.set_target(pts)
    Tp = ps.align(scan)
    assert ps.last_diagnostics.iterations == int(js.last_diagnostics.iterations)
    assert np.abs(Tp - Tj).max() < 1e-3
    assert np.abs(Tp @ T_true - np.eye(4)).max() < 0.03


def test_estimate_normals_gather_path_matches_jax_xla(scene):
    pts = _scene(8000)
    nj = np.asarray(jax_normals.estimate_normals(pts, k=K, backend="xla"))
    nt, info = port_normals.estimate_normals(pts, k=K, backend="gather", return_info=True,
                                             device="cpu")
    assert info["exact"] is None
    dots = np.abs((nt.numpy() * nj).sum(1))
    assert np.median(dots) > 1 - 1e-6 and (dots > 1 - 1e-3).mean() > 0.995
    n2 = len(pts) // 2
    assert np.median(np.abs(nt.numpy()[:n2, 2])) > 0.99  # floor -> +-z
    assert np.median(np.abs(nt.numpy()[n2:, 1])) > 0.99  # wall -> +-y


def test_estimate_normals_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        port_normals.estimate_normals(np.zeros((10, 3), np.float32), backend="pallas")


def test_root_entry_points_numpy_in_and_out(scene):
    pts = _scene(3000)
    n = port.estimate_normals(pts, k=10, device="cpu")
    assert isinstance(n, np.ndarray) and n.shape == (3000, 3) and n.dtype == np.float32
    assert np.median(np.abs((n * jax_pkg.estimate_normals(pts, k=10)).sum(1))) > 1 - 1e-6
    np.testing.assert_array_equal(port.estimate_norm_with_tree(pts, None, k=10, device="cpu"), n)
    np.testing.assert_array_equal(port.get_norm_lines(pts, n, 0.2),
                                  jax_pkg.get_norm_lines(pts, n, 0.2))


def test_estimate_norm_with_tree_honours_the_index(scene):
    """Neighbour indices come from the given object's ``query``."""
    pts = _scene(1500)

    class Tree:
        def query(self, points, k):
            t = torch.from_numpy(np.asarray(points, np.float32))
            d, i = brute_force_knn(t, t, k)
            return d.numpy(), i.numpy()

    got = port.estimate_norm_with_tree(pts, Tree(), k=12, device="cpu")
    want = jax_pkg.estimate_norm_with_tree(pts, Tree(), k=12)
    dots = np.abs((got * want).sum(1))
    assert np.median(dots) > 1 - 1e-6 and (dots > 1 - 1e-3).mean() > 0.99


# The chain of estimate_normals (ops/kernels/normals_chain.py): its plain
# versions, which the CPU takes, against estimate_normals as it ran before
# (chip_smoke.parent_normals, which holds the kernels to it on the card).


@pytest.mark.parametrize("m,n_ref,k,plan", [
    (256, 1 << 17, 2, "tiles"), (256, 1 << 18, 32, "tiles"), (256, 1 << 18, 33, "select"),
    (8192, 1 << 17, 32, "tiles"), (8193, 1 << 17, 32, "select"), (1, 1, 1, "tiles"),
    (65535 * 256, 1, 1, "tiles"), (65535 * 256 + 1, 1, 1, "select")])
def test_sample_plan_takes_the_tiles_while_they_fit(m, n_ref, k, plan):
    """The sampler's way to the k-th distances: the tiles while k fits the
    registers, their lists the scratch and the queries the grid; the select
    for every other shape."""
    assert nc.sample_plan(m, n_ref, k) == plan


@pytest.mark.parametrize("caps,exact_tail", [((4096, 512), True), ((5, 3), True),
                                             ((4096, 512), False), ((1, 1), True),
                                             ((100_000, 100_000), True)])
def test_tail_lists_plain_version_equals_nonzero(caps, exact_tail):
    """The wide tier's queries and the fallback's points from the base tier's
    planar outputs: the first ``cap_t`` and ``cap_q`` of ``torch.nonzero``
    and the whole counts, with lists longer than their caps, caps above the
    counts, and an empty tail without ``exact_tail``."""
    pts = _isolated_scene()
    t = torch.from_numpy(pts)
    pg = build_packed_grid(t, 0.15, 32)
    out = kn.knn_moments_out(pg, t, None, K, port_normals.BASE_RADIUS)
    cert = float(np.float32((6.0 * pg.cell_fine) ** 2))
    tail, un, totals = nc.tail_lists(out, cert if exact_tail else None, *caps)
    unres, exact = out[8] > 0, out[9] > 0
    want_t = torch.nonzero(~exact & ~unres & (out[7] < cert))[:, 0] if exact_tail else \
        torch.zeros(0, dtype=torch.int64)
    want_u = torch.nonzero(unres)[:, 0]
    if caps == (5, 3):
        assert want_t.numel() > caps[0] and want_u.numel() > caps[1]
    assert totals.dtype == torch.int32
    assert totals.tolist() == [want_t.numel(), want_u.numel()]
    for got, want, cap in ((tail, want_t, caps[0]), (un, want_u, caps[1])):
        assert got.dtype == torch.int64 and torch.equal(got, want[:cap])
    assert nc.tail_lists.launches == 0


def _isolated_scene():
    """A dense sheet and lone points whose boxes hold fewer than k
    candidates (as test_isolated_points_are_unresolved_and_fall_back)."""
    rng = np.random.RandomState(2)
    dense = rng.rand(3000, 3).astype(np.float32) * np.float32([5, 5, 0.02])
    lone = rng.rand(20, 3).astype(np.float32) * 3 + np.float32([40, 40, 0])
    return np.vstack([dense, lone]).astype(np.float32)


@pytest.mark.parametrize("scene_name,k,exact_tail", [
    ("sheets", K, True), ("sheets", K, False), ("sheets", 5, True), ("isolated", K, True),
    ("isolated", 5, True), ("isolated", 40, True), ("isolated", 70, True)])
def test_return_info_counts_and_normals_equal_the_parents(scene_name, k, exact_tail):
    """``estimate_normals`` through the chain's plain versions: integer
    ``n_wide`` and ``n_unresolved``, the certificate and the normals of the
    code before the chain, bit for bit, also at a k of the k-NN kernel's
    rounds and of the fallback's sums in its own order on the card."""
    pts = _scene(8000) if scene_name == "sheets" else _isolated_scene()
    t = torch.from_numpy(pts)
    nrm, info = port_normals.estimate_normals(t, k=k, exact_tail=exact_tail, return_info=True)
    pg = build_packed_grid(t, info["cell_size"], cap=32, auto_cap=True)
    want, _, exact, n_wide, n_unresolved = chip_smoke.parent_normals(pg, t, k, exact_tail)
    assert type(info["n_wide"]) is int and type(info["n_unresolved"]) is int
    assert (info["n_wide"], info["n_unresolved"]) == (n_wide, n_unresolved)
    if scene_name == "sheets":
        assert (n_wide > 0) == exact_tail
    else:
        assert n_unresolved > 0
    assert torch.equal(info["exact"], exact)
    assert torch.equal(nrm, want)
