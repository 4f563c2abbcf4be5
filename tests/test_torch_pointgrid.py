"""Port parity of the packed point grid: the build of
point_cloud_registration_tpu_torch/ops/pointgrid.py against the JAX
package's ``build_packed_grid_and_proxy`` and ``nearest_point_packed``.

The packed rows, their indices, the block map and the truncation flags are
held equal bit for bit, on several seeds and with blocks over the cap (the
hashed within-block order decides which points a full block keeps). The
JAX rows are padded to a power of two; the port keeps the occupied rows and
one sentinel row, so the comparison covers the occupied rows and checks that
the rest are padding on both sides. Proxy means are sums of up to ``cap``
float32 values taken in another order: within 4 ulp of 1 m (1e-6 m, on
clouds of a few tens of metres). Tier-1 indices and the resolved flags are
equal; distances agree to float32 rounding (rtol 1e-6).

Rows that carry per-point features (width 6, PlaneICP's normals) and the cap
chosen by ``auto_cap`` are held equal too. The proxy voxels' normals are
smallest eigenvectors of float32 covariances summed in another order: they
agree by ``|n . n'| > 1 - 1e-5`` on valid voxels with a clear eigen-gap.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_registration_tpu.ops.pointgrid import (
    build_packed_grid as jax_build_packed_grid,
    build_packed_grid_and_proxy as jax_build,
    nearest_point_packed as jax_nearest,
)
from point_cloud_registration_tpu_torch.ops.pointgrid import (
    build_packed_grid,
    build_packed_grid_and_proxy,
    index_hash,
    nearest_point_packed,
)
from point_cloud_registration_tpu_torch.utils.convert import packed_grid_from_numpy
from oracles import make_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CELL_FINE = 0.5
CAP = 32


def _cloud(seed):
    """A structured scene plus a dense clump, so that some blocks hold more
    than ``CAP`` points."""
    rng = np.random.RandomState(seed)
    pts = make_scene(rng, n_floor=3000, n_wall=1500)
    clump = rng.randn(1500, 3) * 0.08 + rng.rand(3) * 6
    return np.concatenate([pts, clump]).astype(np.float32)


@pytest.fixture(scope="module", params=[0, 1, 2])
def grids(request):
    pts = _cloud(request.param)
    jpg, jpx = jax_build(pts, CELL_FINE, cap=CAP, min_points=1, with_normals=False)
    pg, px = build_packed_grid_and_proxy(torch.from_numpy(pts), CELL_FINE, CAP, min_points=1)
    return pts, jpg, jpx, pg, px


def test_geometry_matches(grids):
    _, jpg, _, pg, _ = grids
    assert pg.origin_fine == tuple(int(x) for x in jpg.origin_fine)
    assert pg.nb_dims == tuple(int(x) for x in jpg.nb_dims)
    assert pg.cell_fine == float(jpg.cell_fine)
    assert pg.cap == CAP


def test_packed_rows_bit_equal(grids):
    _, jpg, _, pg, _ = grids
    n = pg.pts_packed.shape[0] - 1
    assert int(pg.row_over.sum()) > 0, "the cloud must overflow some blocks"
    np.testing.assert_array_equal(pg.block_row.numpy(), np.asarray(jpg.block_row))
    np.testing.assert_array_equal(pg.idx_packed.numpy()[:n], np.asarray(jpg.idx_packed)[:n])
    np.testing.assert_array_equal(pg.pts_packed.numpy()[:n], np.asarray(jpg.pts_packed)[:n])
    np.testing.assert_array_equal(pg.row_over.numpy()[:n], np.asarray(jpg.row_over)[:n])
    np.testing.assert_array_equal(pg.row_key.numpy()[:n], np.asarray(jpg.row_key)[:n])


def test_padding_rows(grids):
    _, jpg, _, pg, _ = grids
    n = pg.pts_packed.shape[0] - 1
    assert int((np.asarray(jpg.row_key) >= 0).sum()) == n
    for rows in (np.asarray(jpg.idx_packed)[n:], pg.idx_packed.numpy()[n:]):
        assert (rows == -1).all()
    assert np.isinf(pg.pts_packed.numpy()[n]).all() and int(pg.row_key[n]) == -1
    assert int(pg.row_count[n]) == 0 and not bool(pg.row_over[n])
    counts = np.isfinite(pg.pts_packed.numpy().reshape(n + 1, CAP, 3)[..., 0]).sum(1)
    np.testing.assert_array_equal(pg.row_count.numpy(), counts)


def test_proxy_matches(grids):
    _, jpg, jpx, pg, px = grids
    n = pg.pts_packed.shape[0] - 1
    np.testing.assert_array_equal(px.counts.numpy()[:n], np.asarray(jpx.counts)[:n])
    np.testing.assert_array_equal(px.valid.numpy()[:n], np.asarray(jpx.valid)[:n])
    np.testing.assert_allclose(px.means.numpy()[:n], np.asarray(jpx.means)[:n], rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(px.means.numpy()[:n]).max())))
    assert px.origin_cell == tuple(int(x) // 2 for x in jpg.origin_fine)
    assert px.cell_size == float(jpx.grid.cell_size) == 2 * CELL_FINE
    # the query table holds each row's centroid at its block key
    keys = pg.row_key[:n].long()
    torch.testing.assert_close(px.table[keys, 0:3], px.means[:n], rtol=0, atol=0)
    assert float(px.table[keys, 3].min()) == 1.0
    assert int((px.table[:, 3] > 0).sum()) == n


@pytest.mark.parametrize("spread", [0.05, 0.3, 1.5])
def test_nearest_point_packed_matches_jax(grids, spread):
    pts, jpg, _, pg, _ = grids
    rng = np.random.RandomState(int(spread * 100))
    q = (pts[rng.choice(len(pts), 2000)] + rng.randn(2000, 3) * spread).astype(np.float32)
    a = jax_nearest(jpg, jnp.asarray(q))
    b = nearest_point_packed(pg, torch.from_numpy(q), chunk=700)
    np.testing.assert_array_equal(b.idx.numpy(), np.asarray(a.idx))
    np.testing.assert_array_equal(b.resolved.numpy(), np.asarray(a.resolved))
    np.testing.assert_allclose(b.dist.numpy(), np.asarray(a.dist), rtol=1e-6)
    found = b.idx.numpy() >= 0
    np.testing.assert_array_equal(b.point.numpy()[found], pts[b.idx.numpy()[found]])


def test_converted_grid_equals_port_build(grids):
    pts, jpg, jpx, pg, px = grids
    cg, cx = packed_grid_from_numpy(
        jpg.origin_fine, jpg.cell_fine, jpg.nb_dims, jpg.block_row, jpg.row_key,
        jpg.pts_packed, jpg.idx_packed, jpg.row_over, jpx.means, jpx.counts, jpx.valid,
        device="cpu",
    )
    for name in ("block_row", "row_key", "pts_packed", "idx_packed", "row_over", "row_count"):
        torch.testing.assert_close(getattr(cg, name), getattr(pg, name), rtol=0, atol=0)
    assert (cg.origin_fine, cg.nb_dims, cg.cell_fine) == (pg.origin_fine, pg.nb_dims, pg.cell_fine)
    torch.testing.assert_close(cx.table, px.table, rtol=0, atol=1e-6 * 20)
    assert (cx.origin_cell, cx.dims, cx.cell_size) == (px.origin_cell, px.dims, px.cell_size)


def test_index_hash_wraps_like_int32():
    h = index_hash(1 << 17).numpy()
    x = np.arange(1 << 17, dtype=np.int32)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> 16)) * np.int32(0x45D9F3B)
        x = (x ^ (x >> 16)) * np.int32(0x45D9F3B)
    np.testing.assert_array_equal(h, x ^ (x >> 16))
    # the wrapped products are negative for some indices, the final xor
    # clears the sign bit: the sort key (bkey << 32) | h needs h >= 0
    assert (x < 0).any() and (h >= 0).all() and len(np.unique(h)) == len(h)


def test_empty_cloud_raises():
    with pytest.raises(ValueError, match="empty"):
        build_packed_grid(torch.zeros((0, 3)), CELL_FINE)


# -- packed features, auto_cap and proxy normals (PlaneICP's target) ----------


@pytest.fixture(scope="module", params=[0, 1])
def feat_grids(request):
    pts = _cloud(request.param)
    rng = np.random.RandomState(request.param + 10)
    feats = rng.randn(len(pts), 3).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    jpg, jpx = jax_build(pts, CELL_FINE, cap=CAP, min_points=12, with_normals=True, feats=feats)
    pg, px = build_packed_grid_and_proxy(torch.from_numpy(pts), CELL_FINE, CAP, min_points=12,
                                         with_normals=True, feats=torch.from_numpy(feats))
    return pts, feats, jpg, jpx, pg, px


def test_width6_rows_bit_equal(feat_grids):
    pts, feats, jpg, _, pg, _ = feat_grids
    n = pg.pts_packed.shape[0] - 1
    assert pg.width == 6 == jpg.width and pg.cap == CAP
    np.testing.assert_array_equal(pg.pts_packed.numpy()[:n], np.asarray(jpg.pts_packed)[:n])
    np.testing.assert_array_equal(pg.idx_packed.numpy()[:n], np.asarray(jpg.idx_packed)[:n])
    np.testing.assert_array_equal(pg.row_over.numpy()[:n], np.asarray(jpg.row_over)[:n])
    # every kept slot carries its point and that point's features
    slots = pg.pts_packed.numpy().reshape(n + 1, CAP, 6)
    idx = pg.idx_packed.numpy()
    kept = idx >= 0
    np.testing.assert_array_equal(slots[kept][:, :3], pts[idx[kept]])
    np.testing.assert_array_equal(slots[kept][:, 3:], feats[idx[kept]])
    assert np.isinf(slots[~kept]).all()


def test_proxy_normals_match(feat_grids):
    _, _, jpg, jpx, pg, px = feat_grids
    n = pg.pts_packed.shape[0] - 1
    valid = px.valid.numpy()[:n]
    np.testing.assert_array_equal(valid, np.asarray(jpx.valid)[:n])
    assert valid.sum() > 50 and (~valid).sum() > 0  # min_points leaves some voxels out
    # a clear eigen-gap: elsewhere the smallest eigenvector is ill-defined
    vals = np.linalg.eigvalsh(_cov33(np.asarray(jpx.covs)[:n]))
    clear = valid & ((vals[:, 1] - vals[:, 0]) > 0.05 * vals[:, 2])
    dots = np.abs((px.normals.numpy()[:n] * np.asarray(jpx.normals)[:n]).sum(1))
    assert clear.sum() > 50 and dots[clear].min() > 1 - 1e-5
    # the query table carries each valid voxel's normal at its block key
    keys = pg.row_key[:n].long()
    torch.testing.assert_close(px.table[keys, 4:7][px.valid[:n]], px.normals[:n][px.valid[:n]],
                               rtol=0, atol=0)
    assert float(px.table[keys, 4:7][~px.valid[:n]].abs().sum()) == 0.0


def _cov33(c6):
    c = np.zeros((len(c6), 3, 3))
    for k, (i, j) in enumerate([(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]):
        c[:, i, j] = c[:, j, i] = c6[:, k]
    return c


def test_nearest_point_packed_returns_the_slot_features(feat_grids):
    pts, feats, _, _, pg, _ = feat_grids
    rng = np.random.RandomState(3)
    q = (pts[rng.choice(len(pts), 1500)] + rng.randn(1500, 3) * 0.1).astype(np.float32)
    nn = nearest_point_packed(pg, torch.from_numpy(q))
    found = nn.idx.numpy() >= 0
    np.testing.assert_array_equal(nn.feat.numpy()[found], feats[nn.idx.numpy()[found]])
    np.testing.assert_array_equal(nn.point.numpy()[found], pts[nn.idx.numpy()[found]])


@pytest.mark.parametrize("clump,expect", [(0, 1), (300, 2), (3000, 3)])
def test_auto_cap_escalates_like_jax(clump, expect):
    """More than 1 % of the points truncated at ``cap`` doubles it; more
    than 1 % still truncated at ``2 * cap`` triples it."""
    rng = np.random.RandomState(clump)
    sheet = (rng.rand(1500, 3) * np.float32([12, 12, 0.05])).astype(np.float32)
    # a denser patch of the sheet (over cap, under 2 * cap), or a tight clump
    extent = np.float32([3, 3, 0.05]) if clump < 1000 else np.float32(0.4)
    dense = (rng.rand(clump, 3) * extent + np.float32(3.0)).astype(np.float32)
    pts = np.concatenate([sheet, dense])
    base = 8
    jpg = jax_build_packed_grid(pts, 0.3, cap=base, auto_cap=True)
    pg = build_packed_grid(torch.from_numpy(pts), 0.3, base, auto_cap=True)
    assert pg.cap == jpg.cap == expect * base
    n = pg.pts_packed.shape[0] - 1
    np.testing.assert_array_equal(pg.pts_packed.numpy()[:n], np.asarray(jpg.pts_packed)[:n])
    np.testing.assert_array_equal(pg.row_over.numpy()[:n], np.asarray(jpg.row_over)[:n])
    assert build_packed_grid(torch.from_numpy(pts), 0.3, base).cap == base
