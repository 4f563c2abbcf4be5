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
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_registration_tpu.ops.pointgrid import (
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
