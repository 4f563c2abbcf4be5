"""The generators: the same seed gives the same inputs, another seed
others; the rebuild shift keeps the base map's box."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.gen import traffic as gen
from perfbench.tests.small import SMALL


def pool_and_requests(seed, mix, n=6):
    streams = gen.seed_streams(seed)
    pool = gen.make_pool(SMALL, mix, streams)
    reqs = gen.Requests(pool, mix, 1.0, streams["requests"])
    return pool, [reqs.next() for _ in range(n)]


TRACK = {"maps": 1, "scans_per_map": 3, "shift_voxels": 0, "init_translation_sigma_m": 0.1,
         "init_yaw_sigma_deg": 0.2}
REBUILD = dict(TRACK, maps=2, scans_per_map=1, shift_voxels=1.0)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -12])
def test_same_seed_same_inputs(seed):
    a, ra = pool_and_requests(seed, REBUILD)
    b, rb = pool_and_requests(seed, REBUILD)
    for x, y in zip(a.maps + [s for ss in a.scans for s in ss],
                    b.maps + [s for ss in b.scans for s in ss]):
        assert x.dtype == np.float32 and np.array_equal(x, y)
    for x, y in zip(ra, rb):
        assert np.array_equal(x.init_T, y.init_T) and np.array_equal(x.shift, y.shift)


def test_other_seed_other_inputs():
    a, ra = pool_and_requests(1, TRACK)
    b, rb = pool_and_requests(2, TRACK)
    assert not np.array_equal(a.maps[0], b.maps[0])
    assert not np.array_equal(ra[0].init_T, rb[0].init_T)


def test_requests_cycle_the_pool():
    pool, reqs = pool_and_requests(3, TRACK)
    assert [(r.map_index, r.scan_index) for r in reqs] == [(0, 0), (0, 1), (0, 2)] * 2
    assert all(not r.shift.any() for r in reqs)
    pool, reqs = pool_and_requests(3, REBUILD)
    assert [(r.map_index, r.scan_index) for r in reqs] == [(0, 0), (1, 0)] * 3


def test_scan_follows_the_protocol():
    pool, _ = pool_and_requests(4, TRACK)
    scan = pool.scans[0][0]
    assert scan.shape == (SMALL["scan"]["points"], 3)
    # every scan point is a map point + (0, 0, 0.3) + N(0, 0.005) noise
    assert abs(float(np.mean(scan[:, 2])) - float(np.mean(pool.maps[0][:, 2])) - 0.3) < 0.2


def test_rebuild_shift_keeps_the_box():
    pool, reqs = pool_and_requests(5, REBUILD, n=8)
    buffers = gen.Buffers(pool)
    for r in reqs:
        assert np.all((r.shift >= 0) & (r.shift < 1.0)) and r.shift.any()
        base = pool.maps[r.map_index]
        moved, scan = buffers.fill(pool, r)
        assert np.allclose(moved - base, r.shift, atol=1e-4)
        ext_base = base.max(axis=0) - base.min(axis=0)
        ext = moved.max(axis=0) - moved.min(axis=0)
        assert np.allclose(ext, ext_base, atol=1e-4)
        cells = np.floor(moved.max(axis=0)) - np.floor(moved.min(axis=0))
        cells_base = np.floor(base.max(axis=0)) - np.floor(base.min(axis=0))
        assert np.all(np.abs(cells - cells_base) <= 1)
        assert np.allclose(scan - pool.scans[r.map_index][r.scan_index], r.shift, atol=1e-4)


def test_init_T_is_a_yaw_about_the_centre():
    rng = np.random.RandomState(0)
    c = np.array([100.0, 100.0, 5.0])
    T = gen.draw_init_T(rng, c, {"init_translation_sigma_m": 0.0, "init_yaw_sigma_deg": 0.2})
    assert np.allclose(T[:3, :3] @ c + T[:3, 3], c)
    assert np.allclose(T[:3, :3].T @ T[:3, :3], np.eye(3)) and T[2, 2] == 1.0
