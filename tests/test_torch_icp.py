"""Port parity of ICP on the packed point grid: the point-to-point reduction,
the plain version of the point stats kernel (``match_points`` + ``point_stats``)
and the whole ``ICP.set_target`` + ``align`` of
point_cloud_registration_tpu_torch against the JAX package (both with
``CorrespondenceConfig(method="packed")``) and against the float64 oracle.

Both packages build bit-equal packed grids (tests/test_torch_pointgrid.py),
so correspondences agree one for one: equal gate weights, indices and proxy
slots, raw targets bit-equal and proxy centroids within float32 rounding of
their sums. Tolerances: stats normalised by their largest entry within 1e-5
(float32 sums in another order); T within 1e-3 of JAX's with equal
iteration counts; H / g / e2 within 1e-3 of the float64 oracle where every
query resolves within ``cell_fine`` (the reference's own test bound).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_registration_tpu.core.config import CorrespondenceConfig as JaxCorr
from point_cloud_registration_tpu.core.config import ICPConfig as JaxICPConfig
from point_cloud_registration_tpu.core.se3 import transform_points as jax_transform_points
from point_cloud_registration_tpu.models._point_corr import match_points as jax_match_points
from point_cloud_registration_tpu.models.base import pad_points as jax_pad_points
from point_cloud_registration_tpu.models.icp import build_icp_target as jax_build_icp_target
from point_cloud_registration_tpu.models.icp import icp_align as jax_icp_align
from point_cloud_registration_tpu.ops.reduce import point_stats as jax_point_stats
from point_cloud_registration_tpu_torch import ICP, CorrespondenceConfig, ICPConfig
from point_cloud_registration_tpu_torch.models import icp_align, pad_points
from point_cloud_registration_tpu_torch.models._point_corr import (
    PointCorrTarget,
    build_point_corr,
    match_points,
    proxy_radius,
)
from point_cloud_registration_tpu_torch.ops.kernels import _build
from point_cloud_registration_tpu_torch.ops.kernels.fused_align import (
    STATS_WIDTH,
    check_operands,
    stats_from_packed,
)
from point_cloud_registration_tpu_torch.ops.kernels.point_align import (
    point_stats,
    point_stats_reference,
)
from point_cloud_registration_tpu_torch.ops.reduce import point_stats as reduce_point_stats
from point_cloud_registration_tpu_torch.utils.convert import packed_grid_from_numpy
from oracles import (
    exp_so3_np,
    gn_align_np,
    icp_stats_np,
    make_scan,
    make_scene,
    plus_np,
    transform_np,
)
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


def _packed_icp(**kw) -> ICP:
    """The port's ICP on the packed engine whatever the target size."""
    icp = ICP(device="cpu", **kw)
    icp.cfg = dataclasses.replace(icp.cfg, corr=CorrespondenceConfig(**PACKED))
    return icp


def _normalised_close(got, want, atol):
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol)


@pytest.mark.parametrize("huber_delta", [None, 0.1], ids=["plain", "huber"])
def test_point_stats_reduction_matches_jax(huber_delta):
    rng = np.random.RandomState(0)
    src = (rng.rand(400, 3) * 10).astype(np.float32)
    T = plus_np(np.eye(4), rng.randn(6) * 0.05).astype(np.float32)
    q = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    tgt = (q + rng.randn(400, 3) * 0.2).astype(np.float32)
    w = (rng.rand(400) > 0.3).astype(np.float32)
    R = np.ascontiguousarray(T[:3, :3])
    got = reduce_point_stats(*(torch.from_numpy(a) for a in (src, q, tgt, w, R)),
                             huber_delta=huber_delta)
    want = jax_point_stats(*(jnp.asarray(a) for a in (src, q, tgt, w, R)),
                           huber_delta=huber_delta)
    _normalised_close([x.numpy() for x in got], want, atol=1e-5)


def _carried(jt) -> PointCorrTarget:
    pg, px = packed_grid_from_numpy(
        jt.packed.origin_fine, jt.packed.cell_fine, jt.packed.nb_dims, jt.packed.block_row,
        jt.packed.row_key, jt.packed.pts_packed, jt.packed.idx_packed, jt.packed.row_over,
        jt.proxy.means, jt.proxy.counts, jt.proxy.valid, device="cpu",
    )
    return PointCorrTarget(points=torch.from_numpy(np.array(jt.points)), packed=pg, proxy=px)


@pytest.fixture(scope="module")
def scene_target():
    pts = make_scene(np.random.RandomState(0))
    jt = jax_build_icp_target(pts, JaxICPConfig(**PARAMS, corr=JaxCorr(**PACKED)))
    return pts, jt, _carried(jt)


POSES = {
    "identity": np.zeros(6),
    "offset": np.array([0.3, -0.2, 0.15, 0.02, -0.03, 0.04]),
}


@pytest.mark.parametrize("pose", sorted(POSES))
def test_match_points_matches_jax(scene_target, pose):
    pts, jt, tt = scene_target
    rng = np.random.RandomState(5)
    scan = (pts[rng.choice(len(pts), 2000, replace=False)] + rng.randn(2000, 3) * 0.01)
    T = plus_np(np.eye(4), POSES[pose]).astype(np.float32)
    q = np.array(jax_transform_points(jnp.asarray(T), jnp.asarray(scan, jnp.float32)))
    a = jax_match_points(jt, jnp.asarray(q), JaxCorr(**PACKED), MAX_DIST)
    b = match_points(tt, torch.from_numpy(q), CorrespondenceConfig(**PACKED), MAX_DIST)
    np.testing.assert_array_equal(b.weight.numpy(), np.asarray(a.weight))
    np.testing.assert_array_equal(b.point_idx.numpy(), np.asarray(a.point_idx))
    np.testing.assert_array_equal(b.proxy_slot.numpy(), np.asarray(a.proxy_slot))
    raw = b.point_idx.numpy() >= 0
    proxy = b.proxy_slot.numpy() >= 0
    assert raw.sum() > 0 and (pose == "identity" or proxy.sum() > 0)
    np.testing.assert_array_equal(b.target.numpy()[raw], np.asarray(a.target)[raw])
    np.testing.assert_allclose(b.target.numpy()[proxy], np.asarray(a.target)[proxy],
                               rtol=0, atol=1e-5)


def _port_point_stats(tt, scan, T, huber_delta=None, fn=point_stats_reference):
    T = torch.as_tensor(T, dtype=torch.float32)
    corr = CorrespondenceConfig(**PACKED)
    return fn(tt.packed, tt.proxy, torch.from_numpy(scan), torch.ones(len(scan)),
              T[:3, :3], T[:3, 3], MAX_DIST, proxy_radius(corr, MAX_DIST), huber_delta)


@pytest.mark.parametrize("huber_delta", [None, 0.1], ids=["plain", "huber"])
@pytest.mark.parametrize("pose", sorted(POSES))
def test_reference_matches_jax_match_and_stats(scene_target, pose, huber_delta):
    pts, jt, tt = scene_target
    rng = np.random.RandomState(6)
    scan = (pts[rng.choice(len(pts), 2000, replace=False)]
            + rng.randn(2000, 3) * 0.01).astype(np.float32)
    T = plus_np(np.eye(4), POSES[pose]).astype(np.float32)
    Tj = jnp.asarray(T)
    q = jax_transform_points(Tj, jnp.asarray(scan))
    m = jax_match_points(jt, q, JaxCorr(**PACKED), MAX_DIST)
    want = jax_point_stats(jnp.asarray(scan), q, m.target, m.weight, Tj[:3, :3],
                           huber_delta=huber_delta)
    got = stats_from_packed(_port_point_stats(tt, scan, T, huber_delta))
    _normalised_close([x.numpy() for x in got], want, atol=1e-5)


@pytest.fixture(scope="module")
def cube():
    """The reference's own ICP fixture (tests/test_icp.py): 100 seeded random
    points in the unit cube. They share one packed block, so a block's cap
    keeps 32 of them."""
    return np.random.RandomState(42).rand(100, 3).astype(np.float32)


@pytest.fixture(scope="module")
def sparse_cube():
    """600 random points in a 4 m cube: about 9 per block, none over the
    cap, so a match within cell_fine is the exact nearest neighbour."""
    return (np.random.RandomState(43).rand(600, 3) * 4).astype(np.float32)


SMALL_DX = np.array([0.02, -0.03, 0.01, 0.01, -0.005, 0.008])


def test_calc_H_g_e2_matches_oracle(sparse_cube):
    src = transform_np(plus_np(np.eye(4), SMALL_DX), sparse_cube).astype(np.float32)
    icp = _packed_icp(max_iter=10, max_dist=MAX_DIST, tol=1e-3)
    icp.set_target(sparse_cube)
    assert not bool(icp._target.packed.row_over.any())
    H1, g1, e2_1 = icp.calc_H_g_e2(np.eye(4), src)
    H2, g2, e2_2, _ = icp_stats_np(sparse_cube, src, np.eye(4), max_dist=MAX_DIST)
    assert H1.dtype == np.float64
    _normalised_close([H1, g1, np.float64(e2_1)], [H2, g2, np.float64(e2_2)], atol=1e-3)


def test_align_matches_reference_loop(sparse_cube):
    src = transform_np(plus_np(np.eye(4), SMALL_DX), sparse_cube).astype(np.float32)
    icp = _packed_icp(**PARAMS)
    icp.set_target(sparse_cube)
    T_ours = icp.align(src)
    T_ref, _ = gn_align_np(lambda T: icp_stats_np(sparse_cube, src, T, MAX_DIST),
                           max_iter=30, tol=1e-3)
    np.testing.assert_allclose(T_ours, T_ref, atol=1e-3)


def _jax_icp_align(pts, scan, huber_delta=None, max_iter=30, tol=1e-3):
    cfg = JaxICPConfig(max_iter=max_iter, max_dist=MAX_DIST, tol=tol,
                       huber_delta=huber_delta, corr=JaxCorr(**PACKED))
    jt = jax_build_icp_target(pts, cfg)
    src, w = jax_pad_points(scan)
    res = jax_icp_align(jt, src, w, jnp.eye(4, dtype=jnp.float32), cfg)
    d = res.diagnostics
    return np.asarray(res.T), int(d.iterations), bool(d.converged), jt


@pytest.fixture(scope="module")
def scenes():
    return {seed: make_scene(np.random.RandomState(seed)) for seed in (0, 3)}


@pytest.mark.parametrize("scan_name", sorted(SCANS))
def test_icp_align_matches_jax(scenes, scan_name):
    scene_seed, seed, dx = SCANS[scan_name]
    pts = scenes[scene_seed]
    scan, _ = make_scan(np.random.RandomState(seed), pts, np.array(dx))
    T_j, it_j, conv_j, _ = _jax_icp_align(pts, scan)
    icp = _packed_icp(**PARAMS)
    icp.set_target(pts)
    T_t = icp.align(scan)
    d = icp.last_diagnostics
    assert T_t.dtype == np.float64 and T_t.shape == (4, 4)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-3)
    assert d.iterations == it_j
    assert d.converged == conv_j
    assert not d.solver_failed


def test_huber_align_matches_jax():
    """The corrupted scene of tests/test_icp.py (15% directional outliers
    inside the gate) with Huber weighting, on both sides."""
    rng = np.random.RandomState(77)
    target = make_scene(rng, n_floor=4000, n_wall=2000)
    scan, T_true = make_scan(rng, target, np.array([0.02, -0.03, 0.01, 0.15, -0.1, 0.08]))
    n_out = len(scan) * 15 // 100
    scan[:n_out] += np.float32([0.9, 0.6, 0.4]) + rng.randn(n_out, 3).astype(np.float32) * 0.1
    T_j, it_j, _, _ = _jax_icp_align(target, scan, huber_delta=0.1, max_iter=40, tol=1e-6)
    icp = _packed_icp(max_iter=40, max_dist=MAX_DIST, tol=1e-6, huber_delta=0.1)
    icp.set_target(target)
    T_t = icp.align(scan)
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-3)
    assert icp.last_diagnostics.iterations == it_j


def test_align_on_carried_target_matches_jax(scenes):
    scene_seed, seed, dx = SCANS["large_offset"]
    pts = scenes[scene_seed]
    scan, _ = make_scan(np.random.RandomState(seed), pts, np.array(dx))
    T_j, it_j, _, jt = _jax_icp_align(pts, scan)
    src, w = pad_points(scan)
    res = icp_align(_carried(jt), src, w, torch.eye(4),
                    ICPConfig(**PARAMS, corr=CorrespondenceConfig(**PACKED)))
    np.testing.assert_allclose(res.T.numpy(), T_j, rtol=0, atol=1e-4)
    assert res.diagnostics.iterations == it_j


def test_port_build_equals_carried_target(scene_target):
    pts, _, tt = scene_target
    ours = build_point_corr(pts, CorrespondenceConfig(**PACKED), MAX_DIST, device="cpu")
    for name in ("block_row", "row_key", "pts_packed", "idx_packed", "row_over", "row_count"):
        torch.testing.assert_close(getattr(ours.packed, name), getattr(tt.packed, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(ours.points, tt.points, rtol=0, atol=0)


def test_cpu_wrapper_runs_plain_version_without_launching(scene_target):
    pts, _, tt = scene_target
    scan = pts[:700] + np.float32(0.02)
    out = _port_point_stats(tt, scan, np.eye(4), fn=point_stats)
    assert point_stats.launches == 0
    assert out.shape == (STATS_WIDTH,) and out.device.type == "cpu"
    torch.testing.assert_close(out, _port_point_stats(tt, scan, np.eye(4)), rtol=0, atol=0)


def test_auto_and_grid_methods_raise_on_small_targets(cube):
    # "auto" picks the CSR grid below auto_threshold points, as "grid" does
    # at any size: the target is a grid with buckets, no packed rows (the
    # grid path's parity is in tests/test_torch_icp_grid.py); only unknown
    # methods and backends raise
    for corr in (CorrespondenceConfig(), CorrespondenceConfig(method="grid")):
        icp = ICP(device="cpu")
        icp.cfg = dataclasses.replace(icp.cfg, corr=corr)
        icp.set_target(cube)
        assert icp._target.packed is None and icp._target.proxy is None
        assert int(icp._target.buckets.counts.sum()) == len(cube)
    assert CorrespondenceConfig().resolved_method(50_000) == "packed"
    assert CorrespondenceConfig().resolved_method(49_999) == "grid"
    with pytest.raises(ValueError):
        CorrespondenceConfig(method="kdtree")
    with pytest.raises(ValueError):
        ICPConfig(backend="xla")


def test_unset_target_raises():
    with pytest.raises(ValueError, match="Target is not set"):
        ICP(device="cpu").align(np.zeros((10, 3), np.float32))


def test_check_operands_rejects_bad_inputs():
    src, w = torch.zeros(5, 3), torch.ones(5)
    check_operands(src, w, table=torch.zeros(4, 8))
    for bad in (
        (src.double(), w), (src, w[:4]), (src[:, :2], w), (src.t().contiguous().t(), w),
    ):
        with pytest.raises(ValueError):
            check_operands(*bad)
    with pytest.raises(ValueError, match="table"):
        check_operands(src, w, table=torch.zeros(4, 8, dtype=torch.int32))


def test_library_per_source():
    assert _build.library_names() == ["exact_nn", "fused_align", "gn_loop", "gn_step",
                                      "grid_align", "grid_loop", "knn_normals", "point_align",
                                      "point_loop"]
    a, b = _build.library_path("fused_align"), _build.library_path("point_align")
    assert a.parent != b.parent and a.name == "libfused_align.so"
    with pytest.raises(ValueError):
        _build.library_path("missing")


def test_reference_fixture_rotation(cube):
    """The reference fixture's large motion (R = exp([0.1, 0.2, 0.3])) on its
    one capped block: most queries start unresolved and take the proxy
    voxel, and the align still matches JAX's."""
    R = exp_so3_np(np.array([0.1, 0.2, 0.3]))
    src = (cube @ R.T + np.array([0.5, -0.3, 0.2])).astype(np.float32)
    T_j, it_j, _, _ = _jax_icp_align(cube, src)
    icp = _packed_icp(**PARAMS)
    icp.set_target(cube)
    np.testing.assert_allclose(icp.align(src), T_j, rtol=0, atol=1e-3)
    assert icp.last_diagnostics.iterations == it_j


def tie_scene():
    """A lattice target (one point per 0.5 m fine cell of a 4 m cube, eight
    per packed block, every coordinate a multiple of 1/4) and queries whose
    two nearest candidates are exactly as far: ``(target, {kind: (query,
    the two tied targets)})``."""
    g = np.arange(8, dtype=np.float32) * 0.5 + 0.25
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    ties = {
        # midway between kept points of two blocks: the block probed first wins
        "two_blocks": ([1.0, 0.25, 0.25], ([0.75, 0.25, 0.25], [1.25, 0.25, 0.25])),
        # midway between two kept points of one block: the earlier slot wins
        "one_block": ([0.5, 0.25, 0.25], ([0.25, 0.25, 0.25], [0.75, 0.25, 0.25])),
        # beyond cell_fine of every point, midway between two proxy centroids:
        # the voxel probed first (x fastest) wins
        "two_proxies": ([1.0, 0.5, 4.6], ([0.5, 0.5, 3.5], [1.5, 0.5, 3.5])),
    }
    # The tie query stands second, behind a query that sits on a target point:
    # the JAX package's compacted proxy tier pads its index list with 0, so an
    # unresolved query 0 loses its proxy match there (models/_point_corr.py).
    return pts.astype(np.float32), {k: (np.float32([pts[100], q]), np.float32(t))
                                    for k, (q, t) in ties.items()}


def tie_winner(packed, pts, kind, tied):
    """The target that ``match_points`` must pick for the tie ``kind``."""
    if kind != "one_block":
        return tied[0]  # the lower block / proxy key is probed first
    ids = [int(np.flatnonzero((pts == t).all(axis=1))[0]) for t in tied]
    row = packed.idx_packed[int(packed.block_row[0])].tolist()
    return tied[int(row.index(ids[1]) < row.index(ids[0]))]


@pytest.mark.parametrize("kind", ["two_blocks", "one_block", "two_proxies"])
def test_ties_take_the_first_candidate_in_probe_order(kind):
    """What the kernel's lane merge must keep: at equal distance the first
    block in probe order, the first slot in a block, the first proxy voxel;
    the same winner as the JAX package's ``match_points``, seen in the sign of
    the residual."""
    pts, ties = tie_scene()
    q, tied = ties[kind]
    jt = jax_build_icp_target(pts, JaxICPConfig(**PARAMS, corr=JaxCorr(**PACKED)))
    tt = build_point_corr(pts, CorrespondenceConfig(**PACKED), MAX_DIST, device="cpu")
    assert tt.packed.cell_fine == 0.5 and tt.packed.cap == 32
    a = jax_match_points(jt, jnp.asarray(q), JaxCorr(**PACKED), MAX_DIST)
    b = match_points(tt, torch.from_numpy(q), CorrespondenceConfig(**PACKED), MAX_DIST)
    want = tie_winner(tt.packed, pts, kind, tied)
    np.testing.assert_array_equal(b.target.numpy()[1], want)
    np.testing.assert_array_equal(np.asarray(a.target)[1], want)
    np.testing.assert_array_equal(b.point_idx.numpy(), np.asarray(a.point_idx))
    assert (int(b.point_idx[1]) >= 0) == (kind != "two_proxies")
    np.testing.assert_array_equal(b.weight.numpy(), [1.0, 1.0])
    np.testing.assert_array_equal(np.asarray(a.weight), [1.0, 1.0])
    d = np.abs(q[1] - tied).sum(axis=1)
    assert d[0] == d[1]  # an exact tie
    st = stats_from_packed(_port_point_stats(tt, q, np.eye(4)))
    want_st = jax_point_stats(jnp.asarray(q), jnp.asarray(q), a.target, a.weight, jnp.eye(3))
    np.testing.assert_array_equal(st.g.numpy(), np.asarray(want_st.g))
    # g = J^T r with J = [I | ...]; the query on a target point adds nothing
    np.testing.assert_array_equal(st.g.numpy()[:3], q[1] - want)


def _lane_merge(d2, order):
    """The kernel's merge over 8 lanes in NumPy: three xor-shuffle steps on
    (d2, order); the smaller d2 wins and, at equal d2, the lower order."""
    d2, order = d2.copy(), order.copy()
    for off in (4, 2, 1):
        od, oo = d2[np.arange(8) ^ off], order[np.arange(8) ^ off]
        take = (od < d2) | ((od == d2) & (oo < order))
        d2, order = np.where(take, od, d2), np.where(take, oo, order)
    return d2, order


@pytest.mark.parametrize("seed", range(4))
def test_lane_merge_model_keeps_the_first_minimum(seed):
    """Eight lanes each keep the first minimum of their own candidates (a
    block's slots, or every eighth proxy probe); the xor merge then yields the
    first minimum of all candidates in probe order, in every lane, whatever
    the ties and the empty lanes."""
    rng = np.random.RandomState(seed)
    for _ in range(50):
        counts = rng.randint(0, 6, 8)
        # blocks: lane b holds block b's slots, probe order = (lane, slot)
        rows = [rng.randint(0, 4, c).astype(np.float32) for c in counts]
        lane_d2 = np.float32([r.min() if len(r) else np.inf for r in rows])
        d2, lane = _lane_merge(lane_d2, np.arange(8))
        flat = np.concatenate(rows) if counts.sum() else np.float32([])
        if len(flat):
            first = int(np.argmin(flat))  # first minimum in (lane, slot) order
            starts = np.concatenate([[0], np.cumsum(counts)])
            assert (lane == np.searchsorted(starts, first, side="right") - 1).all()
            slot = int(np.argmin(rows[lane[0]]))
            assert starts[lane[0]] + slot == first and (d2 == flat.min()).all()
        else:
            assert np.isinf(d2).all()
        # proxy probes: probe p goes to lane p % 8, merged by (d2, probe index)
        probes = rng.randint(0, 3, rng.randint(0, 40)).astype(np.float32)
        probes[rng.rand(len(probes)) < 0.3] = np.inf  # invalid cells
        best = np.full(8, np.inf, np.float32)
        best_p = np.full(8, np.iinfo(np.int32).max)
        for p, v in enumerate(probes):
            if v < best[p % 8]:
                best[p % 8], best_p[p % 8] = v, p
        d2, p = _lane_merge(best, best_p)
        if np.isfinite(probes).any():
            assert (p == int(np.argmin(probes))).all() and (d2 == probes.min()).all()
        else:
            assert (p == np.iinfo(np.int32).max).all()
