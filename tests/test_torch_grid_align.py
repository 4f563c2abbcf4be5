"""The grid stats kernels (``csrc/grid_align.cu``: ICP's and PlaneICP's
small-target ``"grid"`` method, VPlaneICP's and NDT's hashed voxel map) on
the CPU, where no kernel runs: a NumPy model of the kernels' per-query loop,
their plain versions (``ops/kernels/grid_align.py``) and the wrappers,
against the JAX package on seeded NumPy inputs.

* The model walks each query's window as the plain query does: the float32
  transform and cell division one rounding at a time, the offsets in
  ``search_offsets`` order, each slot by the dense key table or by a
  lower-bound binary search over the sorted keys, a bucket's first ``cap``
  points or a slot's valid centroid, the first minimum by a strict ``<``.
  Its winners equal the JAX ``nearest_point`` / ``nearest_voxel``'s index
  for index (and the port's plain queries'), on inputs with a tie in one
  cell, a tie across two offsets, a bucket over ``cap``, a query outside
  the box, a NaN query, on a dense and a hashed grid.
* A second model follows the kernel's decomposition: the scan in the
  caller's order, a group of lanes per query (offsets ``k = lane mod L``
  through the dense table, or the window's rows of ``window_rows``, each
  by one lower-bound search from a sampled key index and a walk over the
  sorted keys), the candidates from ``hashgrid.bucket_rows``, each lane's
  first minimum on (d2, probe rank, bucket position) and the xor merge of
  the lanes, each query's match at its own position. At the
  kernel's lane counts and sample size, and at others, it gives the JAX
  queries' winners on seeded scenes and on lattices whose ties fall in two
  lanes and in two rows, with rows clipped at the box's faces, empty rows,
  buckets over ``cap`` and searches ending at either end of the keys and
  of a sampled interval; the test asserts that each of these occurred.
* The model's per-query linearizations, gated on ``sqrt(d2) < max_dist``
  and summed in float64, are within 1e-3 (relative to each block's largest
  entry) of JAX's ``icp_stats``, ``plane_icp_stats``, ``vplane_stats`` and
  hashed ``ndt_solver_stats`` in float32, with and without Huber.
* The wrappers on CPU tensors are the plain path the solvers ran before the
  kernels, bit for bit, count no launch, and raise on operands the kernel
  cannot read.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from point_cloud_registration_tpu.core.config import ICPConfig as JaxICPConfig
from point_cloud_registration_tpu.core.config import NDTConfig as JaxNDTConfig
from point_cloud_registration_tpu.core.config import PlaneICPConfig as JaxPlaneICPConfig
from point_cloud_registration_tpu.core.config import VPlaneICPConfig as JaxVPlaneConfig
from point_cloud_registration_tpu.models import _point_corr as jcorr
from point_cloud_registration_tpu.models.icp import icp_stats as jax_icp_stats
from point_cloud_registration_tpu.models.ndt import ndt_solver_stats as jax_ndt_stats
from point_cloud_registration_tpu.models.plane_icp import PlaneICPTarget as JaxPlaneICPTarget
from point_cloud_registration_tpu.models.plane_icp import plane_icp_stats as jax_plane_icp_stats
from point_cloud_registration_tpu.models.voxelized_plane_icp import vplane_stats as jax_vplane_stats
from point_cloud_registration_tpu.ops import hashgrid as jgrid
from point_cloud_registration_tpu.ops import knn as jknn
from point_cloud_registration_tpu.ops import voxelize as jvox
from point_cloud_registration_tpu_torch.core.config import ICPConfig, NDTConfig, VPlaneICPConfig
from point_cloud_registration_tpu_torch.core.gn import packed_from_stats
from point_cloud_registration_tpu_torch.core.se3 import makeRt, transform_points
from point_cloud_registration_tpu_torch.models import _fused, _point_fused
from point_cloud_registration_tpu_torch.models._point_corr import build_point_corr, match_points
from point_cloud_registration_tpu_torch.ops import hashgrid as tgrid
from point_cloud_registration_tpu_torch.ops import knn as tknn
from point_cloud_registration_tpu_torch.ops import reduce
from point_cloud_registration_tpu_torch.ops.kernels import _build
from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga
from point_cloud_registration_tpu_torch.ops.voxelize import build_voxel_map, query_nearest_voxel
from point_cloud_registration_tpu_torch.utils.convert import buckets_from_numpy, grid_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_DIST = 2.0
CELL = 1.0  # the grid method's max_dist / 2, and the voxel size
CAP = 64  # CorrespondenceConfig.cell_cap
HUBER = 0.05
TOL_STATS = 1e-3
POSE = np.float32([[0.9998, -0.0175, 0.0052, 0.03], [0.0174, 0.9998, 0.0087, -0.02],
                   [-0.0053, -0.0086, 0.9999, 0.05], [0, 0, 0, 1]])


def _np(x):
    return np.asarray(jax.device_get(x))


# --- the inputs ---------------------------------------------------------------


def _target():
    """(points, normals, queries): a seeded cloud of 1,800 points in 8 x 8 x 3 m
    and, apart from it, points and queries whose distances are exact (every
    coordinate a multiple of 1/4): a tie in one cell (the earlier bucket
    position wins), a tie across the offsets (-1, 0, 0) and (1, 0, 0) (the
    earlier offset wins), a bucket of 70 points whose nearest is past
    ``cap``; and queries outside the box and NaN."""
    rng = np.random.RandomState(3)
    cloud = rng.rand(1800, 3) * np.float32([8.0, 8.0, 3.0])
    tie_cell = [[20.25, 10.5, 1.5], [20.75, 10.5, 1.5]]
    tie_offsets = [[30.5, 10.5, 1.5], [32.5, 10.5, 1.5]]
    crowd = np.full((70, 3), [40.75, 10.75, 1.75])
    crowd[:, 0] -= np.arange(70)[::-1] * 2.0 ** -10  # the 70th the nearest to the query
    pts = np.vstack([cloud, tie_cell, tie_offsets, crowd]).astype(np.float32)
    normals = rng.randn(len(pts), 3)
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    special = [[20.5, 10.5, 1.5], [31.5, 10.5, 1.5], [40.875, 10.75, 1.75],
               [1e3, 1e3, 1e3], [np.nan, 1.0, 1.0], [-40.0, 2.0, 1.0]]
    q = np.vstack([rng.rand(96, 3) * np.float32([9.0, 9.0, 4.0]) - 0.5, special])
    return pts, normals, q.astype(np.float32)


def _voxels():
    """(cell centres, means, valid, queries) of a seeded voxel map: 600 cells
    in a 12 x 12 x 5 box with jittered centroids, 80 % valid, and apart from
    them two valid cells with centred centroids equidistant from a query on
    their border (the query's own cell, offset (0, 0, 0), wins) and two
    around an empty cell (offset (-1, 0, 0) wins)."""
    rng = np.random.RandomState(4)
    cells = np.unique(np.floor(rng.rand(900, 3) * [12, 12, 5]), axis=0)[:600]
    means = cells + 0.5 + (rng.rand(len(cells), 3) - 0.5) * 0.6
    valid = rng.rand(len(cells)) < 0.8
    ties = np.float32([[40, 10, 1], [41, 10, 1], [50, 10, 1], [52, 10, 1]])
    cells = np.vstack([cells, ties])
    means = np.vstack([means, ties + 0.5]).astype(np.float32)
    valid = np.concatenate([valid, [True] * 4])
    special = [[41.0, 10.5, 1.5], [51.5, 10.5, 1.5], [1e3, -1e3, 0.0], [np.nan, 1.0, 1.0]]
    q = np.vstack([rng.rand(96, 3) * [13, 13, 6] - 0.5, special]).astype(np.float32)
    return (cells + 0.5).astype(np.float32), means, valid, q


# --- the NumPy model of the kernels' per-query loop ---------------------------


def _transform(p, T):
    """q = ((x r0 + y r1) + z r2) + t, each operation rounded in float32."""
    R, t = T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32)
    return ((p[:, 0:1] * R[:, 0] + p[:, 1:2] * R[:, 1]) + p[:, 2:3] * R[:, 2]) + t


def _cells(q, cell):
    with np.errstate(invalid="ignore"):
        f = np.floor(q / np.float32(cell))
    # fmaxf(NaN, -1e9) is -1e9: a NaN coordinate lands outside every box
    return np.where(np.isnan(f), -1e9, np.clip(f, -1e9, 1e9)).astype(np.int64)


def _slot(key, keys, n_cells, dense):
    if key < 0:
        return -1
    if dense is not None:
        return int(dense[key])
    lo, hi = 0, n_cells
    while lo < hi:
        mid = (lo + hi) // 2
        if keys[mid] < key:
            lo = mid + 1
        else:
            hi = mid
    return lo if lo < n_cells and keys[lo] == key else -1


def _sq(q, x):
    d = (q - x).astype(np.float32)
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def model_matches(q, grid, offsets, candidates):
    """Each query's winner and squared distance (-1 and inf for none):
    ``candidates(slot) -> [(index, xyz)]`` in the order the kernel scans."""
    origin = np.asarray(grid["origin"], np.int64)
    dims = np.asarray(grid["dims"], np.int64)
    c = _cells(q, grid["cell"])
    idx = np.full(len(q), -1, np.int64)
    best = np.full(len(q), np.inf, np.float32)
    for i in range(len(q)):
        for off in offsets:
            rel = c[i] + off - origin
            key = -1
            if np.all((rel >= 0) & (rel < dims)):
                key = int(rel[0] + dims[0] * (rel[1] + dims[1] * rel[2]))
            slot = _slot(key, grid["keys"], grid["n_cells"], grid["dense"])
            if slot < 0:
                continue
            for j, x in candidates(slot):
                with np.errstate(invalid="ignore"):
                    d2 = _sq(q[i], x)
                if d2 < best[i]:
                    best[i], idx[i] = d2, j
    return idx, best


def bucket_candidates(points, perm, starts, counts, cap):
    def cands(slot):
        n = min(int(counts[slot]), cap)
        return [(int(p), points[p]) for p in perm[starts[slot]:starts[slot] + n]]
    return cands


def voxel_candidates(means, valid):
    return lambda slot: [(slot, means[slot])] if valid[slot] else []


def _grid_dict(g):
    return {"origin": _np(g.origin_cell), "dims": _np(g.dims), "cell": np.float32(g.cell_size),
            "keys": _np(g.keys), "n_cells": int(g.n_cells),
            "dense": None if g.dense is None else _np(g.dense)}


def _port_grid(g, dev="cpu"):
    return grid_from_numpy(_np(g.origin_cell), float(g.cell_size), _np(g.dims), _np(g.keys),
                           int(g.n_cells), None if g.dense is None else _np(g.dense),
                           device=dev)


# --- the model of the kernel's decomposition ---------------------------------


def _kernel_constant(name):
    """A constant of the grid stats body (``csrc/grid_stats.cuh``, which
    ``grid_align.cu`` and ``grid_loop.cu`` run): the model follows the
    kernel."""
    text = (_build.CSRC_DIR / "grid_stats.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


GRID_LANES, HASHED_LANES = _kernel_constant("kGridLanes"), _kernel_constant("kHashedLanes")
SAMPLE_MAX = _kernel_constant("kSampleMax")
NONE = (np.float32(np.inf), (np.iinfo(np.int64).max,), -1)  # (d2, order, winner)


def _sample_shift(n_cells, sample_max):
    s = 0
    while -(-n_cells >> s) > sample_max:
        s += 1
    return s


def _sampled_lower_bound(keys, n_cells, key, sample_max, events):
    """The kernel's ``lower_bound``: a binary search over the samples
    ``keys[i << s]``, then over the keys between two of them."""
    s = _sample_shift(n_cells, sample_max)
    sample = keys[np.arange(-(-n_cells >> s)) << s]
    lo, hi = 0, len(sample)
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid + 1, hi) if sample[mid] < key else (lo, mid)
    a, b = (0 if lo == 0 else ((lo - 1) << s) + 1), min(lo << s, n_cells)
    first, last = a, b
    while a < b:
        mid = (a + b) // 2
        a, b = (mid + 1, b) if keys[mid] < key else (a, mid)
    if s > 0 and a < n_cells and first < last and a in (first, last):
        events["interval_end"] += 1
    return a


def _consider(best, d2, order, idx):
    if d2 < best[0] or (d2 == best[0] and d2 < np.inf and order < best[1]):
        return (d2, order, idx)
    return best


def model_lane_matches(src, T, grid, offsets, candidates, lanes, sample_max=SAMPLE_MAX,
                       events=None):
    """The kernel's matches of ``src`` at ``T``, each query at its own
    position: ``candidates(slot) -> [(index, xyz)]`` in bucket
    order, read from the table the kernel reads. ``events`` counts what the
    lattices must reach: ties merged across lanes and rows, clipped and
    empty rows, over-cap buckets (counted by ``candidates``), searches
    ending at the keys' ends and at a sampled interval's."""
    events = {} if events is None else events
    for name in ("lane_tie", "row_tie", "clipped_row", "empty_row", "key_first", "key_last",
                 "interval_end"):
        events.setdefault(name, 0)
    origin = np.asarray(grid["origin"], np.int64)
    dims = np.asarray(grid["dims"], np.int64)
    keys, n_cells, dense = grid["keys"], grid["n_cells"], grid["dense"]
    rows, ranks = ga.window_rows(offsets)
    q = _transform(src, T)
    c = _cells(q, grid["cell"])
    idx = np.full(len(src), -2, np.int64)
    best_d2 = np.full(len(src), np.nan, np.float32)
    for i in range(len(src)):
        lane_best, lane_rows = [NONE] * lanes, [None] * lanes

        def visit(lane, slot, rank, row):
            for j, (p, x) in enumerate(candidates(slot)):
                with np.errstate(invalid="ignore"):
                    d2 = _sq(q[i], x)
                old = lane_best[lane]
                if d2 == old[0] and d2 < np.inf and lane_rows[lane] != row and dense is None:
                    events["row_tie"] += 1
                new = _consider(old, d2, (rank, j), p)
                if new is not old:
                    lane_best[lane], lane_rows[lane] = new, row

        for lane in range(lanes):
            if dense is not None:
                for k in range(lane, len(offsets), lanes):
                    rel = c[i] + offsets[k] - origin
                    if np.all((rel >= 0) & (rel < dims)):
                        slot = int(dense[rel[0] + dims[0] * (rel[1] + dims[1] * rel[2])])
                        if slot >= 0:
                            visit(lane, slot, k, k)
                continue
            for r in range(lane, len(rows), lanes):
                dy, dz, lo, hi = (int(v) for v in rows[r])
                ry, rz = c[i][1] + dy - origin[1], c[i][2] + dz - origin[2]
                if not (0 <= ry < dims[1] and 0 <= rz < dims[2]):
                    continue
                first = c[i][0] + lo - origin[0]
                x0, x1 = max(first, 0), min(c[i][0] + hi - origin[0], dims[0] - 1)
                if x0 > x1:
                    continue
                events["clipped_row"] += int(x0 > first or x1 < c[i][0] + hi - origin[0])
                base = dims[0] * (ry + dims[1] * rz)
                pos = _sampled_lower_bound(keys, n_cells, base + x0, sample_max, events)
                hits = 0
                while pos < n_cells and keys[pos] <= base + x1:
                    events["key_first"] += int(pos == 0)
                    events["key_last"] += int(pos == n_cells - 1)
                    visit(lane, pos, int(ranks[r, keys[pos] - base - first]), r)
                    pos, hits = pos + 1, hits + 1
                events["empty_row"] += int(hits == 0)
        # the xor merge: every lane ends with the group's first minimum
        group = list(zip(lane_best, lane_rows))
        off = lanes // 2
        while off:
            merged = []
            for lane in range(lanes):
                (a, ra), (b, rb) = group[lane], group[lane ^ off]
                take = b[0] < a[0] or (b[0] == a[0] and b[1] < a[1])
                if lane < lane ^ off and a[0] == b[0] and a[0] < np.inf:
                    events["lane_tie"] += 1
                    events["row_tie"] += int(ra != rb and dense is None)
                merged.append((b, rb) if take else (a, ra))
            group, off = merged, off // 2
        assert all(g[0][:2] == group[0][0][:2] for g in group)
        best_d2[i], _, idx[i] = group[0][0]
    assert (idx >= -1).all()  # every query written once
    return idx, best_d2


def rows_candidates(rows_t, starts, counts, cap, events=None):
    """A grid target's candidates as the kernel reads them: from
    ``hashgrid.bucket_rows``, the index in the fourth float's bits."""
    rows = rows_t.numpy()
    index = rows[:, 3].view(np.int32)

    def cands(slot):
        n = int(counts[slot])
        if events is not None and n > cap:
            events["over_cap"] = events.get("over_cap", 0) + 1
        a = int(starts[slot])
        return [(int(index[a + j]), rows[a + j, :3]) for j in range(min(n, cap))]
    return cands


# --- the model's linearizations, in float64 ----------------------------------


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def model_stats(kind, src, w, T, idx, d2, targets, feats, huber=None):
    """H, g, e2, n summed in float64 over the gated matches, and their count."""
    R = T[:3, :3].astype(np.float64)
    q = _transform(src, T).astype(np.float64)
    H, g, e2, n, count = np.zeros((6, 6)), np.zeros(6), 0.0, 0.0, 0
    for i in np.flatnonzero((idx >= 0) & (w > 0)):
        if not np.sqrt(np.float32(d2[i])) < np.float32(MAX_DIST):
            continue
        count += 1
        p, d = src[i].astype(np.float64), q[i] - targets[idx[i]].astype(np.float64)
        K = -R @ _skew(p)
        wi = float(w[i])
        if kind in ("point", "ndt"):
            S = np.eye(3) if kind == "point" else _sym(feats[idx[i]])
            J, Sd = np.hstack([np.eye(3), K]), S @ d
            r = np.sqrt(max(d @ Sd, 0.0))
            if huber is not None and r > huber:
                wi *= huber / r
            H += wi * J.T @ S @ J
            g += wi * J.T @ Sd
            e2 += wi * d @ Sd
        else:
            nv = feats[idx[i]].astype(np.float64)
            r = nv @ d
            if huber is not None and abs(r) > huber:
                wi *= huber / abs(r)
            J = np.concatenate([nv, np.cross(p, R.T @ nv)])
            H += wi * np.outer(J, J)
            g += wi * J * r
            e2 += wi * r * r
        n += wi
    return H, g, e2, n, count


def _sym(s6):
    a, b, c, xy, xz, yz = s6.astype(np.float64)
    return np.array([[a, xy, xz], [xy, b, yz], [xz, yz, c]])


def _assert_stats_close(model, jax_stats):
    H, g, e2, n, count = model
    Hj, gj = _np(jax_stats.H).astype(np.float64), _np(jax_stats.g).astype(np.float64)
    assert count > 50
    for got, want in ((H, Hj), (g, gj)):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= TOL_STATS * scale
    assert abs(e2 - float(jax_stats.e2)) <= TOL_STATS * float(jax_stats.e2)
    assert abs(n - float(jax_stats.n_inliers)) <= TOL_STATS * n


# --- fixtures -----------------------------------------------------------------


POSES = {"I": np.eye(4, dtype=np.float32), "pose": POSE}


@pytest.fixture(scope="module")
def point_case():
    """The JAX grid target with its dense key table and without (hashed),
    each with the model's matches of the queries at each of ``POSES``."""
    pts, normals, q = _target()
    offsets = jgrid.search_offsets(MAX_DIST, CELL)
    out = {}
    for layout, budget in (("dense", jgrid.DENSE_CELL_BUDGET), ("hashed", 1)):
        jg, _, jb = jgrid.build_grid(pts, CELL, with_buckets=True, dense_budget=budget)
        assert (jg.dense is None) == (layout == "hashed")
        g = _grid_dict(jg)
        cands = bucket_candidates(pts, _np(jb.perm), _np(jb.starts), _np(jb.counts), CAP)
        model = {name: model_matches(_transform(q, T), g, offsets, cands)
                 for name, T in POSES.items()}
        out[layout] = (jg, jb, model)
    return pts, normals, q, offsets, out


@pytest.fixture(scope="module")
def voxel_case():
    """The same for the seeded voxel map's centroids (``nearest_voxel``)."""
    centres, means, valid, q = _voxels()
    offsets = jgrid.search_offsets(MAX_DIST, CELL)
    out = {}
    for layout, budget in (("dense", jgrid.DENSE_CELL_BUDGET), ("hashed", 1)):
        jg, jinv, _ = jgrid.build_grid(centres, CELL, dense_budget=budget)
        C = jg.keys.shape[0]
        slot_means = np.zeros((C, 3), np.float32)
        slot_valid = np.zeros(C, bool)
        slot_means[_np(jinv)] = means
        slot_valid[_np(jinv)] = valid
        g, cands = _grid_dict(jg), voxel_candidates(slot_means, slot_valid)
        model = {name: model_matches(_transform(q, T), g, offsets, cands)
                 for name, T in POSES.items()}
        out[layout] = (jg, slot_means, slot_valid, model)
    return q, offsets, out


@pytest.fixture(scope="module")
def hashed_scene():
    """A JAX hashed voxel map (``dense_budget=1``, with icov) of a seeded
    scene, a scan of 200 of its points, weights and the model's matches."""
    rng = np.random.RandomState(6)
    centers = rng.rand(40, 3) * 10
    pts = (centers[:, None, :] + rng.randn(40, 60, 3) * 0.4).reshape(-1, 3).astype(np.float32)
    jg, jinv, _ = jgrid.build_grid(pts, CELL, dense_budget=1)
    jvm = jvox._finish_voxel_map(jnp.asarray(pts), jg, jinv, min_points=5, with_icov=True)
    src = pts[rng.choice(len(pts), 200, replace=False)] + rng.randn(200, 3).astype(np.float32) * 0.05
    w = rng.rand(200).astype(np.float32)
    means, valid = _np(jvm.means), _np(jvm.valid)
    idx, d2 = model_matches(_transform(src, POSE), _grid_dict(jg),
                            jgrid.search_offsets(MAX_DIST, CELL), voxel_candidates(means, valid))
    return jvm, src, w, idx, d2


# --- the model against the JAX queries ------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "hashed"])
def test_model_point_matches_equal_jax_nearest_point(point_case, layout):
    pts, _, q, offsets, grids = point_case
    jg, jb, model = grids[layout]
    for name, T in POSES.items():
        idx, d2 = model[name]
        res = jknn.nearest_point(jg, jb, jnp.asarray(pts), jnp.asarray(_transform(q, T)),
                                 offsets, CAP)
        np.testing.assert_array_equal(idx, _np(res.idx))
        hit = idx >= 0
        np.testing.assert_allclose(np.sqrt(d2[hit]), _np(res.dist)[hit], rtol=1e-6)
    # at T = I the constructed cases: the tie in one cell goes to the earlier
    # bucket position, the tie across offsets to (-1, 0, 0), the crowded
    # bucket's nearest (past cap) is not scanned, outside and NaN find none
    idx = model["I"][0]
    n = 1800
    assert idx[-6:-3].tolist() == [n, n + 2, n + 4 + CAP - 1]
    assert idx[-3:].tolist() == [-1, -1, -1]


@pytest.mark.parametrize("layout", ["dense", "hashed"])
def test_model_voxel_matches_equal_jax_nearest_voxel(voxel_case, layout):
    q, offsets, grids = voxel_case
    jg, means, valid, model = grids[layout]
    for name, T in POSES.items():
        idx, d2 = model[name]
        res = jknn.nearest_voxel(jg, jnp.asarray(means), jnp.asarray(valid),
                                 jnp.asarray(_transform(q, T)), offsets)
        np.testing.assert_array_equal(idx, _np(res.idx))
        hit = idx >= 0
        np.testing.assert_allclose(np.sqrt(d2[hit]), _np(res.dist)[hit], rtol=1e-6)
    # at T = I: the tie on a border goes to the query's own cell, the tie
    # around an empty cell to (-1, 0, 0); outside and NaN find none
    centre = lambda s: means[s] - 0.5  # noqa: E731 (the tie cells' centroids are centred)
    ties = model["I"][0][-4:-2]
    assert centre(ties[0]).tolist() == [41, 10, 1] and centre(ties[1]).tolist() == [50, 10, 1]
    assert model["I"][0][-2:].tolist() == [-1, -1]


@pytest.mark.parametrize("layout", ["dense", "hashed"])
def test_port_matches_equal_the_model(point_case, voxel_case, layout):
    """The port's plain queries and the wrappers' ``matches`` on CPU tensors
    give the model's winners and squared distances bit for bit."""
    pts, normals, q, offsets, grids = point_case
    jg, jb, model = grids[layout]
    grid = _port_grid(jg)
    buckets = buckets_from_numpy(_np(jb.perm), _np(jb.starts), _np(jb.counts), device="cpu")
    table = ga.point_table(torch.from_numpy(pts), buckets, CAP,
                           rows=tgrid.bucket_rows(torch.from_numpy(pts), buckets))
    src, w = torch.from_numpy(q), torch.ones(len(q))
    T = torch.from_numpy(POSE)
    idx, d2 = model["pose"]
    got = (torch.empty(len(q), dtype=torch.int32), torch.empty(len(q)))
    ga.grid_point_stats(grid, table, src, w, T[:3, :3], T[:3, 3], offsets, MAX_DIST,
                        matches=got)
    np.testing.assert_array_equal(got[0].numpy(), idx)
    np.testing.assert_array_equal(got[1].numpy(), d2)
    nn = tknn.nearest_point(grid, table.buckets, table.points,
                            transform_points(T, src), offsets, CAP)
    np.testing.assert_array_equal(nn.idx.numpy(), idx)

    vq, voffsets, vgrids = voxel_case
    vjg, means, valid, vmodel = vgrids[layout]
    vtable = ga.voxel_table(torch.from_numpy(means), torch.from_numpy(valid),
                            torch.zeros(len(means), 3))
    vidx, vd2 = vmodel["pose"]
    got = (torch.empty(len(vq), dtype=torch.int32), torch.empty(len(vq)))
    ga.hashed_plane_stats(_port_grid(vjg), vtable, torch.from_numpy(vq), torch.ones(len(vq)),
                          T[:3, :3], T[:3, 3], voffsets, MAX_DIST, matches=got)
    np.testing.assert_array_equal(got[0].numpy(), vidx)
    np.testing.assert_array_equal(got[1].numpy(), vd2)


# --- the kernel's decomposition against the JAX queries ------------------------


LANE_COUNTS = sorted({16, GRID_LANES, HASHED_LANES})


def _port_rows(pts, jb):
    buckets = buckets_from_numpy(_np(jb.perm), _np(jb.starts), _np(jb.counts), device="cpu")
    return tgrid.bucket_rows(torch.from_numpy(pts), buckets)


def test_bucket_rows_are_the_points_in_bucket_order(point_case):
    """``hashgrid.bucket_rows``: row ``starts[s] + j`` is point
    ``perm[starts[s] + j]``, its index in the fourth float's bits; the
    rows a grid target keeps, which its operands hand the kernel, are
    those of its points and buckets."""
    pts, _, _, _, grids = point_case
    jg, jb, _ = grids["dense"]
    rows = _port_rows(pts, jb)
    perm = _np(jb.perm)
    assert rows.dtype == torch.float32 and rows.shape == (len(pts), 4) and rows.is_contiguous()
    np.testing.assert_array_equal(rows[:, :3].numpy(), pts[perm])
    np.testing.assert_array_equal(rows[:, 3].numpy().view(np.int32), perm)
    target = build_point_corr(pts, ICPConfig().corr, MAX_DIST, device="cpu")
    assert target.packed is None
    _, table, _ = _point_fused.grid_operands(target, ICPConfig(max_dist=MAX_DIST))
    assert table.rows is target.rows
    assert torch.equal(target.rows, tgrid.bucket_rows(target.points, target.buckets))
    np.testing.assert_array_equal(target.rows[:, :3].numpy(),
                                  pts[target.buckets.perm.long().numpy()])


@pytest.mark.parametrize("offsets", [
    jgrid.search_offsets(2.0, 1.0), jgrid.search_offsets(1.0, 1.0),
    jgrid.search_offsets(2.0, 0.5), jgrid.search_offsets(0.3, 1.0),
    np.int32([[0, 0, 0], [2, 0, 0], [-1, 0, 0], [1, 1, 0], [0, 0, 0], [3, 0, 0], [0, -1, 2]]),
], ids=["r2", "r1", "r4", "small", "gaps and a repeat"])
def test_window_rows_cover_the_offsets_with_their_ranks(offsets):
    """Each offset lies in exactly one run of consecutive dx at its (dy, dz),
    with its first position in ``offsets`` as its rank; the runs follow the
    keys' order; ``search_offsets`` windows give one run per (dy, dz)."""
    rows, ranks = ga.window_rows(offsets)
    cells = {}
    for r, (dy, dz, lo, hi) in enumerate(rows.tolist()):
        assert lo <= hi and (ranks[r, hi - lo + 1:] == -1).all()
        for i, dx in enumerate(range(lo, hi + 1)):
            assert (dx, dy, dz) not in cells
            cells[(dx, dy, dz)] = int(ranks[r, i])
    want = {}
    for k, o in enumerate(map(tuple, np.asarray(offsets).tolist())):
        want.setdefault(o, k)
    assert cells == want
    keyed = [(dz, dy, lo) for dy, dz, lo, _ in rows.tolist()]
    assert keyed == sorted(keyed)
    if len(offsets) > 8:  # a search_offsets window
        assert len(rows) == len({(o[1], o[2]) for o in np.asarray(offsets).tolist()})


def test_point_table_checks_the_rows_it_is_given(point_case):
    """A grid target's table takes its bucket rows from the caller (the
    target keeps them): ``point_table`` builds none, and the launcher's
    checks refuse rows that are missing, of another shape or dtype, or not
    at a 16-byte boundary (the kernel reads them as float4)."""
    pts, _, _, _, grids = point_case
    _, jb, _ = grids["dense"]
    buckets = buckets_from_numpy(_np(jb.perm), _np(jb.starts), _np(jb.counts), device="cpu")
    points = torch.from_numpy(pts)
    with pytest.raises(TypeError):
        ga.point_table(points, buckets, CAP)  # the rows are required
    rows = tgrid.bucket_rows(points, buckets)
    grid, cpu = _port_grid(grids["dense"][0]), torch.device("cpu")
    ga.check_table("point", grid, ga.point_table(points, buckets, CAP, rows=rows), cpu)
    shifted = torch.empty(rows.numel() + 1)[1:].view(rows.shape)
    shifted.copy_(rows)
    for bad in (None, rows[:-1], rows.double(), rows[:, :3].contiguous(), shifted):
        with pytest.raises(ValueError):
            ga.check_table("point", grid, ga.point_table(points, buckets, CAP, rows=bad), cpu)


def _lane_cases(layout, samples):
    """(lanes, sample size) pairs: the sample size matters only to the
    searches, without a dense key table."""
    return [(lanes, sm) for lanes in LANE_COUNTS
            for sm in (samples if layout == "hashed" else samples[:1])]


SEEDED_CASES = [(layout, lanes, sm) for layout in ("dense", "hashed")
                for lanes, sm in _lane_cases(layout, (SAMPLE_MAX, 5))]


@pytest.mark.parametrize("layout,lanes,sample_max", SEEDED_CASES)
def test_lane_model_point_matches_equal_jax(point_case, layout, lanes, sample_max):
    """The kernel's decomposition on the seeded target (a tie in one cell, a
    tie across offsets, a bucket over ``cap``, outside and NaN queries):
    winners and squared distances equal to the plain model's, winners equal
    to the JAX ``nearest_point``'s, each at the caller's position."""
    pts, _, q, offsets, grids = point_case
    jg, jb, model = grids[layout]
    cands = rows_candidates(_port_rows(pts, jb), _np(jb.starts), _np(jb.counts), CAP)
    for name, T in POSES.items():
        idx, d2 = model_lane_matches(q, T, _grid_dict(jg), offsets, cands, lanes, sample_max)
        np.testing.assert_array_equal(idx, model[name][0])
        np.testing.assert_array_equal(d2, model[name][1])
        res = jknn.nearest_point(jg, jb, jnp.asarray(pts), jnp.asarray(_transform(q, T)),
                                 offsets, CAP)
        np.testing.assert_array_equal(idx, _np(res.idx))


@pytest.mark.parametrize("layout,lanes,sample_max", SEEDED_CASES)
def test_lane_model_voxel_matches_equal_jax(voxel_case, layout, lanes, sample_max):
    """The same on the seeded voxel map (ties on a border and around an
    empty cell) against the JAX ``nearest_voxel``."""
    q, offsets, grids = voxel_case
    jg, means, valid, model = grids[layout]
    for name, T in POSES.items():
        idx, d2 = model_lane_matches(q, T, _grid_dict(jg), offsets,
                                     voxel_candidates(means, valid), lanes, sample_max)
        np.testing.assert_array_equal(idx, model[name][0])
        np.testing.assert_array_equal(d2, model[name][1])
        res = jknn.nearest_voxel(jg, jnp.asarray(means), jnp.asarray(valid),
                                 jnp.asarray(_transform(q, T)), offsets)
        np.testing.assert_array_equal(idx, _np(res.idx))


LATTICE_POSES = {"I": np.eye(4, dtype=np.float32),
                 "shift": np.float32([[1, 0, 0, 0.25], [0, 1, 0, -0.5], [0, 0, 1, 0.25],
                                      [0, 0, 0, 1]])}
LATTICE_CAP = 6


def _lattice_queries(rng, lo, hi, n):
    """Queries on a quarter lattice from a cell beyond the box's low faces to
    one beyond its high faces, with the box's corners: exact distances."""
    q = np.floor(rng.uniform(lo - 1.0, hi + 1.0, (n, 3)) * 4) / 4
    return np.vstack([q, [lo, lo + 0.25, hi]]).astype(np.float32)


@pytest.fixture(scope="module")
def point_lattice():
    """Points on a half-metre lattice (+1/4) in 6 x 6 x 3 m, 40 % of the
    sites but none with 2 <= y < 3 (rows of empty cells), some twice (a tie
    in one bucket), one site eight times (over ``LATTICE_CAP``), and 128
    quarter-lattice queries: ties everywhere."""
    rng = np.random.RandomState(13)
    sites = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(6), indexing="ij"),
                     -1).reshape(-1, 3) * 0.5 + 0.25
    pts = sites[(rng.rand(len(sites)) < 0.4) & ((sites[:, 1] < 2) | (sites[:, 1] > 3))]
    pts = np.vstack([pts, pts[::9], np.repeat(pts[5:6], 8, 0)]).astype(np.float32)
    return pts, _lattice_queries(rng, 0.0, 6.0, 128)


@pytest.fixture(scope="module")
def voxel_lattice():
    """Cells of a 7 x 7 x 4 box, half occupied, 70 % of those valid, their
    centroids a quarter off the centre on a lattice, and 128 quarter-lattice
    queries."""
    rng = np.random.RandomState(14)
    cells = np.stack(np.meshgrid(np.arange(7), np.arange(7), np.arange(4), indexing="ij"),
                     -1).reshape(-1, 3)
    cells = cells[rng.rand(len(cells)) < 0.5]
    means = (cells + 0.5 + rng.randint(-1, 2, cells.shape) * 0.25).astype(np.float32)
    valid = rng.rand(len(cells)) < 0.7
    return (cells + 0.5).astype(np.float32), means, valid, _lattice_queries(rng, 0.0, 7.0, 128)


def _assert_events(events, names):
    missing = [n for n in names if events.get(n, 0) == 0]
    assert not missing, f"the lattice reached no {missing}: {events}"


@pytest.mark.parametrize("layout", ["dense", "hashed"])
def test_lane_model_on_the_point_lattice(point_lattice, layout):
    """Every lane count and sample size: winners equal to the JAX
    ``nearest_point``'s and d2 to the plain model's, with ties across
    lanes and rows, clipped and empty rows, over-cap buckets and searches
    ending at the keys' ends and at sampled intervals' ends."""
    pts, q = point_lattice
    offsets = jgrid.search_offsets(MAX_DIST, CELL)
    budget = jgrid.DENSE_CELL_BUDGET if layout == "dense" else 1
    jg, _, jb = jgrid.build_grid(pts, CELL, with_buckets=True, dense_budget=budget)
    g = _grid_dict(jg)
    perm, starts, counts = _np(jb.perm), _np(jb.starts), _np(jb.counts)
    events = {}
    cands = rows_candidates(_port_rows(pts, jb), starts, counts, LATTICE_CAP, events)
    for name, T in LATTICE_POSES.items():
        plain = model_matches(_transform(q, T), g, offsets,
                              bucket_candidates(pts, perm, starts, counts, LATTICE_CAP))
        res = jknn.nearest_point(jg, jb, jnp.asarray(pts), jnp.asarray(_transform(q, T)),
                                 offsets, LATTICE_CAP)
        np.testing.assert_array_equal(plain[0], _np(res.idx))
        for lanes, sample_max in _lane_cases(layout, (SAMPLE_MAX, 16, 3)):
            idx, d2 = model_lane_matches(q, T, g, offsets, cands, lanes, sample_max, events)
            np.testing.assert_array_equal(idx, plain[0])
            np.testing.assert_array_equal(d2, plain[1])
    _assert_events(events, ["lane_tie", "over_cap"])
    if layout == "hashed":
        _assert_events(events, ["row_tie", "clipped_row", "empty_row", "key_first", "key_last",
                                "interval_end"])


@pytest.mark.parametrize("layout", ["dense", "hashed"])
def test_lane_model_on_the_voxel_lattice(voxel_lattice, layout):
    """The same on the voxel lattice against the JAX ``nearest_voxel``."""
    centres, means, valid, q = voxel_lattice
    offsets = jgrid.search_offsets(MAX_DIST, CELL)
    budget = jgrid.DENSE_CELL_BUDGET if layout == "dense" else 1
    jg, jinv, _ = jgrid.build_grid(centres, CELL, dense_budget=budget)
    C = jg.keys.shape[0]
    slot_means, slot_valid = np.zeros((C, 3), np.float32), np.zeros(C, bool)
    slot_means[_np(jinv)], slot_valid[_np(jinv)] = means, valid
    g, cands = _grid_dict(jg), voxel_candidates(slot_means, slot_valid)
    events = {}
    for name, T in LATTICE_POSES.items():
        plain = model_matches(_transform(q, T), g, offsets, cands)
        res = jknn.nearest_voxel(jg, jnp.asarray(slot_means), jnp.asarray(slot_valid),
                                 jnp.asarray(_transform(q, T)), offsets)
        np.testing.assert_array_equal(plain[0], _np(res.idx))
        for lanes, sample_max in _lane_cases(layout, (SAMPLE_MAX, 16, 3)):
            idx, d2 = model_lane_matches(q, T, g, offsets, cands, lanes, sample_max, events)
            np.testing.assert_array_equal(idx, plain[0])
            np.testing.assert_array_equal(d2, plain[1])
    _assert_events(events, ["lane_tie"])
    if layout == "hashed":
        _assert_events(events, ["row_tie", "clipped_row", "empty_row", "key_first", "key_last",
                                "interval_end"])


# --- the model's linearizations against JAX's stats ---------------------------


@pytest.mark.parametrize("huber", [None, HUBER], ids=["plain", "huber"])
@pytest.mark.parametrize("kind", ["point", "plane_pt"])
def test_model_point_stats_match_jax(point_case, kind, huber):
    pts, normals, q, offsets, grids = point_case
    idx, d2 = (m[:-6] for m in grids["dense"][2]["pose"])
    src = q[:-6]  # the seeded queries (the constructed ones lie outside the scene)
    w = np.random.RandomState(5).rand(len(src)).astype(np.float32)
    w[::7] = 0.0
    model = model_stats(kind, src, w, POSE, idx, d2, pts, normals, huber)
    if kind == "point":
        cfg = JaxICPConfig(max_dist=MAX_DIST, huber_delta=huber)
        target = jcorr.build_point_corr(pts, cfg.corr, MAX_DIST)
        assert target.packed is None  # the grid method
        stats = jax_icp_stats(target, jnp.asarray(src), jnp.asarray(w), jnp.asarray(POSE), cfg)
    else:
        cfg = JaxPlaneICPConfig(max_dist=MAX_DIST, huber_delta=huber)
        target = JaxPlaneICPTarget(corr=jcorr.build_point_corr(pts, cfg.corr, MAX_DIST),
                                   normals=jnp.asarray(normals))
        stats = jax_plane_icp_stats(target, jnp.asarray(src), jnp.asarray(w),
                                    jnp.asarray(POSE), cfg)
    _assert_stats_close(model, stats)


@pytest.mark.parametrize("huber", [None, HUBER], ids=["plain", "huber"])
@pytest.mark.parametrize("kind", ["plane", "ndt"])
def test_model_voxel_stats_match_jax(hashed_scene, kind, huber):
    """On a hashed map of a seeded scene (JAX's build, ``dense_budget=1``):
    VPlaneICP's plane stats and NDT's icov form."""
    jvm, src, w, idx, d2 = hashed_scene
    means = _np(jvm.means)
    feats = _np(jvm.normals) if kind == "plane" else _np(jvm.icovs)
    model = model_stats(kind, src, w, POSE, idx, d2, means, feats, huber)
    if kind == "plane":
        cfg = JaxVPlaneConfig(voxel_size=CELL, max_dist=MAX_DIST, huber_delta=huber)
        stats = jax_vplane_stats(jvm, jnp.asarray(src), jnp.asarray(w), jnp.asarray(POSE), cfg)
    else:
        cfg = JaxNDTConfig(voxel_size=CELL, max_dist=MAX_DIST, huber_delta=huber)
        stats = jax_ndt_stats(jvm, jnp.asarray(src), jnp.asarray(w), jnp.asarray(POSE), cfg)
    _assert_stats_close(model, stats)


# --- the wrappers on CPU tensors ----------------------------------------------


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(8)
    pts = (rng.rand(2000, 3) * [10.0, 10.0, 3.0]).astype(np.float32)
    normals = rng.randn(2000, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    src = (pts[rng.choice(2000, 300, replace=False)] + rng.randn(300, 3) * 0.05).astype(np.float32)
    return torch.from_numpy(pts), torch.from_numpy(normals), torch.from_numpy(src)


def _plain_grid_path(target, src, w, T, cfg, normals):
    """The plain stats of a grid target as the solvers computed them before
    the kernel: ``match_points`` then ``ops/reduce.py``."""
    R, _ = makeRt(T)
    q = transform_points(T, src)
    m = match_points(target, q, cfg.corr, cfg.max_dist)
    wq = w * m.weight
    if normals is None:
        return packed_from_stats(reduce.point_stats(src, q, m.target, wq, R,
                                                    huber_delta=cfg.huber_delta))
    safe = m.point_idx.clamp(0, normals.shape[0] - 1)
    return packed_from_stats(reduce.plane_stats(src, q, m.target, normals[safe], wq, R,
                                                huber_delta=cfg.huber_delta))


def _plain_hashed_path(vm, src, w, T, cfg, kind):
    """The plain stats of a hashed map as the solvers computed them before
    the kernel: ``query_nearest_voxel`` then ``ops/reduce.py``."""
    R, _ = makeRt(T)
    q = transform_points(T, src)
    nn = query_nearest_voxel(vm, q, voxel_size=cfg.voxel_size, max_dist=cfg.max_dist)
    wq = w * (nn.dist < cfg.max_dist) * (nn.idx >= 0)
    safe = nn.idx.clamp(0, vm.means.shape[0] - 1).to(torch.int64)
    if kind == "plane":
        return packed_from_stats(reduce.plane_stats(src, q, vm.means[safe], vm.normals[safe], wq,
                                                    R, huber_delta=cfg.huber_delta))
    return packed_from_stats(reduce.ndt_stats(src, q, vm.means[safe], vm.icovs[safe], wq, R,
                                              huber_delta=cfg.huber_delta))


def _launches():
    return [k.launches for k in (ga.grid_point_stats, ga.grid_plane_point_stats,
                                 ga.hashed_plane_stats, ga.hashed_ndt_stats)]


@pytest.mark.parametrize("huber", [None, HUBER], ids=["plain", "huber"])
@pytest.mark.parametrize("kind", ["point", "plane_pt", "plane", "ndt"])
def test_wrappers_on_cpu_are_the_plain_path(scene, kind, huber):
    pts, normals, src = scene
    w = torch.from_numpy(np.random.RandomState(9).rand(len(src)).astype(np.float32))
    T = torch.from_numpy(POSE)
    before = _launches()
    if kind in ("point", "plane_pt"):
        cfg = ICPConfig(max_dist=MAX_DIST, huber_delta=huber)
        target = build_point_corr(pts, cfg.corr, MAX_DIST, device="cpu")
        nrm = normals if kind == "plane_pt" else None
        got = _point_fused.grid_point_stats_packed(target, src, w, T, cfg, nrm)
        want = _plain_grid_path(target, src, w, T, cfg, nrm)
    else:
        cfg = (VPlaneICPConfig if kind == "plane" else NDTConfig)(
            voxel_size=CELL, max_dist=MAX_DIST, huber_delta=huber)
        with pytest.MonkeyPatch.context() as mp:
            from point_cloud_registration_tpu_torch.ops import voxelize

            mp.setattr(voxelize, "DENSE_CELL_BUDGET", 1)
            vm = build_voxel_map(pts, CELL, min_points=3, with_icov=kind == "ndt", device="cpu")
        assert vm.hashed
        got = _fused.hashed_voxel_stats_packed(vm, src, w, T, cfg, kind)
        want = _plain_hashed_path(vm, src, w, T, cfg, kind)
    assert torch.equal(got, want) and float(got[28]) > 1
    assert _launches() == before


def test_wrappers_raise_on_operands_the_kernel_cannot_read(scene):
    pts, normals, src = scene
    grid, _, buckets = tgrid.build_grid(pts, CELL, with_buckets=True, device="cpu")
    rows = tgrid.bucket_rows(pts, buckets)
    table = ga.point_table(pts, buckets, CAP, rows=rows)
    w, eye, zero = torch.ones(len(src)), torch.eye(3), torch.zeros(3)
    offsets = tgrid.search_offsets(MAX_DIST, CELL)
    ok = ga.grid_point_stats(grid, table, src, w, eye, zero, offsets, MAX_DIST)
    assert ok.shape == (29,)
    bad = {
        "src dtype": dict(src=src.double()),
        "w shape": dict(w=w[:-1]),
        "src contiguity": dict(src=torch.cat([src, src], 1)[:, :3]),
        "points dtype": dict(table=table._replace(points=pts.double())),
        "perm dtype": dict(table=table._replace(buckets=buckets._replace(
            perm=buckets.perm.long()))),
        "keys shape": dict(grid=grid._replace(keys=grid.keys[:-1])),
        "table kind": dict(table=ga.point_table(pts, buckets, CAP, normals, rows=rows)),
        "offsets shape": dict(offsets=offsets[:, :2]),
    }
    for case, kw in bad.items():
        args = dict(grid=grid, table=table, src=src, w=w, R=eye, t=zero, offsets=offsets,
                    max_dist=MAX_DIST) | kw
        with pytest.raises(ValueError):
            ga.grid_point_stats(**args)
            pytest.fail(f"no error for {case}")
    with pytest.raises(ValueError):  # a voxel kind without valid flags
        ga.hashed_plane_stats(grid, ga.point_table(pts, buckets, CAP, normals, rows=rows), src,
                              w, eye, zero, offsets, MAX_DIST)

