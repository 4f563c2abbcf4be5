"""The loop kernel's plain version and launch geometry on the CPU
(``point_cloud_registration_tpu_torch/ops/kernels/gn_loop.py``; on the card
one cooperative launch of ``csrc/gn_loop.cu`` runs the whole Gauss-Newton
loop of a VPlaneICP or NDT align on a dense map).

``fused_loop_reference`` is held to the JAX package's ``fused_voxel_align``
(the Pallas kernel in interpret mode, as the JAX package's own tests run it
on the CPU) and to the port's two-launch resident loop over the same plain
stats; ``loop_grid`` to the stats launch's block ids; a NumPy model of the
kernel's fixed-order row sum (in double precision, rounded once) to a
float64 sum; every single-problem align of the four solvers to one call of
its loop (the point and grid loops' own checks are in
test_torch_gn_loop_point.py and test_torch_gn_loop_grid.py); each stats
kernel's source and its loop's to one shared body.

Tolerances: T within 1e-3 of JAX's (the bound of test_torch_vplane_icp.py
and test_torch_ndt.py: the port builds its own map, so the maps agree to
float32 rounding), with equal iterations, ``converged`` and
``solver_failed``; against the two-launch loop every field of the state
equal bit for bit (the same operations in the same order); the row-sum
model equal to the float64 sum of the rows rounded to float32 (its lanes
and the sum differ by at most n float64 epsilons of the sum of |rows|, far
below a float32 rounding step of these sums), and bit-equal whatever the
CTA count.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_cloud_registration_tpu.core.config import NDTConfig as JaxNDTConfig
from point_cloud_registration_tpu.core.config import VPlaneICPConfig as JaxVPlaneConfig
from point_cloud_registration_tpu.models._fused import fused_voxel_align as jax_fused_voxel_align
from point_cloud_registration_tpu.models.ndt import build_ndt_target as jax_build_ndt_target
from point_cloud_registration_tpu.ops.pallas.fused_align import voxel_fused_spec
from point_cloud_registration_tpu.ops.voxelize import build_voxel_map as jax_build_voxel_map
import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.models import _fused, pad_points
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl
from point_cloud_registration_tpu_torch.ops import voxelize
from oracles import make_scan, make_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PARAMS = dict(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)
TOL_JAX = 1e-3
CSRC = Path(gl.__file__).resolve().parents[2] / "csrc"
KINDS = {"plane": pt.VPlaneICP, "ndt": pt.NDT}
# (scan seed, 6-dof offset): the scans of test_torch_vplane_icp.py
SCANS = {
    "small_offset": (7, [0.02, -0.02, 0.04, 0.008, -0.01, 0.012]),
    "large_offset": (8, [0.1, -0.08, 0.2, 0.02, -0.02, 0.03]),
}


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.RandomState(5))


@pytest.fixture(scope="module")
def targets(scene):
    """The port's dense targets of both kinds on the CPU."""
    out = {}
    for kind, cls in KINDS.items():
        s = cls(**PARAMS, device="cpu")
        s.set_target(scene)
        out[kind] = s
    return out


def _scan(scene, name):
    seed, dx = SCANS[name]
    return make_scan(np.random.RandomState(seed), scene, np.array(dx))[0]


def _operands(solver, scan):
    vm, cfg = solver._target, solver.cfg
    src, w = pad_points(scan, device="cpu")
    kind = "plane" if isinstance(solver, pt.VPlaneICP) else "ndt"
    return ((kind, vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src, w),
            dict(max_dist=cfg.max_dist, huber_delta=cfg.huber_delta, tol=cfg.tol,
                 max_iter=cfg.max_iter))


def _reference_state(solver, scan, init_T=None, **changes):
    operands, settings = _operands(solver, scan)
    settings.update(changes)
    init = torch.eye(4) if init_T is None else init_T
    state = gn.new_state(init[None], settings["max_iter"], "cpu")
    gl.fused_loop_reference(*operands, state, **settings)
    return state


def _jax_fused_align(kind, scene, scan):
    if kind == "plane":
        cfg = JaxVPlaneConfig(**PARAMS)
        jm = jax_build_voxel_map(scene, 1.0, min_points=10, rich="normals")
    else:
        cfg = JaxNDTConfig(**PARAMS)
        jm = jax_build_ndt_target(scene, cfg)
    spec = voxel_fused_spec(jm, kind, max_dist=cfg.max_dist)
    assert spec is not None
    w = jnp.ones((len(scan),), jnp.float32)
    T, d = jax_fused_voxel_align(jm, scan, w, jnp.eye(4, dtype=jnp.float32), cfg, spec,
                                 interpret=True)
    return np.asarray(T), int(d.iterations), bool(d.converged), bool(d.solver_failed)


@pytest.mark.parametrize("scan_name", sorted(SCANS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_reference_matches_jax_fused_align(scene, targets, kind, scan_name):
    scan = _scan(scene, scan_name)
    T_j, it_j, conv_j, failed_j = _jax_fused_align(kind, scene, scan)
    state = _reference_state(targets[kind], scan)
    np.testing.assert_allclose(gn.transforms_of(state.poses)[0].numpy(), T_j, rtol=0,
                               atol=TOL_JAX)
    assert (int(state.it[0]), bool(state.converged[0]), bool(state.failed[0])) == (
        it_j, conv_j, failed_j)
    assert conv_j and not failed_j


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_reference_equals_the_two_launch_loop(scene, targets, kind):
    """The plain loop against ``gauss_newton_device`` (chunks of GN_CHUNK,
    the plain stats and ``gn_step_reference``) on the same operands: the
    pose, counters, flags and histories bit for bit."""
    solver = targets[kind]
    scan = _scan(scene, "large_offset")
    state = _reference_state(solver, scan)
    operands, settings = _operands(solver, scan)
    stats_fn = _fused.fused_voxel_stats_resident(solver._target, operands[5], operands[6],
                                                 solver.cfg, kind)
    T, d = gn.gauss_newton_device(stats_fn, torch.eye(4), settings["max_iter"],
                                  settings["tol"], "cpu")
    assert int(state.it[0]) == d.iterations >= 2
    assert torch.equal(gn.transforms_of(state.poses)[0], T)
    assert (bool(state.converged[0]), bool(state.failed[0])) == (d.converged, d.solver_failed)
    for got, want in ((state.e2[0], d.e2_history), (state.dx_norm[0], d.dx_norm_history),
                      (state.inliers[0], d.inlier_history)):
        assert torch.equal(got, want)
    assert float(state.final_e2[0]) == d.final_e2


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_break_on_the_first_step(scene, targets, kind):
    """A tolerance above the first step: converged after one iteration, T
    not updated on the breaking step, its histories written."""
    state = _reference_state(targets[kind], _scan(scene, "small_offset"), tol=10.0)
    assert (int(state.it[0]), bool(state.converged[0]), bool(state.failed[0]),
            bool(state.done[0])) == (1, True, False, True)
    assert torch.equal(gn.transforms_of(state.poses)[0], torch.eye(4))
    assert 0 < float(state.dx_norm[0, 0]) < 10.0 and float(state.e2[0, 0]) > 0
    assert int(state.inliers[0, 0]) > 0 and float(state.e2[0, 1]) == 0.0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_singular_H_fails_at_once(scene, targets, kind):
    """A scan 100 m away has no correspondence: H = 0, a non-finite step,
    ``solver_failed`` after one iteration, T kept."""
    scan = _scan(scene, "small_offset") + np.float32([0.0, 0.0, 100.0])
    state = _reference_state(targets[kind], scan)
    assert (int(state.it[0]), bool(state.converged[0]), bool(state.failed[0])) == (1, False, True)
    assert not np.isfinite(float(state.dx_norm[0, 0])) and int(state.inliers[0, 0]) == 0
    assert torch.equal(gn.transforms_of(state.poses)[0], torch.eye(4))


@pytest.mark.parametrize("max_iter", [0, 1])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_max_iter_zero_and_one(scene, targets, kind, max_iter):
    """``fused_voxel_align`` through the loop: no iteration at max_iter 0
    (the loop is not called), one at max_iter 1 (done by the count, T
    updated); equal to the two-launch loop's result."""
    solver = targets[kind]
    scan = _scan(scene, "large_offset")
    src, w = pad_points(scan, device="cpu")
    cfg = type(solver.cfg)(**{**PARAMS, "max_iter": max_iter})
    T, d = _fused.fused_voxel_align(solver._target, src, w, torch.eye(4), cfg, kind)
    stats_fn = _fused.fused_voxel_stats_resident(solver._target, src, w, cfg, kind)
    T2, d2 = gn.gauss_newton_device(stats_fn, torch.eye(4), max_iter, cfg.tol, "cpu")
    assert d.iterations == d2.iterations == max_iter
    assert torch.equal(T, T2) and d.converged == d2.converged is False
    assert torch.equal(d.dx_norm_history, d2.dx_norm_history)
    assert torch.equal(T, torch.eye(4)) == (max_iter == 0)


def test_dense_aligns_run_one_loop_and_hashed_ones_do_not(monkeypatch, scene):
    """Every single-problem align calls a loop (here its plain version)
    once an align and counts no launch on the CPU: VPlaneICP and NDT the
    fused loop on a dense map and the grid loop on a hashed one (they no
    longer keep the two-launch loop there); ICP and PlaneICP the point loop
    on a packed target and the grid loop on a grid target. Two iterations
    of a 300-point scan: the calls, not the result, are held here."""
    calls = []
    for name in ("fused_loop_reference", "point_loop_reference", "grid_loop_reference"):
        reference = getattr(gl, name)
        monkeypatch.setattr(gl, name, lambda *a, _name=name, _ref=reference, **k:
                            calls.append((_name.split("_")[0], a[0])) or _ref(*a, **k))
    scan = _scan(scene, "small_offset")[:300]
    before = (gl.fused_loop.launches, gl.point_loop.launches, gl.grid_loop.launches)
    short = {**PARAMS, "max_iter": 2}
    up = np.tile(np.float32([0.0, 0.0, 1.0]), (len(scene), 1))  # any normals: calls only

    def align_voxels():
        for cls in (pt.VPlaneICP, pt.NDT):
            s = cls(**short, device="cpu")
            s.set_target(scene)
            s.align(scan)

    align_voxels()
    for cls, corr in ((pt.ICP, "packed"), (pt.ICP, "grid"), (pt.PlaneICP, "packed"),
                      (pt.PlaneICP, "grid")):
        s = cls(**{k: v for k, v in short.items() if k != "voxel_size"}, device="cpu")
        s.cfg = dataclasses.replace(s.cfg, corr=pt.CorrespondenceConfig(method=corr))
        s.set_target(scene) if cls is pt.ICP else s.set_target(scene, norm=up)
        s.align(scan)
    monkeypatch.setattr(voxelize, "DENSE_CELL_BUDGET", 1)  # hashed maps at this size
    align_voxels()
    assert calls == [("fused", "plane"), ("fused", "ndt"), ("point", "point"), ("grid", "point"),
                     ("point", "plane_pt"), ("grid", "plane_pt"), ("grid", "plane"),
                     ("grid", "ndt")]
    assert (gl.fused_loop.launches, gl.point_loop.launches, gl.grid_loop.launches) == before


def test_wrapper_refuses_what_it_cannot_run(scene, targets):
    operands, settings = _operands(targets["plane"], _scan(scene, "small_offset"))
    two = gn.new_state(torch.eye(4).expand(2, 4, 4), settings["max_iter"], "cpu")
    with pytest.raises(ValueError, match="one problem"):
        gl.fused_loop(*operands, two, **settings)
    short = gn.new_state(torch.eye(4)[None], 5, "cpu")
    with pytest.raises(ValueError, match="one problem"):
        gl.fused_loop(*operands, short, **settings)
    with pytest.raises(ValueError, match="unknown kind"):
        gl.fused_loop("point", *operands[1:], short, **settings)
    # neither the CPU nor a card: no plain fallback
    meta = operands[:5] + (operands[5].to("meta"), operands[6].to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        gl.fused_looper(*meta, gn.new_state(torch.eye(4)[None], 30, "cpu"), **settings)


@pytest.mark.parametrize("n", [1, 8192, 106_496, 262_144])
def test_loop_grid_covers_every_block_id_once(n):
    """The stats launch's block ids (min(ceil(n / 256), MAX_BLOCKS)), each
    taken by exactly one CTA of the persistent grid, on an H100's 132 SMs at
    three CTAs an SM and on a card of two SMs at one."""
    block = 256
    want = min(-(-n // block), fa.MAX_BLOCKS)
    for sms, per_sm in ((132, 3), (2, 1)):
        grid, virtual = gl.loop_grid(n, block, sms, per_sm)
        assert virtual == want and grid == min(want, sms * per_sm)
        ids = sorted(v for c in range(grid) for v in range(c, virtual, grid))
        assert ids == list(range(virtual))


def test_loop_grid_without_a_resident_cta_raises():
    with pytest.raises(RuntimeError, match="no CTA"):
        gl.loop_grid(100_000, 256, 132, 0)


def _sum_lanes() -> int:
    text = (CSRC / "gn_loop.cuh").read_text()
    lanes = int(re.search(r"constexpr int kSumLanes = (\d+);", text).group(1))
    assert f"static_assert(kSumLanes == {lanes}" in text
    return lanes


def _row_sum_model(rows: np.ndarray) -> np.ndarray:
    """gn_loop.cu's sum_rows in NumPy: lane j of a column adds the float32
    rows j, j + L, ... in turn from 0 in float64, then the eight lanes in
    the fixed tree ((l0 + l1) + (l2 + l3)) + ((l4 + l5) + (l6 + l7)), and the
    sum is rounded once to float32."""
    lanes = _sum_lanes()
    rows = rows.astype(np.float32)
    acc = np.zeros((lanes, rows.shape[1]), np.float64)
    for j in range(lanes):
        for r in range(j, rows.shape[0], lanes):
            acc[j] = acc[j] + rows[r].astype(np.float64)
    l = acc
    return (((l[0] + l[1]) + (l[2] + l[3])) + ((l[4] + l[5]) + (l[6] + l[7]))).astype(np.float32)


def _phase_a(rows: np.ndarray, grid: int) -> np.ndarray:
    """The partials buffer as the CTAs of a grid of ``grid`` write it: CTA c
    its block ids c, c + grid, ..., the CTAs in reverse order."""
    buf = np.full_like(rows, np.nan)
    for c in reversed(range(grid)):
        for v in range(c, rows.shape[0], grid):
            buf[v] = rows[v]
    return buf


@pytest.mark.parametrize("n_rows", [1, 7, 416])
def test_row_sum_model_is_the_rounded_sum(n_rows):
    """The float64 sum of the rows, in any order, rounded once to float32:
    rows of six decades, summed to cancel as the rows of g do near a
    solution."""
    rng = np.random.RandomState(n_rows)
    rows = (rng.randn(n_rows, fa.STATS_WIDTH) * 10.0 ** rng.randint(-3, 4, (1, fa.STATS_WIDTH))
            ).astype(np.float32)
    rows[-1] -= rows.sum(axis=0, dtype=np.float64).astype(np.float32) * np.float32(0.999)
    exact = rows.astype(np.float64).sum(axis=0)
    got = _row_sum_model(rows)
    assert got.tobytes() == exact.astype(np.float32).tobytes()
    assert got.tobytes() == rows[::-1].astype(np.float64).sum(axis=0).astype(np.float32).tobytes()


def test_row_sum_does_not_depend_on_the_cta_count():
    rng = np.random.RandomState(3)
    rows = rng.randn(416, fa.STATS_WIDTH).astype(np.float32) * 1e3
    sums = [_row_sum_model(_phase_a(rows, grid)) for grid in (1, 7, 132, 396, 416)]
    assert all(s.tobytes() == sums[0].tobytes() for s in sums)


def test_kernels_share_the_stats_and_update_bodies():
    """Each stats kernel and its loop kernel run one body: fused_align.cu
    and gn_loop.cu fused_stats.cuh's per-point work, point_align.cu and
    point_loop.cu point_stats.cuh's, grid_align.cu and grid_loop.cu
    grid_stats.cuh's; gn_step.cu and the loop kernel (gn_loop.cuh, which
    the three loops include) gn_step.cuh's update: no body is copied into a
    kernel's source."""
    sources = {p.name: p.read_text() for p in sorted(CSRC.iterdir())}
    for stats, loop, header, body, inner in (
            ("fused_align.cu", "gn_loop.cu", "fused_stats.cuh", "fused_block_stats",
             "nearest_valid_row("),
            ("point_align.cu", "point_loop.cu", "point_stats.cuh", "point_block_stats",
             "scan_row<"),
            ("grid_align.cu", "grid_loop.cu", "grid_stats.cuh", "grid_block_stats",
             "group_merge<")):
        for name in (stats, loop):
            assert f'#include "{header}"' in sources[name]
            assert f"{body}<kKind>(" in sources[name]
            assert inner not in sources[name]
        assert f"__device__ __forceinline__ void {body}(" in sources[header]
        assert '#include "gn_loop.cuh"' in sources[loop] and "pcr::launch_loop(" in sources[loop]
        assert "__global__" not in sources[loop]
    for name in ("gn_step.cu", "gn_loop.cuh"):
        assert '#include "gn_step.cuh"' in sources[name]
        assert "gn_update(" in sources[name]
        assert "solve_6x6(" not in sources[name]
    assert "__device__ __forceinline__ void gn_update(" in sources["gn_step.cuh"]
