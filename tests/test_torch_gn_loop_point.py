"""The point loop's plain version and the point and grid loops' launch
geometry on the CPU (``point_cloud_registration_tpu_torch/ops/kernels/
gn_loop.py``: on the card one cooperative launch of ``csrc/point_loop.cu``
runs the whole Gauss-Newton loop of an ICP or PlaneICP align on a packed
target, and one of ``csrc/grid_loop.cu`` that of ICP or PlaneICP on a
small target's grid and of VPlaneICP or NDT on a hashed map). The checks
of each path are this file's functions; test_torch_gn_loop_grid.py runs
them on the grid and hashed paths.

``point_loop_reference`` is held to the JAX package's ``fused_point_align``
(its Pallas kernel in interpret mode, as the JAX package's own tests run
it on the CPU); ``grid_loop_reference`` to ``icp_align``,
``plane_icp_align``, ``vplane_align`` and ``ndt_align`` (XLA code, no
Pallas kernel); both to the host loop (``core.gn.gauss_newton``) over the
same plain stats, also at the loop's edges (a break on the first step, a
singular H, ``max_iter`` 0 and 1, an empty scan); ``loop_grid`` to the
stats launches' block ids at the point and grid kernels' geometries.

Tolerances: T within 1e-3 of JAX's (the bound of test_torch_icp.py,
test_torch_icp_grid.py and test_torch_voxel_sparse.py: each package builds
its own target, equal to float32 rounding), with equal iterations,
``converged`` and ``solver_failed``; against the host loop every field of
the state equal bit for bit (the same operations in the same
order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_cloud_registration_tpu.core.config import CorrespondenceConfig as JaxCorr
from point_cloud_registration_tpu.core.config import ICPConfig as JaxICPConfig
from point_cloud_registration_tpu.core.config import NDTConfig as JaxNDTConfig
from point_cloud_registration_tpu.core.config import PlaneICPConfig as JaxPlaneICPConfig
from point_cloud_registration_tpu.core.config import VPlaneICPConfig as JaxVPlaneConfig
from point_cloud_registration_tpu.models import _point_fused as jpoint_fused
from point_cloud_registration_tpu.models.base import pad_points as jax_pad_points
from point_cloud_registration_tpu.models.icp import build_icp_target as jax_build_icp_target
from point_cloud_registration_tpu.models.icp import icp_align as jax_icp_align
from point_cloud_registration_tpu.models.ndt import ndt_align as jax_ndt_align
from point_cloud_registration_tpu.models.plane_icp import (
    build_plane_icp_target as jax_build_plane_icp_target,
)
from point_cloud_registration_tpu.models.plane_icp import plane_icp_align as jax_plane_icp_align
from point_cloud_registration_tpu.models.voxelized_plane_icp import vplane_align as jax_vplane_align
from point_cloud_registration_tpu.ops import hashgrid as jgrid
from point_cloud_registration_tpu.ops import voxelize as jvox
from point_cloud_registration_tpu.ops.pallas.point_align import point_fused_spec
import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.core.config import (
    CorrespondenceConfig,
    ICPConfig,
    NDTConfig,
    PlaneICPConfig,
    VPlaneICPConfig,
)
from point_cloud_registration_tpu_torch.models import _fused, _point_fused, pad_points
from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius
from point_cloud_registration_tpu_torch.models.icp import build_icp_target
from point_cloud_registration_tpu_torch.models.plane_icp import build_plane_icp_target
from point_cloud_registration_tpu_torch.ops import voxelize
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl
from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga
import host_loop
from oracles import make_scan, make_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PARAMS = dict(max_iter=30, max_dist=2.0, tol=1e-3)
TOL_JAX = 1e-3
# a scan of the scene 6-dof off (test_torch_vplane_icp.py's small offset),
# of few points: the JAX package's Pallas kernel runs in interpret mode
OFFSET = [0.02, -0.02, 0.04, 0.008, -0.01, 0.012]
N_SCAN = 500
# the six single-problem paths that run the point and grid loops: the packed
# ones are this file's, the grid and hashed ones test_torch_gn_loop_grid.py's
ALL_PATHS = ["packed_point", "packed_plane_pt", "grid_point", "grid_plane_pt", "hashed_plane",
             "hashed_ndt"]
PATHS = ALL_PATHS[:2]
EDGES = ["break_first_step", "singular_H", "max_iter_0", "max_iter_1", "empty_scan"]


@pytest.fixture(scope="module")
def scene():
    pts = make_scene(np.random.RandomState(5)).astype(np.float32)
    scan = make_scan(np.random.RandomState(8), pts, np.array(OFFSET), n_points=N_SCAN)[0]
    return pts, scan


@pytest.fixture(scope="module")
def normals(scene):
    """The port's normals of the scene, given to both packages' PlaneICP."""
    return np.asarray(pt.estimate_normals(scene[0], device="cpu"), np.float32)


def _port_target(path, pts, normals):
    """``(kind, target, cfg, align(src, w, T0, cfg) -> (T, diag), host(src,
    w, T0, cfg) -> (T, diag))`` of a path on the port's CPU target: its
    align and the same align through the host loop (``tests/host_loop.py``)."""
    where, kind = path.split("_", 1)
    if where == "hashed":
        cls = VPlaneICPConfig if kind == "plane" else NDTConfig
        cfg = cls(voxel_size=1.0, **PARAMS)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(voxelize, "DENSE_CELL_BUDGET", 1)
            vm = voxelize.build_voxel_map(pts, 1.0, min_points=cfg.min_points,
                                          with_icov=kind == "ndt", device="cpu")
        assert vm.hashed
        return (kind, vm, cfg,
                lambda src, w, T0, c: _fused.fused_voxel_align(vm, src, w, T0, c, kind),
                lambda src, w, T0, c: host_loop.voxel_align(vm, src, w, T0, c, kind))
    corr = CorrespondenceConfig(method=where)
    if kind == "point":
        cfg = ICPConfig(corr=corr, **PARAMS)
        target, tnormals = build_icp_target(pts, cfg, device="cpu"), None
    else:
        cfg = PlaneICPConfig(corr=corr, **PARAMS)
        tg = build_plane_icp_target(pts, cfg, normals=torch.from_numpy(normals), device="cpu")
        target, tnormals = tg.corr, tg.normals
    assert (target.packed is None) == (where == "grid")
    return (kind, target, cfg,
            lambda src, w, T0, c: _point_fused.fused_point_align(target, src, w, T0, c, kind,
                                                                 tnormals),
            lambda src, w, T0, c: host_loop.point_align(target, src, w, T0, c, kind, tnormals))


@pytest.fixture(scope="module")
def targets(scene, normals):
    return {path: _port_target(path, scene[0], normals) for path in PATHS}


def _reference_state(path, target, cfg, src, w, state, normals=None):
    """The plain loop of ``path`` on ``state``."""
    where, kind = path.split("_", 1)
    if where == "packed":
        gl.point_loop_reference(kind, target.packed, target.proxy, src, w, state, cfg.max_dist,
                                proxy_radius(cfg.corr, cfg.max_dist), cfg.huber_delta, cfg.tol,
                                cfg.max_iter)
    else:
        grid, table, offsets = (_fused.hashed_operands(target, cfg, kind) if where == "hashed"
                                else _point_fused.grid_operands(target, cfg, normals))
        gl.grid_loop_reference(kind, grid, table, src, w, offsets, state, cfg.max_dist,
                               cfg.huber_delta, cfg.tol, cfg.max_iter)
    return state


def _jax_align(path, pts, scan, normals):
    """``(T, iterations, converged, solver_failed)`` of the JAX package's
    align of ``path`` from T = I."""
    where, kind = path.split("_", 1)
    src, w = jax_pad_points(scan)
    eye = jnp.eye(4, dtype=jnp.float32)
    if where == "hashed":
        jg, jinv, _ = jgrid.build_grid(pts, 1.0, dense_budget=1)
        if kind == "plane":
            cfg = JaxVPlaneConfig(voxel_size=1.0, **PARAMS)
            jvm = jvox._finish_voxel_map(jnp.asarray(pts), jg, jinv, min_points=cfg.min_points,
                                         with_icov=False)
            res = jax_vplane_align(jvm, src, w, eye, cfg)
        else:
            cfg = JaxNDTConfig(voxel_size=1.0, **PARAMS)
            jvm = jvox._finish_voxel_map(jnp.asarray(pts), jg, jinv, min_points=cfg.min_points,
                                         with_icov=True)
            res = jax_ndt_align(jvm, src, w, eye, cfg)
        assert jvm.grid.dense is None
        T, d = res.T, res.diagnostics
    elif kind == "point":
        cfg = JaxICPConfig(corr=JaxCorr(method=where), **PARAMS)
        jt = jax_build_icp_target(pts, cfg)
        if where == "packed":
            spec = point_fused_spec(jt.packed, "point", cfg.max_dist)
            T, d = jpoint_fused.fused_point_align(jt, None, src, w, eye, cfg, spec,
                                                  interpret=True)
        else:
            res = jax_icp_align(jt, src, w, eye, cfg)
            T, d = res.T, res.diagnostics
    else:
        cfg = JaxPlaneICPConfig(corr=JaxCorr(method=where), **PARAMS)
        jt = jax_build_plane_icp_target(pts, cfg, normals=jnp.asarray(normals))
        if where == "packed":
            spec = point_fused_spec(jt.corr.packed, "plane_pt", cfg.max_dist)
            T, d = jpoint_fused.fused_point_align(jt.corr, jt.normals, src, w, eye, cfg, spec,
                                                  interpret=True)
        else:
            res = jax_plane_icp_align(jt, src, w, eye, cfg)
            T, d = res.T, res.diagnostics
    return np.asarray(T), int(d.iterations), bool(d.converged), bool(d.solver_failed)


def check_matches_jax(scene, normals, targets, path):
    """The plain loop of ``path`` from T = I against the JAX package's align
    of the same path on the same seeded scene and scan."""
    pts, scan = scene
    T_j, it_j, conv_j, failed_j = _jax_align(path, pts, scan, normals)
    _, target, cfg, _, _ = targets[path]
    src, w = pad_points(scan, device="cpu")
    tn = torch.from_numpy(normals) if path == "grid_plane_pt" else None
    state = _reference_state(path, target, cfg, src, w,
                             gn.new_state(torch.eye(4)[None], cfg.max_iter, "cpu"), tn)
    np.testing.assert_allclose(gn.transforms_of(state.poses)[0].numpy(), T_j, rtol=0,
                               atol=TOL_JAX)
    assert (int(state.it[0]), bool(state.converged[0]), bool(state.failed[0])) == (
        it_j, conv_j, failed_j)
    assert conv_j and not failed_j and it_j >= 2


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _both_loops(targets, path, src, w, T0, **changes):
    """The align through its loop (the plain version here) and the host
    loop over the same stats: every field equal bit for bit (NaN payloads
    too); returns the first."""
    _, _, cfg, align, host = targets[path]
    cfg = dataclasses.replace(cfg, **changes)
    T, d = align(src, w, T0, cfg)
    T2, d2 = host(src, w, T0, cfg)
    assert torch.equal(_bits(T), _bits(T2))
    assert (d.iterations, d.converged, d.solver_failed) == (d2.iterations, d2.converged,
                                                            d2.solver_failed)
    for got, want in ((d.e2_history, d2.e2_history), (d.dx_norm_history, d2.dx_norm_history),
                      (d.inlier_history, d2.inlier_history),
                      (torch.tensor(d.final_e2), torch.tensor(d2.final_e2))):
        assert torch.equal(_bits(got), _bits(want))
    return T, d


def check_host(scene, targets, path):
    """A whole align from T = I (``chip_smoke.py`` phase 2d adds a
    perturbed start on the card): the pose, counters, flags and histories
    of the plain loop bit for bit the host loop's."""
    src, w = pad_points(scene[1], device="cpu")
    T, d = _both_loops(targets, path, src, w, torch.eye(4))
    assert d.converged and d.iterations >= 2


def check_edge(scene, targets, path, edge):
    """A tolerance above the first step (converged after one iteration, T
    kept); a scan 100 m away (no correspondence: H = 0, failed after one
    iteration, T kept); ``max_iter`` 0 (the loop is not called) and 1
    (done by the count, T updated); an empty scan (zero stats: failed at
    once): each as the host loop ends."""
    scan = scene[1] + (np.float32([0.0, 0.0, 100.0]) if edge == "singular_H" else 0)
    src, w = pad_points(scan[:0] if edge == "empty_scan" else scan, device="cpu")
    changes = {"break_first_step": dict(tol=10.0), "max_iter_0": dict(max_iter=0),
               "max_iter_1": dict(max_iter=1)}.get(edge, {})
    T, d = _both_loops(targets, path, src, w, torch.eye(4), **changes)
    want = {"break_first_step": (1, True, False), "singular_H": (1, False, True),
            "max_iter_0": (0, False, False), "max_iter_1": (1, False, False),
            "empty_scan": (1, False, True)}[edge]
    assert (d.iterations, d.converged, d.solver_failed) == want
    assert torch.equal(T, torch.eye(4)) == (edge != "max_iter_1")


@pytest.mark.parametrize("path", PATHS)
def test_reference_matches_jax(scene, normals, targets, path):
    check_matches_jax(scene, normals, targets, path)


@pytest.mark.parametrize("path", PATHS)
def test_reference_equals_the_host_loop(scene, targets, path):
    check_host(scene, targets, path)


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("path", PATHS)
def test_edges_equal_the_host_loop(scene, targets, path, edge):
    check_edge(scene, targets, path, edge)


@pytest.mark.parametrize("n", [1, 8192, 106_496, 131_073])
@pytest.mark.parametrize("geometry", [
    (128, fa.MAX_BLOCKS, 6),  # the packed-grid kernel: 128 queries a block, six CTAs an SM
    (8, ga.MAX_BLOCKS, 3),  # the grid kinds: a warp a query, 256 threads, three CTAs an SM
    (128, ga.MAX_BLOCKS, 2),  # the hashed kinds: two lanes a query, two CTAs an SM
])
def test_loop_grid_covers_every_block_id_once(n, geometry):
    """The stats launch's block ids (min(ceil(n / block), cap)), each taken
    by exactly one CTA of the persistent grid, on an H100's 132 SMs and on
    a card of two SMs at one CTA each."""
    block, cap, per_sm = geometry
    want = min(-(-n // block), cap)
    for sms, resident in ((132, per_sm), (2, 1)):
        grid, virtual = gl.loop_grid(n, block, sms, resident, cap)
        assert virtual == want and grid == min(want, sms * resident)
        ids = sorted(v for c in range(grid) for v in range(c, virtual, grid))
        assert ids == list(range(virtual))


def test_loops_refuse_what_they_cannot_run(scene, targets):
    src, w = pad_points(scene[1], device="cpu")
    _, target, cfg, _, _ = targets["packed_point"]
    args = (target.packed, target.proxy, src, w)
    settings = (cfg.max_dist, proxy_radius(cfg.corr, cfg.max_dist), cfg.huber_delta, cfg.tol,
                cfg.max_iter)
    two = gn.new_state(torch.eye(4).expand(2, 4, 4), cfg.max_iter, "cpu")
    with pytest.raises(ValueError, match="one problem"):
        gl.point_loop("point", *args, two, *settings)
    with pytest.raises(ValueError, match="unknown kind"):
        gl.point_loop("plane", *args, two, *settings)
    _, vm, vcfg, _, _ = _port_target("hashed_plane", scene[0], None)
    grid, table, offsets = _fused.hashed_operands(vm, vcfg, "plane")
    one = gn.new_state(torch.eye(4)[None], vcfg.max_iter, "cpu")
    with pytest.raises(ValueError, match="unknown kind"):
        gl.grid_loop("fused", grid, table, src, w, offsets, one, vcfg.max_dist, None, 1e-3, 30)
    # neither the CPU nor a card: no plain fallback
    meta = (src.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        gl.point_looper("point", target.packed, target.proxy, *meta, one, *settings)
    with pytest.raises(ValueError, match="unsupported device"):
        gl.grid_looper("plane", grid, table, *meta, offsets, one, vcfg.max_dist, None, 1e-3, 30)
