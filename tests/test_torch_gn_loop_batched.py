"""The batched loop kernels of the port (``ops/kernels/gn_loop``:
``fused_loop_batched`` for VPlaneICP's "plane" and NDT's "ndt" on a dense
map, ``point_loop_batched`` for ICP's "point" and PlaneICP's "plane_pt" on a
packed target; the counterpart of the JAX ``batched_gauss_newton``
while_loop, ``models/_fused.py:288-355``), FastVPlaneICP's phase 2 in one
loop launch, and the launchers' device (every launcher binds and launches
on its tensors' card).

On the CPU each batched loop runs its plain version
(``batched_loop_reference``: the batched plain stats, then
``gn_step_reference``, until every problem is done). It leaves the state of
B problems bit-equal to the batched host loop's (``core.gn.batched_gauss_newton``
over the same batched stats) and each problem's words bit-equal to that
scan's single-problem plain loop; a problem that is done is left as it was
while the others iterate. ``chip_smoke.py`` (phases 13-14) holds the card's
kernel to the host loop over the batched stats kernel on the card. The
batched aligns against the JAX package's batched functions in interpret
mode (T within 1e-5, equal iterations) are ``tests/test_torch_batched.py``'s
interpret tests, and FastVPlaneICP's ``"always"`` against the JAX class
(6e-2) and phase 2 against the JAX ``_phase2_align`` (1e-4) are
``tests/test_torch_fast_vpicp.py``'s: those tests run these loops. Here
the scenes are small (``oracles.make_scene``, scans of 200 points, B <= 3)
and no JAX function runs.

The device test runs each launcher's CUDA branch on the CPU: tensors that
report ``cuda:1`` (a ``torch.Tensor`` subclass whose factory calls a
``TorchFunctionMode`` keeps on the host), ``torch.cuda.device`` replaced by
a recorder and each kernel library by entries that record the card current
when they are called.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree

import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.core.config import (
    CorrespondenceConfig,
    ICPConfig,
    NDTConfig,
    PlaneICPConfig,
    VPlaneICPConfig,
)
from point_cloud_registration_tpu_torch.models import _fused, _point_fused
from point_cloud_registration_tpu_torch.models import fast_vplane_icp as fvp
from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius
from point_cloud_registration_tpu_torch.models.icp import build_icp_target
from point_cloud_registration_tpu_torch.models.ndt import build_ndt_target
from point_cloud_registration_tpu_torch.models.plane_icp import build_plane_icp_target
from point_cloud_registration_tpu_torch.models.voxelized_plane_icp import build_vplane_target
from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl
from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga
from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn
from point_cloud_registration_tpu_torch.ops.kernels import normals_chain as nc
from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa
import host_loop
from oracles import make_scan, make_scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 200  # points a scan
# distinct initial transforms (6-dof, translation first) and scan offsets:
# the problems stop at different iterations
INIT_DX = [
    [0.01, 0.0, 0.0, 0.002, 0.0, 0.0],
    [0.0, -0.02, 0.01, 0.0, 0.003, -0.002],
    [-0.015, 0.01, -0.01, -0.002, 0.0, 0.003],
]
OFFSETS = [[0.04, -0.02, 0.06], [-0.03, 0.05, 0.02], [0.0, 0.0, 0.1]]
FAILED = 1  # the problem of a batch whose scan lies 100 m off the map: a non-finite dx


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.RandomState(5)).astype(np.float32)


@pytest.fixture(scope="module")
def targets(scene):
    """kind -> (target, cfg) of the four kinds on the scene, on the CPU."""
    packed = CorrespondenceConfig(method="packed")
    icp_cfg = ICPConfig(corr=packed, max_iter=8)
    plane_cfg = PlaneICPConfig(corr=packed, max_iter=8)
    return {
        "plane": (build_vplane_target(scene, VPlaneICPConfig(max_iter=8), device="cpu"),
                  VPlaneICPConfig(max_iter=8)),
        "ndt": (build_ndt_target(scene, NDTConfig(max_iter=8), device="cpu"),
                NDTConfig(max_iter=8)),
        "point": (build_icp_target(scene, icp_cfg, device="cpu"), icp_cfg),
        "plane_pt": (build_plane_icp_target(scene, plane_cfg, device="cpu").corr, plane_cfg),
    }


def _batch(scene, B, fail=True):
    """``(src (B, N, 3), w (B, N), T0 (B, 4, 4))``: scans of the scene moved
    by OFFSETS, the problem FAILED (when B > 1 and ``fail``) moved 100 m
    away, distinct initial transforms."""
    rng = np.random.RandomState(17)
    src = np.stack([scene[rng.choice(len(scene), N, replace=False)] + np.float32(OFFSETS[b])
                    for b in range(B)]).astype(np.float32)
    if B > 1 and fail:
        src[FAILED] += np.float32([100.0, 0.0, 0.0])
    T0 = torch.stack([pt.plus(torch.eye(4), torch.tensor(d)) for d in INIT_DX[:B]])
    return torch.from_numpy(src), torch.ones((B, N)), T0


def _loop_of(kind, target, cfg, src, w):
    """``(batched loop(state), single loop(src_b, w_b, state), batched
    stats at pose rows)`` of ``kind`` on ``target`` with ``cfg``'s
    settings."""
    settings = dict(max_dist=cfg.max_dist, huber_delta=cfg.huber_delta, tol=cfg.tol,
                    max_iter=cfg.max_iter)
    if kind in ("plane", "ndt"):
        head = (kind, target.cells, target.origin_cell, target.dims, target.cell_size)
        return (lambda state: gl.fused_loop_batched(*head, src, w, state, **settings),
                lambda s, ws, state: gl.fused_loop(*head, s, ws, state, **settings),
                _fused.fused_voxel_stats_packed_batched(target, src, w, cfg, kind))
    head = (kind, target.packed, target.proxy)
    settings["proxy_radius"] = proxy_radius(cfg.corr, cfg.max_dist)
    return (lambda state: gl.point_loop_batched(*head, src, w, state, **settings),
            lambda s, ws, state: gl.point_loop(*head, s, ws, state, **settings),
            _point_fused.fused_point_stats_packed_batched(target, src, w, cfg, kind))


def _bits(x):
    """A tensor's words, so that NaNs (a failed problem's |dx|) compare too."""
    x = torch.as_tensor(x)
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _host(stats_all, T0, cfg):
    """``(Ts, diagnostics)`` of the batched host loop
    (``core.gn.batched_gauss_newton``) over the batched stats ``stats_all``
    from ``T0``."""
    return gn.batched_gauss_newton(
        lambda Ts: gn.stats_from_packed(stats_all(gn.pose_rows_of(Ts))()), T0, cfg.max_iter,
        cfg.tol)


def _same(Ts, d, Ts_want, d_want):
    """Two batched results bit for bit (NaN payloads too)."""
    assert torch.equal(_bits(Ts), _bits(Ts_want))
    for f in d._fields:
        assert torch.equal(_bits(getattr(d, f)), _bits(getattr(d_want, f))), f


def _result(state):
    """``(Ts, diagnostics)`` of a batched state, as
    ``core.gn.batched_gauss_newton_device`` returns them."""
    return gn.transforms_of(state.poses), gn.GNDiagnostics(
        iterations=state.it, converged=state.converged.to(torch.bool),
        solver_failed=state.failed.to(torch.bool), e2_history=state.e2,
        dx_norm_history=state.dx_norm, inlier_history=state.inliers, final_e2=state.final_e2)


def _problem_words(state, b):
    """Problem b's words of a batched state, in a single problem's order."""
    f = _bits
    return torch.cat([f(state.poses[b]), state.it[b:b + 1], state.done[b:b + 1],
                      state.failed[b:b + 1], state.converged[b:b + 1],
                      f(state.final_e2[b:b + 1]), f(state.e2[b]), f(state.dx_norm[b]),
                      state.inliers[b]])


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kind", ["plane", "ndt", "point", "plane_pt"])
def test_plain_batched_loop_equals_host_and_single_loops(scene, targets, kind, B):
    target, cfg = targets[kind]
    src, w, T0 = _batch(scene, B)
    loop, single, stats_all = _loop_of(kind, target, cfg, src, w)
    state = gn.new_state(T0, cfg.max_iter, "cpu")
    loop(state)
    _same(*_result(state), *_host(stats_all, T0, cfg))
    for b in range(B):
        one = gn.new_state(T0[b:b + 1], cfg.max_iter, "cpu")
        single(src[b], w[b], one)
        assert torch.equal(_problem_words(state, b), one.words)
    its = state.it.tolist()
    assert bool(state.done.all()) and min(its) >= 1
    if B > 1:
        # a failed problem stops at once, the others later, each left as it was
        assert bool(state.failed[FAILED]) and its[FAILED] == 1
        assert torch.equal(state.poses[FAILED], gn.pose_rows_of(T0)[FAILED])
        assert max(its) > 1 and not bool(state.failed[0])


@pytest.mark.parametrize("kind", ["plane", "point"])
def test_batched_aligns_run_the_loop_once(scene, targets, kind, monkeypatch):
    """The batched align of each stream is one call of its batched loop and
    one read of the state; no stats kernel is bound. Its result is the
    batched host loop's over the same stats, bit for bit."""
    target, cfg = targets[kind]
    src, w, T0 = _batch(scene, 3)
    if kind == "plane":
        module, name = _fused, "fused_loop_batched_reference"
        align = lambda: module.fused_voxel_align_batched(target, src, w, T0, cfg, kind)  # noqa
    else:
        module, name = _point_fused, "point_loop_batched_reference"
        align = lambda: module.fused_point_align_batched(target, None, src, w, T0, cfg,  # noqa
                                                         kind)
    calls = []
    plain_loop, bind = getattr(gl, name), module.resident_stats
    monkeypatch.setattr(gl, name, lambda *a, **k: calls.append("loop") or plain_loop(*a, **k))
    monkeypatch.setattr(module, "resident_stats",
                        lambda *a, **k: calls.append("stats") or bind(*a, **k))
    Ts, d = align()
    assert calls == ["loop"]
    monkeypatch.undo()
    _same(Ts, d, *_host(_loop_of(kind, target, cfg, src, w)[2], T0, cfg))


@pytest.mark.parametrize("kind", ["ndt", "plane_pt"])
def test_batched_loop_max_iter_zero_and_one(scene, targets, kind):
    """``max_iter`` 0: the align returns the initial transforms, no
    iteration; 1: one iteration each, every problem done, the host loop's
    result."""
    target, cfg = targets[kind]
    src, w, T0 = _batch(scene, 3)
    fn = (_fused.fused_voxel_align_batched if kind == "ndt"
          else lambda *a: _point_fused.fused_point_align_batched(a[0], None, *a[1:]))
    Ts, d = fn(target, src, w, T0, dataclasses.replace(cfg, max_iter=0), kind)
    assert torch.equal(Ts, T0) and d.iterations.tolist() == [0, 0, 0]
    assert d.e2_history.shape == (3, 0)
    cfg1 = dataclasses.replace(cfg, max_iter=1)
    loop, _, stats_all = _loop_of(kind, target, cfg1, src, w)
    state = gn.new_state(T0, 1, "cpu")
    loop(state)
    assert state.it.tolist() == [1, 1, 1] and bool(state.done.all())
    _same(*_result(state), *_host(stats_all, T0, cfg1))


def test_batched_loopers_refuse_mismatched_operands(targets):
    target, cfg = targets["plane"]
    head = ("plane", target.cells, target.origin_cell, target.dims, target.cell_size)
    src, w = torch.zeros((2, 5, 3)), torch.ones((2, 5))
    state = gn.new_state(torch.eye(4).expand(3, 4, 4), 4, "cpu")  # 3 problems, 2 scans
    with pytest.raises(ValueError, match="problems"):
        gl.fused_looper_batched(*head, src, w, state, 2.0, None, 1e-3, 4)
    with pytest.raises(ValueError, match="unknown kind"):
        gl.point_looper_batched("plane", None, None, src, w, state, 2.0, 1, None, 1e-3, 4)
    state2 = gn.new_state(torch.eye(4).expand(2, 4, 4), 4, "cpu")
    with pytest.raises(ValueError, match="max_iter"):
        gl.fused_loop_batched_reference(*head, src, w, state2, 2.0, None, 1e-3, 5)
    # the kernel's block ids are ints: B has no cap but that
    gl.check_batch_ids(2**21 - 1, 262_144, 256)
    with pytest.raises(ValueError, match="MAX_BATCH_IDS"):
        gl.check_batch_ids(2**21 + 1, 262_144, 256)


@pytest.mark.parametrize("n, B", [(1, 1), (16_384, 8), (100_000, 3)])
def test_loop_grid_of_a_batch_covers_every_problem_block_once(n, B):
    """The batched kernel's ids b * n_blocks + v over its grid: each
    (problem, block) once, the grid no larger than the ids or the card."""
    grid, virtual = gl.loop_grid(n, 256, 132, 3, problems=B)
    assert virtual == gl.loop_grid(n, 256, 132, 3)[1]
    assert grid == min(B * virtual, 132 * 3)
    ids = sorted(i for c in range(grid) for i in range(c, B * virtual, grid))
    assert ids == list(range(B * virtual))


@pytest.mark.parametrize("kind", ["plane", "point"])
def test_a_done_problem_is_left_as_it_was(scene, targets, kind, monkeypatch):
    """The batched align's plain loop: each stats call sees a problem's done
    flag set from the iteration after its stop, and a done problem's words
    stay as they were while the others iterate."""
    target, cfg = targets[kind]
    src, w, T0 = _batch(scene, 3)
    seen, plain_loop = [], gl.batched_loop_reference

    def watched(stats, state, tol, max_iter):
        def watched_stats():
            seen.append(state.words.clone())
            return stats()

        return plain_loop(watched_stats, state, tol, max_iter)

    monkeypatch.setattr(gl, "batched_loop_reference", watched)
    if kind == "plane":
        Ts, d = _fused.fused_voxel_align_batched(target, src, w, T0, cfg, kind)
    else:
        Ts, d = _point_fused.fused_point_align_batched(target, None, src, w, T0, cfg, kind)
    its = d.iterations.tolist()
    assert len(seen) == max(its) and min(its) == 1 < max(its)
    states = [gn._fields(words, 3, cfg.max_iter) for words in seen]
    last = states[-1]
    for i, state in enumerate(states):
        assert state.done.tolist() == [int(n <= i) for n in its]
        for b in range(3):
            if its[b] <= i:  # done: its words are those it ends with
                assert torch.equal(_problem_words(state, b), _problem_words(last, b)), (i, b)
                assert torch.equal(gn.transforms_of(state.poses)[b], Ts[b])


def test_fast_always_phase2_is_one_loop_and_the_host_loop_result(scene, monkeypatch):
    """FastVPlaneICP ``"always"``: phase 1 and phase 2 each one call of the
    loop (``fused_loop``), no stats kernel bound; each phase's T, iterations,
    flags and histories equal to the host loop's on the same inputs
    (``tests/host_loop.py``), bit for bit."""
    scan, _ = make_scan(np.random.RandomState(7), scene,
                        np.array([0.04, -0.02, 0.05, 0.008, 0.0, -0.006]))
    kw = dict(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3, coreset_switch=2e-2,
              coreset="always", N_target=256)
    fast = fvp.FastVPlaneICP(**kw, device="cpu")
    fast.set_target(scene)
    loops, calls, phase2, reference = [], [], fvp._phase2_align, gl.fused_loop_reference
    aligns, align = [], fvp.fused_voxel_align
    monkeypatch.setattr(gl, "fused_loop_reference",  # its rows and its max_iter
                        lambda *a, **k: loops.append((a[5].shape[0], a[-1])) or reference(*a, **k))
    monkeypatch.setattr(_fused, "resident_stats", lambda *a, **k: calls.append("stats"))
    monkeypatch.setattr(fvp, "_phase2_align", lambda *a: calls.append(a[4]) or phase2(*a))
    monkeypatch.setattr(fvp, "fused_voxel_align",
                        lambda *a, **k: aligns.append((a, align(*a, **k))) or aligns[-1][1])
    fast.align(scan)
    d = fast.last_diagnostics
    # phase 1 on the padded scan, then phase 2 on the coreset within the budget left
    assert len(loops) == 2 and loops[0][1] == 30 and len(calls) == 1
    assert loops[1] == (256, calls[0]) and 0 < calls[0] < 30 and d.iterations > 30 - calls[0]
    assert len(aligns) == 2 and aligns[1][0][1].shape[0] == 256
    for (vm, src, w, T0, cfg, *kind), (T, di) in aligns:
        T_h, d_h = host_loop.voxel_align(vm, src, w, T0, cfg, *kind)
        assert torch.equal(T, T_h)
        assert (di.iterations, di.converged, di.solver_failed, di.final_e2) == (
            d_h.iterations, d_h.converged, d_h.solver_failed, d_h.final_e2)
        for f in ("e2_history", "dx_norm_history", "inlier_history"):
            assert torch.equal(getattr(di, f), getattr(d_h, f)), f


# --- every launcher binds and launches on its tensors' card ------------------

CARD = torch.device("cuda", 1)


class OnCard(torch.Tensor):
    """A CPU tensor that reports ``CARD`` as its device."""

    @property
    def device(self):
        return CARD


def _is_card(device) -> bool:
    return isinstance(device, (str, torch.device)) and torch.device(device).type == "cuda"


def _to_card(tree):
    return _pytree.tree_map(
        lambda x: x.as_subclass(OnCard) if type(x) is torch.Tensor else x, tree)


class FakeCard(TorchFunctionMode):
    """Factory calls and copies that name ``CARD`` make host tensors that
    report it; whatever an ``OnCard`` tensor makes reports it too; pinned
    memory is the host's."""

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("pin_memory", None)
        if func is torch.Tensor.pin_memory:
            return args[0]
        card = _is_card(kwargs.get("device"))
        if card:
            kwargs["device"] = "cpu"
        if func is torch.Tensor.to and any(_is_card(a) for a in args[1:]):
            args, card = tuple("cpu" if _is_card(a) else a for a in args), True
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **kwargs)
        leaves = _pytree.tree_leaves((args, kwargs))
        if card or any(isinstance(x, OnCard) for x in leaves):
            out = _to_card(out)
        return out


class Recorder:
    """``torch.cuda.device`` that records the cards entered."""

    entered: list = []

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        Recorder.entered.append(self.device)

    def __exit__(self, *exc):
        Recorder.entered.pop()


# Entries of the libraries that return a constant of the build and touch no
# card; the others (launches, occupancy and shape queries) are recorded.
CONSTANTS = {"pcr_fused_block_size": 256, "pcr_point_block_size": 128,
             "pcr_grid_queries_per_block": 64, "pcr_gn_loop_block_size": 256,
             "pcr_point_loop_block_size": 128, "pcr_grid_loop_queries_per_block": 64,
             "pcr_knn_item_size": kn.ITEM, "pcr_knn_round_k": kn.ROUND_K,
             "pcr_knn_tile_size": kn.TILE, "pcr_normals_sample_tile": nc.SAMPLE_TILE,
             "pcr_normals_sample_max_k": nc.SAMPLE_MAX_K,
             "pcr_normals_sample_part_max": nc.SAMPLE_PART_MAX, "pcr_normals_tile_size": nc.TILE,
             "pcr_normals_fallback_blocks": nc.FALLBACK_BLOCKS,
             "pcr_exact_nn_segment_length": 64}


class FakeLibrary:
    """A kernel library whose entries record ``(name, the card current)``
    and return 0 (an occupancy query answers 2 CTAs, the exact-NN shape
    query 2 segments)."""

    def __init__(self, log):
        self.log = log

    def __getattr__(self, name):
        def entry(*args):
            if name in CONSTANTS:
                return CONSTANTS[name]
            if name.endswith("_error_string"):
                return b"fake"
            self.log.append((name, Recorder.entered[-1] if Recorder.entered else None))
            for a in args:
                if type(a).__name__ == "CArgObject":
                    a._obj.value = 2
            return 2 if name == "pcr_exact_nn_segments" else 0

        entry.__name__ = name
        setattr(self, name, entry)
        return entry


_CACHED = [fa._kernel_fn, pa._kernel_fn, ga._kernel_fn, gl._kernel_fn,
           gl._point_kernel_fn, gl._grid_kernel_fn, gl._batched_kernel_fn,
           gl._point_batched_kernel_fn, gl._multiprocessors, en._kernel_fn, ga._window_on,
           kn._library, nc._library]


def keep_launch_counts(monkeypatch) -> None:
    """Every kernel wrapper's ``launches`` put back after the test: a faked
    launch counts as a real one, and other tests of the same process assert
    what their own calls count."""
    for module in (fa, pa, ga, gl, kn, nc, en):
        for f in vars(module).values():
            if callable(f) and hasattr(f, "launches"):
                monkeypatch.setattr(f, "launches", f.launches)


@pytest.fixture
def fake_card(monkeypatch):
    """The log of library calls, with the card faked as above; the bindings
    cached meanwhile are dropped before and after, the launch counts put
    back after."""
    log = []
    keep_launch_counts(monkeypatch)
    for module in (fa, pa, ga, gl, kn, nc, en):
        monkeypatch.setattr(module, "load_library", lambda name: FakeLibrary(log))
    monkeypatch.setattr(torch.cuda, "device", Recorder)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=4))
    for f in _CACHED:
        f.cache_clear()
    Recorder.entered = []
    with FakeCard():
        yield log
    for f in _CACHED:
        f.cache_clear()


def test_every_launcher_binds_and_launches_on_its_tensors_card(scene, targets, fake_card):
    log = fake_card
    vm, vcfg = targets["plane"]
    tg, pcfg = targets["point"]
    src1, w1, T0 = _batch(scene, 2, fail=False)
    src, w = _to_card((src1, w1))
    R, t = torch.eye(3), torch.zeros(3)
    cells, pg, proxy = _to_card((vm.cells, tg.packed, tg.proxy))
    radius = proxy_radius(pcfg.corr, pcfg.max_dist)
    idx = _to_card(torch.arange(8, dtype=torch.int64))
    count = _to_card(torch.tensor([8], dtype=torch.int32))
    small = build_icp_target(scene, ICPConfig(), device="cpu")  # the grid method
    grid, table, offsets = _to_card(_point_fused.grid_operands(small, ICPConfig()))
    head = (vm.origin_cell, vm.dims, vm.cell_size)
    settings = dict(max_dist=2.0, huber_delta=None, tol=1e-3, max_iter=4)
    calls = {
        "fused stats": lambda: fa.fused_plane_stats(cells, *head, src[0], w[0], R, t, 2.0),
        "fused stats batched": lambda: fa.fused_ndt_stats_batched(
            _to_card(targets["ndt"][0].cells), *head, src, w, R.expand(2, 3, 3), t.expand(2, 3),
            2.0),
        "point stats": lambda: pa.point_stats(pg, proxy, src[0], w[0], R, t, 2.0, radius),
        "grid stats": lambda: ga.grid_point_stats(grid, table, src[0], w[0], R, t, offsets, 2.0),
        "fused loop": lambda: gl.fused_loop("plane", cells, *head, src[0], w[0],
                                            gn.new_state(T0[:1], 4, CARD), **settings),
        "point loop": lambda: gl.point_loop("point", pg, proxy, src[0], w[0],
                                            gn.new_state(T0[:1], 4, CARD),
                                            proxy_radius=radius, **settings),
        "grid loop": lambda: gl.grid_loop("point", grid, table, src[0], w[0], offsets,
                                          gn.new_state(T0[:1], 4, CARD), **settings),
        "fused loop batched": lambda: gl.fused_loop_batched("plane", cells, *head, src, w,
                                                            gn.new_state(T0, 4, CARD),
                                                            **settings),
        "point loop batched": lambda: gl.point_loop_batched("point", pg, proxy, src, w,
                                                            gn.new_state(T0, 4, CARD),
                                                            proxy_radius=radius, **settings),
        "knn_moments": lambda: kn.knn_moments(pg, src[0], w[0], 5, 1),
        "knn_moments_into": lambda: kn.knn_moments_into(
            pg, src[0], idx, count, 5, 1, torch.zeros((10, N), device=CARD)),
        "sampled_median": lambda: nc.sampled_median(src[0], idx, idx, 5),
        "tail_lists": lambda: nc.tail_lists(torch.zeros((10, N), device=CARD), 1.0, 8, 8),
        "eig_normals": lambda: nc.eig_normals(torch.zeros((10, N), device=CARD)),
        "fallback_normals": lambda: nc.fallback_normals(
            pg, src[0], idx, count, 5, 4, torch.zeros((N, 3), device=CARD)),
        "exact_nn": lambda: en.exact_nn(src[0], src[1]),
    }
    expected = {
        "fused stats": ["pcr_fused_plane_stats"],
        "fused stats batched": ["pcr_fused_ndt_stats"],
        "point stats": ["pcr_point_stats"],
        "grid stats": ["pcr_grid_point_stats"],
        # the occupancy query that sizes the grid (the bind), then the launch
        "fused loop": ["pcr_gn_loop_blocks_per_sm", "pcr_gn_loop_plane"],
        "point loop": ["pcr_point_loop_blocks_per_sm", "pcr_point_loop_point"],
        "grid loop": ["pcr_grid_loop_blocks_per_sm", "pcr_grid_loop_point"],
        "fused loop batched": ["pcr_gn_loop_batched_blocks_per_sm",
                               "pcr_gn_loop_batched_plane"],
        "point loop batched": ["pcr_point_loop_batched_blocks_per_sm",
                               "pcr_point_loop_batched_point"],
        # the grouping's three kernels, then the launch
        "knn_moments": ["pcr_knn_box_keys", "pcr_knn_item_flags", "pcr_knn_item_starts",
                        "pcr_knn_moments"],
        "knn_moments_into": ["pcr_knn_box_keys", "pcr_knn_item_flags", "pcr_knn_item_starts",
                             "pcr_knn_moments"],
        "sampled_median": ["pcr_normals_sample"],
        "tail_lists": ["pcr_normals_tails"],
        "eig_normals": ["pcr_normals_eig"],
        "fallback_normals": ["pcr_normals_fallback"],
        # the shape query that sizes the launch, then the launch
        "exact_nn": ["pcr_exact_nn_segments", "pcr_exact_nn"],
    }
    for what, call in calls.items():
        del log[:]
        call()
        assert [name for name, _ in log] == expected[what], what
        assert all(device == CARD for _, device in log), (what, log)
        assert Recorder.entered == []
