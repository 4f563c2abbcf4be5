"""The prepared loop of a solver's single aligns (``core.gn.PreparedLoop``,
kept in the solver's ``core.gn.LoopSlot``): the state's words, the pinned
init and read buffers and the loop's bound launch, made on the first align
after ``set_target`` and refilled by the aligns after it.

On the CPU the plan runs each kind's plain loop (``gn_loop.*_loop_reference``)
on its own state, so its result is held bit for bit to the two-launch
resident loop (``core.gn.gauss_newton_device`` without ``loop``) for the
eight single-align paths: VPlaneICP and NDT on a dense and on a hashed map,
ICP and PlaneICP on a packed and on a grid target. When a plan is made and
when it is kept is held on the CPU too: once a target and scan bucket, again
after ``set_target``, ``update_target`` or a scan of another padded length.

The launch path runs on the CPU with tensors that report ``cuda:1``
(``test_torch_gn_loop_batched.py``'s ``FakeCard``, ``OnCard`` and
``FakeLibrary``): one C launch an align, carrying that align's scan and
weights; a new plan on another stream; a launch that raised makes the next
align wait for the copy it left in flight. The prepared align on the card
against the unprepared one is ``test_torch_gn_plan_card.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import point_cloud_registration_tpu_torch as pt
from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.models import _fused, _point_fused, pad_points
from point_cloud_registration_tpu_torch.ops import voxelize
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl
from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga
from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa
from oracles import make_scan, make_scene
from test_torch_gn_loop_batched import CARD, FakeCard, FakeLibrary, Recorder, _CACHED, _to_card
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_ITER = 12
# (solver, correspondence method or map layout): the eight single-align paths
CASES = {
    "plane": (pt.VPlaneICP, "dense"),
    "ndt": (pt.NDT, "dense"),
    "plane_hashed": (pt.VPlaneICP, "hashed"),
    "ndt_hashed": (pt.NDT, "hashed"),
    "point": (pt.ICP, "packed"),
    "plane_pt": (pt.PlaneICP, "packed"),
    "point_grid": (pt.ICP, "grid"),
    "plane_pt_grid": (pt.PlaneICP, "grid"),
}
OFFSETS = {"a": [0.05, -0.04, 0.08, 0.01, -0.008, 0.012],
           "b": [-0.03, 0.06, -0.05, -0.006, 0.01, -0.004]}


@pytest.fixture(scope="module")
def scene():
    return make_scene(np.random.RandomState(5)).astype(np.float32)


@pytest.fixture(scope="module")
def scans(scene):
    """Two scans of 1,500 points (one padded length) at other offsets."""
    return {name: make_scan(np.random.RandomState(11 + i), scene, np.array(dx), n_points=1500)[0]
            for i, (name, dx) in enumerate(sorted(OFFSETS.items()))}


def _solver(case, scene):
    cls, layout = CASES[case]
    if cls in (pt.VPlaneICP, pt.NDT):
        s = cls(max_iter=MAX_ITER, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            if layout == "hashed":
                mp.setattr(voxelize, "DENSE_CELL_BUDGET", 1)
            s.set_target(scene)
        assert s._target.hashed == (layout == "hashed")
        return s
    s = cls(max_iter=MAX_ITER, device="cpu")
    s.cfg = dataclasses.replace(s.cfg, corr=pt.CorrespondenceConfig(method=layout))
    s.set_target(scene)
    corr = getattr(s._target, "corr", s._target)
    assert (corr.packed is None) == (layout == "grid")
    return s


@pytest.fixture(scope="module")
def solvers(scene):
    return {case: _solver(case, scene) for case in CASES}


def _bits(x):
    x = torch.as_tensor(x)
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b) -> None:
    """Two ``(T, diagnostics)`` bit for bit, with the same types."""
    (Ta, da), (Tb, db) = a, b
    assert Ta.dtype == Tb.dtype == torch.float32 and Ta.shape == Tb.shape == (4, 4)
    assert torch.equal(_bits(Ta), _bits(Tb))
    for f in da._fields:
        x, y = getattr(da, f), getattr(db, f)
        assert type(x) is type(y), f
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), f
        else:
            assert x == y or (x != x and y != y), f


def _align(solver, scan):
    return torch.as_tensor(solver.align(scan), dtype=torch.float32), solver.last_diagnostics


def _two_launch(solver, scan, monkeypatch):
    """The same align through the two-launch resident loop (``loop`` left
    out) and no plan."""
    device = gn.gauss_newton_device
    with monkeypatch.context() as mp:
        mp.setattr(gn, "gauss_newton_device", lambda *a, loop=None: device(*a))
        T = solver.align(scan)
    return torch.as_tensor(T, dtype=torch.float32), solver.last_diagnostics


def _counts():
    return gn.PreparedLoop.builds, gn.PreparedLoop.reuses


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepared_align_equals_the_two_launch_loop(solvers, scans, case, monkeypatch):
    """Two scans through one plan, each bit for bit the two-launch loop's
    align: T, the iterations, the flags, ``final_e2`` and the histories."""
    solver = solvers[case]
    solver._loop.plan = None
    builds, reuses = _counts()
    got = {name: _align(solver, scan) for name, scan in sorted(scans.items())}
    assert _counts() == (builds + 1, reuses + 1)
    plan = solver._loop.plan
    for name, scan in sorted(scans.items()):
        want = _two_launch(solver, scan, monkeypatch)
        _same(got[name], want)
        assert 2 <= got[name][1].iterations <= MAX_ITER and not got[name][1].solver_failed
    assert solver._loop.plan is plan  # the two-launch aligns neither use nor drop it


def test_plan_is_made_once_a_target_and_scan_bucket(scene, scans):
    """Made on the first align, kept by the aligns after it; made again
    after ``set_target``, ``update_target`` and on a scan of another padded
    length; the plan of the old target is dropped when the target is set."""
    s = pt.VPlaneICP(max_iter=MAX_ITER, device="cpu")
    s.set_target(scene)
    assert s._loop.plan is None
    builds, reuses = _counts()
    s.align(scans["a"])
    first = s._loop.plan
    assert first is not None and first.targets == (s._target,)
    s.align(scans["b"])
    s.align(scans["a"])
    assert _counts() == (builds + 1, reuses + 2) and s._loop.plan is first
    s.align(np.concatenate([scans["a"], scans["b"]] * 3))  # 9,000 points: another bucket
    assert _counts() == (builds + 2, reuses + 2) and s._loop.plan is not first
    s.align(scans["a"])  # back: the plan holds one bucket
    assert _counts() == (builds + 3, reuses + 2)
    s.set_target(scene)
    assert s._loop.plan is None
    s.align(scans["a"])
    s.update_target(scene[:500] + np.float32([0.3, 0.0, 0.0]))
    assert s._loop.plan is None
    s.align(scans["a"])
    s.align(scans["b"])
    assert _counts() == (builds + 5, reuses + 3)
    assert s._loop.plan.targets == (s._target,)


def test_a_slot_given_another_target_makes_another_plan(solvers, scene, scans):
    """The functional align with one slot and two maps in turn, equal in
    every setting: a plan for each map as it comes (the target is compared
    by identity), each align the unprepared one's, bit for bit."""
    other = pt.VPlaneICP(max_iter=MAX_ITER, device="cpu")
    other.set_target(scene + np.float32([0.2, -0.1, 0.0]))
    maps = [solvers["plane"]._target, other._target]
    cfg, slot = solvers["plane"].cfg, gn.LoopSlot()
    src, w = pad_points(scans["a"], device="cpu")
    builds, reuses = _counts()
    for vm in maps + maps[:1] + maps[:1]:
        got = _fused.fused_voxel_align(vm, src, w, torch.eye(4), cfg, slot=slot)
        assert slot.plan.targets[0] is vm
        _same(got, _fused.fused_voxel_align(vm, src, w, torch.eye(4), cfg))
    assert _counts() == (builds + 3, reuses + 1)


@pytest.mark.parametrize("case", ["ndt", "point"])
def test_another_setting_makes_another_plan(solvers, scans, case):
    """The key holds the solver's settings: another ``max_iter`` or ``tol``
    makes a new plan, the same values found again keep it."""
    solver = solvers[case]
    solver.align(scans["a"])
    builds, reuses = _counts()
    cfg = solver.cfg
    try:
        solver.cfg = dataclasses.replace(cfg, max_iter=MAX_ITER - 1)
        solver.align(scans["a"])
        assert solver.last_diagnostics.e2_history.shape == (MAX_ITER - 1,)
        solver.cfg = dataclasses.replace(cfg, max_iter=MAX_ITER - 1)  # equal, not the same
        solver.align(scans["b"])
        solver.cfg = dataclasses.replace(cfg, tol=cfg.tol * 2)
        solver.align(scans["a"])
    finally:
        solver.cfg = cfg
    assert _counts() == (builds + 2, reuses + 1)


def test_results_do_not_alias_the_plan(solvers, scans):
    """Align k's T and diagnostics are left as they were by align k + 1."""
    solver = solvers["plane"]
    T1 = solver.align(scans["a"])
    d1 = solver.last_diagnostics
    kept = (T1.copy(), [(f, getattr(d1, f).clone() if isinstance(getattr(d1, f), torch.Tensor)
                         else getattr(d1, f)) for f in d1._fields])
    T2 = solver.align(scans["b"])
    assert not np.array_equal(T1, T2) and solver._loop.plan is not None
    np.testing.assert_array_equal(T1, kept[0])
    for f, v in kept[1]:
        now = getattr(d1, f)
        assert torch.equal(now, v) if isinstance(v, torch.Tensor) else now == v, f
    host = solver._loop.plan.read
    for x in [d1.e2_history, d1.dx_norm_history, d1.inlier_history]:
        assert x.untyped_storage().data_ptr() != host.untyped_storage().data_ptr()


def test_a_loop_that_raised_leaves_the_next_align_correct(scene, scans, monkeypatch):
    """The plain loop raises once inside a prepared align; the next align
    through the same plan is a fresh solver's, bit for bit."""
    s = pt.NDT(max_iter=MAX_ITER, device="cpu")
    s.set_target(scene)
    s.align(scans["b"])
    reference = gl.fused_loop_reference
    raised = []

    def once(*a, **k):
        if not raised:
            raised.append(1)
            reference(*a, **k)
            raise RuntimeError("the loop failed")
        return reference(*a, **k)

    monkeypatch.setattr(gl, "fused_loop_reference", once)
    with pytest.raises(RuntimeError, match="the loop failed"):
        s.align(scans["a"])
    plan = s._loop.plan
    got = _align(s, scans["a"])
    assert s._loop.plan is plan
    fresh = pt.NDT(max_iter=MAX_ITER, device="cpu")
    fresh._target = s._target
    _same(got, _align(fresh, scans["a"]))


def test_max_iter_zero_makes_no_plan(solvers, scans):
    solver = solvers["plane_pt"]
    cfg = solver.cfg
    solver._loop.plan = None
    try:
        solver.cfg = dataclasses.replace(cfg, max_iter=0)
        T = solver.align(scans["a"])
    finally:
        solver.cfg = cfg
    assert solver._loop.plan is None and solver.last_diagnostics.iterations == 0
    np.testing.assert_array_equal(T, np.eye(4))


# --- the launch path, with tensors that report a card ------------------------

class Event:
    """``torch.cuda.Event`` that counts its records and waits."""

    made: list = []

    def __init__(self, *args, **kwargs):
        self.records, self.waits = [], 0
        Event.made.append(self)

    def record(self, stream=None):
        self.records.append(stream)

    def synchronize(self):
        self.waits += 1


@pytest.fixture
def card(monkeypatch):
    """``(log, streams, current)``: each library call as ``(name, card
    current, args)``, the streams by handle, and ``current["stream"]`` /
    ``current["device"]``, which the fakes of ``torch.cuda`` answer with."""
    log, streams = [], {}
    current = {"stream": 7, "device": 0, "fail": False}

    class ArgsLibrary(FakeLibrary):
        """Each call that touches the card logged with its arguments; the
        next such call fails with a CUDA error while ``current["fail"]``."""

        def __getattr__(self, name):
            entry = super().__getattr__(name)

            def recorded(*args):
                logged = len(self.log)
                rc = entry(*args)
                if len(self.log) == logged:
                    return rc
                self.log[-1] = (*self.log[-1], args)
                if current["fail"] and "blocks_per_sm" not in name:
                    current["fail"] = False
                    return 719
                return rc

            setattr(self, name, recorded)
            return recorded

    for module in (fa, pa, ga, gl):
        monkeypatch.setattr(module, "load_library", lambda name: ArgsLibrary(log))
    monkeypatch.setattr(torch.cuda, "device", Recorder)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: streams.setdefault(
                            current["stream"], types.SimpleNamespace(cuda_stream=current["stream"])))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["device"])
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=4))
    for f in _CACHED:
        f.cache_clear()
    Recorder.entered, Event.made = [], []
    with FakeCard():
        yield log, streams, current
    for f in _CACHED:
        f.cache_clear()


def _card_align(case, solvers, scans):
    """``align(scan name) -> (T, diagnostics)``: the solver's functional
    align on its target and scans as card tensors, through one slot; and the
    name of its loop's C entry."""
    solver = solvers[case]
    kind, layout = {"plane": ("plane", "fused"), "ndt": ("ndt", "fused"),
                    "plane_hashed": ("plane", "grid"), "point": ("point", "point"),
                    "plane_pt": ("plane_pt", "point"),
                    "point_grid": ("point", "grid")}[case]
    target = _to_card(solver._target)
    slot = gn.LoopSlot()
    padded = {name: _to_card(pad_points(scan, device="cpu"))
              for name, scan in scans.items()}

    def align(name):
        src, w = padded[name]
        T0 = torch.eye(4)
        if layout == "fused" or case == "plane_hashed":
            return _fused.fused_voxel_align(target, src, w, T0, solver.cfg, kind, slot=slot)
        if kind == "plane_pt":
            return _point_fused.fused_point_align(target.corr, src, w, T0, solver.cfg, kind,
                                                  target.normals, slot=slot)
        return _point_fused.fused_point_align(target, src, w, T0, solver.cfg, kind, slot=slot)

    prefix = {"fused": "pcr_gn_loop", "point": "pcr_point_loop", "grid": "pcr_grid_loop"}[layout]
    return align, padded, slot, (f"{prefix}_blocks_per_sm", f"{prefix}_{kind}")


@pytest.mark.parametrize("case", ["plane", "ndt", "point", "plane_pt", "point_grid",
                                  "plane_hashed"])
def test_card_align_is_one_launch_of_its_scan(solvers, scans, card, case):
    """The first align binds the loop (its occupancy query) and launches it;
    each align after it is one C call, the launch, with that align's scan
    and weights, on the stream the plan was made on; the init copy's event
    is recorded each align and waited for by none."""
    log, streams, _ = card
    align, padded, slot, (occupancy, entry) = _card_align(case, solvers, scans)
    builds, reuses = _counts()
    for i, name in enumerate(["a", "b", "a"]):
        del log[:]
        align(name)
        assert [c[0] for c in log] == ([entry] if i else [occupancy, entry])
        args = log[-1][2]
        src, w = padded[name]
        at = slot.plan.launch.scan_at
        assert args[at:at + 3] == (src.data_ptr(), w.data_ptr(), src.shape[0])
        assert args[-1] == 7  # the stream handle
    assert _counts() == (builds + 1, reuses + 2)
    (event,) = Event.made
    assert event.records == [streams[7]] * 3 and event.waits == 0
    assert Recorder.entered == []


def test_card_launch_enters_the_card_only_when_it_is_not_current(solvers, scans, card):
    log, _, current = card
    align, *_ = _card_align("plane", solvers, scans)
    current["device"] = 0
    align("a")
    assert log[-1][1] == CARD
    current["device"] = CARD.index
    align("b")
    assert log[-1][0] == "pcr_gn_loop_plane" and log[-1][1] is None


def test_card_plan_is_made_again_on_another_stream(solvers, scans, card):
    log, streams, current = card
    align, _, slot, _ = _card_align("point", solvers, scans)
    builds, reuses = _counts()
    align("a")
    first = slot.plan
    current["stream"] = 9
    align("a")
    assert slot.plan is not first and log[-1][2][-1] == 9
    assert Event.made[-1].records == [streams[9]]
    align("b")
    assert _counts() == (builds + 2, reuses + 1) and slot.plan.stream is streams[9]


def test_card_launch_that_raised_makes_the_next_align_wait_for_its_copy(solvers, scans, card):
    log, streams, current = card
    align, _, slot, (_, entry) = _card_align("ndt", solvers, scans)
    align("a")
    current["fail"] = True
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        align("b")
    (event,) = Event.made
    assert slot.plan.in_flight and event.waits == 0
    launches = gl.fused_loop.launches
    align("b")
    assert event.waits == 1 and not slot.plan.in_flight
    assert gl.fused_loop.launches == launches + 1 and log[-1][0] == entry
