"""The port's profiler spans (``utils/diagnostics.py::span``) and the
benchmark's reduction of them (``perfbench/program_trace.py``).

On the CPU: with no profiler a span is one shared no-op; under
``torch.profiler`` an align records ``pcr.align`` with ``pcr.align.upload``,
``pcr.gn.setup`` and ``pcr.gn.read`` inside it, in that order (the first
align after ``set_target`` also ``pcr.gn.plan`` inside ``pcr.gn.setup``), a
PlaneICP ``set_target`` records ``pcr.set_target`` with the build's three
phases, an ICP ``set_target`` ``pcr.set_target`` with ``pcr.build.upload``
and ``pcr.build.index``, and an NDT ``set_target`` ``pcr.set_target`` with
``pcr.build.index``; ``profiler_trace``'s file holds them. The readers run on a trace
made by hand (times in ms): each value worked out by hand, the same
attribution with the device's clock shifted by 0.5 ms, an operation with no
launching call placed by its start and counted, the benchmark's ten readers
unchanged by the program's spans and runtime calls, and the idle gaps named
by program phase.
"""

import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from oracles import make_scan, make_scene
from perfbench import harness
from perfbench import program_trace as pt
from perfbench import trace as tr
from point_cloud_registration_tpu_torch import ICP, NDT, PlaneICP, VPlaneICP
from point_cloud_registration_tpu_torch.utils import profiler_trace
from point_cloud_registration_tpu_torch.utils.diagnostics import span
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SOLVERS = {"PlaneICP": lambda: PlaneICP(max_iter=5, k=5, device="cpu"),
           "VPlaneICP": lambda: VPlaneICP(voxel_size=1.0, max_iter=5, device="cpu"),
           "NDT": lambda: NDT(voxel_size=1.0, max_iter=5, device="cpu"),
           "ICP": lambda: ICP(max_iter=5, device="cpu")}
ALIGN_SPANS = ["pcr.align", "pcr.align.upload", "pcr.gn.setup", "pcr.gn.read"]
BUILD_SPANS = ["pcr.set_target", "pcr.build.upload", "pcr.build.normals", "pcr.build.index"]


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(3)
    cloud = make_scene(rng, n_floor=400, n_wall=200, extent=4.0, height=2.0)
    scan = make_scan(rng, cloud, np.array([0.02, -0.01, 0.03, 0.004, -0.005, 0.006]),
                     n_points=300)[0]
    return cloud, scan


def program_spans(prof) -> list:
    """``(name, start_ns, end_ns, user annotation)`` of every ``pcr.`` event."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("pcr.")]


def inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_span_without_a_profiler_is_one_shared_no_op():
    ctx = span("pcr.align")
    assert all(span(n) is ctx for n in ALIGN_SPANS + BUILD_SPANS + ["other"])
    with ctx:
        pass


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_align_records_its_phases_in_order(scene, solver):
    cloud, scan = scene
    s = SOLVERS[solver]()
    s.set_target(cloud)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T = s.align(scan)
    assert np.all(np.isfinite(T))
    # the first align after set_target makes its prepared loop inside the setup
    first = sorted(program_spans(prof), key=lambda e: e[1])
    names = [e[0] for e in first]
    assert names == ALIGN_SPANS[:3] + ["pcr.gn.plan"] + ALIGN_SPANS[3:]
    assert inside(first[3], first[2]) and not any(e[3] for e in first)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.align(scan)
    spans = sorted(program_spans(prof), key=lambda e: e[1])
    assert [e[0] for e in spans] == ALIGN_SPANS
    assert all(inside(child, spans[0]) for child in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))  # in turn, not nested
    # function scope: the profiler mirrors no user range on the card's timeline
    assert not any(e[3] for e in spans)


def test_plane_icp_set_target_records_the_build(scene):
    cloud, _ = scene
    s = SOLVERS["PlaneICP"]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.set_target(cloud)
    spans = sorted(program_spans(prof), key=lambda e: e[1])
    assert [e[0] for e in spans] == BUILD_SPANS
    assert all(inside(child, spans[0]) for child in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))


def test_icp_set_target_records_the_build(scene, monkeypatch):
    cloud, _ = scene
    s = SOLVERS["ICP"]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.set_target(cloud)
    spans = sorted(program_spans(prof), key=lambda e: e[1])
    assert [e[0] for e in spans] == ["pcr.set_target", "pcr.build.upload", "pcr.build.index"]
    assert all(inside(child, spans[0]) for child in spans[1:])
    assert spans[1][2] <= spans[2][1]  # in turn, not nested
    assert not any(e[3] for e in spans)
    # without a profiler each span is the shared no-op, and the target the same
    from point_cloud_registration_tpu_torch.models import icp as icp_module

    made = []
    monkeypatch.setattr(icp_module, "span", lambda name: made.append(span(name)) or made[-1])
    again = SOLVERS["ICP"]()
    again.set_target(cloud)
    assert len(made) == 3 and all(m is span("other") for m in made)
    assert torch.equal(again._target.points, s._target.points)
    assert torch.equal(again._target.rows, s._target.rows)


def test_ndt_set_target_records_the_build(scene, monkeypatch):
    cloud, _ = scene
    s = SOLVERS["NDT"]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.set_target(cloud)
    spans = sorted(program_spans(prof), key=lambda e: e[1])
    assert [e[0] for e in spans] == ["pcr.set_target", "pcr.build.index"]
    assert inside(spans[1], spans[0])
    assert not any(e[3] for e in spans)
    # without a profiler each span is the shared no-op, and the map the same
    from point_cloud_registration_tpu_torch.models import ndt as ndt_module

    made = []
    monkeypatch.setattr(ndt_module, "span", lambda name: made.append(span(name)) or made[-1])
    again = SOLVERS["NDT"]()
    again.set_target(cloud)
    assert len(made) == 2 and all(m is span("other") for m in made)
    assert torch.equal(again.voxels.cells.feats, s.voxels.cells.feats)


def test_profiler_trace_file_holds_the_spans(scene, tmp_path):
    cloud, scan = scene
    s = SOLVERS["VPlaneICP"]()
    with profiler_trace(str(tmp_path)):
        s.set_target(cloud)
        s.align(scan)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(ALIGN_SPANS) | {"pcr.set_target", "pcr.build.index"} <= names


# A trace by hand, in ms: one align and one set_target. Host events are
# (name, start, end, correlation id or None); device operations carry the
# id of the runtime call that issued them.
HOST = [
    ("pb.align", 0.0, 10.0, None),
    ("pcr.align", 0.5, 9.5, None),
    ("pcr.align.upload", 1.0, 2.0, None),
    ("cudaMemcpyAsync", 1.1, 1.2, 1),
    ("cudaStreamSynchronize", 1.3, 1.9, 2),
    ("cudaLaunchKernel", 1.95, 1.98, 3),
    ("aten::copy_", 1.05, 1.92, 1),  # an operator: its id is not a runtime call's
    ("pcr.gn.setup", 3.0, 5.0, None),
    ("cudaMemcpyAsync", 3.1, 3.2, 4),
    ("cudaLaunchCooperativeKernel", 4.0, 4.5, 5),
    ("pcr.gn.read", 6.0, 8.0, None),
    ("cudaMemcpyAsync", 6.1, 6.2, 6),
    ("cudaStreamSynchronize", 6.3, 7.9, 7),
    ("pb.set_target", 20.0, 40.0, None),
    ("pcr.set_target", 20.5, 39.0, None),
    ("pcr.build.upload", 21.0, 22.0, None),
    ("cudaMemcpyAsync", 21.1, 21.2, 10),
    ("cudaStreamSynchronize", 21.3, 21.9, 11),
    ("pcr.build.normals", 22.0, 30.0, None),
    ("cudaLaunchKernel", 22.1, 22.2, 12),
    ("cudaLaunchKernel", 24.0, 24.1, 13),
    ("cudaMemsetAsync", 25.0, 25.1, 14),
    ("cudaLaunchKernel", 26.0, 26.1, 15),
    ("cudaStreamSynchronize", 27.0, 29.0, 16),
    ("pcr.build.index", 30.0, 38.0, None),
    ("cudaLaunchKernel", 30.1, 30.2, 17),
    ("cudaLaunchKernel", 31.0, 31.1, 18),
    ("cudaDeviceSynchronize", 32.0, 37.0, 19),
]
DEVICE = [
    ("Memcpy HtoD (Pageable -> Device)", 1.15, 1.25, 1),
    ("pad_kernel", 2.5, 2.6, 3),  # runs after its span closed on the host
    ("Memcpy HtoD (Pinned -> Device)", 3.3, 3.4, 4),
    ("gn_loop_kernel", 4.6, 7.0, 5),
    ("Memcpy DtoH (Device -> Pageable)", 7.0, 7.1, 6),
    ("orphan_kernel", 8.8, 8.9, 99),  # its launching call is not in the trace
    ("Memcpy HtoD (Pageable -> Device)", 21.15, 21.8, 10),
    ("moments_kernel", 22.3, 23.0, 12),
    ("sort_kernel", 24.3, 24.6, 13),
    ("Memset (Device)", 25.2, 25.3, 14),
    ("flag_kernel", 30.05, 30.15, 15),  # starts on the card after normals closed
    ("index_kernel", 30.3, 30.9, 17),
    ("rank_kernel", 31.2, 36.0, 18),
]
BY_HAND = {"align_upload_ms": 1.0, "align_self_ms": 9.0 - 5.0, "align_syncs": 2.0,
           "gn_setup_ms": 2.0, "gn_read_ms": 2.0, "build_upload_ms": 1.0, "normals_ms": 8.0,
           "normals_launches": 3.0, "index_ms": 8.0, "index_launches": 2.0, "build_syncs": 3.0}


class FakeEvent:
    """What the reductions read of a kineto event."""

    def __init__(self, name, a_ms, b_ms, corr, device_type):
        self._name, self._corr, self._type = name, corr or 0, device_type
        self._a, self._d = round(a_ms * 1e6), round((b_ms - a_ms) * 1e6)

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._type

    def correlation_id(self):
        return self._corr


class FakeProfile:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda _self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def fake_profile(shift_ms: float = 0.0, host=HOST, device=DEVICE) -> FakeProfile:
    return FakeProfile([FakeEvent(*h, DeviceType.CPU) for h in host]
                       + [FakeEvent(n, a + shift_ms, b + shift_ms, c, DeviceType.CUDA)
                          for n, a, b, c in device])


def context(trace) -> tr.Context:
    return tr.Context(trace=trace, iterations=[5, 4], loop_kernel="gn_loop_kernel",
                      bound_ms=0.01, latencies_ms=[1.5, 2.5, 1.0])


@pytest.mark.parametrize("metric", sorted(BY_HAND))
def test_reader_value_by_hand(metric):
    got = pt.READERS[metric](context(pt.collect(fake_profile())))
    assert got == pytest.approx(BY_HAND[metric], abs=1e-9)


@pytest.mark.parametrize("shift_ms", [0.5, -0.5])
def test_a_shifted_device_clock_changes_no_attribution(shift_ms):
    base, shifted = pt.collect(fake_profile()), pt.collect(fake_profile(shift_ms))
    assert [base.open_span(t) for t in base.launched] == \
        [shifted.open_span(t) for t in shifted.launched]
    assert pt.read_all(context(base)) == pytest.approx(pt.read_all(context(shifted)))
    # by the device's own clock the same shift moves an operation
    assert [base.open_span(d[1]) for d in base.device] != \
        [shifted.open_span(d[1]) for d in shifted.device]


def test_an_operation_without_its_call_falls_back_to_its_start():
    trace = pt.collect(fake_profile())
    assert trace.fallbacks == ["orphan_kernel"]
    i = [d[0] for d in trace.device].index("orphan_kernel")
    assert trace.launched[i] == trace.device[i][1]
    assert trace.open_span(trace.launched[i]) == "pcr.align"
    pad = [d[0] for d in trace.device].index("pad_kernel")
    assert trace.open_span(trace.launched[pad]) == "pcr.align.upload"


EXISTING = [m["name"] for m in harness.load_benchmark()["per_layer"]]


@pytest.mark.parametrize("metric", EXISTING)
def test_existing_reader_unchanged_by_the_program_spans(metric):
    reader = harness.module_of("metrics", metric)
    without = fake_profile(host=[h for h in HOST if not h[0].startswith(("pcr.", "cu", "aten"))])
    plain, program = tr.collect(without), pt.collect(fake_profile())
    assert (program.spans, program.device) == (tr.collect(fake_profile()).spans, plain.device)
    assert reader.read(context(program)) == reader.read(context(plain))


def test_breakdown_names_a_gap_by_the_program_phase():
    program = pt.collect(fake_profile())
    gaps = dict((round(1e3 * s, 6), name) for name, s in tr.breakdown(program)["idle_gaps"])
    assert gaps[1.2] == "pcr.gn.setup"  # from the state's copy to the loop kernel
    plain = {round(1e3 * s, 6): name for name, s in tr.breakdown(tr.collect(fake_profile()))
             ["idle_gaps"]}
    assert plain[1.2] == "pb.align"
