"""Phase timing and profiler traces (counterpart of
``point_cloud_registration_tpu/utils/diagnostics.py``).

:class:`PhaseTimer` accumulates the time of named phases: on the card by
CUDA events recorded on the current stream around the phase (the stream's
span from the phase's first launch to its last, which the end event's
synchronize fences), on the CPU by the host clock, where the work is
synchronous. :func:`profiler_trace` writes a ``torch.profiler`` trace
(Chrome trace JSON, viewable in Perfetto) of a block of work.

The program marks its phases with :func:`span`: ``pcr.align`` (with
``pcr.align.upload``, ``pcr.gn.setup`` and ``pcr.gn.read`` inside it) and
``pcr.set_target`` (PlaneICP's with ``pcr.build.upload``,
``pcr.build.normals`` and ``pcr.build.index``, VPlaneICP's with
``pcr.build.index``). So::

    with profiler_trace("trace_dir"):
        solver.align(scan)

writes the ``pcr.*`` spans beside the kernels, copies and CUDA runtime calls
that each phase issued. With no profiler running a span costs one read of the
profiler's flag; it never synchronizes.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from torch.autograd import profiler as _autograd_profiler

from point_cloud_registration_tpu_torch.core.device import resolve_device

_NO_SPAN = contextlib.nullcontext()


class PhaseTimer:
    """Seconds per named phase, summed over calls::

        timer = PhaseTimer()
        with timer.phase("voxelize"):
            vm = build_voxel_map(...)
        print(timer.report())

    ``device`` (default: ``core.device.default_device()``, the card, or an
    error without one) picks the clock: CUDA events on a card, the host
    clock on the CPU.
    """

    def __init__(self, *, device=None) -> None:
        self.device = resolve_device(None, device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block as phase ``name``. ``block_on`` keeps the JAX
        signature: the end event's synchronize (card) or the host clock
        (CPU) already covers the work, so it is not needed."""
        del block_on
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield
            finally:
                end.record(stream)
                end.synchronize()
                self._add(name, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, tot in self.totals.items():
            n = self.counts[name]
            lines.append(f"{name:24s} {tot * 1e3:9.2f} ms total  x{n}  "
                         f"{tot / n * 1e3:8.2f} ms/call")
        return "\n".join(lines)

    def as_dict(self) -> dict[str, float]:
        return dict(self.totals)


def span(name: str):
    """A profiler range ``name`` while a torch profiler records, else one
    shared no-op context: one flag read when no profiler runs. The range
    takes the host's wall between its ends and waits for nothing on the
    card.

    The range is of function scope, as an operator's: the profiler mirrors
    a user-scope range (``record_function``) on the card's timeline, and a
    reader of the trace's device events would take the mirror for device
    work."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU and, when there is
    one, the card) and write ``<log_dir>/trace.json``; yields the profiler,
    whose ``key_averages()`` tables the device times. The trace holds the
    program's ``pcr.*`` spans (:func:`span`) beside the kernels and copies,
    for Perfetto: ``with profiler_trace(dir): solver.align(scan)``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
