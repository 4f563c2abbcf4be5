"""The traced run's reduction: the benchmark's spans and the device's
operations from one ``torch.profiler`` trace, in one clock.

Spans are the benchmark's own ``record_function`` ranges named ``pb.*``
around each call into the program; device operations are every kernel,
copy and set that the trace shows on the card. Per-layer readers
(``perfbench/metrics``) take a :class:`Trace` and the run's counters.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "pb."


@dataclass
class Trace:
    spans: list  # (name, start_s, end_s), the benchmark's host spans
    device: list  # (name, start_s, end_s), every device operation
    merged: list = field(default_factory=list)  # union of the device intervals

    def __post_init__(self):
        self.spans.sort(key=lambda s: s[1])
        self.device.sort(key=lambda d: d[1])
        merged = []
        for _, a, b in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.merged = merged

    @property
    def window(self) -> tuple[float, float]:
        """From the first span's start to the last span's end."""
        return self.spans[0][1], max(s[2] for s in self.spans)

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]

    def busy(self, lo: float, hi: float) -> float:
        """Seconds of ``[lo, hi]`` in which some operation ran on the device."""
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.merged)

    def ops_in(self, lo: float, hi: float) -> list:
        """Device operations that started inside ``[lo, hi]``."""
        return [d for d in self.device if lo <= d[1] <= hi]

    def idle_gaps(self) -> list:
        """``(start, end)`` of every stretch of the window with nothing on
        the device."""
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.merged:
            if b < lo or a > hi:
                continue
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def open_span(self, t: float) -> str:
        """The innermost benchmark span open on the host at ``t``, or
        ``client`` (the benchmark's own work between calls)."""
        best = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "client"


def collect(prof) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    spans, device = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if name.startswith(SPAN_PREFIX):
            if e.device_type() == DeviceType.CPU:
                spans.append((name, a, b))
        elif e.device_type() == DeviceType.CUDA:
            device.append((name, a, b))
    return Trace(spans=spans, device=device)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the benchmark span open on the host."""
    lo, hi = tr.window
    by_name = defaultdict(float)
    for name, a, b in tr.ops_in(lo, hi):
        by_name[name[:120]] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[tr.open_span((a + b) / 2), b - a] for a, b in gaps]}


def is_kernel(name: str) -> bool:
    """A kernel, not a copy or a set."""
    return not name.startswith(("Memcpy", "Memset"))


@dataclass
class Context:
    """What a per-layer reader may read: the trace, the traced requests'
    iteration counts (``last_diagnostics``) and latencies (ms, host clock),
    the loop kernel's name, and the least milliseconds the card could take
    for an align's loop, from the reference's counts (None when nothing
    was counted)."""

    trace: Trace
    iterations: list
    loop_kernel: str
    bound_ms: float | None = None
    latencies_ms: list = field(default_factory=list)
