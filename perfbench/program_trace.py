"""The program's own spans in a traced run, and the device's work put down
to them by correlation id.

The port marks its phases with profiler ranges named ``pcr.*``
(``point_cloud_registration_tpu_torch/utils/diagnostics.py::span``):
``pcr.align`` holds ``pcr.align.upload``, ``pcr.gn.setup`` and
``pcr.gn.read``; ``pcr.set_target`` holds ``pcr.build.upload``,
``pcr.build.normals`` and ``pcr.build.index``. :func:`collect` reads them
from the same ``torch.profiler`` trace as ``trace.collect``, with the CUDA
runtime calls on the host and each device operation's correlation id, the
id of the runtime call that issued it. That call's host time places the
operation in a span, whatever offset the trace gives the device's clock
against the host's. An operation whose call the trace lacks is placed by
its own start, as ``trace.py``'s readers place every operation, and
counted in ``fallbacks``.

:class:`ProgramTrace` is a ``trace.Trace`` that holds the benchmark's spans
and the device's operations as ``trace.collect`` keeps them, so each reader
of ``metrics/`` reads it as it reads a ``Trace``; its ``open_span`` names a
moment by the innermost span of either kind, so ``trace.breakdown`` names
the idle gaps by the program's phase. :data:`READERS` are the per-layer
readers of the spans, each ``read(ctx)`` over a ``trace.Context`` whose
``trace`` is a :class:`ProgramTrace`.

The harness's ``Context`` carries a ``trace.Trace``, which keeps none of
this; :func:`main` runs a cell traced, as ``run.py --trace 1`` does, and
prints these readers' values beside the harness's result::

    python3 perfbench/program_trace.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.trace import SPAN_PREFIX, Context, Trace, breakdown, is_kernel  # noqa: E402

PROGRAM_PREFIX = "pcr."
# CUDA API calls on the host (``cuda*``, ``cu*``); operators are ``aten::*``.
RUNTIME_PREFIX = "cu"
# The host's waits for the card among the runtime calls.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


@dataclass
class ProgramTrace(Trace):
    program: list = field(default_factory=list)  # (name, start_s, end_s), the program's spans
    runtime: list = field(default_factory=list)  # (name, start_s, end_s, correlation id)
    device_corr: list = field(default_factory=list)  # correlation id of each of ``device``
    launched: list = field(init=False)  # host time each of ``device`` was issued
    fallbacks: list = field(init=False)  # names of the device operations placed by their start

    def __post_init__(self):
        # ``device`` and its ids sorted together; ``Trace``'s stable sort
        # then keeps the order.
        corr = self.device_corr or [None] * len(self.device)
        pairs = sorted(zip(self.device, corr), key=lambda p: p[0][1])
        self.device = [d for d, _ in pairs]
        self.device_corr = [c for _, c in pairs]
        super().__post_init__()
        self.program.sort(key=lambda s: s[1])
        self.runtime.sort(key=lambda r: r[1])
        calls = {r[3]: r for r in self.runtime}
        self.launched, self.fallbacks = [], []
        for (name, a, _), c in zip(self.device, self.device_corr):
            call = calls.get(c)
            if call is None:
                self.fallbacks.append(name)
            self.launched.append(a if call is None else call[1])

    def program_named(self, name: str) -> list:
        return [s for s in self.program if s[0] == name]

    def launched_in(self, lo: float, hi: float) -> list:
        """Device operations issued on the host inside ``[lo, hi]``."""
        return [d for d, t in zip(self.device, self.launched) if lo <= t <= hi]

    def syncs_in(self, lo: float, hi: float) -> int:
        """Host waits for the card that started inside ``[lo, hi]``."""
        return sum(1 for r in self.runtime if r[0] in SYNCS and lo <= r[1] <= hi)

    def self_s(self, lo: float, hi: float) -> float:
        """Seconds of ``[lo, hi]`` outside every program span that lies
        strictly inside it: a span's own time, its children's taken out."""
        inner = [(a, b) for _, a, b in self.program if lo <= a and b <= hi and (a, b) != (lo, hi)]
        covered, end = 0.0, lo
        for a, b in sorted(inner):
            if b > end:
                covered += b - max(a, end)
                end = b
        return (hi - lo) - covered

    def open_span(self, t: float) -> str:
        """The innermost span, the benchmark's or the program's, open on
        the host at ``t``, or ``client``."""
        best = None
        for name, a, b in self.spans + self.program:
            if a <= t <= b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "client"


def collect(prof) -> ProgramTrace:
    """A :class:`ProgramTrace` from a finished ``torch.profiler.profile``:
    the spans and device operations of ``trace.collect`` by the same rule,
    with the device operations' correlation ids, the program's spans and
    the runtime calls."""
    from torch.autograd import DeviceType

    spans, device, corr, program, runtime = [], [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        on_host = e.device_type() == DeviceType.CPU
        if name.startswith(SPAN_PREFIX):
            if on_host:
                spans.append((name, a, b))
        elif e.device_type() == DeviceType.CUDA:
            device.append((name, a, b))
            corr.append(e.correlation_id())
        elif on_host and name.startswith(PROGRAM_PREFIX):
            program.append((name, a, b))
        elif on_host and name.startswith(RUNTIME_PREFIX):
            runtime.append((name, a, b, e.correlation_id()))
    return ProgramTrace(spans=spans, device=device, device_corr=corr, program=program,
                        runtime=runtime)


def _mean_ms(tr: ProgramTrace, name: str):
    spans = tr.program_named(name)
    return 1e3 * sum(b - a for _, a, b in spans) / len(spans) if spans else None


def _kernels_per(tr: ProgramTrace, name: str, per: str):
    """Kernels issued inside the spans ``name``, per span ``per``."""
    n = len(tr.program_named(per))
    if not n:
        return None
    return sum(1 for _, a, b in tr.program_named(name)
               for d in tr.launched_in(a, b) if is_kernel(d[0])) / n


def _syncs_per(tr: ProgramTrace, name: str):
    spans = tr.program_named(name)
    if not spans:
        return None
    return sum(tr.syncs_in(a, b) for _, a, b in spans) / len(spans)


def align_self_ms(ctx: Context):
    spans = ctx.trace.program_named("pcr.align")
    if not spans:
        return None
    return 1e3 * sum(ctx.trace.self_s(a, b) for _, a, b in spans) / len(spans)


# name -> read(ctx): the metric, its unit and what it reads are in PERF.md
# section 3.
READERS = {
    "align_upload_ms": lambda ctx: _mean_ms(ctx.trace, "pcr.align.upload"),
    "align_self_ms": align_self_ms,
    "align_syncs": lambda ctx: _syncs_per(ctx.trace, "pcr.align"),
    "gn_setup_ms": lambda ctx: _mean_ms(ctx.trace, "pcr.gn.setup"),
    "gn_read_ms": lambda ctx: _mean_ms(ctx.trace, "pcr.gn.read"),
    "build_upload_ms": lambda ctx: _mean_ms(ctx.trace, "pcr.build.upload"),
    "normals_ms": lambda ctx: _mean_ms(ctx.trace, "pcr.build.normals"),
    "normals_launches": lambda ctx: _kernels_per(ctx.trace, "pcr.build.normals",
                                                 "pcr.set_target"),
    "index_ms": lambda ctx: _mean_ms(ctx.trace, "pcr.build.index"),
    "index_launches": lambda ctx: _kernels_per(ctx.trace, "pcr.build.index", "pcr.set_target"),
    "build_syncs": lambda ctx: _syncs_per(ctx.trace, "pcr.set_target"),
}


def read_all(ctx: Context) -> dict:
    """Every reader's value that is not None."""
    values = {name: read(ctx) for name, read in READERS.items()}
    return {name: v for name, v in values.items() if v is not None}


@contextlib.contextmanager
def kept_profiles():
    """Every ``torch.profiler.profile`` opened inside the block, kept in the
    list it yields (the harness opens its own and does not return it)."""
    import torch.profiler

    made, base = [], torch.profiler.profile

    class Kept(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    torch.profiler.profile = Kept
    try:
        yield made
    finally:
        torch.profiler.profile = base


def measure(cell, seed: int, seconds: float, device) -> dict:
    """One traced run of ``cell`` (``harness.run``), and what the program's
    spans give on its trace: the readers, the idle gaps named by program
    phase, the operations placed by their start, and the benchmark's own
    ``pb.align`` wall and kernels a ``set_target`` on the same trace."""
    from perfbench import harness
    from perfbench.metrics import align_ms, build_launches

    with kept_profiles() as made:
        result = harness.run(cell, seed, seconds, True, device)
    tr = collect(made[-1])
    ctx = Context(trace=tr, iterations=[], loop_kernel=cell.solver.LOOP_KERNEL)
    return {"result": result, "program": read_all(ctx),
            "pb_align_ms": align_ms.read(ctx), "build_launches": build_launches.read(ctx),
            "fallbacks": len(tr.fallbacks),
            "fallback_names": Counter(n[:80] for n in tr.fallbacks).most_common(10),
            "breakdown": breakdown(tr) if tr.spans else None}


def main(argv=None) -> int:
    from perfbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        harness.log(f"{args.workload} needs a CUDA card")
        return 3
    out = measure(cell, args.seed, args.seconds, "cuda:0")
    print(json.dumps({"workload": args.workload, "seed": args.seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
