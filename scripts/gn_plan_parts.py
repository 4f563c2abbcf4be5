"""An align's parts in one traced run of a benchmark cell, and the share of
aligns that found their prepared loop and their scan slot.

    python3 scripts/gn_plan_parts.py --workload <cell> --seed <n> --seconds <s> [--tree DIR]

Runs a cell traced, as ``perfbench/program_trace.py``'s ``measure`` does, on
the tree ``DIR`` (default: this repository; a parent unpacked by ``git
archive`` compares the same cell and seed before and after) and prints one
JSON line: the program's span readers (``gn_setup_ms``, ``gn_read_ms``,
``align_self_ms``, ``align_syncs``, ...), the device operations issued in an
align's ``pb.align`` by name (``align_ops``), the traced run's metrics, and
``plan``: the prepared loops made and reused over the run, warm-up included
(``core.gn.PreparedLoop.builds`` and ``reuses``), and their hit share
``reuses / (builds + reuses)``; ``scan``: the same of the scan slots
(``models.base.ScanSlot``). Each is None on a tree without them.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    from perfbench import harness, program_trace
    from perfbench.metrics import align_ms
    from perfbench.trace import Context
    from point_cloud_registration_tpu_torch.core import gn
    from point_cloud_registration_tpu_torch.models import base

    if not torch.cuda.is_available():
        harness.log(f"{args.workload} needs a CUDA card")
        return 3
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    with program_trace.kept_profiles() as made:
        result = harness.run(cell, args.seed, args.seconds, True, "cuda:0")
    tr = program_trace.collect(made[-1])
    ctx = Context(trace=tr, iterations=[], loop_kernel=cell.solver.LOOP_KERNEL)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "tree": args.tree,
                      "program": program_trace.read_all(ctx), "pb_align_ms": align_ms.read(ctx),
                      "align_ops": align_ops(tr),
                      "metrics": result["metrics"], "correct": result["correct"],
                      "plan": counts(getattr(gn, "PreparedLoop", None)),
                      "scan": counts(getattr(base, "ScanSlot", None))}), flush=True)
    return 0


def align_ops(tr) -> dict:
    """The device operations issued inside the benchmark's ``pb.align``
    spans, by name, per align (placed by their runtime call's host time)."""
    spans = tr.spans_named("pb.align")
    names = Counter(d[0][:80] for _, a, b in spans for d in tr.launched_in(a, b))
    return {name: n / len(spans) for name, n in names.most_common()} if spans else {}


def counts(cls) -> dict | None:
    """``cls.builds``, ``cls.reuses`` and the hit share; None without ``cls``."""
    if cls is None:
        return None
    made = cls.builds + cls.reuses
    return {"builds": cls.builds, "reuses": cls.reuses,
            "hit_share": cls.reuses / made if made else None}


if __name__ == "__main__":
    sys.exit(main())
