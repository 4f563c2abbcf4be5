"""An align's parts in one traced run of a benchmark cell, and the share of
aligns that found their prepared loop.

    python3 scripts/gn_plan_parts.py --workload <cell> --seed <n> --seconds <s> [--tree DIR]

Runs ``perfbench/program_trace.py``'s ``measure`` on the tree ``DIR`` (default:
this repository; a parent unpacked by ``git archive`` compares the same cell
and seed before and after) and prints one JSON line: the program's span
readers (``gn_setup_ms``, ``gn_read_ms``, ``align_self_ms``, ``align_syncs``,
...), the traced run's metrics, and ``plan``: the prepared loops made and
reused over the run, warm-up included (``core.gn.PreparedLoop.builds`` and
``reuses``), and their hit share ``reuses / (builds + reuses)``; ``plan`` is
None on a tree without prepared loops.
"""

from __future__ import annotations

import argparse
import json
import sys
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
    from point_cloud_registration_tpu_torch.core import gn

    if not torch.cuda.is_available():
        harness.log(f"{args.workload} needs a CUDA card")
        return 3
    plan = getattr(gn, "PreparedLoop", None)
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    out = program_trace.measure(cell, args.seed, args.seconds, "cuda:0")
    counts = None
    if plan is not None:
        made = plan.builds + plan.reuses
        counts = {"builds": plan.builds, "reuses": plan.reuses,
                  "hit_share": plan.reuses / made if made else None}
    result = out["result"]
    print(json.dumps({"workload": args.workload, "seed": args.seed, "tree": args.tree,
                      "program": out["program"], "pb_align_ms": out["pb_align_ms"],
                      "metrics": result["metrics"], "correct": result["correct"],
                      "plan": counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
