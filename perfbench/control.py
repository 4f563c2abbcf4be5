"""The lower-precision control: the plain reference put in the program's
place, in float32 with TF32 matrix products (the precision below the
configurations' float32 with TF32 off), driven through a cell's own window
and judged by the same comparison. Its numbers are the upper readings from
which the limits were set; a sound comparison finds it not correct.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]
                                 [--fault unchanged|half|altered|short | --sound]

With ``--fault <name>`` it drives the program with that fault of
``perfbench/faults.py`` planted instead, and with ``--sound`` the program
itself: the lower readings, many seeds in one process. Prints one JSON line
per seed: the numbers compared and ``correct``; standard error holds each
compared request's line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path


class ReferenceProgram:
    """A solver adapter (``perfbench/solvers``) over a plain reference module,
    computed in float32 with TF32 matrix products on a card."""

    LOOP_KERNEL = "no loop kernel"

    def __init__(self, reference):
        self.reference = reference

    @contextlib.contextmanager
    def _tf32(self):
        import torch

        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def make(self, params: dict, device):
        return {"params": params, "device": device, "target": None, "last": None}

    def set_target(self, state, points) -> None:
        import torch

        with self._tf32():
            state["target"] = self.reference.build(points, state["params"], state["device"],
                                                   torch.float32)

    def align(self, state, scan, init_T):
        import torch

        with self._tf32():
            out = self.reference.register(state["target"], scan, init_T, state["params"],
                                          state["device"], torch.float32)
        state["last"] = out
        return out.poses[out.updates].double().cpu().numpy()

    def outcome(self, state) -> tuple[int, list, list]:
        out = state["last"]
        return out.iterations, list(out.e2), list(out.dx_norms)


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import harness
    from perfbench.faults import FAULTS, Broken

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--fault", choices=FAULTS, default=None,
                       help="drive the program with this fault planted instead of the control")
    which.add_argument("--sound", action="store_true",
                       help="drive the program itself instead of the control")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("the control runs on a card; none found")
        return 3
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    program = (Broken(cell.solver, args.fault) if args.fault
               else cell.solver if args.sound else ReferenceProgram(cell.reference))
    for seed in args.seeds:
        result = harness.run(cell, seed, args.seconds, False, "cuda:0", program=program)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": args.fault or ("sound" if args.sound else "tf32 control"),
                          "correct": result["correct"],
                          "attempted": result["attempted"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
