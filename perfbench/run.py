"""The benchmark's entry point.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card and prints, as the last line
of standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number the comparison with the reference judged, beside
its limit (also the last lines of standard error). Exits non-zero, printing
no result, without a card or with fewer cards than the cell asks for, and
when the JAX stack or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import harness

    started = harness.process_start_wall()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.resolve(harness.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                         started=started)
    found = harness.banned_modules()
    if found:
        harness.log(f"modules of the JAX stack or the JAX package were loaded: {found}")
        return 4
    for line in harness.check_lines(result):
        harness.log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
