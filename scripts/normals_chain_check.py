#!/usr/bin/env python3
"""The normals chain on a CUDA card, alone: phase 6c of ``chip_smoke.py``.

    python3 scripts/normals_chain_check.py [--probe] [--out-dir chiprun_out]

Builds the kernels and prints ptxas's registers and spills of the normals'
kernels, then, with ``--probe``, checks the PyTorch arithmetic
that ``csrc/normals_chain.cu`` and ``csrc/eigh3.cuh`` mirror on the card: the
order in which ``torch.sum`` adds three floats of a row (lanes 0 and 2, then
lane 1), and a division by a Python number as a product with its float32
reciprocal. Then it runs ``chip_smoke.run_normals_chain`` on phase 6's map
and on a map of the benchmark's ``plane_icp_b01`` cells and writes its rows
to ``normals_chain.json`` in the output directory. Prints the card's name and
power limit first.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import chip_smoke
from bench import make_city_map


def probe() -> dict:
    """Bit-level facts of ATen on this card, each as the share of 2**22
    random values (of several magnitudes) on which it holds."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1 << 22, 3), device="cuda", generator=g)
    x = x * torch.exp(4 * torch.randn((1 << 22, 1), device="cuda", generator=g))
    sq = x * x
    s = torch.sum(sq, dim=-1)
    orders = {"(x2 + y2) + z2": (sq[:, 0] + sq[:, 1]) + sq[:, 2],
              "(x2 + z2) + y2": (sq[:, 0] + sq[:, 2]) + sq[:, 1],
              "x2 + (y2 + z2)": sq[:, 0] + (sq[:, 1] + sq[:, 2])}
    out = {f"torch.sum(row of 3) == {k}": float((s == v).float().mean())
           for k, v in orders.items()}
    v = x[:, 0]
    for c in (3.0, 6.0):
        out[f"x / {c} == x * float32(1 / {c})"] = float(
            (v / c == v * torch.tensor(np.float32(1.0) / np.float32(c), device="cuda"))
            .float().mean())
        out[f"x / {c} == x / tensor({c})"] = float(
            (v / c == v / torch.tensor(c, dtype=torch.float32, device="cuda")).float().mean())
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--out-dir", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("normals_chain_check.py needs a CUDA card")
    chip_smoke.log(chip_smoke.nvidia_smi_line())
    chip_smoke.log(f"build: {chip_smoke.build_kernels():.2f} s")
    from point_cloud_registration_tpu_torch.ops.kernels import _build

    for name in ("knn_normals", "normals_chain"):  # ptxas: registers and spills per kernel
        log = (_build.library_path(name).parent / "nvcc.log").read_text().splitlines()
        chip_smoke.log("\n".join(f"[ptxas {name}] {line.split('ptxas info    : ')[-1]}"
                                  for line in log if "Compiling entry" in line or "spill" in line
                                  or "Used" in line))
    if args.probe:
        chip_smoke.log(f"[probe] {json.dumps(probe())}")
    dev = torch.device("cuda")
    maps = {"city": make_city_map(np.random.RandomState(chip_smoke.SEED), chip_smoke.N_MAP),
            "b01": chip_smoke.b01_map()}
    rows = chip_smoke.run_normals_chain(maps, dev)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "normals_chain.json").write_text(json.dumps(rows, indent=1))
    chip_smoke.log('{"ok": true}')


if __name__ == "__main__":
    main()
