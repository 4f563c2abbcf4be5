#!/usr/bin/env python3
"""Where the time of the k-NN moments kernel goes, on a CUDA card.

    python3 scripts/knn_moments_ablation.py

On the seed-42 bench map (1.2M points, k = 15) it times the kernel alone
(the grouping is done once, outside the timing), per tier of
``estimate_normals`` (all points at radius 2, the uncertified tail at radius
4), by CUDA events:

* the shipped build;
* builds of ``csrc/knn_normals.cu`` with one textual substitution each:
  another stage size or number of warps per block, a walk that starts at the
  box's corner instead of its middle (these compute the same function), and
  one part cut out (the results of these are wrong; only their time is
  read): no insertion chain (the bar is a running minimum), no second walk,
  neither.

A substitution whose pattern is no longer in the source stops the script.
Prints the card's name and power limit first.
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from bench import make_city_map
from point_cloud_registration_tpu_torch.ops import normals as nm
from point_cloud_registration_tpu_torch.ops.kernels import _build
from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn
from point_cloud_registration_tpu_torch.ops.pointgrid import build_packed_grid

K = 15
NO_CHAIN = ("for (int j = 0; j < kMax; ++j) {\n    const float lo",
            "for (int j = kMax - 1; j < kMax; ++j) {\n    const float lo")
NO_SECOND_WALK = ("if (fillings > 0) {", "if (fillings < 0) {")
FROM_CORNER = ("first_block = nx * (ny / 4 + ny * (nz / 2));", "first_block = 0;")
STAGE, WARPS = "kStagePoints = 512;", "kWarps = 4;"
VARIANTS = {
    "stage of 256 points": [(STAGE, "kStagePoints = 256;")],
    "stage of 1024 points": [(STAGE, "kStagePoints = 1024;")],
    "2 warps per block": [(WARPS, "kWarps = 2;")],
    "stage of 1024 points, 2 warps per block": [(STAGE, "kStagePoints = 1024;"),
                                                (WARPS, "kWarps = 2;")],
    "no insertion chain": [NO_CHAIN],
    "no second walk": [NO_SECOND_WALK],
    "neither": [NO_CHAIN, NO_SECOND_WALK],
    "walk from the corner": [FROM_CORNER],
}


def build_variants() -> dict:
    source = (_build.CSRC_DIR / "knn_normals.cu").read_text()
    out_dir = _build.BUILD_ROOT / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        text = source
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: pattern {old!r} is not in the source once")
            text = text.replace(old, new)
        stem = name.replace(" ", "_").replace(",", "")
        (out_dir / f"{stem}.cu").write_text(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
               str(out_dir / f"{stem}.so"), str(out_dir / f"{stem}.cu")]
        procs[name] = (out_dir / f"{stem}.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = kn._bind(ctypes.CDLL(str(path)))
    return libs


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("knn_moments_ablation.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_variants()
    shipped_lib = kn._library()
    map_t = torch.from_numpy(make_city_map(np.random.RandomState(42), 1_200_000)).cuda()
    n = map_t.shape[0]
    cell = max(nm.sample_knn_radius(map_t, K), 1e-3)
    pg = build_packed_grid(map_t, cell, cap=32, auto_cap=True)
    ones = torch.ones(n, device="cuda")
    _, _, rk2, unres, exact = kn.knn_moments(pg, map_t, ones, K, nm.BASE_RADIUS)
    tail = torch.nonzero(~exact & ~unres
                         & (rk2 < float(np.float32((6.0 * pg.cell_fine) ** 2))))[:, 0]
    q_w = map_t[tail].contiguous()
    print(f"cell {cell:.6f}, cap {pg.cap}, tail {q_w.shape[0]} queries", flush=True)
    for label, q, radius in (("base tier", map_t, nm.BASE_RADIUS), ("wide tier", q_w, nm.WIDE_RADIUS)):
        groups = kn.box_groups_cuda(pg, q, radius)
        out = torch.empty((10, q.shape[0]), device="cuda")

        def run(lib=shipped_lib):
            kn._library = lambda: lib  # the build that launch_moments calls
            kn.launch_moments(pg, q, ones[:q.shape[0]], K, radius, groups, out)

        print(f"== {label}, r = {radius}: {q.shape[0]} queries, {int(groups[2][0])} work items; "
              f"kernel alone, ms")
        shipped = cuda_ms(run)
        again = {name: cuda_ms(lambda: run(lib)) for name, lib in libs.items()}
        print(f"   shipped build (stage of 512 points, 4 warps per block): "
              f"{shipped:.3f}, again {cuda_ms(run):.3f}")
        for name, ms in again.items():
            print(f"   {name}: {ms:.3f}")


if __name__ == "__main__":
    main()
