#!/usr/bin/env python3
"""The packed-grid stats kernels alone, beside other builds of them, on a CUDA card.

    python3 scripts/point_stats_ablation.py [other_point_align.cu ...]

On the seed-42 bench data (1.2M-point map, 100k-point scan, ICP's and
PlaneICP's targets with the port's own normals) it times one launch of
``point_stats`` and of ``plane_point_stats`` without the wrapper's sum of the
per-block partials, as ``torch.profiler`` reads the kernel's device time over
20 launches (CUDA events around back-to-back launches of a kernel this short
measure the host), at T = I (the first iteration) and at the scan's known
offset (the last):

* the shipped build;
* builds of ``csrc/point_align.cu`` with one textual substitution each
  (another number of resident blocks per SM, which sets the register
  budget; another block size; and parts cut out, whose sums are wrong and
  of which only the time is read: rows cut to 4 points, no 29-term update). A substitution whose pattern is
  no longer in the source stops the script;
* every further source named on the command line (an older commit's copy of
  the file, with ``gn_accumulate.cuh`` beside it), which must have the same C
  interface.

Every build's sums are held to the shipped build's. Prints the card's name
and power limit first.
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import point_cloud_registration_tpu_torch as pt
from bench import make_city_map, make_scan
from point_cloud_registration_tpu_torch.models import pad_points
from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius
from point_cloud_registration_tpu_torch.ops.kernels import _build
from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

PER_SM, THREADS = "kBlocksPerSm = 6;", "kThreads = 128;"
# Parts cut out: the sums of these builds are wrong, only their time is read.
ONE_TRIP = ("min(__ldg(&tb.row_count[row]), tb.cap)", "min(__ldg(&tb.row_count[row]), 4)")
NO_UPDATE = ("    if (!(sqrtf(my_d2) < max_dist)) continue;\n",
             "    if (!(sqrtf(my_d2) < max_dist)) continue;\n"
             "    acc[0] += tx + ty + tz + nx;\n    continue;\n")
VARIANTS = {
    "cut: at most 4 points of a row": [ONE_TRIP],
    "cut: no 29-term update": [NO_UPDATE],
    "4 blocks per SM": [(PER_SM, "kBlocksPerSm = 4;")],
    "5 blocks per SM": [(PER_SM, "kBlocksPerSm = 5;")],
    "blocks of 256 threads, 3 per SM": [(PER_SM, "kBlocksPerSm = 3;"),
                                        (THREADS, "kThreads = 256;")],
}


def build_variants(extra_sources: list) -> dict:
    source = (_build.CSRC_DIR / "point_align.cu").read_text()
    out_dir = _build.BUILD_ROOT / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = {}
    for name, cuts in VARIANTS.items():
        text = source
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: pattern {old!r} is not in the source once")
            text = text.replace(old, new)
        path = out_dir / (name.replace(" ", "_").replace(",", "") + ".cu")
        path.write_text(text)
        todo[name] = (path, _build.CSRC_DIR)
    for k, src in enumerate(extra_sources):
        todo[f"source {src}"] = (os.path.abspath(src), os.path.dirname(os.path.abspath(src)))
    procs = {}
    for k, (name, (path, include)) in enumerate(todo.items()):
        lib = out_dir / f"point_variant_{k}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-o", str(lib),
               str(path)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        report = "; ".join(line.split(":", 1)[-1].strip() for line in log.splitlines()
                           if "registers" in line or "spill" in line)
        print(f"   built {name}: {report}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of the stats kernel alone over ``reps`` calls
    of ``fn``, read from ``torch.profiler``: CUDA events around back-to-back
    launches of a kernel this short give the host's launch rate instead."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "point_stats_kernel" in e.key]
    traced = sum(e.count for e in rows)  # the trace may miss a launch
    if traced < reps // 2:
        raise RuntimeError(f"the trace holds {traced} of {reps} launches")
    return sum(e.self_device_time_total for e in rows) / 1e3 / traced


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("point_stats_ablation.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_variants(sys.argv[1:])
    rng = np.random.RandomState(42)
    map_np = make_city_map(rng, 1_200_000)
    scan_np = make_scan(rng, map_np, 100_000)
    map_t = torch.from_numpy(map_np).cuda()
    src, w = pad_points(scan_np, device="cuda")
    params = dict(max_iter=30, max_dist=2.0, tol=1e-3, device="cuda")
    icp = pt.ICP(**params)
    icp.set_target(map_t)
    picp = pt.PlaneICP(**params, k=15)
    picp.set_target(map_t, norm=pt.estimate_normals(map_t, k=15))
    poses = {"T = I": torch.zeros(3), "t = (0, 0, -0.3)": torch.tensor([0.0, 0.0, -0.3])}
    for kind, solver in (("point", icp), ("plane_pt", picp)):
        tg = getattr(solver._target, "corr", solver._target)
        radius = proxy_radius(solver.cfg.corr, solver.cfg.max_dist)
        for label, t in poses.items():
            args = (tg.packed, tg.proxy, src, w, torch.eye(3), t, solver.cfg.max_dist, radius,
                    solver.cfg.huber_delta)

            def run(bound):
                return pa.launch_partials(kind, bound, *args)

            shipped = pa._kernel_fn(kind)
            want = run(shipped).sum(dim=0)
            print(f"== {kind}, {src.shape[0]} queries at {label}: kernel alone, ms", flush=True)
            first = kernel_ms(lambda: run(shipped))
            times = {}
            for name, lib in libs.items():
                bound = pa._bind(lib, kind)
                got = run(bound).sum(dim=0)
                err = float((got - want).abs().max() / want.abs().max())
                if not (err < 1e-4 or name.startswith("cut:")):
                    raise AssertionError(f"{name}: sums differ from the shipped build's by {err}")
                times[name] = kernel_ms(lambda: run(bound))
            print(f"   shipped build ({shipped[1]} threads per block): {first:.4f}, again "
                  f"{kernel_ms(lambda: run(shipped)):.4f}")
            for name, ms in times.items():
                print(f"   {name}: {ms:.4f}")
            # fewer queries: a kernel bound by latency keeps its time, one bound by
            # a rate (issue, L1, L2) is faster in proportion
            parts = {m: kernel_ms(lambda: pa.launch_partials(
                kind, shipped, tg.packed, tg.proxy, src[:m].contiguous(), w[:m].contiguous(),
                *args[4:])) for m in (src.shape[0] // 8, src.shape[0] // 4, src.shape[0] // 2)}
            print("   shipped build on the first " + ", ".join(
                f"{m} queries: {ms:.4f}" for m, ms in parts.items()))


if __name__ == "__main__":
    main()
