#!/usr/bin/env python3
"""Where the time of the grid stats kernel (``csrc/grid_align.cu``) goes,
on a CUDA card.

    python3 scripts/grid_stats_ablation.py [--out-dir DIR]
    python3 scripts/grid_stats_ablation.py --walls [--out-dir DIR]

On the data of ``chip_smoke.py`` phases 9 and 10 (ICP and PlaneICP with
default configurations on bench.py's seed-42 40,000-point LiDAR target and
a 10,000-point scan of it; VPlaneICP and NDT on the city map twice, the
copy 3 km away, 2.4M points hashed, with the 100k scan), at each align's
converged pose, it times each kind's kernel alone by the profiler
(kernels named ``grid_stats_kernel``, 20 launches of the bound launch):

* the shipped build, first and last (the spread of the call);
* builds of the source with one textual substitution each: other lanes per
  query (``kGridLanes``, 32, for the grid kinds: 4, 8, 16;
  ``kHashedLanes``, 2, for the hashed ones: 1, 4, 8), other register
  budgets (``kGridMinBlocks``, 3 blocks of 256 threads an SM: 2, 4;
  ``kHashedMinBlocks``, 2: 1, 3) or no such hint, a sampled key index of
  128, 2,048 or 8,192 keys instead of 512 (``kSampleMax``), the pose held
  in registers instead of shared memory, blocks of 128 threads
  (``kThreads``);
* builds with two or three substitutions: blocks of 128 threads with the
  grid kinds' budget at 5 or 6 blocks an SM and 16 or 32 lanes, and the
  grid kinds' constants before the scan lost its order (2 blocks, 8
  lanes);
* the shipped build on the scan ordered by cell (:func:`cell_order`: the
  kernel reads the queries in the caller's order) and with ``MAX_BLOCKS``
  512 and 2,048.

Every variant computes the same function: its winners and squared
distances at the converged pose are held to ``grid_align.plain_matches``
bit for bit before it is timed. A substitution whose pattern is no longer
in the source once stops the script.

With ``--walls`` it builds no variant and instead asks whether ordering
the scan by cell pays end to end: it times the four warm aligns whole
(``align`` from device-resident input to T on the host, by the host clock
after a synchronize) on the scan in its input order and on the scan
ordered by cell in the caller (:func:`cell_order` and a gather, inside the
timed call), the two in turns, ``--reps`` aligns each; then for each the
device time of one align by the profiler.

Prints the card's name and power limit first; with ``--out-dir`` the
numbers also go to ``DIR/grid_stats_ablation.json`` (``--walls``:
``DIR/grid_stats_walls.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

SEED, N_MAP, N_SCAN = 42, 1_200_000, 100_000
N_SMALL, N_SMALL_SCAN = 40_000, 10_000
TILE_SHIFT = np.float32([3000.0, 3000.0, 0.0])
PARAMS = dict(max_iter=30, max_dist=2.0, tol=1e-3)
REPS = 20
LANES = {"kGridLanes": (32, ("point", "plane_pt"), (4, 8, 16)),
         "kHashedLanes": (2, ("plane", "ndt"), (1, 4, 8))}
VARIANTS = {
    **{f"{n} lanes per query ({', '.join(kinds)})": [(f"{const} = {now};", f"{const} = {n};")]
       for const, (now, kinds, others) in LANES.items() for n in others},
    **{f"at least {b} blocks per SM, grid kinds": [
        ("kGridMinBlocks = 3;", f"kGridMinBlocks = {b};")] for b in (2, 4)},
    **{f"at least {b} blocks per SM, hashed kinds": [
        ("kHashedMinBlocks = 2;", f"kHashedMinBlocks = {b};")] for b in (1, 3)},
    "no register hint": [("__launch_bounds__(kThreads, min_blocks_of(kKind))",
                          "__launch_bounds__(kThreads)")],
    **{f"sampled index of {n:,} keys": [("kSampleMax = 512;", f"kSampleMax = {n};")]
       for n in (128, 2048, 8192)},
    "the pose in registers": [("grid_block_stats<kKind>(ix, tb, src, w, n, pose_s,",
                               "grid_block_stats<kKind>(ix, tb, src, w, n, pcr::load_pose(pose),")],
    "blocks of 128 threads": [("kThreads = 256;", "kThreads = 128;")],
    # the grid kinds' occupancy and lanes together: blocks of 128 threads,
    # the register budget that lets an SM hold 640-768 of them
    **{f"blocks of 128 threads, at least {b} an SM, {n} grid lanes": [
        ("kThreads = 256;", "kThreads = 128;"), ("kGridMinBlocks = 3;", f"kGridMinBlocks = {b};"),
        ("kGridLanes = 32;", f"kGridLanes = {n};")]
       for b in (5, 6) for n in (16, 32)},
    "two blocks per SM and 8 lanes, grid kinds (before the scan lost its order)": [
        ("kGridMinBlocks = 3;", "kGridMinBlocks = 2;"), ("kGridLanes = 32;", "kGridLanes = 8;")],
}


def build_variants() -> dict:
    """``{variant: {kind: (C function, queries per block)}}``, one nvcc each,
    all started together."""
    from point_cloud_registration_tpu_torch.ops.kernels import _build
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    # the kernel and its stats body: a variant's copies of both, side by side,
    # so that the copy's include finds the changed body first
    files = {name: (_build.CSRC_DIR / name).read_text()
             for name in ("grid_align.cu", "grid_stats.cuh")}
    out_dir = _build.BUILD_ROOT / "grid_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        texts = dict(files)
        for old, new in cuts:
            where = [f for f, text in texts.items() if old in text]
            if len(where) != 1 or texts[where[0]].count(old) != 1:
                raise RuntimeError(f"{name}: pattern {old!r} is not in the sources once")
            texts[where[0]] = texts[where[0]].replace(old, new)
        stem = "".join(c if c.isalnum() else "_" for c in name)
        (out_dir / stem).mkdir(exist_ok=True)
        for f, text in texts.items():
            (out_dir / stem / f).write_text(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
               str(out_dir / f"{stem}.so"), str(out_dir / stem / "grid_align.cu")]
        procs[name] = (out_dir / f"{stem}.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.split("Used ")[1].split(",")[0] for line in log.splitlines()
                if "Used" in line and "registers" in line]
        spills = [line.strip() for line in log.splitlines() if "spill" in line
                  and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        print(f"built: {name}: {'; '.join(regs)}{' (' + '; '.join(spills) + ')' if spills else ''}",
              flush=True)
        lib = ctypes.CDLL(str(path))
        libs[name] = {kind: ga._bind(lib, kind) for kind in ga._C_SYMBOLS}
    return libs


def alone_ms(launch, tries: int = 3) -> float:
    """Device ms per launch by the profiler; a trace that holds no
    ``grid_stats_kernel`` (the profiler drops one now and then) is logged
    and taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                launch()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if "grid_stats_kernel" in e.key and e.self_device_time_total > 0]
        if rows:
            return sum(e.self_device_time_total for e in rows) / 1e3 / REPS
        print(f"[profiler] trace {attempt} of {tries} holds no grid_stats_kernel", flush=True)
    raise AssertionError(f"the profiler saw no grid_stats_kernel in {tries} traces")


def cases(dev) -> dict:
    """``{kind: ((grid, table, src, w, offsets, T, cfg), (solver, scan))}``
    at each align's converged pose."""
    import point_cloud_registration_tpu_torch as pt
    from bench import make_city_map, make_lidar_map, make_scan
    from point_cloud_registration_tpu_torch.models import _fused, _point_fused
    from point_cloud_registration_tpu_torch.models.base import pad_points

    rng = np.random.RandomState(SEED)
    map_np = make_city_map(rng, N_MAP)
    scan_t = torch.from_numpy(make_scan(rng, map_np, N_SCAN)).to(dev)
    two_t = torch.from_numpy(np.vstack([map_np, map_np + TILE_SHIFT])).to(dev)
    rng_small = np.random.RandomState(SEED)
    small = make_lidar_map(rng_small, N_SMALL)
    small_scan_t = torch.from_numpy(make_scan(rng_small, small, N_SMALL_SCAN)).to(dev)
    small_t = torch.from_numpy(small).to(dev)
    out = {}
    for kind, s, target, scan in (
            ("point", pt.ICP(**PARAMS, device=dev), small_t, small_scan_t),
            ("plane_pt", pt.PlaneICP(**PARAMS, device=dev), small_t, small_scan_t),
            ("plane", pt.VPlaneICP(voxel_size=1.0, **PARAMS, device=dev), two_t, scan_t),
            ("ndt", pt.NDT(voxel_size=1.0, **PARAMS, device=dev), two_t, scan_t)):
        s.set_target(target)
        T = torch.as_tensor(s.align(scan), dtype=torch.float32)
        if kind in ("plane", "ndt"):
            grid, table, offsets = _fused.hashed_operands(s._target, s.cfg, kind)
        else:
            normals = s._target.normals if kind == "plane_pt" else None
            grid, table, offsets = _point_fused.grid_operands(
                getattr(s._target, "corr", s._target), s.cfg, normals)
        src, w = pad_points(scan, device=dev)
        out[kind] = ((grid, table, src, w, offsets, T, s.cfg), (s, scan))
    return out


def cell_order(src: torch.Tensor, w: torch.Tensor, cell_size: float) -> torch.Tensor:
    """(n,) int64 on the card: the scan's points by their own cell
    ``floor(p / cell_size)``, by the float64 key ``cx + 2^17 cy + 2^34 cz``
    (z, then y, then x), points of weight 0 last, equal keys in input order
    (a stable sort). A rigid pose keeps neighbours together, so queries next
    to each other in this order look in overlapping windows at every
    pose."""
    weights = torch.tensor([1.0, 2.0 ** 17, 2.0 ** 34], dtype=torch.float64,
                           device=src.device)
    key = torch.div(src, float(cell_size), rounding_mode="floor").double() @ weights
    key.masked_fill_(w == 0, float("inf"))
    return torch.sort(key, stable=True).indices


def walls(data: dict, reps: int) -> dict:
    """``{kind: {variant: {"walls_ms", "device_ms"}}}``: each kind's warm
    align on the scan in its input order and ordered by cell in the caller,
    in turns (the first variant alternating from round to round)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for kind, ((grid, *_), (s, scan)) in data.items():
        ones = torch.ones(scan.shape[0], device=scan.device)
        variants = {"input order": lambda: s.align(scan),
                    "ordered by cell in the caller": lambda: s.align(
                        scan[cell_order(scan, ones, grid.cell_size)])}
        res = {name: {"walls_ms": []} for name in variants}
        for run in variants.values():  # warm
            run()
        for r in range(reps):
            for name in (list(variants) if r % 2 == 0 else list(variants)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                variants[name]()
                res[name]["walls_ms"].append(1e3 * (time.perf_counter() - t0))
        for name, run in variants.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            res[name]["device_ms"] = sum(e.self_device_time_total
                                         for e in prof.key_averages()) / 1e3
        out[kind] = res
        print(f"walls {kind}: " + "; ".join(
            f"{name}: align ms min {min(v['walls_ms']):.3f}, median "
            f"{float(np.median(v['walls_ms'])):.3f}, device {v['device_ms']:.3f}"
            for name, v in res.items()), flush=True)
    return out


def time_kind(case, kind: str, ordered: bool = False) -> float:
    """The kind's kernel (as ``grid_align`` binds it now) alone, after its
    winners are held to the plain query's; with ``ordered``, on the scan
    ordered by :func:`cell_order`."""
    from point_cloud_registration_tpu_torch.core.gn import pose_rows_of
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    (grid, table, src, w, offsets, T, cfg), _ = case
    if ordered:
        order = cell_order(src, w, grid.cell_size)
        src, w = src[order].contiguous(), w[order].contiguous()
    n, dev = src.shape[0], src.device
    idx, d2 = torch.empty(n, dtype=torch.int32, device=dev), torch.empty(n, device=dev)
    ga.resident_launch(kind, grid, table, src, w, offsets, pose_rows_of(T[None]).to(dev), None,
                       cfg.max_dist, cfg.huber_delta, (idx, d2))()
    idx_p, d2_p = ga.plain_matches(grid, table, src, T[:3, :3], T[:3, 3], offsets)
    if not (torch.equal(idx, idx_p) and torch.equal(d2, d2_p)):
        raise AssertionError(f"{kind}: winners differ from the plain query's")
    launch = ga.resident_launch(kind, grid, table, src, w, offsets,
                                pose_rows_of(T[None]).to(dev), None, cfg.max_dist,
                                cfg.huber_delta)
    return alone_ms(launch)


def main() -> None:
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--walls", action="store_true",
                    help="time the aligns whole with the scan ordered and unordered, no builds")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("grid_stats_ablation.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    from point_cloud_registration_tpu_torch.ops.kernels import _build

    _build.build_all(["grid_align"])
    report = (_build.library_path("grid_align").parent / "nvcc.log").read_text().splitlines()
    if args.walls:
        result = walls(cases(dev), args.reps)
        if args.out_dir is not None:
            path = Path(args.out_dir) / "grid_stats_walls.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps({"card": smi, "reps": args.reps, "walls": result},
                                       indent=1))
        return
    print("shipped build: " + "; ".join(line.split(": ", 1)[-1].strip() for line in report
                                        if "registers" in line or "spill" in line), flush=True)
    libs = build_variants()
    data = cases(dev)
    shipped = ga._kernel_fn
    results = {}

    def run(label: str, bound=None, ordered: bool = False) -> None:
        ga._kernel_fn = (lambda kind: bound[kind]) if bound is not None else shipped
        try:
            results[label] = {kind: time_kind(case, kind, ordered)
                              for kind, case in data.items()}
        finally:
            ga._kernel_fn = shipped
        print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in results[label].items())
              + " ms", flush=True)

    run("shipped")
    for name, bound in libs.items():
        run(name, bound)
    run("scan ordered by cell", ordered=True)
    default_blocks = ga.MAX_BLOCKS
    for blocks in (512, 2048):
        ga.MAX_BLOCKS = blocks
        try:
            run(f"MAX_BLOCKS {blocks}")
        finally:
            ga.MAX_BLOCKS = default_blocks
    run("shipped, again")
    if args.out_dir is not None:
        path = Path(args.out_dir) / "grid_stats_ablation.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"card": smi, "reps": REPS, "ms_alone": results}, indent=1))


if __name__ == "__main__":
    main()
