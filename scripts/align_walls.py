#!/usr/bin/env python3
"""Time the warm aligns of the port's solvers on one CUDA card, through the
entry points that two trees of the repository share, so that one call can
time a commit beside its parent.

    PYTHONPATH=. python3 scripts/align_walls.py --tag change [--out-dir DIR]
    PYTHONPATH=path/to/parent python3 scripts/align_walls.py --tag parent [--out-dir DIR]
    PYTHONPATH=. python3 scripts/align_walls.py --tag chunks --chunks 1,2,4,8,16,30

``point_cloud_registration_tpu_torch`` and ``bench`` come from the tree on
``PYTHONPATH``. The data of ``chip_smoke.py``: bench.py's seed-42 city map
of 1.2M points and its 100k-point scan (voxel 1, max_dist 2, max_iter 30,
tol 1e-3), and B = 8 scans of 16,384 points (``make_scan(RandomState(100 +
b), map, 16384)``). For VPlaneICP, NDT, ICP and PlaneICP (normals of its
own, estimated in ``set_target``) the warm ``align`` from device-resident
input, and for the batched VPlaneICP and ICP streams the warm batched
align. Then the paths of ``chip_smoke.py`` phases 9 and 10: ICP and
PlaneICP with default configurations on bench.py's 40,000-point LiDAR
target and a 10,000-point scan of it (the ``"grid"`` method), VPlaneICP
and NDT on the city map twice, the copy 3 km away (2.4M points, a hashed
map), with the 100k scan. For each path: the walls of ``--reps`` runs (host
clock; each align ends in its copy to the host), the device time and busy
share of one more by ``torch.profiler``, the host milliseconds per
iteration (the shortest wall less the device time, over the iterations)
and the syncs of one more (``torch.cuda.set_sync_debug_mode("warn")``).
For the four paths of phases 9 and 10 also the grid stats kernel
(``ops/kernels/grid_align``) at the align's converged pose: the time to
bind its launch (``grid_align.resident_stats``) and its time alone, by
the profiler (kernels named ``grid_stats_kernel``), over ``--reps`` * 3
launches. Prints one line per path and the card's name and power limit; with
``--out-dir`` it also appends the numbers to
``DIR/align_walls_<tag>.json``.

With ``--chunks``, a tree whose resident loop has ``core.gn.GN_CHUNK``
instead times every path's warm align at each of the listed chunk lengths,
in ``--reps`` rounds: every length once per round, the order rotating from
round to round; it prints the min and median wall of each length.

Then each path in turns (``TURNS``: VPlaneICP and NDT on the dense map,
ICP and PlaneICP on the packed grid, the grid and hashed paths, the
batched VPlaneICP and ICP streams), ``--reps`` rounds of two aligns: the
tree's own align (one launch of a loop kernel, ``ops/kernels/gn_loop``,
where the tree has one for the path) and the two-launch resident loop
(``core.gn.gauss_newton_device`` and ``batched_gauss_newton_device``
without their ``loop``), the order swapped every round; for each the walls,
the device time and busy share and the syncs, as rows
``<path>_align_turn`` and ``<path>_two_launch_turn``.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import subprocess
import time
import warnings
from pathlib import Path

import numpy as np

SEED, N_MAP, N_SCAN, N_BATCHES, N_BATCH = 42, 1_200_000, 100_000, 8, 16384
N_SMALL, N_SMALL_SCAN = 40_000, 10_000  # chip_smoke.py phase 9
TILE_SHIFT = np.float32([3000.0, 3000.0, 0.0])  # chip_smoke.py phase 10
PARAMS = dict(max_iter=30, max_dist=2.0, tol=1e-3)
# the paths timed in turns through their own align and the two-launch loop
TURNS = ("vplane_icp", "ndt", "icp", "plane_icp", "icp_grid", "plane_icp_grid",
         "vplane_icp_hashed", "ndt_hashed", "batched_vplane_icp", "batched_icp")


def device_ms(fn) -> tuple[float, int]:
    """Device milliseconds and kernels of one call of ``fn`` by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    return sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows)


def syncs(fn) -> int:
    """The times one call of ``fn`` makes the host wait for the card
    (``torch.cuda.set_sync_debug_mode("warn")``); the first switch of the
    mode reports a sync of its own, at its own lines, which is left out."""
    import torch

    torch.cuda.synchronize()
    lines, first = inspect.getsourcelines(torch.cuda.set_sync_debug_mode)
    own = range(first, first + len(lines))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message)
               and not (w.filename == torch.cuda.__file__ and w.lineno in own) for w in caught)


def grid_kernel_ms(s, kind: str, scan_t, reps: int) -> dict:
    """The grid stats kernel of ``kind`` on solver ``s``'s align operands
    at its converged pose: ``{"bind_ms", "alone_ms"}``, the bind by the host
    clock around a synchronize, the launches alone by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from point_cloud_registration_tpu_torch.core.gn import pose_rows_of
    from point_cloud_registration_tpu_torch.models import _fused, _point_fused
    from point_cloud_registration_tpu_torch.models.base import pad_points
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    if kind in ("plane", "ndt"):
        grid, table, offsets = _fused.hashed_operands(s._target, s.cfg, kind)
    else:
        normals = s._target.normals if kind == "plane_pt" else None
        grid, table, offsets = _point_fused.grid_operands(getattr(s._target, "corr", s._target),
                                                          s.cfg, normals)
    src, w = pad_points(scan_t, device=scan_t.device)
    T = torch.as_tensor(s.align(scan_t), dtype=torch.float32)
    poses = pose_rows_of(T[None]).to(scan_t.device)
    bind = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launch = ga.resident_stats(kind, grid, table, src, w, offsets, s.cfg.max_dist,
                                   s.cfg.huber_delta, poses, None)
        torch.cuda.synchronize()
        bind.append(1e3 * (time.perf_counter() - t0))
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if "grid_stats_kernel" in e.key and e.self_device_time_total > 0]
    return {"bind_ms": min(bind), "alone_ms": sum(e.self_device_time_total for e in rows) / 1e3
            / reps}


def two_launch(run):
    """``run()`` with ``core.gn.gauss_newton_device`` and
    ``batched_gauss_newton_device`` taking no whole-loop ``loop``: every
    align in it runs the two-launch resident loop."""
    from point_cloud_registration_tpu_torch.core import gn

    devices = gn.gauss_newton_device, gn.batched_gauss_newton_device

    def stripped(device):
        return lambda *args, loop=None, **kwargs: device(*args, **kwargs)

    gn.gauss_newton_device, gn.batched_gauss_newton_device = map(stripped, devices)
    try:
        return run()
    finally:
        gn.gauss_newton_device, gn.batched_gauss_newton_device = devices


def sweep_chunks(paths: dict, chunks: list, args) -> dict:
    """The warm align walls of every path at each ``GN_CHUNK`` in ``chunks``,
    in ``args.reps`` rotating rounds: ``{path: {chunk: walls_ms}}``."""
    import torch

    from point_cloud_registration_tpu_torch.core import gn

    default = gn.GN_CHUNK
    out = {}
    try:
        for name, run in paths.items():
            walls = {c: [] for c in chunks}
            for c in chunks:  # warm at every length
                gn.GN_CHUNK = c
                run()
            for r in range(args.reps):
                for c in chunks[r % len(chunks):] + chunks[:r % len(chunks)]:
                    gn.GN_CHUNK = c
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    walls[c].append(1e3 * (time.perf_counter() - t0))
            out[name] = {str(c): w for c, w in walls.items()}
            print(f"[{args.tag}] {name}: align ms, min / median of {args.reps} rounds: "
                  + "; ".join(f"chunk {c} {min(w):.3f} / {float(np.median(w)):.3f}"
                              for c, w in walls.items()), flush=True)
    finally:
        gn.GN_CHUNK = default
    return out


def main() -> None:
    import torch

    import point_cloud_registration_tpu_torch as pt
    from bench import make_city_map, make_lidar_map, make_scan
    from point_cloud_registration_tpu_torch.models._fused import fused_voxel_align_batched
    from point_cloud_registration_tpu_torch.models._point_fused import fused_point_align_batched

    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--chunks", default=None,
                    help="comma-separated GN_CHUNK values to time the resident loop at")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("align_walls.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    map_np = make_city_map(rng, N_MAP)
    scan_np = make_scan(rng, map_np, N_SCAN)
    map_t, scan_t = torch.from_numpy(map_np).to(dev), torch.from_numpy(scan_np).to(dev)
    scans = np.stack([make_scan(np.random.RandomState(100 + b), map_np, N_BATCH)
                      for b in range(N_BATCHES)])
    src_b = torch.from_numpy(scans).to(dev)
    w_b = torch.ones(src_b.shape[:2], device=dev)
    eye_b = torch.eye(4).expand(N_BATCHES, 4, 4).clone()

    solvers = {
        "vplane_icp": pt.VPlaneICP(voxel_size=1.0, **PARAMS, device=dev),
        "ndt": pt.NDT(voxel_size=1.0, **PARAMS, device=dev),
        "icp": pt.ICP(**PARAMS, device=dev),
        "plane_icp": pt.PlaneICP(**PARAMS, device=dev),
    }
    paths = {}
    for name, s in solvers.items():
        s.set_target(map_t)
        paths[name] = (lambda s=s: (s.align(scan_t), s.last_diagnostics.iterations))
    vp, icp = solvers["vplane_icp"], solvers["icp"]

    def batched(run):
        Ts, d = run()
        return Ts, int(d.iterations.max())

    paths["batched_vplane_icp"] = lambda: batched(lambda: fused_voxel_align_batched(
        vp._target, src_b, w_b, eye_b, vp.cfg, "plane"))
    paths["batched_icp"] = lambda: batched(lambda: fused_point_align_batched(
        icp._target, None, src_b, w_b, eye_b, icp.cfg, "point"))

    # phase 9's small target (the grid method) and phase 10's hashed map
    rng_small = np.random.RandomState(SEED)
    small = make_lidar_map(rng_small, N_SMALL)
    small_t = torch.from_numpy(small).to(dev)
    small_scan_t = torch.from_numpy(make_scan(rng_small, small, N_SMALL_SCAN)).to(dev)
    two_t = torch.from_numpy(np.vstack([map_np, map_np + TILE_SHIFT])).to(dev)
    grid_solvers = {}
    for name, s, target, scan, kind in (
            ("icp_grid", pt.ICP(**PARAMS, device=dev), small_t, small_scan_t, "point"),
            ("plane_icp_grid", pt.PlaneICP(**PARAMS, device=dev), small_t, small_scan_t,
             "plane_pt"),
            ("vplane_icp_hashed", pt.VPlaneICP(voxel_size=1.0, **PARAMS, device=dev), two_t,
             scan_t, "plane"),
            ("ndt_hashed", pt.NDT(voxel_size=1.0, **PARAMS, device=dev), two_t, scan_t, "ndt")):
        s.set_target(target)
        paths[name] = (lambda s=s, scan=scan: (s.align(scan), s.last_diagnostics.iterations))
        grid_solvers[name] = (s, kind, scan)

    out = {"tag": args.tag, "card": smi, "torch": torch.__version__, "paths": {}}
    print(f"[{args.tag}] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    if args.chunks is not None:
        out["chunks"] = sweep_chunks(paths, [int(c) for c in args.chunks.split(",")], args)
        paths = {}
    turn_walls = {}
    if paths:
        for name in TURNS:
            modes = {f"{name}_align_turn": paths[name],
                     f"{name}_two_launch_turn": functools.partial(two_launch, paths[name])}
            for run in modes.values():
                run()
            for r in range(args.reps):
                for mode in list(modes)[::1 if r % 2 == 0 else -1]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    modes[mode]()
                    turn_walls.setdefault(mode, []).append(1e3 * (time.perf_counter() - t0))
            paths.update(modes)
    for name, run in paths.items():
        run()
        walls = turn_walls.get(name, [])
        for _ in range(0 if walls else args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, its = run()
            walls.append(1e3 * (time.perf_counter() - t0))
        its = run()[1]
        dev_ms, kernels = device_ms(run)
        row = {"walls_ms": walls, "iterations": its, "device_ms": dev_ms, "kernels": kernels,
               "busy": dev_ms / min(walls), "host_ms_per_iteration": (min(walls) - dev_ms) / its,
               "syncs": syncs(run)}
        if name.startswith("batched"):
            row["regs_per_s"] = N_BATCHES / (min(walls) / 1e3)
        if name in grid_solvers:
            s, kind, scan = grid_solvers[name]
            row["grid_kernel"] = grid_kernel_ms(s, kind, scan, 3 * args.reps)
        out["paths"][name] = row
        print(f"[{args.tag}] {name}: {its} iterations; align ms min {min(walls):.3f}, median "
              f"{float(np.median(walls)):.3f} (all {', '.join(f'{x:.3f}' for x in walls)}); "
              f"device {dev_ms:.3f} ms in {kernels} kernels, busy {100 * row['busy']:.1f} %; "
              f"host {row['host_ms_per_iteration']:.3f} ms per iteration; {row['syncs']} syncs"
              + (f"; {row['regs_per_s']:.1f} registrations/s" if "regs_per_s" in row else "")
              + (f"; grid stats kernel: bind {row['grid_kernel']['bind_ms']:.3f} ms, alone "
                 f"{row['grid_kernel']['alone_ms']:.4f} ms" if "grid_kernel" in row else ""),
              flush=True)
    if args.out_dir is not None:
        path = Path(args.out_dir) / f"align_walls_{args.tag}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        runs = json.loads(path.read_text()) if path.is_file() else []
        path.write_text(json.dumps(runs + [out], indent=1))


if __name__ == "__main__":
    main()
