#!/usr/bin/env python3
"""Where the time of the port's batched aligns goes, on one CUDA card.

    python3 scripts/profile_batched_port.py

bench.py's batched protocol (the seed-42 city map, 1.2M points; B = 8 scans
of 16,384 points, ``make_scan(RandomState(100 + b), map, 16384)``; B-01
parameters) through ``models._fused.fused_voxel_align_batched`` (VPlaneICP's
target) and ``models._point_fused.fused_point_align_batched`` (ICP's). For
each: the warm wall time of one batched align; the device time and the top
kernels by ``torch.profiler``; the host time of the loop's parts by
``cProfile`` over 20 aligns (the stats call with its launch, sums and copy;
the batched solve; the per-problem norms and updates), and one batched
launch alone by the profiler.
"""

import cProfile
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import point_cloud_registration_tpu_torch as pt
from bench import make_city_map, make_scan
from point_cloud_registration_tpu_torch.models._fused import fused_voxel_align_batched
from point_cloud_registration_tpu_torch.models._point_fused import fused_point_align_batched
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

PARAMS = dict(max_iter=30, max_dist=2.0, tol=1e-3)
B, N = 8, 16384


def device_rows(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


def report(label, align, launch):
    align()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        align()
        walls.append(1e3 * (time.perf_counter() - t0))
    rows = device_rows(align)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"== {label}: warm wall ms {', '.join(f'{x:.2f}' for x in walls)}; device "
          f"{device_ms:.3f} ms in {sum(e.count for e in rows)} kernels (busy "
          f"{100 * device_ms / min(walls):.1f} %)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")
    launch()
    rows = device_rows(lambda: [launch() for _ in range(10)])
    kernel = [e for e in rows if "stats_kernel" in e.key]
    print(f"   one batched launch alone: {kernel[0].self_device_time_total / 1e3 / 10:.4f} ms "
          f"(profiler, mean of 10)")
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(20):
        align()
    prof.disable()
    stats = pstats.Stats(prof)
    stats.sort_stats("cumulative").print_stats(
        r"batched_gauss_newton|stats_all|solve_6x6_batched|_launch_batched|sum_partials|"
        r"pose_rows|stats_from_packed|\bplus\b|linalg_vector_norm|method 'cpu'")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_batched_port.py needs a CUDA card")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    rng = np.random.RandomState(42)
    map_np = make_city_map(rng, 1_200_000)
    scans = np.stack([make_scan(np.random.RandomState(100 + b), map_np, N) for b in range(B)])
    src = torch.from_numpy(scans).to(dev)
    w = torch.ones((B, N), device=dev)
    eye = torch.eye(4).expand(B, 4, 4).clone()
    vp = pt.VPlaneICP(voxel_size=1.0, **PARAMS, device=dev)
    vp.set_target(map_np)
    vm = vp._target
    R, t = eye[:, :3, :3], eye[:, :3, 3]
    report("batched VPlaneICP",
           lambda: fused_voxel_align_batched(vm, src, w, eye, vp.cfg, "plane"),
           lambda: fa.fused_plane_stats_batched(vm.cells, vm.origin_cell, vm.dims, vm.cell_size,
                                                src, w, R, t, vp.cfg.max_dist))
    icp = pt.ICP(**PARAMS, device=dev)
    icp.set_target(map_np)
    tg = icp._target
    from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius

    report("batched ICP",
           lambda: fused_point_align_batched(tg, None, src, w, eye, icp.cfg, "point"),
           lambda: pa.point_stats_batched(tg.packed, tg.proxy, src, w, R, t, icp.cfg.max_dist,
                                          proxy_radius(icp.cfg.corr, icp.cfg.max_dist)))


if __name__ == "__main__":
    main()
