#!/usr/bin/env python3
"""Where the time of the port's hashed-grid paths goes, on the card.

    python3 scripts/profile_grid.py        # on a machine with a CUDA card

On the data of ``chip_smoke.py`` phases 9-12 (seeded ``bench`` data), warms
each path once, times one untraced call by the host clock (ending in a
synchronize), then traces one call with ``torch.profiler`` and prints its
wall time, its device time (the kernels' self time), the device's busy
share (device time over the untraced call's wall time: tracing slows the
host, not the kernels), the kernel launches and the kernels that take most
of the device time:

* ICP and PlaneICP ``align`` on the 40,000-point LiDAR target (the grid
  method), and one grid stats call (``fused_point_stats``) of each;
* VPlaneICP and NDT ``set_target`` and ``align`` on the 2.4M-point hashed
  map (two city tiles 3 km apart), and one hashed stats call;
* VPlaneICP ``update_target`` (600k points into a 600k-point map) and the
  ``align`` after it;
* ``KDTree(map)``, ``query(scan, k=1)``, ``VoxelGrid.query(scan)`` and
  ``voxel_filter(map, 0.5)`` on the 1.2M-point city map.

Prints the card's name and power limit first.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import point_cloud_registration_tpu_torch as pt
from bench import make_city_map, make_lidar_map, make_scan
from point_cloud_registration_tpu_torch.models import pad_points
from point_cloud_registration_tpu_torch.models._fused import fused_voxel_stats
from point_cloud_registration_tpu_torch.models._point_fused import fused_point_stats

PARAMS = dict(max_iter=30, max_dist=2.0, tol=1e-3)


def traced(label, fn):
    fn()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    traced_ms = 1e3 * (time.perf_counter() - t0)
    # kernel rows only: an aten op's row repeats the time of the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"== {label}: wall {wall_ms:.3f} ms untraced ({traced_ms:.3f} traced), device "
          f"{total_ms:.3f} ms in {sum(e.count for e in rows)} kernels (busy "
          f"{100 * total_ms / wall_ms:.1f} % of the untraced wall)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_grid.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.RandomState(42)
    small = make_lidar_map(rng, 40_000)
    small_scan = make_scan(rng, small, 10_000)
    small_t, small_scan_t = torch.from_numpy(small).to(dev), torch.from_numpy(small_scan).to(dev)
    for name, cls, kind in (("ICP", pt.ICP, "point"), ("PlaneICP", pt.PlaneICP, "plane_pt")):
        s = cls(**PARAMS, device=dev)
        traced(f"{name}.set_target(40k LiDAR target)", lambda: s.set_target(small_t))
        T = torch.as_tensor(s.align(small_scan_t), dtype=torch.float32)
        traced(f"{name}.align(10k scan), grid method, {s.last_diagnostics.iterations} it.",
               lambda: s.align(small_scan_t))
        corr = getattr(s._target, "corr", s._target)
        normals = getattr(s._target, "normals", None)
        src, w = pad_points(small_scan_t, device=dev)
        traced(f"{name} one grid stats call", lambda: fused_point_stats(
            corr, src, w, T, s.cfg, kind, normals))

    rng = np.random.RandomState(42)
    map_np = make_city_map(rng, 1_200_000)
    scan_np = make_scan(rng, map_np, 100_000)
    map_t, scan_t = torch.from_numpy(map_np).to(dev), torch.from_numpy(scan_np).to(dev)
    two_t = torch.cat([map_t, map_t + torch.tensor([3000.0, 3000.0, 0.0], device=dev)])
    for name, cls, kind in (("VPlaneICP", pt.VPlaneICP, "plane"), ("NDT", pt.NDT, "ndt")):
        s = cls(voxel_size=1.0, **PARAMS, device=dev)
        traced(f"{name}.set_target(2.4M points, hashed)", lambda: s.set_target(two_t))
        T = torch.as_tensor(s.align(scan_t), dtype=torch.float32)
        traced(f"{name}.align(100k scan) on the hashed map, {s.last_diagnostics.iterations} it.",
               lambda: s.align(scan_t))
        src, w = pad_points(scan_t, device=dev)
        traced(f"{name} one hashed stats call", lambda: fused_voxel_stats(
            s._target, src, w, T, s.cfg, kind))

    perm = torch.from_numpy(np.random.RandomState(7).permutation(len(map_np))).to(dev)
    part_a, part_b = map_t[perm[:600_000]], map_t[perm[600_000:]]
    s = pt.VPlaneICP(voxel_size=1.0, **PARAMS, device=dev)

    def update():
        s.set_target(part_a)
        s.update_target(part_b)

    traced("VPlaneICP.set_target(600k) + update_target(600k)", update)
    traced("VPlaneICP.align(100k scan) after update_target", lambda: s.align(scan_t))

    traced("KDTree(1.2M map)", lambda: pt.KDTree(map_t))
    tree = pt.KDTree(map_t)
    traced("KDTree.query(100k scan, k=1)", lambda: tree.query(scan_t, k=1))
    vg = pt.VoxelGrid(1.0, device=dev)
    vg.set_points(map_t)
    vg.calc_icov()
    traced("VoxelGrid.query(100k scan, mean/norm/icov)",
           lambda: vg.query(scan_t, ["mean", "norm", "icov"]))
    traced("voxel_filter(1.2M map, 0.5)", lambda: pt.voxel_filter(map_t, 0.5))


if __name__ == "__main__":
    main()
