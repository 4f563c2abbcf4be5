#!/usr/bin/env python3
"""Where the device time of the port's normals, PlaneICP and ICP paths and of
the exact 1-NN oracle goes.

    python3 scripts/profile_port.py        # on a machine with a CUDA card

Builds the seed-42 bench data (1.2M-point map, 100k-point scan), warms each
path once, then traces one ``estimate_normals(map, k=15)``, one
``knn_moments`` call of each of its tiers (the k-NN kernel beside the two
grouping kernels and the sort before it), one
``PlaneICP.set_target(map, norm=normals)`` and one ``align(scan)`` with
``torch.profiler`` and prints, for each, the wall time, the device time
("Self CUDA time total") and the kernels that take most of it. Then one
launch each of ``plane_point_stats`` and ``point_stats`` (ICP's target) at the
scan's known offset and of ``exact_nn`` (4,096 scan points against the map),
whose rows give each kernel's time alone beside the wrapper's other kernels,
and ICP's ``align``. Last, for the exact 1-NN: in how many of the groups of
8 references a query's running minimum improves, per reference segment of
the launch, which is what a locate-on-improvement design would pay. Prints
the card's name and power limit first.
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
from bench import make_city_map, make_scan
from point_cloud_registration_tpu_torch.models import pad_points
from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius
from point_cloud_registration_tpu_torch.ops import normals as nm
from point_cloud_registration_tpu_torch.ops.kernels.exact_nn import exact_nn
from point_cloud_registration_tpu_torch.ops.kernels.knn_normals import knn_moments
from point_cloud_registration_tpu_torch.ops.kernels.point_align import (
    plane_point_stats,
    point_stats,
)
from point_cloud_registration_tpu_torch.ops.normals import estimate_normals
from point_cloud_registration_tpu_torch.ops.pointgrid import build_packed_grid


def traced(label, fn):
    fn()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel rows only: an aten op's row repeats the time of the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"== {label}: wall {wall_ms:.3f} ms untraced, device {total_ms:.3f} ms in "
          f"{sum(e.count for e in rows)} kernels", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_port.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.RandomState(42)
    map_np = make_city_map(rng, 1_200_000)
    scan_np = make_scan(rng, map_np, 100_000)
    map_t = torch.from_numpy(map_np).cuda()
    scan_t = torch.from_numpy(scan_np).cuda()
    traced("estimate_normals(map, k=15)", lambda: estimate_normals(map_t, k=15))
    traced("estimate_normals(map, k=15, exact_tail=False)",
           lambda: estimate_normals(map_t, k=15, exact_tail=False))
    # the two launches of the k-NN moments wrapper, on the queries estimate_normals sends
    _, info = estimate_normals(map_t, k=15, return_info=True)
    pg = build_packed_grid(map_t, info["cell_size"], cap=32, auto_cap=True)
    ones = torch.ones(map_t.shape[0], device="cuda")
    _, _, rk2, unres, exact = knn_moments(pg, map_t, ones, 15, nm.BASE_RADIUS)
    tail = torch.nonzero(~exact & ~unres
                         & (rk2 < float(np.float32((6.0 * pg.cell_fine) ** 2))))[:, 0]
    q_w = map_t[tail].contiguous()
    traced(f"knn_moments, base tier (r = {nm.BASE_RADIUS}, {map_t.shape[0]} queries)",
           lambda: knn_moments(pg, map_t, ones, 15, nm.BASE_RADIUS))
    traced(f"knn_moments, wide tier (r = {nm.WIDE_RADIUS}, {q_w.shape[0]} queries)",
           lambda: knn_moments(pg, q_w, ones[:q_w.shape[0]], 15, nm.WIDE_RADIUS))
    normals = estimate_normals(map_t, k=15)
    solver = pt.PlaneICP(max_iter=30, max_dist=2.0, tol=1e-3, device="cuda")
    traced("PlaneICP.set_target(map, norm=normals)",
           lambda: solver.set_target(map_t, norm=normals))
    traced("PlaneICP.align(scan)", lambda: solver.align(scan_t))
    print("iterations:", solver.last_diagnostics.iterations)
    # one launch of each packed-grid stats kernel at the scan's known offset
    icp = pt.ICP(max_iter=30, max_dist=2.0, tol=1e-3, device="cuda")
    icp.set_target(map_t)
    src, w = pad_points(scan_np, device="cuda")
    R, t = torch.eye(3), torch.tensor([0.0, 0.0, -0.3])
    for label, fn, s in (("plane_point_stats", plane_point_stats, solver),
                         ("point_stats", point_stats, icp)):
        tg = getattr(s._target, "corr", s._target)
        radius = proxy_radius(s.cfg.corr, s.cfg.max_dist)
        traced(f"{label}, {src.shape[0]} queries at t = (0, 0, -0.3)",
               lambda: fn(tg.packed, tg.proxy, src, w, R, t, s.cfg.max_dist, radius,
                          s.cfg.huber_delta))
    traced("ICP.align(scan)", lambda: icp.align(scan_t))
    print("iterations:", icp.last_diagnostics.iterations)
    sel = np.sort(np.random.RandomState(42).choice(len(scan_np), 4096, replace=False))
    q = (scan_t[torch.from_numpy(sel).cuda()] + t.cuda()).contiguous()
    traced(f"exact_nn, {q.shape[0]} queries x {map_t.shape[0]} references",
           lambda: exact_nn(q, map_t))
    improving_groups(q, map_t, segments=66, group=8)


def improving_groups(q, ref, segments: int, group: int) -> None:
    """In how many groups of ``group`` consecutive references the running
    minimum of a query's squared distance improves, each of ``segments``
    equal reference segments starting anew."""
    seg_len = -(-ref.shape[0] // segments)
    total, n_groups, any_of_128 = 0, 0, 0
    for a in range(0, ref.shape[0], seg_len):
        seg = ref[a:a + seg_len]
        seg = seg[:seg.shape[0] // group * group]
        d2 = ((q[:, None, :] - seg[None]) ** 2).sum(-1)
        gmin = d2.reshape(q.shape[0], -1, group).amin(dim=2)
        before = torch.cummin(gmin, dim=1).values
        better = torch.ones_like(gmin, dtype=torch.bool)
        better[:, 1:] = gmin[:, 1:] < before[:, :-1]
        total += int(better.sum())
        n_groups += gmin.shape[1]
        # a warp of 32 lanes x 4 queries walks again if any of its 128 queries improved
        any_of_128 += int(better.reshape(-1, 128, gmin.shape[1]).any(dim=1).sum())
    print(f"== exact_nn, running minimum over groups of {group} in {segments} segments: a query "
          f"improves in {total / q.shape[0] / segments:.2f} of the {n_groups // segments} groups of a "
          f"segment; some query of a warp's 128 improves in "
          f"{any_of_128 / (q.shape[0] // 128) / n_groups:.4f} of the groups")


if __name__ == "__main__":
    main()
