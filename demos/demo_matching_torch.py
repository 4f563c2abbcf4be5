#!/usr/bin/env python3
"""Headless registration demo on the PyTorch/CUDA port: the command line of
demos/demo_matching.py (the JAX package's demo) flag for flag, plus
``--device``.

Generates a synthetic scene (or loads a PCD via --map), perturbs a scan by
the requested initial pose, aligns with the chosen solver, prints the
reference-style result summary, and renders a before/after PNG.

    python3 demos/demo_matching_torch.py --map cloud.pcd --method VPlaneICP
    python3 demos/demo_matching_torch.py --method NDT --x 0.3 --yaw 2.0 --device cpu

It runs on the first CUDA card unless ``--device cpu`` is given; without a
card and without that flag it raises. The same arguments draw the same map
and scan as the JAX demo: the random draws come in the same order.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
for _p in (str(_HERE), str(_HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import point_cloud_registration_tpu_torch as pcr  # noqa: E402
from point_cloud_registration_tpu_torch.core.device import default_device  # noqa: E402
from point_cloud_registration_tpu_torch.utils import read_pcd_xyz  # noqa: E402


def rpy_to_so3(roll, pitch, yaw):
    """Degrees -> rotation matrix (the demo GUI's RPY convention)."""
    r, p, y = np.deg2rad([roll, pitch, yaw])
    Rx = np.array([[1, 0, 0], [0, np.cos(r), -np.sin(r)], [0, np.sin(r), np.cos(r)]])
    Ry = np.array([[np.cos(p), 0, np.sin(p)], [0, 1, 0], [-np.sin(p), 0, np.cos(p)]])
    Rz = np.array([[np.cos(y), -np.sin(y), 0], [np.sin(y), np.cos(y), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def rotation_to_quaternion(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w < 1e-9:
        return np.array([0.0, 0.0, 0.0, 1.0])
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return np.array([x, y, z, w])


def make_demo_scene(rng, n=120_000):
    n4 = n // 4
    floor = np.stack([rng.rand(n4) * 30, rng.rand(n4) * 30, rng.randn(n4) * 0.02], 1)
    wall1 = np.stack([rng.rand(n4) * 30, rng.randn(n4) * 0.02, rng.rand(n4) * 4], 1)
    wall2 = np.stack([rng.randn(n4) * 0.02, rng.rand(n4) * 30, rng.rand(n4) * 4], 1)
    ramp_x = rng.rand(n4) * 10 + 10
    ramp = np.stack(
        [ramp_x, rng.rand(n4) * 10 + 10, 0.3 * (ramp_x - 10) + rng.randn(n4) * 0.02], 1
    )
    return np.vstack([floor, wall1, wall2, ramp]).astype(np.float32)


def demo_device(name: str) -> torch.device:
    """The device of ``--device``: ``"cuda"`` is the first card, which
    ``default_device`` gives or refuses with ``RuntimeError``; any other name
    (``"cpu"``) is taken as given."""
    return default_device() if name == "cuda" else torch.device(name)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"


def clock(dev: torch.device) -> float:
    """Seconds on the host's clock, read after the card's queue has drained."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


SOLVERS = {
    "ICP": lambda a, dev: pcr.ICP(max_iter=a.max_iter, max_dist=a.max_dist, tol=a.tol,
                                  device=dev),
    "PlaneICP": lambda a, dev: pcr.PlaneICP(max_iter=a.max_iter, max_dist=a.max_dist,
                                            tol=a.tol, k=a.k, device=dev),
    "VPlaneICP": lambda a, dev: pcr.VPlaneICP(
        voxel_size=a.voxel_size, max_iter=a.max_iter, max_dist=a.max_dist, tol=a.tol,
        device=dev,
    ),
    "NDT": lambda a, dev: pcr.NDT(
        voxel_size=a.voxel_size, max_iter=a.max_iter, max_dist=a.max_dist, tol=a.tol,
        device=dev,
    ),
    "FastVPlaneICP": lambda a, dev: pcr.FastVPlaneICP(
        voxel_size=a.voxel_size, max_iter=a.max_iter, max_dist=a.max_dist, tol=a.tol,
        device=dev,
    ),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--method", choices=sorted(SOLVERS), default="VPlaneICP")
    ap.add_argument("--map", help="PCD file to use as the map (default: synthetic scene)")
    ap.add_argument("--voxel-size", type=float, default=1.0, dest="voxel_size")
    ap.add_argument("--max-dist", type=float, default=2.0, dest="max_dist")
    ap.add_argument("--max-iter", type=int, default=30, dest="max_iter")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--k", type=int, default=15)
    # initial pose of the scan (the GUI's XYZ + RPY spinboxes)
    ap.add_argument("--x", type=float, default=0.2)
    ap.add_argument("--y", type=float, default=-0.1)
    ap.add_argument("--z", type=float, default=0.3)
    ap.add_argument("--roll", type=float, default=0.0)
    ap.add_argument("--pitch", type=float, default=0.0)
    ap.add_argument("--yaw", type=float, default=1.0)
    ap.add_argument("--scan-points", type=int, default=30_000)
    ap.add_argument("--out", default="demo_matching.png")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the first card; an error without one) or cpu")
    args = ap.parse_args(argv)
    dev = demo_device(args.device)

    rng = np.random.RandomState(0)
    if args.map:
        map_pts = read_pcd_xyz(args.map)
    else:
        map_pts = make_demo_scene(rng)

    R = rpy_to_so3(args.roll, args.pitch, args.yaw)
    t = np.array([args.x, args.y, args.z])
    sel = rng.choice(len(map_pts), min(args.scan_points, len(map_pts)), replace=False)
    scan = (map_pts[sel] @ R.T + t + rng.randn(len(sel), 3) * 0.005).astype(np.float32)

    solver = SOLVERS[args.method](args, dev)
    t0 = clock(dev)
    solver.set_target(map_pts)
    t1 = clock(dev)
    T = solver.align(scan)
    t2 = clock(dev)

    d = solver.last_diagnostics
    Rf, tf = T[:3, :3], T[:3, 3]
    quaternion = rotation_to_quaternion(Rf)
    print(f"method: {args.method}")
    print(f"set_target: {t1 - t0:.3f}s   align: {t2 - t1:.3f}s   iterations: {int(d.iterations)}"
          f"   ({device_name(dev)})")
    print("T =\n", np.array2string(T, precision=5, suppress_small=True))
    print("quaternion (x,y,z,w):", np.round(quaternion, 5))
    print("translation:", np.round(tf, 5))
    print("final e2:", float(d.final_e2), " converged:", bool(d.converged))

    aligned = scan @ np.asarray(Rf).T + tf
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(12, 6))
        ss = slice(0, len(scan), max(1, len(scan) // 8000))
        ms = slice(0, len(map_pts), max(1, len(map_pts) // 20000))
        for ax, cloud, title in [
            (axes[0], scan, "before"),
            (axes[1], aligned, "after"),
        ]:
            ax.scatter(map_pts[ms, 0], map_pts[ms, 1], s=0.3, c="#bbbbbb", label="map")
            ax.scatter(cloud[ss, 0], cloud[ss, 1], s=0.5, c="#cc3333", label="scan")
            ax.set_title(f"{args.method}: {title}")
            ax.set_aspect("equal")
            ax.legend(markerscale=10)
        fig.tight_layout()
        fig.savefig(args.out, dpi=110)
        plt.close(fig)
        print("wrote", args.out)
    except Exception as e:  # rendering is best-effort in headless envs
        print("(skipped plot:", e, ")")

    return {
        "method": args.method, "device": str(dev), "n_map": len(map_pts), "n_scan": len(scan),
        "T": T, "quaternion": quaternion, "translation": tf,
        "iterations": int(d.iterations), "final_e2": float(d.final_e2),
        "converged": bool(d.converged), "solver_failed": bool(d.solver_failed),
        "set_target_s": t1 - t0, "align_s": t2 - t1,
    }


if __name__ == "__main__":
    main()
