#!/usr/bin/env python3
"""Headless voxel-map demo on the PyTorch/CUDA port: the command line of
demos/demo_visualize_voxels.py (the JAX package's demo) plus ``--device``.
Prints voxel-map statistics and renders the per-voxel coloring to a PNG.

    python3 demos/demo_visualize_voxels_torch.py [--pcd cloud.pcd] [--voxel-size 1.0] [--device cpu]

It runs on the first CUDA card unless ``--device cpu`` is given; without a
card and without that flag it raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
# demo_matching_torch also puts the repository's root on sys.path
from demo_matching_torch import clock, demo_device, device_name, make_demo_scene  # noqa: E402

import point_cloud_registration_tpu_torch as pcr  # noqa: E402
from point_cloud_registration_tpu_torch.utils import read_pcd_xyz  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pcd", help="input PCD (default: synthetic scene)")
    ap.add_argument("--voxel-size", type=float, default=1.0, dest="voxel_size")
    ap.add_argument("--out", default="demo_voxels.png")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the first card; an error without one) or cpu")
    args = ap.parse_args(argv)
    dev = demo_device(args.device)

    if args.pcd:
        pts = read_pcd_xyz(args.pcd)
    else:
        pts = make_demo_scene(np.random.RandomState(2), n=80_000)

    t0 = clock(dev)
    vg = pcr.VoxelGrid(args.voxel_size, device=dev)
    vg.set_points(pts)
    seconds = clock(dev) - t0
    print(f"voxelized {len(pts)} points in {seconds:.3f}s   ({device_name(dev)})")
    n_valid = len(vg.mean)
    print(f"valid voxels (>= {vg.min_points} points): {n_valid}")
    counts = vg._compacted("count")
    print(f"points per voxel: mean {counts.mean():.1f}, max {counts.max()}")
    filtered = pcr.voxel_filter(pts, args.voxel_size, device=dev)
    print(f"voxel_filter: {len(pts)} -> {len(filtered)} points")

    rec = pcr.color_by_voxel(pts, args.voxel_size, device=dev)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        rgb = rec["irgb"]
        colors = (
            np.stack([(rgb >> 16) & 255, (rgb >> 8) & 255, rgb & 255], axis=1) / 255.0
        )
        fig, axes = plt.subplots(1, 2, figsize=(13, 6))
        ss = slice(0, len(pts), max(1, len(pts) // 40000))
        axes[0].scatter(pts[ss, 0], pts[ss, 1], s=0.4, c=colors[ss])
        axes[0].set_title("points colored by voxel")
        axes[0].set_aspect("equal")
        axes[1].scatter(filtered[:, 0], filtered[:, 1], s=0.8, c="#336699")
        axes[1].set_title(f"voxel_filter output ({len(filtered)} pts)")
        axes[1].set_aspect("equal")
        fig.tight_layout()
        fig.savefig(args.out, dpi=110)
        plt.close(fig)
        print("wrote", args.out)
    except Exception as e:  # rendering is best-effort in headless envs
        print("(skipped plot:", e, ")")

    return {"device": str(dev), "n_points": len(pts), "min_points": vg.min_points,
            "n_valid": n_valid, "count_mean": float(counts.mean()),
            "count_max": int(counts.max()), "counts": counts, "filtered": filtered,
            "irgb": np.asarray(rec["irgb"]), "seconds": seconds}


if __name__ == "__main__":
    main()
