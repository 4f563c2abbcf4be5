#!/usr/bin/env python3
"""Headless normal-estimation demo on the PyTorch/CUDA port: the command
line of demos/demo_estimate_normals.py (the JAX package's demo) plus
``--device``. Estimates k-NN PCA normals (the k-NN moments kernel on a card)
and renders the cloud colored by |n_z| plus a sparse quiver of normal
segments (via get_norm_lines) to a PNG.

    python3 demos/demo_estimate_normals_torch.py [--pcd cloud.pcd] [--k 15] [--device cpu]

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
    ap.add_argument("--k", type=int, default=15)
    ap.add_argument("--out", default="demo_normals.png")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the first card; an error without one) or cpu")
    args = ap.parse_args(argv)
    dev = demo_device(args.device)

    if args.pcd:
        pts = read_pcd_xyz(args.pcd)
    else:
        pts = make_demo_scene(np.random.RandomState(1), n=60_000)

    t0 = clock(dev)
    normals = pcr.estimate_normals(pts, k=args.k, device=dev)
    seconds = clock(dev) - t0
    print(f"estimated {len(pts)} normals in {seconds:.3f}s   ({device_name(dev)})")

    step = max(1, len(pts) // 400)
    lines = pcr.get_norm_lines(pts[::step], normals[::step], length=0.5)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(9, 8))
        ss = slice(0, len(pts), max(1, len(pts) // 30000))
        sc = ax.scatter(
            pts[ss, 0], pts[ss, 2], s=0.4, c=np.abs(normals[ss, 2]), cmap="viridis"
        )
        for i in range(0, len(lines), 2):
            ax.plot(lines[i : i + 2, 0], lines[i : i + 2, 2], "r-", lw=0.6)
        fig.colorbar(sc, label="|n_z|")
        ax.set_xlabel("x")
        ax.set_ylabel("z")
        ax.set_title(f"k-NN PCA normals (k={args.k}) — side view")
        fig.tight_layout()
        fig.savefig(args.out, dpi=110)
        plt.close(fig)
        print("wrote", args.out)
    except Exception as e:  # rendering is best-effort in headless envs
        print("(skipped plot:", e, ")")

    return {"device": str(dev), "n_points": len(pts), "normals": normals, "lines": lines,
            "seconds": seconds}


if __name__ == "__main__":
    main()
