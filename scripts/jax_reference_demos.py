#!/usr/bin/env python3
"""The JAX package's results of the demos on ``chip_smoke.py`` phase 17's data, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_demos.py [matching] [voxels]

The map is ``bench.make_city_map(np.random.RandomState(42), 1_200_000)``,
the cloud that phase 17 writes to a PCD file and reads back bit for bit.

* ``matching``: what ``demos/demo_matching.py --map <that PCD>
  --scan-points 100000`` does at its default pose (x 0.2, y -0.1, z 0.3,
  yaw 1 degree) and the B-01 parameters (voxel 1, max_dist 2, max_iter 30,
  tol 1e-3, k 15): the demo's own draws (``RandomState(0)``: ``choice``,
  then ``randn``) and its ``SOLVERS``, each ``set_target(map)`` then
  ``align(scan)``. PlaneICP estimates its normals in ``set_target`` with the
  JAX package's default on the CPU, the packed-block XLA path
  (``ops/normals.py``, ``backend="auto"`` off a TPU); the port's normals
  equal the k-NN kernel path (``backend="pallas"``), which is too slow to
  interpret at 1.2M points here.
* ``voxels``: what ``demos/demo_visualize_voxels.py --pcd <that PCD>
  --voxel-size 1.0`` computes: ``VoxelGrid(1.0).set_points``, the valid
  voxels, the mean, max and sum of their counts, ``voxel_filter``'s row
  count and the SHA-256 of ``color_by_voxel``'s ``irgb``.

Prints ``DEMO_REF``, the dict ``chip_smoke.py`` holds phase 17 to, and the
run time.
"""

import argparse
import hashlib
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "demos")]

import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

import point_cloud_registration_tpu as pcr
from bench import make_city_map
from demo_matching import SOLVERS, rpy_to_so3

N_MAP, N_SCAN = 1_200_000, 100_000
DEMO_ARGS = argparse.Namespace(voxel_size=1.0, max_dist=2.0, max_iter=30, tol=1e-3, k=15,
                               x=0.2, y=-0.1, z=0.3, roll=0.0, pitch=0.0, yaw=1.0)


def demo_scan(map_np: np.ndarray) -> np.ndarray:
    """The scan of ``demo_matching.py --map``: its draws, in its order."""
    a = DEMO_ARGS
    rng = np.random.RandomState(0)
    R = rpy_to_so3(a.roll, a.pitch, a.yaw)
    t = np.array([a.x, a.y, a.z])
    sel = rng.choice(len(map_np), min(N_SCAN, len(map_np)), replace=False)
    return (map_np[sel] @ R.T + t + rng.randn(len(sel), 3) * 0.005).astype(np.float32)


def matching(map_np: np.ndarray) -> dict:
    scan = demo_scan(map_np)
    out = {}
    for method in ("VPlaneICP", "NDT", "ICP", "PlaneICP", "FastVPlaneICP"):
        t0 = time.perf_counter()
        solver = SOLVERS[method](DEMO_ARGS)
        solver.set_target(map_np)
        T = np.asarray(solver.align(scan), np.float64)
        d = solver.last_diagnostics
        out[method] = {"iterations": int(d.iterations), "converged": bool(d.converged),
                       "T": T[:3].tolist()}
        print(f"{method}: iterations {int(d.iterations)}, converged {bool(d.converged)}, "
              f"solver_failed {bool(d.solver_failed)}, final e2 {float(d.final_e2)}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def voxels(map_np: np.ndarray) -> dict:
    t0 = time.perf_counter()
    vg = pcr.VoxelGrid(1.0)
    vg.set_points(map_np)
    counts = np.asarray(vg._compacted("count"))
    filtered = pcr.voxel_filter(map_np, 1.0)
    irgb = np.ascontiguousarray(pcr.color_by_voxel(map_np, 1.0)["irgb"], dtype="<u4")
    out = {"n_valid": int(len(vg.mean)), "min_points": int(vg.min_points),
           "count_mean": float(counts.mean()), "count_max": int(counts.max()),
           "count_sum": int(counts.sum()), "n_filtered": int(len(filtered)),
           "irgb_sha256": hashlib.sha256(irgb.tobytes()).hexdigest()}
    print(f"voxels: {out}, {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> None:
    phases = sys.argv[1:] or ["matching", "voxels"]
    t0 = time.perf_counter()
    map_np = make_city_map(np.random.RandomState(42), N_MAP)
    ref = {}
    if "matching" in phases:
        ref.update(matching(map_np))
    if "voxels" in phases:
        ref["voxels"] = voxels(map_np)
    print("PlaneICP normals: the JAX package's CPU default, the packed-block XLA path "
          "(estimate_normals backend='auto' off a TPU)")
    np.set_printoptions(precision=10, linewidth=160)
    print("DEMO_REF =", repr(ref))
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
