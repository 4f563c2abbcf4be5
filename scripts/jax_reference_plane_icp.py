#!/usr/bin/env python3
"""The JAX package's PlaneICP result on the seeded bench data, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_plane_icp.py

Builds ``bench.make_city_map`` / ``make_scan`` (seed 42, 1.2M-point map,
100k-point scan), estimates the map's normals with the JAX package
(``estimate_normals(k=15)``: the gather path off the TPU), builds the
PlaneICP target with them and aligns (``max_iter 30, max_dist 2, tol 1e-3``).
Prints rows 0-2 of T and the iteration count: the ``T_REF_PLANE_ICP`` and
iteration count that ``chip_smoke.py`` holds the port's PlaneICP path to.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from bench import make_city_map, make_scan
from point_cloud_registration_tpu.core.config import PlaneICPConfig
from point_cloud_registration_tpu.models.base import pad_points
from point_cloud_registration_tpu.models.plane_icp import build_plane_icp_target, plane_icp_align
from point_cloud_registration_tpu.ops.normals import estimate_normals


def main() -> None:
    rng = np.random.RandomState(42)
    map_np = make_city_map(rng, 1_200_000)
    scan_np = make_scan(rng, map_np, 100_000)
    cfg = PlaneICPConfig(max_iter=30, max_dist=2.0, tol=1e-3, k=15)
    t0 = time.perf_counter()
    normals = jax.block_until_ready(estimate_normals(map_np, k=cfg.k))
    print(f"normals: {time.perf_counter() - t0:.1f} s", flush=True)
    target = build_plane_icp_target(map_np, cfg, normals=normals)
    src, w = pad_points(scan_np)
    res = plane_icp_align(target, src, w, jnp.eye(4, dtype=jnp.float32), cfg)
    T = np.asarray(res.T, np.float64)
    np.set_printoptions(precision=10, linewidth=160)
    print("iterations:", int(res.diagnostics.iterations), "converged:",
          bool(res.diagnostics.converged))
    print(repr(T[:3]))
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
