#!/usr/bin/env python3
"""The JAX package's multi-device results on the data of ``chip_smoke.py`` phase 16,
on the CPU with eight virtual devices.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_parallel.py [phase ...]

Phases (all by default), each on seeded ``bench`` data: the city map
(``make_city_map``, seed 42, 1.2M points), its 100k scan and the B-01
parameters (max_iter 30, max_dist 2, tol 1e-3, voxel 1 m):

* ``sharded``: ``parallel.align_sharded`` on ``make_mesh(batch=1, data=4)``
  for VPlaneICP, NDT, ICP (the packed method at 1.2M points) and PlaneICP
  (its own normals), the scan padded by ``pad_points``;
* ``fused``: ``parallel.align_batched_fused_sharded`` on ``make_mesh(2, 2)``
  (B = 8 folds over all four devices), kinds plane, ndt, point and
  plane_pt, Pallas in interpret mode, on the bench's batched scans
  ``make_scan(RandomState(100 + b), map, 16384)``: each problem's
  iterations and T against ``chip_smoke.BATCHED_REF`` (the JAX class API
  one scan at a time, ``scripts/jax_reference_batched.py``), to which
  ``chip_smoke.py`` holds phase 16's batched paths;
* ``map``: ``parallel.align_map_sharded`` of VPlaneICP and NDT on
  ``shard_voxel_map_on_mesh(map, 1.0, make_map_mesh(4, 1))`` (auto axis).

Prints the ``SHARDED_REF`` and ``MAP_REF`` constants of ``chip_smoke.py``
(the iteration counts and rows 0-2 of T) and, for ``fused``, the largest
difference from ``BATCHED_REF``.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from bench import make_city_map, make_scan
from chip_smoke import BATCHED_REF
from point_cloud_registration_tpu import models
from point_cloud_registration_tpu.core import config
from point_cloud_registration_tpu.models.base import pad_points
from point_cloud_registration_tpu.ops import voxelize
from point_cloud_registration_tpu.ops.pallas.fused_align import voxel_fused_spec
from point_cloud_registration_tpu.ops.pallas.point_align import point_fused_spec
from point_cloud_registration_tpu.parallel import (
    align_batched_fused_sharded,
    align_map_sharded,
    align_sharded,
    make_map_mesh,
    make_mesh,
    shard_voxel_map_on_mesh,
)

PARAMS = dict(max_iter=30, max_dist=2.0, tol=1e-3)
B, N_BATCH = 8, 16384
CFGS = {
    "vplane_icp": config.VPlaneICPConfig(voxel_size=1.0, **PARAMS),
    "ndt": config.NDTConfig(voxel_size=1.0, **PARAMS),
    "icp": config.ICPConfig(**PARAMS),
    "plane_icp": config.PlaneICPConfig(**PARAMS),
}
BUILD = {"vplane_icp": models.build_vplane_target, "ndt": models.build_ndt_target,
         "icp": models.build_icp_target, "plane_icp": models.build_plane_icp_target}
FUSED = {"plane": "vplane_icp", "ndt": "ndt", "point": "icp", "plane_pt": "plane_icp"}


def rows(T) -> str:
    return np.array2string(np.asarray(T, np.float64)[:3].reshape(-1), separator=", ",
                           precision=9, max_line_width=400, floatmode="maxprec")


def city():
    rng = np.random.RandomState(42)
    map_np = make_city_map(rng, 1_200_000)
    return map_np, make_scan(rng, map_np, 100_000)


def phase_sharded():
    map_np, scan_np = city()
    src, w = pad_points(scan_np)
    mesh = make_mesh(batch=1, data=4)
    print("SHARDED_REF = {  # kind: (iterations, rows 0-2 of T), align_sharded on 1 x 4")
    for kind in ("vplane_icp", "ndt", "icp", "plane_icp"):
        voxelize._GEOM_HINTS.clear()
        t0 = time.perf_counter()
        target = BUILD[kind](map_np, CFGS[kind])
        out = align_sharded(kind, target, src, w, jnp.eye(4, dtype=jnp.float32), CFGS[kind], mesh)
        d = out.diagnostics
        assert bool(d.converged) and not bool(d.solver_failed)
        print(f'    "{kind}": ({int(d.iterations)}, {rows(out.T)}),  '
              f"# {time.perf_counter() - t0:.1f} s", flush=True)
    print("}")


def phase_fused():
    map_np, _ = city()
    scans = jnp.asarray(np.stack([make_scan(np.random.RandomState(100 + b), map_np, N_BATCH)
                                  for b in range(B)]))
    w = jnp.ones((B, N_BATCH), jnp.float32)
    T0 = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
    mesh = make_mesh(batch=2, data=2)
    for kind, solver in FUSED.items():
        voxelize._GEOM_HINTS.clear()
        t0 = time.perf_counter()
        cfg, normals = CFGS[solver], None
        target = BUILD[solver](map_np, cfg)
        if kind in ("plane", "ndt"):
            spec = voxel_fused_spec(target, kind, max_dist=cfg.max_dist)
        elif kind == "point":
            spec = point_fused_spec(target.packed, kind, cfg.max_dist)
        else:
            target, normals = target.corr, target.normals
            spec = point_fused_spec(target.packed, kind, cfg.max_dist)
        out = align_batched_fused_sharded(target, normals, scans, w, T0, cfg, spec, mesh,
                                          interpret=True)
        its = [int(x) for x in out.diagnostics.iterations]
        ref = BATCHED_REF[kind]
        dT = max(float(np.abs(np.asarray(out.T[b], np.float64)[:3].reshape(-1) - rows_b).max())
                 for b, (_, rows_b) in enumerate(ref))
        print(f"{kind}: iterations {its} (BATCHED_REF: {[i for i, _ in ref]}), max |T - "
              f"BATCHED_REF| {dT:.3e}; {time.perf_counter() - t0:.1f} s", flush=True)


def phase_map():
    map_np, scan_np = city()
    src, w = pad_points(scan_np)
    mesh = make_map_mesh(4, 1)
    print("MAP_REF = {  # kind: (iterations, rows 0-2 of T), align_map_sharded on 4 x 1, auto axis")
    for kind in ("vplane_icp", "ndt"):
        t0 = time.perf_counter()
        svm, meta = shard_voxel_map_on_mesh(map_np, 1.0, mesh, with_icov=kind == "ndt")
        out = align_map_sharded(kind, svm, meta, src, w, jnp.eye(4, dtype=jnp.float32),
                                CFGS[kind], mesh)
        d = out.diagnostics
        assert bool(d.converged) and not bool(d.solver_failed)
        print(f'    "{kind}": ({int(d.iterations)}, {rows(out.T)}),  # axis {meta.axis}, slab '
              f"{meta.dims_slab}, {time.perf_counter() - t0:.1f} s", flush=True)
    print("}")


PHASES = {"sharded": phase_sharded, "fused": phase_fused, "map": phase_map}

if __name__ == "__main__":
    for name in sys.argv[1:] or list(PHASES):
        PHASES[name]()
