#!/usr/bin/env python3
"""The JAX package's results on the data of ``chip_smoke.py`` phases 9-12, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_grid.py [phase ...]

Phases (all by default), each on seeded ``bench`` data:

* ``grid``: a 40,000-point LiDAR target (``make_lidar_map``, seed 42) and a
  10,000-point scan of it (``make_scan``). ``ICP()`` with its default
  configuration (the ``"grid"`` correspondence method below 50k target
  points), and ``PlaneICP()`` twice: with the normals of the JAX k-NN
  kernel path (``estimate_normals(backend="pallas")``, interpreted on the
  CPU: the function the port's kernel computes) and with the CPU default
  (the gather path).
* ``hashed``: the seed-42 city map (1.2M points) plus the same tile moved by
  (3000, 3000, 0) m, whose box of about 3201 x 3201 x 21 cells is over the
  dense budget, so the map is hashed; the bench 100k scan of the first tile.
  ``VPlaneICP`` and ``NDT`` with the B-01 parameters.
* ``update``: the city map split by ``np.random.RandomState(7).permutation``
  into two halves: ``set_target(half 1)``, ``update_target(half 2)``,
  ``align(scan)`` for ``VPlaneICP`` and ``NDT``; the bounding boxes of half 1
  and of the whole map in cells.
* ``filter``: ``voxel_filter(map, 0.5)``: the centroid count and 16 rows
  spread evenly over the output (in the order of the cells' keys).

Prints rows 0-2 of each T with the iteration count: the ``T_REF_*``
constants of ``chip_smoke.py``. Each phase starts with the JAX package's
geometry hints cleared (``ops.voxelize._GEOM_HINTS``): a hint left by an
earlier phase's map would make the first build a clipped dense one, which
``align`` then detects and rebuilds.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

import point_cloud_registration_tpu as pcr
from bench import make_city_map, make_lidar_map, make_scan
from point_cloud_registration_tpu.ops import voxelize
from point_cloud_registration_tpu.ops.hashgrid import _bbox_cells
from point_cloud_registration_tpu.ops.normals import estimate_normals

PARAMS = dict(max_iter=30, max_dist=2.0, tol=1e-3)
N_SMALL, N_SMALL_SCAN = 40_000, 10_000
SHIFT = np.float32([3000.0, 3000.0, 0.0])


def report(name, solver, T, t0):
    d = solver.last_diagnostics
    print(f"{name}: iterations {int(d.iterations)}, converged {bool(d.converged)}, "
          f"solver_failed {bool(d.solver_failed)}, {time.perf_counter() - t0:.1f} s")
    print(repr(np.asarray(T, np.float64)[:3]), flush=True)


def city():
    rng = np.random.RandomState(42)
    map_np = make_city_map(rng, 1_200_000)
    return map_np, make_scan(rng, map_np, 100_000)


def phase_grid():
    rng = np.random.RandomState(42)
    target = make_lidar_map(rng, N_SMALL)
    scan = make_scan(rng, target, N_SMALL_SCAN)
    t0 = time.perf_counter()
    icp = pcr.ICP(**PARAMS)
    icp.set_target(target)
    report("ICP (grid)", icp, icp.align(scan), t0)
    for backend in ("pallas", "auto"):
        t0 = time.perf_counter()
        normals = np.asarray(estimate_normals(target, k=15, backend=backend))
        print(f"normals ({backend}): {time.perf_counter() - t0:.1f} s", flush=True)
        picp = pcr.PlaneICP(**PARAMS)
        picp.set_target(target, norm=normals)
        report(f"PlaneICP (grid, normals backend {backend})", picp, picp.align(scan), t0)


def phase_hashed():
    map_np, scan_np = city()
    two = np.vstack([map_np, map_np + SHIFT])
    lo, hi = _bbox_cells(two, 1.0)
    print(f"two tiles: {len(two)} points, cells {lo} .. {hi}, "
          f"{int(np.prod(hi - lo + 1))} cells", flush=True)
    for name, cls in (("VPlaneICP", pcr.VPlaneICP), ("NDT", pcr.NDT)):
        t0 = time.perf_counter()
        s = cls(voxel_size=1.0, **PARAMS)
        s.set_target(two)
        T = s.align(scan_np)
        print(f"{name} map hashed: {s._target.grid.dense is None}, capacity "
              f"{s._target.means.shape[0]}, occupied {int(s._target.grid.n_cells)}", flush=True)
        report(f"{name} (hashed map)", s, T, t0)


def phase_update():
    map_np, scan_np = city()
    perm = np.random.RandomState(7).permutation(len(map_np))
    half = len(map_np) // 2
    a, b = map_np[perm[:half]], map_np[perm[half:]]
    print(f"bbox cells: half 1 {_bbox_cells(a, 1.0)}, map {_bbox_cells(map_np, 1.0)}")
    for name, cls in (("VPlaneICP", pcr.VPlaneICP), ("NDT", pcr.NDT)):
        t0 = time.perf_counter()
        s = cls(voxel_size=1.0, **PARAMS)
        s.set_target(a)
        s.update_target(b)
        report(f"{name} (update_target)", s, s.align(scan_np), t0)


def phase_filter():
    map_np, _ = city()
    t0 = time.perf_counter()
    out = pcr.voxel_filter(map_np, 0.5)
    rows = np.linspace(0, len(out) - 1, 16).astype(int)
    print(f"voxel_filter(map, 0.5): {len(out)} centroids, {time.perf_counter() - t0:.1f} s")
    np.set_printoptions(precision=9, linewidth=160)
    print("rows", rows.tolist())
    print(repr(out[rows].astype(np.float64)), flush=True)


PHASES = {"grid": phase_grid, "hashed": phase_hashed, "update": phase_update,
          "filter": phase_filter}


def main() -> None:
    np.set_printoptions(precision=10, linewidth=160)
    for name in sys.argv[1:] or list(PHASES):
        voxelize._GEOM_HINTS.clear()
        PHASES[name]()


if __name__ == "__main__":
    main()
