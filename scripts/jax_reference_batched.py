#!/usr/bin/env python3
"""The JAX package's results on the data of ``chip_smoke.py`` phases 13-15, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_batched.py [phase ...]

Phases (all by default), each on seeded ``bench`` data: the city map
(``make_city_map``, seed 42, 1.2M points) and

* ``batched``: the bench's batched scans, ``make_scan(RandomState(100 + b),
  map, 16384)`` for b = 0..7 (``bench.py:807-809``), each aligned from
  T = I by the JAX class API, one scan at a time: ``VPlaneICP``, ``NDT``,
  ``ICP`` (the packed method at 1.2M points) and ``PlaneICP`` (its own
  normals, the gather path off the TPU), with the B-01 parameters;
* ``fast``: the bench's 100k scan (``make_scan`` after the map, seed 42):
  ``VPlaneICP``'s step norms, which place the coreset switch, then
  ``FastVPlaneICP(coreset="always", coreset_switch=SWITCH)``: its T, its
  iterations and phase 1's.

Prints the ``BATCHED_REF`` and ``FAST_REF`` constants of ``chip_smoke.py``:
per problem the iteration count and rows 0-2 of T.
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
from bench import make_city_map, make_scan
from point_cloud_registration_tpu.ops import voxelize

PARAMS = dict(max_iter=30, max_dist=2.0, tol=1e-3)
B, N_BATCH = 8, 16384
# The coreset switch of phase 15: between VPlaneICP's second and third step
# norms on the 100k scan (0.0329 and 0.00174, near their geometric mean), so
# that phase 1 stops after three iterations and phase 2 runs; far from both,
# so that the port's step norms, equal to these within float32 rounding, stop
# where JAX's do.
SWITCH = 7.5e-3


def rows(T) -> str:
    return np.array2string(np.asarray(T, np.float64)[:3].reshape(-1), separator=", ",
                           precision=9, max_line_width=400, floatmode="maxprec")


def city():
    rng = np.random.RandomState(42)
    map_np = make_city_map(rng, 1_200_000)
    return map_np, make_scan(rng, map_np, 100_000)


def phase_batched():
    map_np, _ = city()
    scans = [make_scan(np.random.RandomState(100 + b), map_np, N_BATCH) for b in range(B)]
    print("BATCHED_REF = {  # kind: [(iterations, rows 0-2 of T)] per scan")
    for kind, make in (("plane", lambda: pcr.VPlaneICP(voxel_size=1.0, **PARAMS)),
                       ("ndt", lambda: pcr.NDT(voxel_size=1.0, **PARAMS)),
                       ("point", lambda: pcr.ICP(**PARAMS)),
                       ("plane_pt", lambda: pcr.PlaneICP(**PARAMS))):
        voxelize._GEOM_HINTS.clear()
        t0 = time.perf_counter()
        s = make()
        s.set_target(map_np)
        print(f'    "{kind}": [')
        for scan in scans:
            T = s.align(scan)
            d = s.last_diagnostics
            assert bool(d.converged) and not bool(d.solver_failed)
            print(f"        ({int(d.iterations)}, {rows(T)}),")
        print(f"    ],  # {time.perf_counter() - t0:.1f} s", flush=True)
    print("}")


def phase_fast():
    map_np, scan_np = city()
    voxelize._GEOM_HINTS.clear()
    plain = pcr.VPlaneICP(voxel_size=1.0, **PARAMS)
    plain.set_target(map_np)
    T_plain = plain.align(scan_np)
    d = plain.last_diagnostics
    it = int(d.iterations)
    print(f"# VPlaneICP: {it} iterations, step norms "
          f"{np.asarray(d.dx_norm_history)[:it].tolist()}")
    print(f"# VPlaneICP T rows 0-2: {rows(T_plain)}")
    fast = pcr.FastVPlaneICP(voxel_size=1.0, **PARAMS, coreset="always", coreset_switch=SWITCH)
    inner = fast._phase1
    phase1 = {}

    def record(*args):
        T, diag = inner(*args)
        phase1["iterations"] = int(diag.iterations)
        return T, diag

    fast._phase1 = record
    fast.set_target(map_np)
    t0 = time.perf_counter()
    T = fast.align(scan_np)
    d = fast.last_diagnostics
    print(f"# FastVPlaneICP always, switch {SWITCH}: {time.perf_counter() - t0:.1f} s, "
          f"converged {bool(d.converged)}, failed {bool(d.solver_failed)}")
    print(f"FAST_REF = ({SWITCH}, {phase1['iterations']}, {int(d.iterations)}, {rows(T)})"
          "  # switch, phase-1 iterations, iterations, rows 0-2 of T", flush=True)


PHASES = {"batched": phase_batched, "fast": phase_fast}


def main() -> None:
    for name in sys.argv[1:] or list(PHASES):
        PHASES[name]()


if __name__ == "__main__":
    main()
