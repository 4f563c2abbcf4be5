#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's solver paths once on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure raises and the script exits nonzero:

1. Device: a CUDA card must be present; prints torch/CUDA versions, the
   card's name and its ``nvidia-smi`` name and power limit.
2. Build: compiles every ``point_cloud_registration_tpu_torch/csrc/*.cu``
   with nvcc (sm_90a), one nvcc per source, all started together, into
   ``point_cloud_registration_tpu_torch/_build/``; prints the build seconds
   and ptxas' register report.
2c. gn_loop: the loop kernel (``csrc/gn_loop.cu``, kinds plane and ndt),
   VPlaneICP's and NDT's whole Gauss-Newton loop in one cooperative launch,
   on the city map and the 100k scan below, from T = I and from a perturbed
   start, against the host loop (``core.gn.gauss_newton`` over the stats
   kernel, :func:`host_align`) on the same tensors: the first iteration's
   block rows bit-equal to the stats kernel's, equal iterations and flags,
   T within ``TOL_LOOP``, the e2 and |dx| histories within a relative
   ``TOL_LOOP``, the inliers equal, three more aligns bit-identical; its
   plain version's T within ``TOL_LOOP``. Its time per align (events and
   alone), the plain version's, the aligns of both loops in turns (walls,
   device time, busy share, syncs), each kind's ptxas report and its bound.
2d. The point and grid loops (``csrc/point_loop.cu``: ICP and PlaneICP on
   the packed grid of the city map, the 100k scan; ``csrc/grid_loop.cu``:
   ICP and PlaneICP on phase 9's small target, VPlaneICP and NDT on phase
   10's hashed map), the same loop kernel (``csrc/gn_loop.cuh``) over the
   packed-grid and grid stats bodies, each case from T = I and from the
   perturbed start against the host loop over the stats kernel on the same
   tensors: the first iteration's block rows, T, the iterations, the flags
   and the e2, |dx| and inlier histories bit-equal, three more aligns
   bit-identical; its plain version's T within ``TOL_T``, equal iterations
   and flags; a launch of more CTAs than fit on the card raises (the card
   refuses it) and counts nothing. Its time per align (events and alone),
   the plain version's, both loops' aligns in turns (walls, device time,
   busy share, syncs: one through the loop kernel), each kind's ptxas
   report and its bound.

Every align below runs a loop kernel: one launch and one read of the
state an align, no launch of the stats kernel (VPlaneICP and NDT on a
dense map ``gn_loop.fused_loop``, ICP and PlaneICP on a packed target
``point_loop``, the grid and hashed aligns ``grid_loop``, the batched
streams of phases 13-14 ``fused_loop_batched`` and ``point_loop_batched``,
FastVPlaneICP's phase 2 ``fused_loop``). Each path is also run again under
the host loop (:func:`host_loop`: ``core.gn.gauss_newton`` /
``batched_gauss_newton`` over the path's stats kernel, one launch of it an
iteration, the loop of the multi-device paths and the plain reference of
the loop kernels): T within ``TOL_HOST``, equal iterations, ``converged``
and ``solver_failed``; it prints the syncs of one align of each loop
(``torch.cuda.set_sync_debug_mode("warn")``, with the lines that caused
them): one on the loop kernels' paths.

Then, for each solver path (VPlaneICP, NDT, ICP and, after the normals
phase, PlaneICP) on bench.py's seed-42 city map (1.2M points) and 100k-point
scan, with the bench parameters:

3. Kernel vs plain version: the path's stats kernel against its plain
   PyTorch version on the card, at the main path's shapes, at T = I and at
   a perturbed T; the launch as the align binds it (``resident_stats`` at
   pose rows on the card) bit-equal to the wrapper's, which is the same
   kernel at B = 1.
4. Main path: ``Solver(...).set_target(map)`` then ``align(scan)`` with every
   launch count set to 0 just before and read just after; it must converge
   near the scan's known offset, to the JAX package's result on the same
   data with the same iteration count, through its loop kernel (one launch
   of it, none of the stats kernel). Then three warm runs, bit-identical to
   the first, and the per-iteration time of the align's bound launch
   beside the plain version's (and the wrapper's, which copies its pose). Then the loop kernel against the host loop: the align walls
   in turns (host, loop, loop, host), each loop's device time and
   busy share by the profiler and its host milliseconds per iteration.
5. The path with the plain stats: the GN loop over the plain version must
   reach the kernel's T with the same iteration count; for ICP and PlaneICP
   it also counts, per iteration, the queries that take the proxy voxel.
   For these two the packed-grid kernel is also held to its plain version on
   a small lattice target: queries exactly midway between two kept points of
   two blocks, of one block and between two proxy centroids, a query outside
   the grid, a scan that goes to the proxy whole, and caps whose rows are no
   multiple of 16 bytes. For VPlaneICP and NDT the fused voxel kernel is held
   to its plain version on a lattice voxel map, one query per launch (so the
   sums name the winner): queries exactly midway between two valid cells of
   two rows and of two bitmap words of one row, a window with no valid cell,
   queries on and beyond every face of the grid; then 1,000 queries with zero
   weights, in the caller's order and ordered by cell. Phase 4 of these two
   prints the valid cells per window (mean, p99) beside the bound.

Between ICP and PlaneICP:

6. Normals: ``estimate_normals(map, k=15, return_info=True)`` on the card at
   1.2M points, launch counts reset just before and read just after (the
   k-NN moments kernel must have run once per tier); the kernel against its
   plain version on the main path's queries, every map point at radius 2
   and the uncertified tail at radius 4, and on a shuffled sample of the map,
   whose results must equal the unshuffled ones bit for bit; how the queries
   group by candidate box; warm time of the whole call, of each launch and
   of the grouping alone, and each tier's bound. PlaneICP's target takes
   these normals (``set_target(map, norm=normals)``).

After PlaneICP:

6b. k = 40, above one walk of the k-NN kernel: ``estimate_normals(map,
   k=40)`` through the kernel (once per tier), the kernel against its plain
   version at that k, and ``PlaneICP(k=40)`` with normals of its own through
   the k-NN and plane_pt kernels, converged near the scan's offset (there is
   no JAX reference at this k and size).

6c. The normals chain (``ops/kernels/normals_chain.py``) on phase 6's map
   and on a map of the benchmark's ``plane_icp_b01`` cells, at k = 5, 15
   and 40: each step against its plain version on the card, bit for bit
   (the sampler's cell size; the base tier's planar launch against
   ``knn_moments``; the lists of the wide tier and of the fallback against
   ``torch.nonzero(...)[:cap]``; the wide tier written into the planar
   outputs against gathered queries and an ``index_put``; the normals
   against ``smallest_eigvec_sym3``; the fallback's normals against its
   search in PyTorch, a differing point allowed only where its k + 1 nearest
   distances hold a tie); the whole ``estimate_normals`` against its code
   before the chain (``parent_normals``): cell size, certificate, tier
   counts and normals; each wrapper launched once a call; the host's waits
   by ``torch.cuda.set_sync_debug_mode``; the times of both versions and of
   each kernel of a call alone. Then the shapes off the main path
   (``chain_edge_cases``): the sampler by each of its ways, at k above the
   tiles' 32, with more queries than 8,192 and with k above the references,
   cell size bit-equal; the fallback at k = 7, 33, 63, 64, 100 and 200 on
   3,000 points, bit-equal below k = 64 but where a tie is counted, and from
   64 within ``FALLBACK_TOL``.

7. Exact 1-NN: the kernel against its plain version on 4,096 scan points at
   ICP's converged T against the whole map (distance and index equal), and
   as the oracle of the packed grid: every such query that
   ``nearest_point_packed`` resolves within blocks that are not truncated
   has the exact distance. Timed beside chunked ``torch.cdist(...).min``.
   Before that, bit for bit against the plain version at small ragged shapes
   with a NaN query and with references duplicated across a tile border and
   a segment border of the kernel (the first index must win).
Then the paths on the hashed grid (phases 9-12), each held to the JAX
package's result on the same seeded data (``T_REF_*`` and the
``VOXEL_FILTER_*`` constants, from ``scripts/jax_reference_grid.py``):

9. Small targets: ``ICP()`` and ``PlaneICP()`` with default configurations
   on a 40,000-point LiDAR target (``bench.make_lidar_map``) and a
   10,000-point scan of it: the ``"grid"`` method, its CSR bucket scan and
   linearization in the grid stats kernel (``csrc/grid_align.cu``, kinds
   "point" and "plane_pt"), no packed-grid kernel launch; PlaneICP's normals
   through the k-NN kernel. One launch of the grid loop kernel
   (``csrc/grid_loop.cu``, the grid stats body inside), no launch of the grid
   stats kernel, one sync; the host loop's aligns launch the
   grid stats kernel once per iteration (the path its kernels-line row
   names). The host loop over the
   kernel's plain version reaches the align's T within ``TOL_GRID_PLAIN``
   with equal iterations and flags; at that loop's initial, a middle and
   the converged pose the kernel's stats hold to the plain version's within
   the bounds of phase 3, every query's winner and squared distance equal
   the plain query's (``knn.nearest_point``) and the launch the align binds
   is the wrapper's, bit for bit. The kernel against its plain version on
   the lattice scene of phase 5 in 1 m buckets (caps 64 and 5), with the
   dense key table and with the binary search. Then ``nearest_point``
   against the exact 1-NN kernel at ICP's converged T, wherever the window
   had no overflow and the match lies within a cell; warm times, the
   kernel's time (events and alone) beside the plain version's and its
   bound, and the time of one stats call.
10. Over-budget map: the city tile plus the same tile 3 km away (2.4M
   points, about 2.15e8 cells): ``VPlaneICP`` and ``NDT`` on the hashed map,
   through the grid loop kernel over the hashed stats (``grid_loop.cu`` and
   ``grid_align.cu``, kinds "plane" and "ndt", NDT in the icov form; no
   fused launch), checked as in phase 9
   (``knn.nearest_voxel`` for the winners), and on phase 5's voxel lattice
   as a hashed map with occupied cells that are not valid; build and align
   times, peak memory.
11. ``update_target``: the map split in two by a seeded permutation;
   ``set_target(half 1)``, ``update_target(half 2)``, ``align(scan)``: one
   launch of the loop kernel on the rebuilt cell index, the fused kernel held
   to its plain version there; counts and valid cells equal a full rebuild's.
12. Utilities at full size: ``KDTree(map).query(scan, k=1)`` equal to the
   exact 1-NN kernel (its escapes run that kernel), ``query(k=8)`` to
   ``brute_force_knn``; ``VoxelGrid`` ``set_points`` / ``calc_icov`` /
   ``query``; ``voxel_filter(map, 0.5)`` against the JAX package's count and
   rows.

Then the batched streams and the coreset solver (phases 13-15), held to the
JAX package's per-scan results (``BATCHED_REF``, ``FAST_REF_*``, from
``scripts/jax_reference_batched.py``):

13. The batched voxel stream: bench.py's B = 8 scans of 16,384 points
   (``make_scan(RandomState(100 + b), map, 16384)``) against VPlaneICP's
   and NDT's targets from T = I through
   ``models._fused.fused_voxel_align_batched``: one launch of the batched
   loop kernel (``gn_loop.fused_loop_batched``), no stats launch, one sync; each problem's T, iterations, flags and histories
   bit-equal to its single ``align``, T within 1e-3 of the JAX package's
   with equal iterations. The batched loop from T = I and from 8 perturbed
   starts (``hold_batched_loop``): its first iteration's block rows
   bit-equal to the batched stats kernel's, the state's words bit-equal to
   the two-launch batched loop's (:func:`two_launch`: the batched stats
   kernel, then the update kernel of ``csrc/gn_step.cu``, each iteration;
   the card reference, since the host's solve can differ from the card's
   in a step's last bit: one |dx| of the ICP stream) and each problem's to
   its single-problem
   loop kernel's, against the batched host loop equal iterations and flags
   and T within ``TOL_LOOP``, T within 1e-4 of its plain version with equal iterations
   and flags; a launch of more CTAs than fit refused with ``RuntimeError``;
   its time by events and alone, the plain version's, both loops' aligns
   in turns (walls, device time, syncs, launches), ptxas and its bound.
   Before it the batched stats kernel against its plain version and
   its single entry at these shapes and 8 distinct poses, and at n = 1, 7,
   257 points a problem (a problem's tail must read nothing of the next
   one's). A mixed batch: one scan 100 m up (all outliers: failed, T = I,
   one iteration) and one with half its weights 0; the others keep the
   clean batch's T bit for bit. Warm wall time, registrations/s, Mpts/s,
   device time and busy share by ``torch.profiler``.
14. The batched point stream: the same for ICP's packed target and
   PlaneICP's (phase 6's normals), through
   ``models._point_fused.fused_point_align_batched``.
15. FastVPlaneICP on the map and the 100k scan: ``"auto"`` equal to phase
   4's VPlaneICP bit for bit (T, iterations, one loop launch); ``"always"``
   with the switch ``FAST_SWITCH``: phase 1 in one launch of the loop
   kernel, its iterations equal to JAX's, phase 2 in one more launch of it
   on the ``N_target`` coreset rows (no stats launch), its T, iterations,
   flags and histories bit-equal to the host loop's phase 2 on the same
   coreset (or to the two-launch loop's, the host loop's iterations and
   flags equal and T within ``TOL_LOOP``), T within 6e-2 of JAX's and of
   VPlaneICP's; the live points, the host
   lift's seconds and microseconds a live point beside one full-cloud
   iteration's wall and nanoseconds a point, and their ratio: the card's
   breakeven in remaining iterations.
15b. The current card set explicitly (``torch.cuda.set_device`` of the last
   card) and the solvers on ``cuda:<index>``: VPlaneICP's align and the
   batched ICP align equal to phases 4's and 14's bit for bit, one launch
   of their loop kernels (every launcher binds and launches on its
   tensors' card; one card here: the same card).

Then the multi-device paths (phase 16, ``point_cloud_registration_tpu_torch.parallel``),
held to the JAX package's results of the same paths (``SHARDED_REF``,
``MAP_REF``, ``BATCHED_REF``, from ``scripts/jax_reference_parallel.py``);
each part prints the card's name and power limit, the backend and the world
size:

16a. World size 1 with NCCL, in this process (``initialize`` on a
   ``HashStore``, ``make_mesh(1, 1)``): ``align_sharded`` of VPlaneICP, NDT,
   ICP and PlaneICP (phase 6's normals) equal to phase 4's T bit for bit,
   with its iterations and flags and one kernel launch per iteration;
   ``align_batched_sharded`` and ``align_batched_fused_sharded`` of the four
   kinds on phases 13-14's 8 scans equal to their per-problem T bit for bit,
   one batched launch per batched iteration for ``align_batched_sharded``
   (the host loop), one launch of the batched loop kernel for
   ``align_batched_fused_sharded``; ``align_map_sharded`` of
   VPlaneICP and NDT (``make_map_mesh(1, 1)``, plain query and stats, no
   kernel) within 5e-5 of phase 4's T with equal iterations. The process
   group is destroyed afterwards.
16b. ``N_RANKS`` = 4 processes on the one card (``python3 chip_smoke.py
   --phase16-rank SPEC`` each, a FileStore, gloo on the host, compute on
   ``cuda:0``), each under a timeout of ``RANK_TIMEOUT_S``:
   ``align_sharded`` on ``make_mesh(1, 4)`` within 1e-5 of phase 4's T
   (equal iterations, one launch per iteration on every rank, the same
   bits on every rank); ``align_batched_fused_sharded`` on ``make_mesh(2,
   2)`` with B = 8 (over all four ranks) and B = 6 (over the batch axis
   alone) bit for bit phases 13-14's per-problem T; ``align_batched_sharded``
   on (2, 2) within 1e-5; ``align_map_sharded`` on
   ``shard_voxel_map_on_mesh(map, 1.0, make_map_mesh(4, 1))`` (auto axis)
   within 5e-5 of phase 4's T, the on-mesh builder's meta at axis 2 equal to
   ``shard_voxel_map``'s; each slab's valid cells and the queries each rank
   selects; per rank the launches, iterations and warm align time, and the
   host time of one all-reduce of 29 floats on each backend. These are
   correctness runs on one card: no number of phase 16 is a scaling figure.

Then the user's entry points (phase 17), held to the JAX package's results
of the same demos on the same data (``DEMO_REF``, from
``scripts/jax_reference_demos.py``); each time is printed with the card's
name and power limit:

17. The demos (``demos/*_torch.py``): phase 4's map written to a binary PCD
   in a temporary directory with ``write_pcd`` and read back with
   ``read_pcd_xyz``, bit for bit (and whether the native reader loaded).
   ``demo_matching_torch.main`` with ``--map`` that file, ``--scan-points``
   100,000, the demo's default pose, the B-01 parameters and ``--device
   cuda``, once per method (VPlaneICP, NDT, ICP, PlaneICP, FastVPlaneICP),
   twice each (the first run and a warm one, bit-equal), the launch counts
   set to 0 just before each run and read just after: one launch of the
   path's loop kernel (PlaneICP: also the k-NN kernel once per tier in its
   ``set_target``), no other kernel; T within 1e-3 of the JAX package's with
   equal iterations and ``converged``. ``demo_estimate_normals_torch`` on the
   file, k = 15: the k-NN kernel once per tier, the normals phase 6's bit
   for bit. ``demo_visualize_voxels_torch`` on the file, voxel 1: the valid
   voxels, the counts' mean, max and sum, ``voxel_filter``'s rows and the
   digest of ``color_by_voxel``'s colours equal to the JAX package's. Then
   the host's bounding box of the NumPy map (what ``build_voxel_map`` reads
   before its copy) against the copy and the same box on the card.

8. No JAX was imported (checked last, after phases 9-17; each rank of 16b
   checks its own).

The line before the last is a JSON object describing each kernel: its
launches on its path, its error against the plain version, its time, the
plain version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes the function needs of every input
and output once over 3.35 TB/s and the operations over 67 TFLOP/s fp32;
``exact_nn`` also has ``contract_bound_ms``, its 8 separately rounded
operations per pair at half that rate) and, where one PyTorch call computes
the same function, that call's time; ``paths`` gives its launches on every
path that runs it (its main path first, then phases 9-17; phase 16's
paths are named after the path, the mode ``nccl1`` or ``gloo4_rank0``, and
for the batched fused path the batch: ``batched_fused_sharded_plane_8_nccl1``;
the map-sharded paths run no kernel and show 0; every kernel lists phase
17's demo paths, ``demo_<Method>`` and ``demo_normals``, with the first
run's launches, 0 where a demo bypasses it); the four align
kernels also carry ``batched``: the batched entry's launches, error, time,
plain time, the time of B single launches and bound at phase 13's and 14's
shapes. The grid stats kernels of phases 9 and 10 (``grid_point_stats``,
``grid_plane_point_stats``, ``hashed_plane_stats``, ``hashed_ndt_stats``)
stand for XLA code of the JAX package (``replaces`` names the query,
``ops/knn.py``); each has ``alone_ms``, its time by the
profiler. ``fused_loop``, ``point_loop`` and ``grid_loop`` (the loop
kernels) replace the JAX while_loop around the fused, the packed-grid and
the grid stats: their numbers are phase 2c's and 2d's, VPlaneICP's, ICP's
and ICP grid's at the top and each kind's in ``kinds``;
``fused_loop_batched`` and ``point_loop_batched`` the while_loop of the
JAX ``batched_gauss_newton``: their numbers are phases 13's and 14's at B =
8 x 16,384, VPlaneICP's and ICP's at the top, each kind's in ``kinds``.
``launches_path`` names the path that ``launches`` counts: the kernel's
main path or, where that no longer launches it (the stats kernels on every
align), the first of its paths that does (the host loop's aligns of phases
9, 10, 13-14 and 16, ``*_host_loop``). The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np

DEVICE = "cuda"
N_MAP = 1_200_000
N_SCAN = 100_000
SEED = 42
PARAMS = dict(max_iter=30, max_dist=2.0, tol=1e-3)  # bench.py:582-592
SCAN_OFFSET = np.array([0.0, 0.0, 0.3])  # bench.make_scan: scan = map + offset
# Kernel vs plain version on the card. Both sum ~1e5 float32 terms in other
# orders and nvcc contracts FMAs (ulp-level differences in q); a query whose
# distance lies within an ulp of a gate may flip, which moves the sums by
# about one point's share (1 / n_inliers ~ 1e-5).
TOL_H = 1e-4  # plane: max |dH| / max |H|; ndt, point: max |dH_ij| / sqrt(H_ii H_jj)
TOL_G = 1e-4  # max_i |dg_i| / sqrt(H_ii e2), the Cauchy-Schwarz scale of g_i
TOL_E2 = 1e-4  # |de2| / e2
TOL_N = 2  # |dn_inliers|
TOL_T = 1e-4  # max |dT| between the kernel's and the plain version's GN runs
TOL_REF = 1e-3  # max |T - T_jax|, the port's parity budget
TOL_HOST = 1e-6  # max |T - T_host|: the loop kernel against the host loop on the same stats
TOL_OFFSET = 0.1  # |t - (-offset)| of the recovered transform
PERTURBATION = [0.05, -0.04, -0.25, 0.01, -0.008, 0.012]
# The JAX package's results on the same seeded map and scan (JAX 0.9.0 on
# the CPU; rows 0-2 of T). The voxel objectives land 0.0699 (VPlaneICP) and
# 0.0764 (NDT) from the generating offset on this scene, in the JAX package
# too, so each path is held to the reference's result and to a 0.1 offset
# bound.
T_REF_VPLANE = np.array([
    [1.0, 4.63e-05, -4.9e-06, -0.0014129],
    [-4.63e-05, 1.0, -5.44e-05, 0.0074022],
    [4.9e-06, 5.44e-05, 1.0, -0.3694947],
])
T_REF_NDT = np.array([
    [1.0, -1.2929332e-05, -1.4378009e-05, 2.8962442e-03],
    [1.2928946e-05, 1.0, -4.9533519e-05, -1.0072330e-03],
    [1.4377494e-05, 4.9533322e-05, 1.0, -3.7634879e-01],
])
T_REF_ICP = np.array([
    [1.0, 4.5659098e-07, 5.9677086e-07, -1.4656399e-04],
    [-4.3830522e-07, 1.0, -2.0411762e-06, 2.3575976e-06],
    [-5.9648028e-07, 2.0385517e-06, 1.0, -3.0019087e-01],
])
# PlaneICP of the JAX package on the CPU with its own normals (the gather
# path), scripts/jax_reference_plane_icp.py. The port's normals differ from
# those on the uncertified tail, so T agrees within TOL_REF, not to rounding.
T_REF_PLANE_ICP = np.array([
    [1.0, -2.9214179e-06, -2.2835184e-07, 1.9454493e-04],
    [2.9214177e-06, 1.0, -9.9732915e-07, -1.9303942e-04],
    [2.2827965e-07, 9.9732824e-07, 1.0, -2.9965439e-01],
])
K_NORMALS = 15
K_ROUNDS = 40  # above knn_normals.ROUND_K: the k-NN kernel selects in rounds
K_CHAIN = (5, 15, 40)  # phase 6c: the k of the normals chain's checks (5: the benchmark's)
# the wrappers of ops/kernels/normals_chain.py, each launched once an estimate_normals
CHAIN_STEPS = ("sampled_median", "tail_lists", "eig_normals", "fallback_normals")
# their rows of the kernels line: phase 6c's step, the wrapper, the JAX code
# that the step's plain version ports, the profiler's names of its kernels
CHAIN_ROWS = (
    ("sample", "sampled_median", "point_cloud_registration_tpu/ops/normals.py:64",
     ("sample_", "median_kernel")),
    ("tails", "tail_lists", "point_cloud_registration_tpu/ops/normals.py:303",
     ("tails_mark",)),
    ("eig", "eig_normals", "point_cloud_registration_tpu/ops/eigh3.py:167", ("eig_kernel",)),
    ("fallback", "fallback_normals", "point_cloud_registration_tpu/ops/normals.py:330",
     ("fallback_kernel",)),
)
K_DEEP = (80, 100)  # two and three rounds, checked kernel against plain
# phase 6c's fallback off the main path: each side of ATen's changes of
# schedule (a warp's lanes to 63; from 64 more lanes under 16 points; from
# 128 vector loads; from 256 the mean across warps), on more points than the
# plain version's chunk of 2,048
K_FALLBACK = (7, 33, 63, 64, 100, 200)
N_FALLBACK = 3000
# From k = 64 the fallback's sums keep their own order: its normals against
# the plain version's, 1 - |n . n_plain| on points with no tie
FALLBACK_TOL = 1e-5
# cov6 of kernel vs plain: float32 sums of up to ~50 products in another
# order, relative to the query's largest covariance entry
TOL_COV = 1e-5
TOL_FLAGS = 8  # queries whose flags or counts may differ (none expected)
N_SHUFFLED = 65536  # map points of the k-NN kernel's query-order check
# estimate_normals on the seeded map: queries of the wide tier, points left
# to the plain fallback and points certified exact, as first recorded with
# the one-thread-per-query kernel; the function has not changed since
NORMALS_REF = {"n_wide": 215_988, "n_unresolved": 314, "n_exact": 1_139_014}
N_EXACT = 4096  # queries of the exact 1-NN phase
# Phases 9-12. The JAX package's results on the same seeded data (JAX 0.9.0
# on the CPU, scripts/jax_reference_grid.py; rows 0-2 of T).
N_SMALL, N_SMALL_SCAN = 40_000, 10_000  # phase 9: a LiDAR target below auto_threshold
T_REF_ICP_GRID = np.array([  # 5 iterations
    [1.0000002384e+00, -2.3136537948e-06, 2.2141684894e-06, 2.0029963343e-04],
    [1.9600379346e-06, 1.0000001192e+00, -2.5174158509e-06, -2.7826384758e-04],
    [-2.2105889457e-06, 2.5215840651e-06, 1.0000003576e+00, -2.9999551177e-01],
])
# with the normals of the JAX k-NN kernel path (backend="pallas", the function
# of the port's kernel); with its CPU default (the gather path) JAX takes 2
# iterations and lands 6.4e-4 away
T_REF_PLANE_ICP_GRID = np.array([  # 3 iterations
    [1.0, -1.1050958619e-06, -1.1029878806e-06, -2.5256304070e-05],
    [1.1202562291e-06, 1.0, -7.5899879448e-07, -3.2163783908e-04],
    [1.1114789231e-06, 7.5719435699e-07, 1.0, -3.0023872852e-01],
])
TILE_SHIFT = np.float32([3000.0, 3000.0, 0.0])  # phase 10: the second tile
T_REF_VPLANE_HASHED = np.array([  # 4 iterations
    [1.0, 4.6283865231e-05, -4.8695792429e-06, -1.4128923649e-03],
    [-4.6284032578e-05, 1.0, -5.4369695135e-05, 7.4022398330e-03],
    [4.8683778004e-06, 5.4369796999e-05, 1.0, -3.6949470639e-01],
])
T_REF_NDT_HASHED = np.array([  # 3 iterations, the icov form on both sides
    [1.0, -1.2928582692e-05, -1.4378070773e-05, 2.8961212374e-03],
    [1.2928196156e-05, 1.0, -4.9533366109e-05, -1.0072856676e-03],
    [1.4377555090e-05, 4.9533169658e-05, 1.0, -3.7634879351e-01],
])
SPLIT_SEED = 7  # phase 11: the map split by np.random.RandomState(7).permutation
T_REF_VPLANE_UPDATE = np.array([  # 4 iterations
    [1.0, 4.628562237e-05, -4.870300472e-06, -1.413418213e-03],
    [-4.628578972e-05, 1.0, -5.436920401e-05, 7.402469870e-03],
    [4.869099030e-06, 5.436930951e-05, 1.0, -3.694947064e-01],
])
T_REF_NDT_UPDATE = np.array([  # 3 iterations; JAX's CPU NDT takes the icov form
    [1.0, -1.292100569e-05, -1.437651099e-05, 2.896857914e-03],
    [1.292062097e-05, 1.0, -4.942181113e-05, -1.008179504e-03],
    [1.437600167e-05, 4.942162195e-05, 1.0, -3.763411045e-01],
])
# phase 12: voxel_filter(map, 0.5) of the JAX package: the centroid count and
# 16 rows spread over its output (in the cells' key order, as the port's)
VOXEL_FILTER_COUNT = 491_375
VOXEL_FILTER_ROWS = [0, 32758, 65516, 98274, 131033, 163791, 196549, 229307, 262066, 294824,
                     327582, 360340, 393099, 425857, 458615, 491374]
VOXEL_FILTER_REF = np.array([
    [6.591689587e-01, 2.614038289e-01, -8.466839790e-03],
    [1.175849152e+02, 4.837220764e+01, -2.323862910e-02],
    [2.468243599e+01, 9.681309509e+01, -1.247563958e-02],
    [1.162549133e+02, 1.447152863e+02, -2.739465237e-02],
    [7.839582062e+01, 1.932333679e+02, -2.237805724e-02],
    [1.163854828e+02, 4.068720245e+01, 3.248023242e-02],
    [9.172700500e+01, 8.817884827e+01, 2.282039262e-02],
    [4.892893600e+01, 1.355949097e+02, 1.329137478e-02],
    [3.030044937e+01, 1.832094879e+02, 1.294311732e-01],
    [1.407565689e+01, 4.234670639e+01, 1.032078624e+00],
    [2.774733925e+01, 1.345426273e+01, 2.409578562e+00],
    [1.036597252e+01, 1.881728821e+02, 2.816321373e+00],
    [1.473406525e+02, 1.634071808e+02, 3.705329180e+00],
    [4.960070801e+01, 1.355272064e+02, 4.848175049e+00],
    [1.814516754e+02, 1.037328110e+02, 5.640537739e+00],
    [8.593728638e+01, 1.876911316e+02, 1.956024551e+01],
])
# Phases 13-15. The batched streams: bench.py's batched scans (bench.py:807-809)
N_BATCHES, N_BATCH = 8, 16384
BATCH_TAILS = (1, 7, 257)  # scans of no multiple of 8 or of a block, kernel vs plain
TOL_BATCHED = 1e-5  # max |T - T_single| of a problem of a batched align
BATCHED_KINDS = {"vplane_icp": "plane", "ndt": "ndt", "icp": "point", "plane_icp": "plane_pt"}
# The batched loop kernels (gn_loop.cuh's batched template, built in
# csrc/gn_loop.cu and csrc/point_loop.cu): each batched align's whole loop in
# one launch, the while_loop of the JAX batched_gauss_newton
BATCHED_LOOPS = {"plane": "fused_loop_batched", "ndt": "fused_loop_batched",
                 "point": "point_loop_batched", "plane_pt": "point_loop_batched"}
# each one's library (csrc/<library>.cu)
BATCHED_LOOP_LIBRARIES = {"fused_loop_batched": "gn_loop", "point_loop_batched": "point_loop"}
BATCHED_LOOP_REPLACES = "point_cloud_registration_tpu/models/_fused.py:345"
# The JAX package's per-scan results (JAX 0.9.0 on the CPU, the class API one
# scan at a time; JAX_PLATFORMS=cpu python3 scripts/jax_reference_batched.py):
# kind -> [(iterations, rows 0-2 of T)] per scan
BATCHED_REF = {
    "plane": [
        (5, [1, 6.32884548e-05, 3.10843316e-05, -0.00672493922, -6.32783049e-05, 1,
             -6.1637882e-05, 0.0090647107, -3.1085252e-05, 6.1636063e-05, 1, -0.363829374]),
        (5, [1, -4.34263748e-05, -4.0595045e-05, 0.000215811306, 4.34287795e-05, 1,
             0.000110774192, 0.00553553412, 4.05911815e-05, -0.000110775822, 1, -0.359401464]),
        (5, [1, 6.70419904e-05, -2.83731401e-06, -0.00253277784, -6.7039924e-05, 1,
             0.000105505824, 0.0111196535, 2.84036196e-06, -0.000105505278, 1, -0.349240571]),
        (4, [1, 2.46538002e-06, 8.59619904e-05, -0.00323001714, -2.46588729e-06, 1,
             6.45892987e-06, 0.00941320788, -8.59607317e-05, -6.45845012e-06, 1, -0.356624037]),
        (4, [1, 7.94239677e-05, 0.000194900931, -0.0132679958, -7.94138323e-05, 1,
             -0.000148829611, 0.0170767177, -0.000194901819, 0.000148826628, 1, -0.363548905]),
        (4, [1, 0.000196818699, 0.000118975098, -0.0180764496, -0.00019681672, 1,
             -2.71619392e-05, 0.00320373313, -0.00011896967, 2.71478602e-05, 1, -0.351673961]),
        (4, [1, -4.6026591e-05, 0.0001754572, 0.00314076757, 4.60185947e-05, 1,
             9.74426657e-05, 0.000976959826, -0.000175459252, -9.74380964e-05, 1, -0.333349198]),
        (4, [1, 0.000119408935, 9.19578815e-05, -0.0177295096, -0.000119414493, 1,
             3.81901846e-05, 0.0134526864, -9.19522718e-05, -3.81899154e-05, 1, -0.347756922]),
    ],
    "ndt": [
        (4, [1, 1.00027537e-05, 0.000148672232, -0.000823972921, -9.99545227e-06, 1,
             -3.16901569e-05, 0.00266343774, -0.000148669525, 3.16899241e-05, 1, -0.357889563]),
        (3, [1, -3.89020715e-05, 1.77247639e-05, 0.00634216145, 3.89047236e-05, 1,
             2.6368567e-05, 0.00172409345, -1.77267429e-05, -2.63665643e-05, 1, -0.360882491]),
        (4, [1, -2.97696692e-06, 1.85451409e-05, -0.000567989657, 2.97825545e-06, 1,
             0.000144196776, -0.00169512199, -1.85451208e-05, -0.000144195568, 1, -0.347054005]),
        (4, [1, -8.79768413e-05, -1.85491863e-05, 0.00616778387, 8.7978915e-05, 1,
             2.91743636e-05, -0.000216987217, 1.85464123e-05, -2.91744836e-05, 1, -0.365767807]),
        (4, [1, -1.25939778e-05, 0.00020653446, -0.000292064389, 1.26025307e-05, 1,
             -0.00010804167, 0.0113938143, -0.000206532539, 0.000108043379, 1, -0.37008971]),
        (4, [1, 0.000123139776, 0.000212421903, -0.0113423029, -0.000123146587, 1,
             3.80208185e-05, 0.0049687922, -0.000212416067, -3.80360288e-05, 1, -0.339609951]),
        (3, [1, -2.27115215e-05, 0.000216468004, 0.0011007397, 2.26919001e-05, 1,
             0.00018475292, 0.0042347298, -0.000216470566, -0.000184746357, 1, -0.328792334]),
        (4, [1, -2.53702319e-06, 0.000106325701, 0.00195952994, 2.53665735e-06, 1,
             -4.92332329e-05, 0.00428956468, -0.000106324435, 4.92375912e-05, 1, -0.359115243]),
    ],
    "point": [
        (6, [1, -3.47887919e-07, -1.48769959e-06, -0.00020284683, 3.69478272e-07, 1,
             7.12202564e-09, 8.67113995e-05, 1.48828985e-06, -1.25006636e-08, 1, -0.300212175]),
        (6, [1, -1.52744406e-06, 1.26709711e-06, 0.000100899437, 1.55307498e-06, 1,
             5.25362657e-06, -0.000292912242, -1.26717259e-06, -5.25259384e-06, 1, -0.29950884]),
        (6, [1, -1.65762003e-06, -2.20100173e-06, 7.06221763e-05, 1.67903409e-06, 1,
             -1.8316988e-06, -1.09884613e-05, 2.20134007e-06, 1.82881763e-06, 1, -0.300429761]),
        (6, [1.00000012, 6.53491554e-07, 4.14059514e-06, 1.42762583e-05, -6.39935138e-07, 1,
             -3.3685285e-07, -7.66611629e-05, -4.14038277e-06, 3.33704008e-07, 1.00000012, -0.299452454]),
        (6, [1, 1.79266942e-06, 1.68369934e-06, -0.000132059897, -1.78184655e-06, 1,
             -6.42239229e-06, 0.000537910441, -1.68363567e-06, 6.41962924e-06, 1, -0.300647765]),
        (6, [1.00000012, 1.7280787e-06, 2.35714651e-07, -0.000582760549, -1.69538487e-06, 1,
             -1.18741195e-06, 0.00019724865, -2.35743911e-07, 1.18799801e-06, 1.00000012, -0.300073087]),
        (6, [1.00000012, -1.72151727e-06, 4.04798129e-06, 0.000268440403, 1.73303204e-06, 1,
             -5.920474e-07, 1.15609837e-05, -4.04787943e-06, 5.88745991e-07, 1.00000012, -0.299694061]),
        (6, [1.00000012, -4.17181627e-06, -3.66832319e-06, 0.000337887876, 4.19306389e-06, 1,
             -1.94214249e-06, -0.000546979194, 3.66852896e-06, 1.94148197e-06, 1.00000012, -0.300509453]),
    ],
    "plane_pt": [
        (3, [1, 5.43339229e-06, -1.76228423e-06, -0.000437365088, -5.4331872e-06, 1,
             -2.09597238e-06, 0.00111017993, 1.76209642e-06, 2.09603968e-06, 1, -0.300121725]),
        (3, [1, -2.1659398e-06, -2.67314135e-07, 0.000270448509, 2.1660428e-06, 1,
             8.34820639e-08, 4.28696221e-05, 2.67298674e-07, -8.34611456e-08, 1, -0.299486071]),
        (3, [1, -6.8447066e-06, -1.48839763e-06, 0.000281558081, 6.8447207e-06, 1,
             -2.43349132e-06, -0.000681076024, 1.48847255e-06, 2.43346722e-06, 1, -0.299791217]),
        (3, [1, 1.20292179e-06, -1.2038272e-06, 0.000492934254, -1.2025364e-06, 1,
             -2.70404416e-06, 7.17343355e-05, 1.20373988e-06, 2.70410237e-06, 1, -0.2998766]),
        (3, [1, 5.0276708e-06, 3.81827704e-07, -0.000529150595, -5.02687408e-06, 1,
             -1.58608418e-06, 0.00135363988, -3.81858627e-07, 1.58611328e-06, 1, -0.29962638]),
        (3, [1, -3.62059751e-07, 7.35402864e-07, -0.000248568307, 3.61922247e-07, 1,
             -4.41748853e-07, 0.000481498428, -7.3541014e-07, 4.41737029e-07, 1, -0.299558073]),
        (3, [1, -7.55899282e-06, 1.38402038e-06, 0.000684224477, 7.55938845e-06, 1,
             -1.81174983e-07, -0.000224498741, -1.38328187e-06, 1.81058567e-07, 1, -0.299465418]),
        (3, [1, -1.84615365e-05, -2.64864707e-06, 0.00191601692, 1.84616802e-05, 1,
             4.58843715e-07, -0.00213896111, 2.64797222e-06, -4.58642717e-07, 1, -0.299689472]),
    ],
}
# FastVPlaneICP "always" (the same script's "fast" phase): the switch between
# VPlaneICP's second and third step norms on the 100k scan, phase 1's and all
# iterations, rows 0-2 of T
FAST_SWITCH = 7.5e-3
FAST_REF_PHASE1, FAST_REF_ITERATIONS = 3, 7
FAST_REF_T = np.array([
    1.000000000e+00, 1.411803896e-05, 2.589712312e-05, 5.738548934e-03,
    -1.411649373e-05, 1.000000000e+00, -7.135313354e-05, 9.325046092e-03,
    -2.589702490e-05, 7.135215856e-05, 1.000000000e+00, -3.673594296e-01,
])
TOL_FAST = 6e-2  # tests/test_fast_vpicp.py:48-50: the coreset objective's optimum
# Phase 16. The multi-device paths (parallel/): world size 1 with NCCL in this
# process, then N_RANKS gloo processes on the one card
SHARDED_KINDS = ("vplane_icp", "ndt", "icp", "plane_icp")
KERNELS_OF = {  # the single and the batched entry of each solver's stats kernel
    "vplane_icp": ("fused_plane_stats", "fused_plane_stats_batched"),
    "ndt": ("fused_ndt_stats", "fused_ndt_stats_batched"),
    "icp": ("point_stats", "point_stats_batched"),
    "plane_icp": ("plane_point_stats", "plane_point_stats_batched"),
}
N_RANKS = 4
RANK_TIMEOUT_S = 120  # per rank process of phase 16b
GLOO_FUSED_BATCHES = (N_BATCHES, 6)  # over all four ranks, over the batch axis alone
TOL_SHARDED = 1e-5  # sharded vs single, tests/test_sharded.py:63
TOL_MAP = 5e-5  # map-sharded (plain query and stats) vs the kernel, tests/test_map_sharded.py:188
# The JAX package's results of the same paths (JAX 0.9.0 on the CPU, eight virtual
# devices; JAX_PLATFORMS=cpu python3 scripts/jax_reference_parallel.py): align_sharded
# on 1 x 4 and align_map_sharded on 4 x 1 (auto axis)
SHARDED_REF = {  # kind: (iterations, rows 0-2 of T)
    "vplane_icp": (4, np.array([1, 4.62838507e-05, -4.86956469e-06, -0.00141287176,
        -4.6284018e-05, 1, -5.43696988e-05, 0.00740225567, 4.86836279e-06, 5.43698043e-05, 1,
        -0.369494706])),
    "ndt": (3, np.array([1, -1.29213613e-05, -1.43711341e-05, 0.00289758295, 1.29209748e-05, 1,
        -4.95251916e-05, -0.00101045798, 1.43706193e-05, 4.95249988e-05, 1, -0.376347423])),
    "icp": (6, np.array([1, 4.56590641e-07, 5.96769951e-07, -0.000146566526, -4.38304539e-07,
        1, -2.04117919e-06, 2.35433799e-06, -5.96479367e-07, 2.03855097e-06, 1, -0.300190866])),
    "plane_icp": (3, np.array([1, -2.92141976e-06, -2.28256567e-07, 0.000194545908,
        2.92141954e-06, 1, -9.97310963e-07, -0.00019303977, 2.28184362e-07, 9.97310053e-07, 1,
        -0.299654365])),
}
MAP_REF = {  # kind: (iterations, rows 0-2 of T)
    "vplane_icp": (4, np.array([1, 4.62838689e-05, -4.86954059e-06, -0.00141290284,
        -4.62840362e-05, 1, -5.43697242e-05, 0.00740225427, 4.86833915e-06, 5.43698297e-05, 1,
        -0.369494677])),
    "ndt": (3, np.array([1, -1.2937644e-05, -1.43913057e-05, 0.00289859716, 1.29372575e-05, 1,
        -4.94533488e-05, -0.00100828474, 1.43907882e-05, 4.94531523e-05, 1, -0.376348317])),
}
# Phase 17: the port's demos (demos/*_torch.py) on phase 4's map through a PCD file,
# with the demo's default pose (x 0.2, y -0.1, z 0.3, yaw 1 degree) and B-01 parameters
DEMOS = Path(__file__).resolve().parent / "demos"
DEMO_ARGS = ["--scan-points", str(N_SCAN), "--voxel-size", "1.0", "--max-dist", "2.0",
             "--max-iter", "30", "--tol", "1e-3", "--k", str(K_NORMALS)]
# each method's loop kernel: every method ("auto" FastVPlaneICP: VPlaneICP at
# max_iter 30) aligns in one launch of one
DEMO_KERNEL = {"VPlaneICP": "fused_loop", "NDT": "fused_loop", "ICP": "point_loop",
               "PlaneICP": "point_loop", "FastVPlaneICP": "fused_loop"}
# The JAX package's results of the demos on the same data (JAX 0.9.0 on the CPU;
# JAX_PLATFORMS=cpu python3 scripts/jax_reference_demos.py): the demos' own draws and
# classes; PlaneICP's normals from the JAX package's CPU default (the packed-block XLA
# path), the port's from its k-NN kernel
DEMO_REF = {
    "VPlaneICP": {"iterations": 8, "converged": True, "T": [
        [0.9998509287834167, 0.017444707453250885, 4.701521902461536e-05, -0.20105129480361938],
        [-0.017444700002670288, 0.9998509287834167, 7.992697646841407e-06, 0.1091611310839653],
        [-4.6674256736878306e-05, -8.7424805315095e-06, 1.0, -0.3584847152233124]]},
    "NDT": {"iterations": 5, "converged": True, "T": [
        [0.9998478889465332, 0.017463289201259613, 2.415879862383008e-05, -0.20103812217712402],
        [-0.017463281750679016, 0.9998478889465332, 3.956449290853925e-06, 0.1068350300192833],
        [-2.4020595446927473e-05, -4.443503712536767e-06, 1.0, -0.3709053099155426]]},
    "ICP": {"iterations": 30, "converged": False, "T": [
        [0.9999392032623291, 0.011388829909265041, 0.00020906289864797145, 0.12270323932170868],
        [-0.01138875912874937, 0.9999390840530396, -1.887973485281691e-05, -0.12080467492341995],
        [-0.0002090264461003244, 1.63054428412579e-05, 1.0, -0.2969510853290558]]},
    "PlaneICP": {"iterations": 8, "converged": True, "T": [
        [0.9998555779457092, 0.017450585961341858, -5.015062924940139e-07, -0.19862744212150574],
        [-0.017450565472245216, 0.9998555779457092, -9.602699719835073e-07, 0.10259044915437698],
        [3.1420859158970416e-07, 8.155766408890486e-07, 1.0, -0.30019110441207886]]},
    "FastVPlaneICP": {"iterations": 8, "converged": True, "T": [
        [0.9998509287834167, 0.017444707453250885, 4.701521902461536e-05, -0.20105129480361938],
        [-0.017444700002670288, 0.9998509287834167, 7.992697646841407e-06, 0.1091611310839653],
        [-4.6674256736878306e-05, -8.7424805315095e-06, 1.0, -0.3584847152233124]]},
    "voxels": {"n_valid": 32893, "min_points": 10, "count_mean": 20.010123734533185,
               "count_max": 119, "count_sum": 658193, "n_filtered": 201415,
               "irgb_sha256": "38920da05d90420c95cf2e9efa43409415d7116d132e8f7e31917dcc5f34a321"},
}
N_KNN = 4096  # queries of KDTree.query(k=8)
K_KNN = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOP_PER_S = 67e12  # H100 SXM, outside the tensor cores
ROOT = Path(__file__).resolve().parent
CSRC = "point_cloud_registration_tpu_torch/csrc"
PALLAS = "point_cloud_registration_tpu/ops/pallas"


class SolverPath(NamedTuple):
    name: str
    make: Callable  # device -> solver
    kernel: Callable  # the stats wrapper, with its ``launches`` count
    plain: Callable  # its plain PyTorch version
    args: Callable  # (solver, src, w, T) -> the wrapper's arguments
    work: Callable  # (solver, src, w, T, n_inliers) -> (bytes, flops) of one call
    set_target: Callable  # (solver, map) -> None
    h_metric: str  # "max" or "entry" (see TOL_H)
    t_ref: np.ndarray
    iterations_ref: int
    source: str
    replaces: str
    loop: str = "fused_loop"  # its align's loop kernel (ops/kernels/gn_loop): one launch


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    from point_cloud_registration_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    for name in _build.library_names():
        log_path = _build.library_path(name).parent / "nvcc.log"
        if log_path.is_file():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"  ptxas [{name}]:", line.strip())
    return seconds


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_once(fn) -> tuple:
    """``(result, milliseconds)`` of one call of ``fn`` on the card."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare_knn(label: str, k_out, p_out) -> float:
    """Hold the k-NN moments kernel's outputs ``k_out`` against the plain
    version's ``p_out``; returns the largest absolute error of cov6."""
    d_flags = int((k_out[3] != p_out[3]).sum() + (k_out[4] != p_out[4]).sum()
                  + (k_out[1] != p_out[1]).sum())
    same = (k_out[1] == p_out[1]) & ~p_out[3]
    rk_rel = float(((k_out[2] - p_out[2]).abs() / p_out[2])[same].max())
    scale = p_out[0].abs().amax(dim=1, keepdim=True)
    cov_rel = float(((k_out[0] - p_out[0]).abs() / scale.clamp(min=1e-30))[same].max())
    cov_abs = float((k_out[0] - p_out[0]).abs()[same].max())
    # the same error against the size of the summed products, d2 <= rk2
    cov_rk = float(((k_out[0] - p_out[0]).abs() / p_out[2][:, None])[same].max())
    log(f"{label} on {p_out[1].shape[0]} queries: flags/counts differing {d_flags}, "
        f"unresolved {int(p_out[3].sum())}, exact {int(p_out[4].sum())}; rk2 rel err "
        f"{rk_rel:.3e}; cov6 rel err {cov_rel:.3e} (max abs {cov_abs:.3e}, "
        f"over rk2 {cov_rk:.3e})")
    if not (d_flags <= TOL_FLAGS and rk_rel <= 1e-6 and cov_rel < TOL_COV):
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    return cov_abs


def knn_tier_stats(tag: str, pg, q, radius: int, selected: float) -> dict:
    """How the queries ``q`` of one ``knn_moments`` launch group by candidate
    box, the time of the grouping alone and the launch's bound: the function
    needs every input and output once (of the packed rows, the kept points of
    the rows that a query's box holds), each candidate's distance once and
    the moments (18 flops) of the ``selected`` points."""
    import torch

    from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn

    n = q.shape[0]
    # the grouping's kernels against its plain version, with int32 keys and, as
    # for a grid of so many blocks that int32 cannot hold a box key, with int64
    # keys; the items' starts up to their count, which stays on the card
    vast = pg._replace(nb_dims=(1 << 12, 1 << 12, 1 << 11))
    for grid in (pg, vast):
        order, starts, ctl = kn.box_groups_cuda(grid, q, radius)
        got = (order, starts[:int(ctl[0])])
        if not (all(torch.equal(a, b) for a, b in zip(got, kn.box_groups(grid, q, radius)))
                and ctl[1:].tolist() == [0, 0]):
            raise AssertionError(f"{tag} r = {radius}: box_groups_cuda disagrees with box_groups")
    order, starts, ctl = kn.box_groups_cuda(pg, q, radius)
    n_items = int(ctl[0])
    n_boxes = torch.unique(kn._box_start(pg, q, radius), dim=0).shape[0]
    group_ms = cuda_ms(lambda: kn.box_groups_cuda(pg, q, radius), 10)
    group_plain_ms = cuda_ms(lambda: kn.box_groups(pg, q, radius), 10)
    cand = 0.0
    held = torch.zeros_like(pg.row_over)  # rows that some query's box holds
    for a in range(0, n, 1 << 16):
        rows = kn.box_rows(pg, q[a:a + (1 << 16)], radius)
        cand += float(pg.row_count[rows].sum())
        held[rows.reshape(-1)] = True
    row_bytes = 12 * int(pg.row_count[held].sum())
    b_ms, b_by = bound_ms(
        row_bytes + nbytes(pg.row_count, pg.block_row, pg.row_over, q) + 4 * n + 40 * n,
        cand * FLOPS_DIST + selected * 18)
    log(f"{tag} r = {radius}: {n} queries in {n_items} work items of at most {kn.ITEM} "
        f"({n / max(n_items, 1):.2f} per item) for {n_boxes} boxes ({n / max(n_boxes, 1):.2f} per box), "
        f"{cand / max(n, 1):.1f} candidates per query; grouping alone {group_ms:.3f} ms (its plain "
        f"version, equal in every index, {group_plain_ms:.3f} ms); "
        f"bound {b_ms:.4f} ms by {b_by} ({row_bytes / 1e6:.1f} MB of kept points in the boxes' rows)")
    return {"queries": n, "items": n_items, "boxes": n_boxes,
            "queries_per_item": n / max(n_items, 1),
            "candidates_per_query": cand / max(n, 1), "group_ms": group_ms,
            "group_plain_ms": group_plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def compare_stats(k, p) -> dict:
    """Errors of the kernel's packed stats ``k`` against the plain ``p``."""
    from point_cloud_registration_tpu_torch.ops.kernels.fused_align import stats_from_packed

    sk = stats_from_packed(k.double().cpu())
    sp = stats_from_packed(p.double().cpu())
    e2 = float(sp.e2)
    diag = np.maximum(np.diag(sp.H.numpy()), 1e-30)
    dH = np.abs((sk.H - sp.H).numpy())
    g_scale = np.sqrt(np.maximum(diag * e2, 1e-30))
    return {
        "max": float(dH.max() / np.abs(sp.H.numpy()).max()),
        "entry": float((dH / np.sqrt(np.outer(diag, diag))).max()),
        "g": float(np.max(np.abs((sk.g - sp.g).numpy()) / g_scale)),
        "e2": abs(float(sk.e2) - e2) / max(e2, 1e-30),
        "n": abs(float(sk.n_inliers) - float(sp.n_inliers)),
        "max_abs": float((k.double() - p.double()).abs().max()),
    }


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least milliseconds the card could take, and what binds."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# Flops per distance evaluation (3 subtractions, 3 products, 2 sums), per
# plane row (residual 5, R^T n and the cross product 24, the weighted
# 21 + 6 + 1 outer-product terms 2 each and their weights 7) and per m = 3
# point (three whitened rows of about the same, plus K = -R skew(p)).
FLOPS_DIST = 8
FLOPS_PLANE_ROW = 92
FLOPS_M3_POINT = 330


def all_kernels() -> list:
    """Every kernel wrapper of the package, each with its ``launches`` count
    (the batched entries of a kernel count apart from its single entry)."""
    from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
    from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn
    from point_cloud_registration_tpu_torch.ops.kernels import normals_chain as nc
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    return [fa.fused_plane_stats, fa.fused_ndt_stats, pa.point_stats, pa.plane_point_stats,
            kn.knn_moments, en.exact_nn, fa.fused_plane_stats_batched, fa.fused_ndt_stats_batched,
            pa.point_stats_batched, pa.plane_point_stats_batched, ga.grid_point_stats, ga.grid_plane_point_stats, ga.hashed_plane_stats,
            ga.hashed_ndt_stats, gl.fused_loop, gl.point_loop, gl.grid_loop,
            gl.fused_loop_batched, gl.point_loop_batched, nc.sampled_median, nc.tail_lists,
            nc.eig_normals, nc.fallback_normals]


def reset_launches() -> None:
    for k in all_kernels():
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in all_kernels()}


def check_loop(tag: str, counts: dict, iterations, loop: str = "fused_loop",
               stats: tuple = ("fused_plane_stats", "fused_ndt_stats")) -> dict:
    """The launches of one align through the loop kernel ``loop`` (VPlaneICP
    and NDT on a dense map: ``fused_loop``; ICP and PlaneICP on a packed
    target: ``point_loop``; the grid and hashed aligns: ``grid_loop``): one
    launch of it, none of its ``stats`` kernels. Returns the counts."""
    out = {"worked": int(np.asarray(iterations).max()), "loop": counts[loop],
           "enqueued": sum(counts[k] for k in stats)}
    log(f"{tag} loop kernel {loop}: {out['loop']} launch for {out['worked']} iterations; stats "
        f"launches {out['enqueued']} (expected 1, 0)")
    if (out["loop"], out["enqueued"]) != (1, 0):
        raise AssertionError(f"{tag} launches {counts}: expected one of {loop} and none of "
                             "its stats kernels")
    return out


def host_align(s, src, w, T0):
    """``(T, diagnostics)`` of solver ``s``'s align of the padded scan
    ``src``, ``w`` from ``T0`` through the host loop (``core.gn.gauss_newton``
    over the solver's stats, ``_stats_fn``: one launch of the stats kernel
    an iteration, the solve and the update on the host)."""
    from point_cloud_registration_tpu_torch.core.gn import gauss_newton

    return gauss_newton(lambda T: s._stats_fn(s._target, src, w, T), T0, s.cfg.max_iter,
                        s.cfg.tol)


def host_batched(stats_all, init_Ts, cfg, device):
    """``(Ts, diagnostics)`` of the batched host loop
    (``core.gn.batched_gauss_newton``) over ``stats_all`` (the batched stats
    kernel at pose rows on ``device``, ``fused_*_stats_packed_batched``): one
    launch of it an iteration."""
    from point_cloud_registration_tpu_torch.core.gn import (
        batched_gauss_newton,
        pose_rows_of,
        stats_from_packed,
    )

    return batched_gauss_newton(
        lambda Ts: stats_from_packed(stats_all(pose_rows_of(Ts).to(device))().cpu()), init_Ts,
        cfg.max_iter, cfg.tol)


def host_voxel_align(vm, source, src_weight, init_T, cfg, kind: str = "plane", slot=None):
    """``models._fused.fused_voxel_align`` through the host loop over
    ``fused_voxel_stats``."""
    from point_cloud_registration_tpu_torch.core.gn import gauss_newton
    from point_cloud_registration_tpu_torch.models._fused import fused_voxel_stats

    return gauss_newton(lambda T: fused_voxel_stats(vm, source, src_weight, T, cfg, kind),
                        init_T, cfg.max_iter, cfg.tol)


def host_point_align(target, source, src_weight, init_T, cfg, kind: str = "point",
                     normals=None, slot=None):
    """``models._point_fused.fused_point_align`` through the host loop over
    ``fused_point_stats``."""
    from point_cloud_registration_tpu_torch.core.gn import gauss_newton
    from point_cloud_registration_tpu_torch.models._point_fused import fused_point_stats

    return gauss_newton(
        lambda T: fused_point_stats(target, source, src_weight, T, cfg, kind, normals), init_T,
        cfg.max_iter, cfg.tol)


def host_voxel_align_batched(vm, sources, src_weights, init_Ts, cfg, kind: str = "plane"):
    """``models._fused.fused_voxel_align_batched`` through the batched host
    loop over the batched fused stats kernel."""
    from point_cloud_registration_tpu_torch.models._fused import fused_voxel_stats_packed_batched

    return host_batched(fused_voxel_stats_packed_batched(vm, sources, src_weights, cfg, kind),
                        init_Ts, cfg, vm.cells.centers.device)


def host_point_align_batched(target, normals, sources, src_weights, init_Ts, cfg,
                             kind: str = "point"):
    """``models._point_fused.fused_point_align_batched`` through the batched
    host loop over the batched point stats kernel."""
    from point_cloud_registration_tpu_torch.models._point_fused import (
        fused_point_stats_packed_batched,
    )

    return host_batched(
        fused_point_stats_packed_batched(target, sources, src_weights, cfg, kind), init_Ts, cfg,
        target.packed.pts_packed.device)


# The aligns that host_loop() swaps: (module, name, its host-loop twin)
HOST_ALIGNS = (("models.voxelized_plane_icp", "fused_voxel_align", host_voxel_align),
               ("models.ndt", "fused_voxel_align", host_voxel_align),
               ("models.fast_vplane_icp", "fused_voxel_align", host_voxel_align),
               ("models.icp", "fused_point_align", host_point_align),
               ("models.plane_icp", "fused_point_align", host_point_align),
               ("models._fused", "fused_voxel_align_batched", host_voxel_align_batched),
               ("models._point_fused", "fused_point_align_batched", host_point_align_batched))


@contextlib.contextmanager
def host_loop():
    """Every solver's align and every batched align inside runs the host
    loop (``core.gn.gauss_newton`` / ``batched_gauss_newton``, the loop of
    the multi-device paths and the plain reference of the loop kernels) over
    the same stats kernel: the functions the solvers call are swapped for
    their host-loop twins (``HOST_ALIGNS``)."""
    import importlib

    swaps = [(importlib.import_module(f"point_cloud_registration_tpu_torch.{module}"), name, fn)
             for module, name, fn in HOST_ALIGNS]
    saved = [getattr(module, name) for module, name, _ in swaps]
    for module, name, fn in swaps:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(swaps, saved):
            setattr(module, name, fn)


def gn_stepper(state, tol: float):
    """``step(stats)``: one launch of the Gauss-Newton update kernel
    (``csrc/gn_step.cu``: the loop kernels' update, ``csrc/gn_step.cuh``,
    alone) on the card state ``state``, with ``tol`` and the state's
    pointers bound once. The two-launch reference of phases 13-15
    (:func:`two_launch`) steps with it: the update the loop kernels run on
    the card, whose solve can differ from the host loop's in a step's last
    bit (phase 14's ICP stream: one |dx| entry, T equal)."""
    import ctypes

    import torch

    from point_cloud_registration_tpu_torch.ops.kernels._build import load_library

    fn = load_library("gn_step").pcr_gn_step
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [c_ptr] * 11 + [c_int, c_int, ctypes.c_float, c_ptr]
    fn.restype = c_int
    dev = state.words.device
    B, M = state.e2.shape
    bound = [x.data_ptr() for x in state[1:]]
    tail = (B, M, float(tol), torch.cuda.current_stream(dev).cuda_stream)

    def step(stats) -> None:
        stats = stats.reshape(B, 29)
        if not stats.is_contiguous() or stats.device != dev:
            raise ValueError(f"stats must be a contiguous ({B}, 29) tensor on {dev}")
        with torch.cuda.device(dev):
            rc = fn(stats.data_ptr(), *bound, None, *tail)
        if rc != 0:
            raise RuntimeError(f"gn_step kernel launch failed: CUDA error {rc}")

    return step


def two_launch(stats, init_Ts, max_iter: int, tol: float, dev):
    """The two-launch loop of B problems on the card -> its final state on
    the host: the state made on the card, ``stats(poses, done)`` bound once
    to its pose rows and done flags (``resident_stats``: a stats kernel that
    skips a done problem), then ``max_iter`` iterations of the stats launch
    and :func:`gn_stepper`'s update, which leaves a done problem as it is;
    one read. The card reference of phases 13-15."""
    from point_cloud_registration_tpu_torch.core import gn

    state = gn.new_state(init_Ts, max_iter, dev)
    launch, step = stats(state.poses, state.done), gn_stepper(state, tol)
    for _ in range(max_iter):
        step(launch())
    return gn.read_state(state)


def hold_to_loops(tag: str, k, Ts_h, d_h, two) -> dict:
    """The loop kernel's final state ``k`` (B problems, on the host) against
    the host loop's result ``(Ts_h, d_h)`` (batched form) and the two-launch
    reference's state ``two`` (:func:`two_launch`) of the same stats kernel
    from the same start: ``k``'s words bit-equal to ``two``'s; against the
    host loop equal iterations and flags, T within ``TOL_LOOP``, and
    whether T, the histories and final e2 are bit-equal. Raises unless both
    hold. Returns the two-launch and host results."""
    import torch

    from point_cloud_registration_tpu_torch.core import gn

    two_equal = torch.equal(k.words, two.words)
    flags = all(torch.equal(a, b) for a, b in (
        (k.it, d_h.iterations), (k.converged.bool(), d_h.converged),
        (k.failed.bool(), d_h.solver_failed)))
    T_k = gn.transforms_of(k.poses)
    dT = float((T_k - Ts_h).abs().max())
    host_bits = flags and all(torch.equal(float_bits(a), float_bits(b)) for a, b in (
        (T_k, Ts_h), (k.final_e2, d_h.final_e2), (k.e2, d_h.e2_history),
        (k.dx_norm, d_h.dx_norm_history), (k.inliers, d_h.inlier_history)))
    log(f"{tag} state words bit-equal to the two-launch loop's {two_equal}; against the host "
        f"loop: iterations and flags equal {flags}, max |dT| {dT:.3e}, T, e2, |dx| and inlier "
        f"histories bit-equal {host_bits}")
    if not (two_equal and flags and dT <= TOL_LOOP):
        raise AssertionError(f"{tag} the loop kernel is off the two-launch loop or the host loop")
    return {"two_launch_equal": two_equal, "dT_host": dT, "host_bit_equal": host_bits}


def count_syncs(fn, sites: dict | None = None):
    """``(fn(), syncs)``: the calls that made the host wait for the card
    during ``fn`` (``torch.cuda.set_sync_debug_mode("warn")``); ``sites``,
    when given, gets the count of each Python line that made one."""
    import torch

    torch.cuda.synchronize()
    syncs = []
    # the first switch of the mode reports a sync of its own, at its own line
    switch, first = inspect.getsourcelines(torch.cuda.set_sync_debug_mode)
    own = (torch.cuda.__file__, range(first, first + len(switch)))

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message) and not (filename == own[0] and lineno in own[1]):
            # the calling lines of this repository, innermost last
            stack = [f"{Path(f.filename).name}:{f.lineno}" for f in traceback.extract_stack()[:-1]
                     if str(ROOT) in f.filename and "chip_smoke" not in f.filename]
            syncs.append(" < ".join(reversed(stack[-3:])) or f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for key in syncs if sites is not None else ():
        sites[key] = sites.get(key, 0) + 1
    return out, len(syncs)


def hold_to_host(tag: str, align, T, d, max_syncs: int | None = None) -> dict:
    """Run ``align() -> (T, diagnostics)`` again under :func:`host_loop` and
    hold the loop kernel's ``T`` and ``d`` to it: T within TOL_HOST, equal
    iterations, ``converged`` and ``solver_failed`` (per problem for a
    batch); with ``max_syncs``, at most that many syncs in the loop
    kernel's align. Returns the difference, both loops' syncs and the host loop's T."""
    sites = {}
    (T_d, _), syncs_d = count_syncs(align, sites)
    with host_loop():
        (T_h, d_h), syncs_h = count_syncs(align)
    dT = float(np.abs(np.asarray(T_h, np.float64) - np.asarray(T, np.float64)).max())
    same = all(np.array_equal(np.asarray(getattr(d, f)), np.asarray(getattr(d_h, f)))
               for f in ("iterations", "converged", "solver_failed"))
    log(f"{tag} loop kernel vs host loop: max |dT| {dT:.3e}, iterations, converged and "
        f"solver_failed equal: {same}; syncs per align {syncs_d} at {sites} (host loop "
        f"{syncs_h})")
    if not (dT <= TOL_HOST and same and np.array_equal(np.asarray(T_d), np.asarray(T))):
        raise AssertionError(f"{tag} the loop kernel is off the host loop: dT {dT}, {d} vs {d_h}")
    if max_syncs is not None and syncs_d > max_syncs:
        raise AssertionError(f"{tag} {syncs_d} syncs in an align, more than {max_syncs}")
    if syncs_h < int(np.asarray(d.iterations).max()):
        raise AssertionError(f"{tag} the sync count does not work: {syncs_h} syncs in the host "
                             f"loop of {int(np.asarray(d.iterations).max())} iterations")
    return {"dT_host": dT, "syncs": syncs_d, "sync_sites": sites, "syncs_host": syncs_h,
            "T_host": np.asarray(T_h).tolist()}


def host_loop_launches(tag: str, kernel: str, hold) -> dict:
    """``hold()`` (:func:`hold_to_host`) with the launch counts set to 0
    just before: its result with ``host_loop_launches``, the launches of the
    stats kernel ``kernel`` in the aligns it ran. The align through the loop
    kernel launches none; the host loop (:func:`host_loop`, the loop of the
    multi-device paths) launches it once per iteration: the path whose
    launches its kernels-line row names."""
    reset_launches()
    out = hold()
    out["host_loop_launches"] = launch_counts()[kernel]
    log(f"{tag} {kernel} launches in the aligns of the loop kernel and the host loop: "
        f"{out['host_loop_launches']}")
    return out


def resident_launcher(path: SolverPath, s, src, w, T):
    """``launch() -> (1, 29)``: the stats launch of ``path`` bound once
    (``resident_stats``) at the pose row of ``T`` on the card, as the loop
    kernel's stats body reads it; its launches count as the wrapper's."""
    from point_cloud_registration_tpu_torch.core.gn import pose_rows_of
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    poses = pose_rows_of(T[None]).to(src.device)
    args = path.args(s, src, w, T)
    if path.args is voxel_args:
        return fa.resident_stats(BATCHED_KINDS[path.name], *args[:6], *args[8:10], poses, None)
    return pa.resident_stats(BATCHED_KINDS[path.name], *args[:4], *args[6:9], poses, None)


def voxel_args(s, src, w, T):
    """The arguments of a fused voxel-stats wrapper for solver ``s`` at ``T``
    (also of its batched twin: ``src`` (B, n, 3), ``w`` (B, n), ``T`` (B, 4, 4))."""
    vm = s._target
    return (vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src, w,
            T[..., :3, :3], T[..., :3, 3], s.cfg.max_dist, s.cfg.huber_delta)


def voxel_windows(vm, q, w, radius: int, chunk: int = 1 << 14) -> dict:
    """What the windows of the weighted queries ``q`` touch in the map's cell
    index: the valid cells per window (mean, p99), the distinct rows and
    bitmap words, and the in-grid cells (what a dense probe reads)."""
    import torch

    from point_cloud_registration_tpu_torch.ops.knn import compact_rows, window_offsets

    dev = q.device
    n_rows = vm.cells.centers.shape[0] - 1
    rows_hit = torch.zeros(n_rows + 1, dtype=torch.bool, device=dev)
    words_hit = torch.zeros(vm.cells.occ.shape[0], dtype=torch.bool, device=dev)
    dims = torch.tensor(vm.dims, device=dev)
    offs = window_offsets(radius, dev)
    inv = torch.tensor(np.float32(1.0 / np.float32(vm.cell_size)), device=dev)
    origin = torch.tensor(vm.origin_cell, device=dev)
    live = q[w > 0]
    per_window, in_grid = [], 0.0
    for a in range(0, live.shape[0], chunk):
        c = torch.floor(live[a:a + chunk] * inv).clamp(-1e9, 1e9).long() - origin
        cells = c[:, None, :] + offs[None]
        ok = ((cells >= 0) & (cells < dims)).all(dim=-1)
        key = torch.where(ok, cells[..., 0] + dims[0] * (cells[..., 1] + dims[1] * cells[..., 2]),
                          0)
        row = torch.where(ok, compact_rows(vm.cells.occ, key, n_rows), n_rows)
        rows_hit[row.reshape(-1)] = True
        words_hit[(key >> 5)[ok]] = True
        per_window.append((row < n_rows).sum(dim=1))
        in_grid += float(ok.sum())
    per_window = torch.cat(per_window).float()
    return {"valid_per_window": float(per_window.mean()),
            "valid_per_window_p99": float(torch.quantile(per_window, 0.99)),
            "distances": float(per_window.sum()), "rows": int(rows_hit[:n_rows].sum()),
            "words": int(words_hit.sum()), "in_grid_probes": in_grid}


def voxel_work(row_flops):
    def work(s, src, w, T, n_inliers):
        # The function needs, once each: the scan's points of nonzero weight,
        # all weights and the 29 sums; the centroid of every valid cell that
        # some window touches, and the features of every cell that wins for
        # an inlier; the bitmap words those windows cover. Every valid cell of
        # a window is one distance, every inlier one linearization.
        import torch

        from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
        from point_cloud_registration_tpu_torch.ops.knn import window_radius

        vm = s._target
        q = src @ T[:3, :3].T.to(src.device) + T[:3, 3].to(src.device)
        hit = voxel_windows(vm, q, w, window_radius(s.cfg.max_dist, vm.cell_size))
        _, _, best_row, wq = fa._voxel_matches(vm.cells, vm.origin_cell, vm.dims, vm.cell_size,
                                               src, w, T[:3, :3], T[:3, 3], s.cfg.max_dist,
                                               8192)
        winners = int(torch.unique(best_row[wq != 0]).numel())
        feat_bytes = vm.cells.feats.shape[1] * 4
        n_live = int((w != 0).sum())
        n_bytes = (12 * n_live + 4 * w.shape[0] + 29 * 4 + 16 * hit["rows"]
                   + feat_bytes * winners + 8 * hit["words"])
        flops = hit["distances"] * FLOPS_DIST + n_inliers * row_flops
        # the counts before: every touched valid row with its features and the
        # whole scan; and before the cell index, the dense table whole (rows
        # of 8 and 12 floats) and every in-grid probe
        touched = nbytes(src, w) + 29 * 4 + (16 + feat_bytes) * hit["rows"] + 8 * hit["words"]
        dense = nbytes(src, w) + 29 * 4 + int(np.prod(vm.dims)) * (16 + feat_bytes)
        old_ms = bound_ms(dense, hit["in_grid_probes"] * FLOPS_DIST + n_inliers * row_flops)
        log(f"[{s.__class__.__name__}] valid cells per window: mean "
            f"{hit['valid_per_window']:.2f}, p99 {hit['valid_per_window_p99']:.0f} (of "
            f"{hit['in_grid_probes'] / max(float((w > 0).sum()), 1.0):.1f} in-grid cells); "
            f"bytes the function needs: {n_bytes / 1e6:.3f} MB ({hit['rows']} of "
            f"{vm.cells.centers.shape[0] - 1} valid centroids, features of {winners} winning "
            f"cells, {hit['words']} bitmap words, {n_live} of {w.shape[0]} scan points); "
            f"with the features of every touched cell and the whole scan: "
            f"{touched / 1e6:.3f} MB; with the dense table counted whole: "
            f"{dense / 1e6:.1f} MB, {old_ms[0]:.5f} ms by {old_ms[1]}")
        return n_bytes, flops
    return work


def point_args(s, src, w, T):
    """The arguments of a packed-grid stats wrapper for solver ``s`` at ``T``
    (also of its batched twin)."""
    from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius

    tg = getattr(s._target, "corr", s._target)
    return (tg.packed, tg.proxy, src, w, T[..., :3, :3], T[..., :3, 3], s.cfg.max_dist,
            proxy_radius(s.cfg.corr, s.cfg.max_dist), s.cfg.huber_delta)


def point_work(row_flops, slot_bytes, proxy_row_bytes):
    def work(s, src, w, T, n_inliers):
        # The function needs, once each: the scan and its weights, block_row,
        # row_count, the kept points of the rows in the queries' windows, and
        # of the proxy table the rows in the windows of the queries that tier
        # 1 leaves unresolved. Every kept point of a query's 2x2x2 blocks and
        # every in-grid proxy cell of an unresolved query is one distance.
        import torch

        from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius

        tg = getattr(s._target, "corr", s._target)
        pg = tg.packed
        q = src @ T[:3, :3].T.to(src.device) + T[:3, 3].to(src.device)
        rows = _window_rows(pg, q)
        held = torch.zeros_like(pg.row_over)  # rows in some query's window
        held[rows[rows >= 0]] = True
        row_bytes = slot_bytes * int(pg.row_count[held].sum())
        cand = torch.where(rows >= 0, pg.row_count[rows.clamp(min=0)], 0).sum(dim=1)
        unresolved = _unresolved(pg, q, w)
        keys = _proxy_window_keys(tg.proxy, q[unresolved],
                                  proxy_radius(s.cfg.corr, s.cfg.max_dist))
        n_bytes = (row_bytes + nbytes(pg.row_count, pg.block_row, src, w) + 29 * 4
                   + proxy_row_bytes * torch.unique(keys[keys >= 0]).numel())
        padded = nbytes(pg.pts_packed, pg.row_count, pg.block_row, tg.proxy.table, src, w) + 29 * 4
        flops = (float((cand * (w > 0)).sum()) + float((keys >= 0).sum())) * FLOPS_DIST \
            + n_inliers * row_flops
        log(f"[{s.__class__.__name__}] bytes the function needs: {n_bytes / 1e6:.1f} MB "
            f"({row_bytes / 1e6:.1f} MB of kept points in the windows' rows, "
            f"{int(unresolved.sum())} queries to the proxy); with the padded row and proxy tables "
            f"counted whole, as before: {padded / 1e6:.1f} MB, "
            f"{bound_ms(padded, flops)[0]:.5f} ms")
        return n_bytes, flops
    return work


def _unresolved(pg, q, w):
    """(N,) bool: the weighted queries that tier 1 leaves to the proxy."""
    from point_cloud_registration_tpu_torch.ops.pointgrid import nearest_point_packed

    return ~nearest_point_packed(pg, q).resolved & (w > 0)


def _proxy_window_keys(proxy, q, radius: int):
    """(M, (2 radius + 1)^3) keys of the proxy cells in each query's window,
    -1 outside the grid."""
    import torch

    from point_cloud_registration_tpu_torch.ops.pointgrid import _cells

    c = _cells(q, proxy.cell_size, proxy.origin_cell)
    r = torch.arange(-radius, radius + 1, device=q.device)
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    cells = c[:, None, :] + off[None]
    dims = torch.tensor(proxy.dims, device=q.device)
    ok = ((cells >= 0) & (cells < dims)).all(dim=-1)
    return torch.where(ok, cells[..., 0] + dims[0] * (cells[..., 1] + dims[1] * cells[..., 2]), -1)


def plain_target(s, m):
    s.set_target(m)


def solver_paths() -> list[SolverPath]:
    """The three solver paths whose target is built from the map alone."""
    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    return [
        SolverPath("vplane_icp", lambda d: pt.VPlaneICP(voxel_size=1.0, **PARAMS, device=d),
                   fa.fused_plane_stats, fa.fused_plane_stats_reference, voxel_args,
                   voxel_work(FLOPS_PLANE_ROW), plain_target, "max",
                   T_REF_VPLANE, 4, f"{CSRC}/fused_align.cu", f"{PALLAS}/fused_align.py:550"),
        SolverPath("ndt", lambda d: pt.NDT(voxel_size=1.0, **PARAMS, device=d),
                   fa.fused_ndt_stats, fa.fused_ndt_stats_reference, voxel_args,
                   voxel_work(FLOPS_M3_POINT), plain_target, "entry",
                   T_REF_NDT, 3, f"{CSRC}/fused_align.cu", f"{PALLAS}/fused_align.py:550"),
        SolverPath("icp", lambda d: pt.ICP(**PARAMS, device=d),
                   pa.point_stats, pa.point_stats_reference, point_args,
                   point_work(FLOPS_M3_POINT, 12, 16), plain_target, "entry",
                   T_REF_ICP, 6, f"{CSRC}/point_align.cu", f"{PALLAS}/point_align.py:594",
                   loop="point_loop"),
    ]


def plane_icp_path(normals) -> SolverPath:
    """The PlaneICP path; its target takes the map's ``normals`` (a tensor on
    the card)."""
    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    return SolverPath("plane_icp", lambda d: pt.PlaneICP(**PARAMS, k=K_NORMALS, device=d),
                      pa.plane_point_stats, pa.plane_point_stats_reference, point_args,
                      point_work(FLOPS_PLANE_ROW, 24, 32), lambda s, m: s.set_target(m, norm=normals),
                      "entry", T_REF_PLANE_ICP, 3, f"{CSRC}/point_align.cu",
                      f"{PALLAS}/point_align.py:594", loop="point_loop")


def run_path(path: SolverPath, map_np, scan_np, dev) -> dict:
    """Phases 3-5 for one path; returns its measurements."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.models import pad_points
    from point_cloud_registration_tpu_torch.ops.kernels.fused_align import stats_from_packed

    tag = f"[{path.name}]"
    # 3. Kernel vs plain version at the main path's shapes
    checker = path.make(dev)
    path.set_target(checker, map_np)
    src, w = pad_points(scan_np, device=dev)
    T_pert = pt.plus(torch.eye(4), torch.tensor(PERTURBATION))
    max_abs_err = 0.0
    for label, T in (("T=I", torch.eye(4)), ("T=perturbed", T_pert)):
        args = path.args(checker, src, w, T)
        got = path.kernel(*args)
        # the launch the align makes, bound to pose rows on the card: the
        # wrapper's launch, bit for bit
        if not torch.equal(resident_launcher(path, checker, src, w, T)()[0], got):
            raise AssertionError(f"{tag} the resident launch differs from the wrapper's at {label}")
        err = compare_stats(got, path.plain(*args))
        log(f"{tag} kernel vs plain at {label}: rel err H {err[path.h_metric]:.3e} "
            f"({path.h_metric}), g {err['g']:.3e}, e2 {err['e2']:.3e}; "
            f"n_inliers diff {err['n']:.0f}; max abs {err['max_abs']:.3e}")
        if not (err[path.h_metric] < TOL_H and err["g"] < TOL_G and err["e2"] < TOL_E2
                and err["n"] <= TOL_N):
            raise AssertionError(f"{tag} kernel disagrees with its plain version at {label}: {err}")
        max_abs_err = max(max_abs_err, err["max_abs"])
    del checker

    # 4. Main path at full size, through the user's entry points
    reset_launches()
    t0 = time.perf_counter()
    solver = path.make(dev)
    path.set_target(solver, map_np)
    T_k = solver.align(scan_np)
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = path.kernel.launches
    d = solver.last_diagnostics
    log(f"{tag} main path (first call, numpy inputs): {first_s:.3f} s, {d.iterations} "
        f"iterations, converged {d.converged}, launch counts {counts}")
    log(f"{tag} T =\n{np.array2string(T_k, precision=7)}")
    if not (d.converged and not d.solver_failed):
        raise AssertionError(f"{tag} align did not converge: {d}")
    if not np.isfinite(T_k).all():
        raise AssertionError(f"{tag} non-finite transform")
    off_err = float(np.linalg.norm(T_k[:3, 3] + SCAN_OFFSET))
    ref_err = float(np.abs(T_k[:3] - path.t_ref).max())
    log(f"{tag} |t - (0, 0, -0.3)| = {off_err:.5f}; max |T - T_jax| = {ref_err:.2e}")
    if not (off_err < TOL_OFFSET and ref_err < TOL_REF
            and d.iterations == path.iterations_ref):
        raise AssertionError(
            f"{tag} transform off the reference: offset error {off_err}, "
            f"JAX difference {ref_err}, {d.iterations} iterations "
            f"(JAX: {path.iterations_ref})"
        )
    resident = check_loop(tag, counts, d.iterations, path.loop, (path.kernel.__name__,))

    map_t = torch.from_numpy(map_np).to(dev)
    scan_t = torch.from_numpy(scan_np).to(dev)
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path.set_target(solver, map_t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        T_w = solver.align(scan_t)
        t2 = time.perf_counter()
        warm.append((t1 - t0, t2 - t1))
        if not (np.array_equal(T_w, T_k) and solver.last_diagnostics.iterations == d.iterations):
            raise AssertionError(f"{tag} a warm run gave another result than the first")
    log(f"{tag} warm (device-resident inputs), set_target s / align s: "
        + ", ".join(f"{s:.4f} / {a:.4f}" for s, a in warm))
    loops = compare_loops(tag, lambda: (solver.align(scan_t), solver.last_diagnostics), T_k, d, 1)

    Tc = torch.as_tensor(T_k, dtype=torch.float32)
    args = path.args(solver, src, w, Tc)
    launch = resident_launcher(path, solver, src, w, Tc)  # as the align launches it
    kernel_ms = cuda_ms(launch, 50)
    plain_ms = cuda_ms(lambda: path.plain(*args), 5)
    kernel_ms_2 = cuda_ms(launch, 50)
    plain_ms_2 = cuda_ms(lambda: path.plain(*args), 5)
    wrapper_ms = cuda_ms(lambda: path.kernel(*args), 50)
    log(f"{tag} per-iteration stats at the converged T (the align's bound launch, plain, "
        f"launch, plain): {kernel_ms:.4f}, {plain_ms:.4f}, {kernel_ms_2:.4f}, {plain_ms_2:.4f} "
        f"ms; the wrapper (its pose copied to the card, operands checked) {wrapper_ms:.4f} ms")

    n_inliers = float(path.kernel(*args)[28])
    b_ms, b_by = bound_ms(*path.work(solver, src, w, Tc, n_inliers))
    log(f"{tag} bound {b_ms:.5f} ms by {b_by}")

    # 5. The path with the plain stats function on the card
    packed_grid = path.args is point_args
    proxy_share = []  # per iteration: the share of the queries that take the proxy

    def plain_stats(T):
        if packed_grid:
            pg = getattr(solver._target, "corr", solver._target).packed
            q = src @ T[:3, :3].T.to(dev) + T[:3, 3].to(dev)
            proxy_share.append(float(_unresolved(pg, q, w).sum()) / float((w > 0).sum()))
        return stats_from_packed(path.plain(*path.args(solver, src, w, T)).cpu())

    cfg = solver.cfg
    T_p, d_p = pt.gauss_newton(plain_stats, torch.eye(4), cfg.max_iter, cfg.tol)
    if packed_grid:
        log(f"{tag} share of the {int((w > 0).sum())} queries that take the proxy, per "
            f"iteration: " + ", ".join(f"{x:.5f}" for x in proxy_share))
        max_abs_err = max(max_abs_err, point_edge_cases(path, dev))
    else:
        max_abs_err = max(max_abs_err, voxel_edge_cases(path, dev))
    dT = float(np.abs(T_p.numpy().astype(np.float64) - T_k).max())
    log(f"{tag} plain-stats GN: {d_p.iterations} iterations, max |dT| vs kernel {dT:.3e}")
    if not (dT < TOL_T and d_p.iterations == d.iterations):
        raise AssertionError(f"{tag} the plain-stats GN loop disagrees with the kernel's")

    return {
        "first_call_s": first_s,
        "set_target_s": min(s for s, _ in warm), "align_s": min(a for _, a in warm),
        "iterations": d.iterations, "kernel_ms": [kernel_ms, kernel_ms_2],
        "plain_ms": [plain_ms, plain_ms_2], "offset_err": off_err, "dT_jax": ref_err,
        "dT_plain": dT, "launches": launches, "max_abs_err": max_abs_err,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "T": T_k,
        "resident": resident,
        "loop_launches": counts[path.loop], **loops,
        "extra": {"wrapper_ms": wrapper_ms},
        **({"proxy_share": proxy_share} if packed_grid else {}),
    }


def compare_loops(tag: str, align, T, d, max_syncs: int | None = None,
                  n_points: int | None = None) -> dict:
    """The resident loop against the host loop on one path, ``align() ->
    (T, diagnostics)`` on device-resident inputs: :func:`hold_to_host`, then
    the align walls in turns (host, resident, resident, host), each loop's
    device time and busy share by the profiler, and the host milliseconds
    per iteration (wall less device time, over the iterations). A batch
    (``n_points`` a scan) also gets registrations/s."""
    import torch

    out = hold_to_host(tag, align, T, d, max_syncs)
    walls = {"host_loop": [], "resident_loop": []}
    for mode in ("host_loop", "resident_loop", "resident_loop", "host_loop"):
        with host_loop() if mode == "host_loop" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            align()
            walls[mode].append(time.perf_counter() - t0)
    its = int(np.asarray(d.iterations).max())
    line = []
    for mode, wall in walls.items():
        with host_loop() if mode == "host_loop" else contextlib.nullcontext():
            device_ms, n_kernels, busy = device_busy(align, min(wall))
        host_ms = (1e3 * min(wall) - device_ms) / its
        out[mode] = {"align_walls_s": wall, "device_ms": device_ms, "kernels": n_kernels,
                     "busy": busy, "host_ms_per_iteration": host_ms}
        extra = ""
        if n_points is not None:
            B = np.asarray(d.iterations).size
            out[mode]["regs_per_s"] = B / min(wall)
            out[mode]["mpts_per_s"] = B * n_points / min(wall) / 1e6
            extra = (f", {B / min(wall):.1f} registrations/s, "
                     f"{B * n_points / min(wall) / 1e6:.2f} Mpts/s")
        line.append(f"{mode}: align ms {', '.join(f'{1e3 * x:.3f}' for x in wall)}; device "
                    f"{device_ms:.3f} ms in {n_kernels} kernels, busy {100 * busy:.1f} %; host "
                    f"{host_ms:.3f} ms per iteration{extra}")
    log(f"{tag} {its} iterations, in turns (host, resident, resident, host): " + "; ".join(line))
    return out


# The update (csrc/gn_step.cuh) of one problem and iteration: the 29 stats
# read, the pose read and written, the four counters and flags read and
# written, final_e2 and three history entries written (260 bytes); the solve
# (scaling 30, Hs 42, factor 91, substitutions 72, rescale 6), the norm (12)
# and the update (exp 90, pose 60): about 410 operations.
GN_STEP_BYTES = 116 + 2 * 48 + 2 * 16 + 4 + 12
GN_STEP_FLOPS = 410


# Phase 2c: the loop kernel (csrc/gn_loop.cu), VPlaneICP's and NDT's whole
# Gauss-Newton loop in one launch
LOOP_KINDS = {"vplane_icp": ("plane", "VPlaneICP", FLOPS_PLANE_ROW),
              "ndt": ("ndt", "NDT", FLOPS_M3_POINT)}
TOL_LOOP = 1e-5  # max |dT| and the e2 / |dx| histories' relative gap to the host loop
LOOP_SOURCE = f"{CSRC}/gn_loop.cu"
LOOP_REPLACES = "point_cloud_registration_tpu/core/gn.py:182"  # the while_loop of gauss_newton
LOOP_LABELS = {"ILi0E": "plane", "ILi1E": "ndt"}


def rel_gap(a, b, n: int) -> float:
    """Largest |a - b| / |b| over the first ``n`` entries (0 where both are 0)."""
    a = np.asarray(a[:n], np.float64)
    b = np.asarray(b[:n], np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30), initial=0.0))


def run_gn_loop(map_np, scan_np, dev) -> dict:
    """Phase 2c: the loop kernel at the main path's shapes (the city map, the
    100k scan, VPlaneICP's and NDT's targets and settings), from T = I and
    from a perturbed start, against the host loop (:func:`host_align`: the
    stats kernel, the solve and the update on the host) on the same
    tensors: the first iteration's block rows bit-equal to the stats kernel's
    (the loop kernel's ``rows`` output), equal iterations and flags, T within
    TOL_LOOP, the e2 and |dx| histories within a relative TOL_LOOP, the
    inlier histories equal; three more aligns bit-identical; against its plain version
    (``fused_loop_reference``) T within TOL_LOOP. Then its time per align by
    events (a copy of the initial state and the launch) and alone (the
    profiler), the plain version's, the walls of both loops in turns with
    their device time, busy share and syncs, and its bound."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.core import gn
    from point_cloud_registration_tpu_torch.models import pad_points
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
    from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl

    src, w = pad_points(scan_np, device=dev)
    eye = torch.eye(4)
    T_pert = pt.plus(eye, torch.tensor(PERTURBATION))
    ptxas = library_ptxas("gn_loop", "gn_loop_kernel", LOOP_LABELS)
    log("[gn_loop] ptxas: " + "; ".join(
        f"{k} {v['registers']} registers, {v.get('spill_stores', 0)} / {v.get('spill_loads', 0)} "
        f"bytes spilled, {v.get('stack', 0)} bytes stack" for k, v in ptxas.items()))
    out = {"ptxas": ptxas, "launches_check": 0}
    for name, (kind, cls, row_flops) in LOOP_KINDS.items():
        tag = f"[gn_loop {kind}]"
        solver = getattr(pt, cls)(voxel_size=1.0, **PARAMS, device=dev)
        solver.set_target(map_np)
        vm, cfg = solver._target, solver.cfg
        operands = (kind, vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src, w)
        settings = dict(max_dist=cfg.max_dist, huber_delta=cfg.huber_delta, tol=cfg.tol,
                        max_iter=cfg.max_iter)
        r = {"dT_host": 0.0, "dT_plain": 0.0, "e2_rel": 0.0, "dx_rel": 0.0}
        before = gl.fused_loop.launches
        for label, T0 in (("T=I", eye), ("T=perturbed", T_pert)):
            # the stats kernel's launch at T0, the host loop's first, and its block rows
            fn, args, partials = fa.launch_args(
                fa._kernel_fn(kind), vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src[None],
                w[None], gn.pose_rows_of(T0[None]).to(dev), None, cfg.max_dist, cfg.huber_delta)
            if fn(*args) != 0:
                raise AssertionError(f"{tag} the stats launch failed")
            rows = torch.full_like(partials[0], float("nan"))
            state = gn.new_state(T0[None], cfg.max_iter, dev)
            launch = gl.fused_looper(*operands, state, **settings, rows=rows)
            launch()
            k = gn.read_state(state)
            rows_equal = torch.equal(rows, partials[0])
            T_host, d_host = host_align(solver, src, w, T0)
            plain = gn.new_state(T0[None], cfg.max_iter, "cpu")
            gl.fused_loop_reference(*operands, plain, **settings)
            its = int(k.it[0])
            T_k = gn.transforms_of(k.poses)[0]
            dT_h = float((T_k - T_host).abs().max())
            dT_plain = float((T_k - gn.transforms_of(plain.poses)[0]).abs().max())
            flags = (its, bool(k.converged[0]), bool(k.failed[0]))
            e2_rel = rel_gap(k.e2[0], d_host.e2_history, its)
            dx_rel = rel_gap(k.dx_norm[0], d_host.dx_norm_history, its)
            inliers_equal = torch.equal(k.inliers[0], d_host.inlier_history)
            warm_equal = []
            for _ in range(3):
                state = gn.new_state(T0[None], cfg.max_iter, dev)
                gl.fused_loop(*operands, state, **settings)
                warm_equal.append(torch.equal(gn.read_state(state).words, k.words))
            log(f"{tag} {label} on {src.shape[0]} points, grid {launch.grid[0]} CTAs for "
                f"{launch.grid[1]} block ids: first iteration's block rows bit-equal to the stats "
                f"kernel's {rows_equal}; {its} iterations "
                f"(host loop {d_host.iterations}, plain {int(plain.it[0])}), converged "
                f"{flags[1]} / {d_host.converged}, failed {flags[2]} / {d_host.solver_failed}; "
                f"max |T - T_host| {dT_h:.3e}, |T - T_plain| {dT_plain:.3e}; relative "
                f"e2 gap {e2_rel:.3e}, |dx| gap {dx_rel:.3e}; inliers equal {inliers_equal}; "
                f"three more aligns bit-identical {warm_equal}")
            if not (rows_equal and flags == (d_host.iterations, d_host.converged,
                                                   d_host.solver_failed)
                    and flags == (int(plain.it[0]), bool(plain.converged[0]),
                                  bool(plain.failed[0]))
                    and dT_h <= TOL_LOOP and dT_plain <= TOL_LOOP and e2_rel <= TOL_LOOP
                    and dx_rel <= TOL_LOOP and inliers_equal and all(warm_equal)):
                raise AssertionError(f"{tag} {label}: the loop kernel is off the host loop or its "
                                     "plain version")
            for key, v in (("dT_host", dT_h), ("dT_plain", dT_plain), ("e2_rel", e2_rel),
                           ("dx_rel", dx_rel)):
                r[key] = max(r[key], v)
            if label == "T=I":
                r["iterations"], T_conv = its, T_k
                r["inliers"] = float(k.inliers[0][its - 1])
        out["launches_check"] += gl.fused_loop.launches - before

        # time per align at T = I: events (the state's copy and the launch), alone
        init = gn.new_state(eye[None], cfg.max_iter, dev)
        state = gn.new_state(eye[None], cfg.max_iter, dev)
        launch = gl.fused_looper(*operands, state, **settings)

        def once():
            state.words.copy_(init.words)
            launch()

        r["ms"] = cuda_ms(once, 50)
        r["alone_ms"] = kernel_alone_ms(once, 20, "gn_loop_kernel")
        r["plain_ms"] = cuda_ms(lambda: gl.fused_loop_reference(
            *operands, gn.new_state(eye[None], cfg.max_iter, "cpu"), **settings), 2)
        # both loops' aligns in turns (host, loop, loop, host): the loop kernel's
        # through the solver's prepared loop
        aligns = {"host": lambda: host_align(solver, src, w, eye),
                  "loop": lambda: solver._align_fn(vm, src, w, eye)}
        walls = {m: [] for m in aligns}
        for mode in ("host", "loop", "loop", "host"):
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                aligns[mode]()
                walls[mode].append(time.perf_counter() - t0)
        line = []
        for mode, align in aligns.items():
            device_ms, n_kernels, busy = device_busy(align, min(walls[mode]))
            _, syncs = count_syncs(align)
            r[mode] = {"align_walls_s": walls[mode], "device_ms": device_ms, "kernels": n_kernels,
                       "busy": busy, "syncs": syncs}
            line.append(f"{mode}: align ms {', '.join(f'{1e3 * x:.3f}' for x in walls[mode])}; "
                        f"device {device_ms:.3f} ms in {n_kernels} kernels, busy "
                        f"{100 * busy:.1f} %, {syncs} syncs")
        if r["loop"]["syncs"] != 1:
            raise AssertionError(f"{tag} {r['loop']['syncs']} syncs in an align through the loop "
                                 "kernel, not 1")
        # bound: the stats' work at the converged pose for each iteration run,
        # each input read once, the state's 260 bytes; also with the stats'
        # bytes read again every iteration
        its = r["iterations"]
        n_bytes, flops = voxel_work(row_flops)(solver, src, w, T_conv, r["inliers"])
        ops = its * (flops + GN_STEP_FLOPS)
        r["bound_ms"], r["bound_by"] = bound_ms(n_bytes + GN_STEP_BYTES, ops)
        r["bound_reread_ms"] = bound_ms(its * n_bytes + GN_STEP_BYTES, ops)[0]
        log(f"{tag} {its} iterations a launch: {r['ms']:.4f} ms by events (the state's copy and "
            f"the launch), alone {r['alone_ms']:.4f} ms (profiler); the plain version "
            f"{r['plain_ms']:.2f} ms; bound {r['bound_ms']:.5f} ms by {r['bound_by']} (the stats' "
            f"bytes read every iteration: {r['bound_reread_ms']:.5f} ms)")
        log(f"{tag} aligns in turns (host, loop, loop, host): " + "; ".join(line))
        out[kind] = r
    out["max_abs_err"] = max(out[k]["dT_plain"] for k in ("plane", "ndt"))
    return out


# Phase 2d: the point loop (csrc/point_loop.cu: ICP and PlaneICP on the
# packed grid) and the grid loop (csrc/grid_loop.cu: ICP and PlaneICP on a
# small target's grid, VPlaneICP and NDT on a hashed map), each align's
# whole Gauss-Newton loop in one launch
NEW_LOOPS = {  # case: (loop wrapper, kind, the stats kernel it runs)
    "icp": ("point_loop", "point", "point_stats"),
    "plane_icp": ("point_loop", "plane_pt", "plane_point_stats"),
    "icp_grid": ("grid_loop", "point", "grid_point_stats"),
    "plane_icp_grid": ("grid_loop", "plane_pt", "grid_plane_point_stats"),
    "vplane_icp_hashed": ("grid_loop", "plane", "hashed_plane_stats"),
    "ndt_hashed": ("grid_loop", "ndt", "hashed_ndt_stats"),
}
LOOP_SOURCES = {"point_loop": f"{CSRC}/point_loop.cu", "grid_loop": f"{CSRC}/grid_loop.cu"}
LOOP_STATS_OF = {"point_loop": f"{PALLAS}/point_align.py:594",
                 "grid_loop": "point_cloud_registration_tpu/ops/knn.py:410, :78"}
LOOP_PTXAS_LABELS = {"point_loop": {"ILi0E": "point", "ILi1E": "plane_pt"},
                     "grid_loop": {"ILi0E": "point", "ILi1E": "plane_pt", "ILi2E": "plane",
                                   "ILi3E": "ndt"}}


def float_bits(x):
    """A tensor's words as int32, so that NaN payloads compare too."""
    import torch

    x = torch.as_tensor(x)
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def new_loop_cases(map_np, scan_np, dev) -> dict:
    """Phase 2d's operands: for each case of ``NEW_LOOPS`` its solver's
    :func:`loop_case` on the case's target and scan."""
    import point_cloud_registration_tpu_torch as pt
    from bench import make_lidar_map, make_scan

    rng = np.random.RandomState(SEED)
    small = make_lidar_map(rng, N_SMALL)
    small_scan = make_scan(rng, small, N_SMALL_SCAN)
    two = np.vstack([map_np, map_np + TILE_SHIFT])
    solvers = {
        "icp": (pt.ICP(**PARAMS, device=dev), map_np, scan_np),
        "plane_icp": (pt.PlaneICP(**PARAMS, k=K_NORMALS, device=dev), map_np, scan_np),
        "icp_grid": (pt.ICP(**PARAMS, device=dev), small, small_scan),
        "plane_icp_grid": (pt.PlaneICP(**PARAMS, device=dev), small, small_scan),
        "vplane_icp_hashed": (pt.VPlaneICP(voxel_size=1.0, **PARAMS, device=dev), two, scan_np),
        "ndt_hashed": (pt.NDT(voxel_size=1.0, **PARAMS, device=dev), two, scan_np),
    }
    return {case: loop_case(case, s, target, scan, dev)
            for case, (s, target, scan) in solvers.items()}


def loop_case(case: str, s, target_np, scan, dev) -> dict:
    """Solver ``s`` with its target set to ``target_np``, its align's scan
    tensors on the card, ``looper(state, rows=None)`` (the loop kernel's
    bound launch), the plain loop ``plain(state)``, ``first(T0) -> (fn,
    args, partials)`` (the stats kernel's launch at ``T0``, the host loop's
    first) and ``work(T, n_inliers) -> (bytes, flops)`` of one iteration's
    stats."""
    import torch

    from point_cloud_registration_tpu_torch.core import gn
    from point_cloud_registration_tpu_torch.models import pad_points
    from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius
    from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    loop, kind, _ = NEW_LOOPS[case]
    s.set_target(target_np)
    cfg = s.cfg
    src, w = pad_points(scan, device=dev)
    settings = dict(max_dist=cfg.max_dist, huber_delta=cfg.huber_delta, tol=cfg.tol,
                    max_iter=cfg.max_iter)
    pose = lambda T0: gn.pose_rows_of(T0[None]).to(dev)  # noqa: E731
    if loop == "point_loop":
        tg = getattr(s._target, "corr", s._target)
        if tg.packed is None:
            raise AssertionError(f"[{case}] the target is not packed")
        radius = proxy_radius(cfg.corr, cfg.max_dist)
        operands = (kind, tg.packed, tg.proxy, src, w)
        looper = functools.partial(gl.point_looper, *operands, proxy_radius=radius, **settings)
        plain = functools.partial(gl.point_loop_reference, *operands, proxy_radius=radius,
                                  **settings)
        first = lambda T0: pa.partials_args(  # noqa: E731
            pa._kernel_fn(kind), tg.packed, tg.proxy, src[None], w[None], pose(T0), None,
            cfg.max_dist, radius, cfg.huber_delta)
        point = kind == "point"
        per_call = point_work(FLOPS_M3_POINT if point else FLOPS_PLANE_ROW, 12 if point else 24,
                              16 if point else 32)
        work = lambda T, n: per_call(s, src, w, T, n)  # noqa: E731
    else:
        hashed = kind in ("plane", "ndt")
        if hashed != bool(getattr(s._target, "hashed", False)):
            raise AssertionError(f"[{case}] the target's layout is not the case's")
        grid, table, offsets = grid_operands(kind, s)
        operands = (kind, grid, table, src, w, offsets)
        looper = functools.partial(gl.grid_looper, *operands, **settings)
        plain = functools.partial(gl.grid_loop_reference, *operands, **settings)
        off_d, window = ga.bind_window(grid, offsets, dev)
        first = lambda T0: ga._launch_args(  # noqa: E731
            ga._kernel_fn(kind), grid, table, src, w, off_d, window, pose(T0), None,
            cfg.max_dist, cfg.huber_delta, None)

        def work(T, n_inliers):
            idx = torch.empty(src.shape[0], dtype=torch.int32, device=dev)
            d2 = torch.empty(src.shape[0], device=dev)
            grid_fns(kind)[0](grid, table, src, w, T[:3, :3], T[:3, 3], offsets, cfg.max_dist,
                              cfg.huber_delta, matches=(idx, d2))
            return grid_work(kind, grid, table, src, w, T, offsets, cfg.max_dist, idx, d2)[:2]
    return {"solver": s, "src": src, "w": w, "cfg": cfg, "looper": looper, "plain": plain,
            "first": first, "work": work}


def run_new_loops(map_np, scan_np, dev) -> dict:
    """Phase 2d: the point and grid loops on the main paths' data (the city
    map and the 100k scan for ICP and PlaneICP on the packed grid and for
    VPlaneICP and NDT on phase 10's two-tile hashed map; phase 9's 40k LiDAR
    target and 10k scan for ICP and PlaneICP on a grid target), from T = I
    and from a perturbed start, against the host loop (:func:`host_align`:
    the stats kernel, the solve and the update on the host) on the same
    tensors: the first iteration's block rows, T, the iterations, the flags
    and the e2, |dx| and inlier histories bit-equal; three more aligns
    bit-identical; against its plain version (``point_loop_reference`` /
    ``grid_loop_reference``: the plain stats on the card, ``gn_step_reference``
    on the host) T within TOL_T (phase 5's bound on the plain stats' GN
    loop: their float32 sums run in another order), equal iterations and
    flags; for ICP a launch of more CTAs than fit on the card (832 on room
    for 792) must raise and change nothing. Then its
    time per align by events (a copy of the initial state and the launch)
    and alone (the profiler), the plain version's, both loops' aligns in
    turns with their device time, busy share and syncs (one through the loop
    kernel), its bound (the stats' work at the converged pose times the
    iterations, each input read once, with the update's) and each kind's
    ptxas report."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.core import gn
    from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl

    eye = torch.eye(4)
    T_pert = pt.plus(eye, torch.tensor(PERTURBATION))
    out = {"ptxas": {}}
    for loop, labels in LOOP_PTXAS_LABELS.items():
        out["ptxas"][loop] = library_ptxas(loop, "gn_loop_kernel", labels)
        log(f"[{loop}] ptxas: " + "; ".join(
            f"{k} {v['registers']} registers, {v.get('spill_stores', 0)} / "
            f"{v.get('spill_loads', 0)} bytes spilled, {v.get('stack', 0)} bytes stack"
            for k, v in out["ptxas"][loop].items()))
    for case, c in new_loop_cases(map_np, scan_np, dev).items():
        loop, kind, _ = NEW_LOOPS[case]
        wrapper = getattr(gl, loop)
        tag = f"[{loop} {case}]"
        cfg, src = c["cfg"], c["src"]
        r = {"dT_plain": 0.0, "e2_rel_plain": 0.0}
        before = wrapper.launches
        for label, T0 in (("T=I", eye), ("T=perturbed", T_pert)):
            fn, args, partials = c["first"](T0)
            if fn(*args) != 0:
                raise AssertionError(f"{tag} the stats launch failed")
            rows = torch.full_like(partials[0], float("nan"))
            state = gn.new_state(T0[None], cfg.max_iter, dev)
            launch = c["looper"](state, rows=rows)
            launch()
            k = gn.read_state(state)
            rows_equal = torch.equal(rows, partials[0])
            T_host, d_host = host_align(c["solver"], src, c["w"], T0)
            plain = gn.new_state(T0[None], cfg.max_iter, "cpu")
            c["plain"](plain)
            its = int(k.it[0])
            T_k = gn.transforms_of(k.poses)[0]
            same = (torch.equal(float_bits(T_k), float_bits(T_host))
                    and (its, bool(k.converged[0]), bool(k.failed[0])) == (
                        d_host.iterations, d_host.converged, d_host.solver_failed)
                    and all(torch.equal(float_bits(a), float_bits(b)) for a, b in (
                        (k.e2[0], d_host.e2_history), (k.dx_norm[0], d_host.dx_norm_history),
                        (k.inliers[0], d_host.inlier_history),
                        (k.final_e2[0], torch.tensor(d_host.final_e2)))))
            dT_plain = float((T_k - gn.transforms_of(plain.poses)[0]).abs().max())
            e2_rel = rel_gap(k.e2[0], plain.e2[0], its)
            plain_same = (its, bool(k.converged[0]), bool(k.failed[0])) == (
                int(plain.it[0]), bool(plain.converged[0]), bool(plain.failed[0]))
            warm_equal = []
            for _ in range(3):
                state = gn.new_state(T0[None], cfg.max_iter, dev)
                c["looper"](state)()
                warm_equal.append(torch.equal(gn.read_state(state).words, k.words))
            log(f"{tag} {label} on {src.shape[0]} points, grid {launch.grid[0]} CTAs for "
                f"{launch.grid[1]} block ids: first iteration's block rows bit-equal to the stats "
                f"kernel's {rows_equal}; {its} iterations (host loop {d_host.iterations}, plain "
                f"{int(plain.it[0])}), converged {bool(k.converged[0])}, failed "
                f"{bool(k.failed[0])}; T, flags and histories bit-equal to the host loop's "
                f"{same}; plain version: max |dT| {dT_plain:.3e}, relative e2 gap {e2_rel:.3e}, "
                f"iterations and flags equal {plain_same}; three more aligns bit-identical "
                f"{warm_equal}")
            if not (rows_equal and same and plain_same and dT_plain < TOL_T and all(warm_equal)
                    and bool(k.converged[0])):
                raise AssertionError(f"{tag} {label}: the loop kernel is off the host loop or its "
                                     "plain version")
            r["dT_plain"] = max(r["dT_plain"], dT_plain)
            r["e2_rel_plain"] = max(r["e2_rel_plain"], e2_rel)
            if label == "T=I":
                r["iterations"], T_conv = its, T_k
                r["inliers"] = float(k.inliers[0][its - 1])
        r["launches_check"] = wrapper.launches - before
        if case == "icp":  # more CTAs than fit at once: the card refuses, the wrapper raises
            fn, block, per_sm, error_string = gl._point_kernel_fn(kind)
            state = gn.new_state(eye[None], cfg.max_iter, dev)
            launch = c["looper"](state, bound=(fn, block, lambda device=None: per_sm(device) + 1,
                                               error_string))
            try:
                launch()
            except RuntimeError as err:
                log(f"{tag} {launch.grid[0]} CTAs of {launch.grid[1]} block ids with room for "
                    f"{per_sm()} an SM: {err}")
            else:
                raise AssertionError(f"{tag} a cooperative launch of more CTAs than fit ran")
            if wrapper.launches != before + r["launches_check"] or int(
                    gn.read_state(state).it[0]) != 0:
                raise AssertionError(f"{tag} the refused launch counted or ran")

        # time per align at T = I: events (the state's copy and the launch), alone
        init = gn.new_state(eye[None], cfg.max_iter, dev)
        state = gn.new_state(eye[None], cfg.max_iter, dev)
        launch = c["looper"](state)

        def once():
            state.words.copy_(init.words)
            launch()

        r["ms"] = cuda_ms(once, 30)
        r["alone_ms"] = kernel_alone_ms(once, 20, "gn_loop_kernel")
        r["plain_ms"] = cuda_ms(lambda: c["plain"](gn.new_state(eye[None], cfg.max_iter, "cpu")),
                                2)
        # both loops' aligns in turns (host, loop, loop, host): the loop kernel's
        # through the solver's prepared loop
        s = c["solver"]
        aligns = {"host": lambda: host_align(s, src, c["w"], eye),
                  "loop": lambda: s._align_fn(s._target, src, c["w"], eye)}
        walls = {m: [] for m in aligns}
        for mode in ("host", "loop", "loop", "host"):
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                aligns[mode]()
                walls[mode].append(time.perf_counter() - t0)
        line = []
        for mode, align in aligns.items():
            device_ms, n_kernels, busy = device_busy(align, min(walls[mode]))
            _, syncs = count_syncs(align)
            r[mode] = {"align_walls_s": walls[mode], "device_ms": device_ms, "kernels": n_kernels,
                       "busy": busy, "syncs": syncs}
            line.append(f"{mode}: align ms {', '.join(f'{1e3 * x:.3f}' for x in walls[mode])}; "
                        f"device {device_ms:.3f} ms in {n_kernels} kernels, busy "
                        f"{100 * busy:.1f} %, {syncs} syncs")
        if r["loop"]["syncs"] != 1:
            raise AssertionError(f"{tag} {r['loop']['syncs']} syncs in an align through the loop "
                                 "kernel, not 1")
        # bound: the stats' work at the converged pose for each iteration run,
        # each input read once, the state's 260 bytes; also with the stats'
        # bytes read again every iteration
        its = r["iterations"]
        n_bytes, flops = c["work"](T_conv, r["inliers"])
        ops = its * (flops + GN_STEP_FLOPS)
        r["bound_ms"], r["bound_by"] = bound_ms(n_bytes + GN_STEP_BYTES, ops)
        r["bound_reread_ms"] = bound_ms(its * n_bytes + GN_STEP_BYTES, ops)[0]
        log(f"{tag} {its} iterations a launch: {r['ms']:.4f} ms by events (the state's copy and "
            f"the launch), alone {r['alone_ms']:.4f} ms (profiler); the plain version "
            f"{r['plain_ms']:.2f} ms; bound {r['bound_ms']:.5f} ms by {r['bound_by']} (the stats' "
            f"bytes read every iteration: {r['bound_reread_ms']:.5f} ms)")
        log(f"{tag} aligns in turns (host, loop, loop, host): " + "; ".join(line))
        out[case] = r
    for loop in LOOP_SOURCES:
        out[f"{loop}_max_abs_err"] = max(out[case]["dT_plain"] for case, (l, _, _) in
                                         NEW_LOOPS.items() if l == loop)
    return out


def lattice_scene():
    """A small target whose ties are exact: one point per 0.5 m fine cell of a
    4 m cube (eight per packed block, every coordinate a multiple of 1/4), a
    seeded random unit normal per point, and scans named by what they test."""
    g = np.arange(8, dtype=np.float32) * 0.5 + 0.25
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    rng = np.random.RandomState(SEED)
    normals = rng.randn(len(pts), 3)
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    above = np.stack(np.meshgrid(g, g, [4.5, 4.75, 5.0], indexing="ij"), axis=-1).reshape(-1, 3)
    scans = {
        # midway between two kept points of two blocks: the block probed first wins
        "tie of two blocks": [[1.0, 0.25, 0.25]],
        # midway between two kept points of one block: the earlier slot wins
        "tie in one block": [[0.5, 0.25, 0.25]],
        # beyond cell_fine of every point, midway between two proxy centroids
        "tie of two proxy voxels": [[1.0, 0.5, 4.6]],
        # no block of the window in the grid; a window that the grid cuts; one
        # that reaches a proxy voxel from outside
        "outside the grid": [[100.0, 100.0, 100.0], [-0.2, 0.3, 0.3], [-1.0, 2.0, 2.0]],
        # every query at least cell_fine above the top layer: all to the proxy
        "all to the proxy": above + rng.rand(len(above), 3) * 0.1,
        "generic": rng.rand(3000, 3) * 5.0 - 0.5,
    }
    return pts, normals, {k: np.asarray(v, np.float32) for k, v in scans.items()}


def point_edge_cases(path: SolverPath, dev) -> float:
    """The packed-grid stats kernel of ``path`` against its plain version on
    the lattice scene; returns the largest absolute error."""
    import torch

    from point_cloud_registration_tpu_torch.ops.pointgrid import build_packed_grid_and_proxy

    plane = path.name == "plane_icp"
    pts, normals, scans = lattice_scene()
    pts_t = torch.from_numpy(pts).to(dev)
    feats = torch.from_numpy(normals).to(dev) if plane else None
    worst = 0.0
    # rows of 32 slots are multiples of 16 bytes; 30 x 12 and 31 x 24 bytes are not
    for cap in (32, 30, 31):
        pg, proxy = build_packed_grid_and_proxy(pts_t, 0.5, cap, min_points=3 if plane else 1,
                                                with_normals=plane, feats=feats)
        for name, scan in scans.items():
            src = torch.from_numpy(scan).to(dev)
            w = torch.ones(len(scan), device=dev)
            for T in (torch.tensor(np.float32(
                    [[1, 0, 0, 0.5], [0, 1, 0, 0.25], [0, 0, 1, -0.5], [0, 0, 0, 1]])),
                    torch.eye(4)):
                args = (pg, proxy, src, w, T[:3, :3], T[:3, 3], 2.0, 2, None)
                k, p = path.kernel(*args), path.plain(*args)
                err = float((k - p).abs().max())
                if not (err <= 1e-5 * max(1.0, float(p.abs().max())) and k[28] == p[28]):
                    raise AssertionError(f"[{path.name}] {name}, cap {cap}: kernel {k.tolist()} "
                                         f"against plain {p.tolist()}")
                worst = max(worst, err)
            # p is now the plain version's result at T = I
            if name == "all to the proxy" and not (
                    _unresolved(pg, src, w).all() and float(p[28]) == len(scan)):
                raise AssertionError(f"[{path.name}] {name}: some query did not take the proxy")
    log(f"[{path.name}] kernel vs plain on the lattice scene ({', '.join(scans)}; caps 32, 30, "
        f"31; two poses): max abs err {worst:.3e}")
    return worst


def voxel_lattice(kind: str, dev):
    """A small voxel map whose distances are exact: cells of 1 m on a grid of
    (37, 9, 7) (rows of 37 cells cross the 32-cell words of the bitmap at
    every offset), centroids at the cell centres, a quarter of the cells
    valid, with seeded random unit normals ("plane") or random upper
    triangular U ("ndt"); a 7x7x7 block left empty. Returns ``(cells, dims,
    valid, ties)``: ``ties`` holds queries midway between two valid cells,
    of two rows and of two words of one row."""
    import torch

    from point_cloud_registration_tpu_torch.ops.knn import cell_index

    dims = (37, 9, 7)
    rng = np.random.RandomState(SEED)
    d = int(np.prod(dims))
    key = np.arange(d)
    xyz = np.stack([key % dims[0], (key // dims[0]) % dims[1], key // (dims[0] * dims[1])], 1)
    valid = rng.rand(d) < 0.25
    valid[(xyz[:, 0] >= 20) & (xyz[:, 0] < 27) & (xyz[:, 1] >= 1) & (xyz[:, 1] < 8)] = False
    ties = []
    for low, high, mid in ((31, 32, [32.0, 0.5, 0.5]), (63, 64, [27.0, 1.5, 0.5]),
                           (5, 5 + dims[0], [5.5, 1.0, 0.5]),
                           (140, 140 + dims[0], [29.5, 4.0, 0.5])):
        valid[[low, high]] = True
        ties.append(mid)
    if kind == "plane":
        feats = rng.randn(d, 3)
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    else:
        feats = rng.randn(d, 6) * 0.3 + np.array([1.0, 0.0, 0.0, 1.0, 0.0, 1.0])
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    cells = cell_index(t(xyz + 0.5), torch.from_numpy(valid).to(dev), t(feats))
    return cells, dims, valid, np.asarray(ties, np.float32)


def voxel_edge_cases(path: SolverPath, dev) -> float:
    """The fused voxel kernel of ``path`` against its plain version on the
    lattice map: each tie query, a query whose window holds no valid cell and
    queries on, across and beyond every face of the grid, one launch each
    (the sums of one query name its winner); then 1,000 queries (no multiple
    of the 256-thread block) with weights of which a third are 0, and the same
    scan ordered by cell. Returns the largest absolute error."""
    import torch

    from point_cloud_registration_tpu_torch.ops.knn import nearest_valid_cell

    kind = "plane" if path.name == "vplane_icp" else "ndt"
    cells, dims, valid, ties = voxel_lattice(kind, dev)
    rng = np.random.RandomState(SEED + 1)
    hi = np.float32(dims)
    singles = {
        "tie": ties,
        "empty window": np.float32([[23.5, 4.5, 3.5]]),
        "faces": np.vstack([rng.rand(40, 3) * (hi + 6) - 3,
                            np.float32([[0.0, 4.2, 3.1], [36.99, 4.2, 3.1], [10.1, 0.0, 6.99],
                                        [10.1, 8.99, 0.0], [-2.5, 4.5, 3.5], [39.4, 8.0, 6.0],
                                        [1e12, 0.0, 0.0], [5.0, -3e9, 2.0]])]),
    }
    worst = 0.0
    eye, zero = torch.eye(3), torch.zeros(3)

    def check(label, src, w, max_dist):
        nonlocal worst
        args = (cells, (0, 0, 0), dims, 1.0, src, w, eye, zero, max_dist, None)
        k, p = path.kernel(*args), path.plain(*args)
        err = float((k - p).abs().max())
        # n is the summed weight: equal for weights of 1, to rounding for others
        if not (err <= 1e-5 * max(1.0, float(p.abs().max()))
                and abs(float(k[28] - p[28])) <= 1e-5 * max(1.0, float(p[28]))):
            raise AssertionError(f"[{path.name}] {label}: kernel {k.tolist()} against plain "
                                 f"{p.tolist()}")
        worst = max(worst, err)
        return p

    for max_dist in (2.0, 1.0):  # windows of radius 2 and 1
        for name, qs in singles.items():
            for j, qn in enumerate(qs):
                src = torch.from_numpy(qn[None].astype(np.float32)).to(dev)
                p = check(f"{name} {qn.tolist()} at max_dist {max_dist}", src,
                          torch.ones(1, device=dev), max_dist)
                if name == "empty window" and float(p[28]) != 0.0:
                    raise AssertionError(f"[{path.name}] the empty window found a cell")
        # each tie goes to the cell probed first, the lower key
        q = torch.from_numpy(ties).to(dev)
        _, row = nearest_valid_cell(cells.centers, dims, torch.floor(q).long(), q, int(max_dist),
                                    occ=cells.occ)
        keys = np.flatnonzero(valid)[row.cpu().numpy()]
        if not np.array_equal(keys, [31, 63, 5, 140]):
            raise AssertionError(f"[{path.name}] the plain version's tie winners are {keys}")
        many = torch.from_numpy((rng.rand(1000, 3) * (hi + 2) - 1).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.rand(1000) > 0.33).astype(np.float32)
                             * rng.rand(1000).astype(np.float32)).to(dev)
        check(f"1000 queries, {int((w == 0).sum())} of weight 0", many, w, max_dist)
        c = torch.floor(many) + 2  # ordered by cell, as a LiDAR's scan lines nearly are
        order = torch.argsort(c[:, 0] + 64 * (c[:, 1] + 64 * c[:, 2]), stable=True)
        check("the same ordered by cell", many[order].contiguous(), w[order].contiguous(),
              max_dist)
    log(f"[{path.name}] kernel vs plain on the voxel lattice (ties of two rows and of two "
        f"words of a row, an empty window, the grid's faces, one query per launch; 1,000 "
        f"queries with zero weights, in the caller's order and by cell; radius 2 and 1): "
        f"max abs err {worst:.3e}")
    return worst


def run_normals(map_t, dev) -> tuple:
    """Phase 6: the normals path and its kernel; returns ``(normals,
    measurements)``."""
    import torch

    from point_cloud_registration_tpu_torch.ops import normals as nm
    from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn
    from point_cloud_registration_tpu_torch.ops.pointgrid import build_packed_grid

    tag = "[normals]"
    n = map_t.shape[0]
    # Main path, through the user's entry point
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    normals, info = nm.estimate_normals(map_t, k=K_NORMALS, return_info=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = kn.knn_moments.launches
    exact_frac = float(info["exact"].float().mean())
    log(f"{tag} main path (first call): {first_s:.3f} s; cell_size {info['cell_size']:.6f}, "
        f"cap {info['cap']}, base tier {info['n_base']} queries, wide tier {info['n_wide']}, "
        f"unresolved {info['n_unresolved']}, certified exact {exact_frac:.4f}; "
        f"launch counts {counts}")
    tiers = 1 + (info["n_wide"] > 0)
    if launches != tiers:
        raise AssertionError(f"{tag} knn_moments launched {launches} times for {tiers} tiers")
    chain_launches = {key: counts[key] for key in CHAIN_STEPS}
    if chain_launches != dict.fromkeys(CHAIN_STEPS, 1):
        raise AssertionError(f"{tag} a step of the normals chain did not launch once")
    if normals.shape != (n, 3) or not torch.isfinite(normals).all():
        raise AssertionError(f"{tag} normals are not finite (N, 3)")
    unit = float((normals.norm(dim=1) - 1).abs().max())
    if not unit < 1e-4:
        raise AssertionError(f"{tag} normals are not unit vectors: {unit}")
    got = {"n_wide": info["n_wide"], "n_unresolved": info["n_unresolved"],
           "n_exact": int(info["exact"].sum())}
    if got != NORMALS_REF:
        raise AssertionError(f"{tag} tiers and certificate {got}, recorded {NORMALS_REF}")
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_w, info_w = nm.estimate_normals(map_t, k=K_NORMALS, return_info=True)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if not (torch.equal(n_w, normals) and torch.equal(info_w["exact"], info["exact"])):
            raise AssertionError(f"{tag} a warm run gave another result than the first")
    log(f"{tag} warm (device-resident input), estimate_normals s: "
        + ", ".join(f"{x:.4f}" for x in warm))

    # Kernel vs plain version at the main path's shapes and inputs: the base
    # tier over every point of the map, the wide tier over the tail that the
    # base tier could not certify, the queries estimate_normals sends it
    pg = build_packed_grid(map_t, info["cell_size"], cap=32, auto_cap=True)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    base = lambda: kn.knn_moments(pg, map_t, ones, K_NORMALS, nm.BASE_RADIUS)
    base_ms = cuda_ms(base, 3)
    p_base, plain_ms = cuda_ms_once(
        lambda: kn.knn_moments_reference(pg, map_t, ones, K_NORMALS, nm.BASE_RADIUS))
    base_ms_2 = cuda_ms(base, 3)
    k_base = base()
    _, cnt, rk2, unres, exact = k_base
    tail = torch.nonzero(~exact & ~unres
                         & (rk2 < float(np.float32((6.0 * pg.cell_fine) ** 2))))[:, 0]
    tail = tail[:info["n_wide"]]
    if tail.numel() != info["n_wide"] or pg.cap != info["cap"]:
        raise AssertionError(f"{tag} the rebuilt grid or tail is not the main path's: "
                             f"{tail.numel()} tail queries, cap {pg.cap}")
    q_w = map_t[tail].contiguous()
    wide = lambda: kn.knn_moments(pg, q_w, ones[:q_w.shape[0]], K_NORMALS, nm.WIDE_RADIUS)
    wide_ms = cuda_ms(wide, 3)
    p_wide, plain_wide_ms = cuda_ms_once(
        lambda: kn.knn_moments_reference(pg, q_w, ones[:q_w.shape[0]], K_NORMALS,
                                         nm.WIDE_RADIUS))
    max_abs_err = max(compare_knn(f"{tag} kernel vs plain, base tier (r = {nm.BASE_RADIUS})",
                                  k_base, p_base),
                      compare_knn(f"{tag} kernel vs plain, wide tier (r = {nm.WIDE_RADIUS})",
                                  wide(), p_wide))
    wide_ms_2 = cuda_ms(wide, 3)
    log(f"{tag} knn_moments per launch, grouping included: base tier (kernel, plain, kernel) "
        f"{base_ms:.3f}, {plain_ms:.1f}, {base_ms_2:.3f} ms; wide tier ({q_w.shape[0]} queries; "
        f"kernel, plain, kernel) {wide_ms:.3f}, {plain_wide_ms:.1f}, {wide_ms_2:.3f} ms")
    # The outputs must not depend on the order of the queries: a shuffled
    # sample of the map gives, point for point, the bits of the full launch
    pick = torch.from_numpy(np.random.RandomState(SEED).permutation(n)[:N_SHUFFLED]).to(dev)
    q_s = map_t[pick].contiguous()
    k_shuf = kn.knn_moments(pg, q_s, ones[:N_SHUFFLED], K_NORMALS, nm.BASE_RADIUS)
    max_abs_err = max(max_abs_err, compare_knn(
        f"{tag} kernel vs plain, shuffled sample (r = {nm.BASE_RADIUS})", k_shuf,
        kn.knn_moments_reference(pg, q_s, ones[:N_SHUFFLED], K_NORMALS, nm.BASE_RADIUS)))
    if not all(torch.equal(a, b[pick]) for a, b in zip(k_shuf, k_base)):
        raise AssertionError(f"{tag} the kernel's outputs depend on the order of the queries")
    log(f"{tag} {N_SHUFFLED} shuffled map points: bit-equal to the same points of the full launch")
    # The paths the main path's grid does not take: rows that do not start at
    # multiples of 16 bytes (a cap that is no multiple of four: copied word by
    # word), the buffer of 32 (k > 16) and its rounds (k > 32; three rounds at
    # k = 100), on a fifth of the map, where some boxes hold between 32 and k
    # candidates and some more than k
    pg_odd = build_packed_grid(map_t[:n // 5], info["cell_size"], cap=30)
    for k_odd in (K_NORMALS, 20, K_ROUNDS) + K_DEEP:
        args = (pg_odd, q_s, ones[:N_SHUFFLED], k_odd, nm.BASE_RADIUS)
        plain = kn.knn_moments_reference(*args)
        label = f"{tag} kernel vs plain, cap {pg_odd.cap}, k = {k_odd}"
        if k_odd > kn.ROUND_K:
            short = int((plain[3] & (plain[1] > kn.ROUND_K)).sum())
            full = int((~plain[3]).sum())
            label += f" ({short} queries with {kn.ROUND_K + 1} to {k_odd - 1} candidates, {full} with k)"
            if not (short > 0 and full > 0):
                raise AssertionError(f"{label}: the rounds' exits are not all taken")
        max_abs_err = max(max_abs_err, compare_knn(label, kn.knn_moments(*args), plain))
    tiers = {
        "base": knn_tier_stats(tag, pg, map_t, nm.BASE_RADIUS, float(cnt.sum())),
        "wide": knn_tier_stats(tag, pg, q_w, nm.WIDE_RADIUS, float(p_wide[1].sum())),
    }
    tiers["base"].update(kernel_ms=[base_ms, base_ms_2], plain_ms=[plain_ms])
    tiers["wide"].update(kernel_ms=[wide_ms, wide_ms_2], plain_ms=[plain_wide_ms])
    return normals, {
        "first_call_s": first_s, "estimate_normals_s": min(warm), "cell_size": info["cell_size"],
        "cap": info["cap"], "n_wide": info["n_wide"], "n_unresolved": info["n_unresolved"],
        "exact_frac": exact_frac, "tiers": tiers,
        "kernel_ms": [base_ms, base_ms_2], "plain_ms": [plain_ms], "launches": launches,
        "max_abs_err": max_abs_err, "bound_ms": tiers["base"]["bound_ms"],
        "bound_by": tiers["base"]["bound_by"], "library_ms": None,
        "chain_launches": chain_launches,
    }


def run_rounds(map_np, scan_np, dev) -> dict:
    """Phase 6b: k = 40, above one walk of the k-NN kernel, through the
    entry points: ``estimate_normals(map, k=40)`` (the kernel must run once
    per tier; the kernel against its plain version on a shuffled sample of
    the map with this k's grid) and ``PlaneICP(k=40)`` (normals of its own,
    then ``align``: through the k-NN and the plane_pt kernels, converged near
    the scan's offset)."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.ops import normals as nm
    from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa
    from point_cloud_registration_tpu_torch.ops.pointgrid import build_packed_grid

    tag = f"[normals k = {K_ROUNDS}]"
    map_t = torch.from_numpy(map_np).to(dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    normals, info = nm.estimate_normals(map_t, k=K_ROUNDS, return_info=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    tiers = 1 + (info["n_wide"] > 0)
    log(f"{tag} estimate_normals (first call): {first_s:.3f} s; cell_size "
        f"{info['cell_size']:.6f}, cap {info['cap']}, wide tier {info['n_wide']}, unresolved "
        f"{info['n_unresolved']}, certified exact {float(info['exact'].float().mean()):.4f}; "
        f"launch counts {launch_counts()}")
    counts = launch_counts()
    chain_launches = {key: counts[key] for key in CHAIN_STEPS}
    if kn.knn_moments.launches != tiers or any(counts[key] != 1 for key in CHAIN_STEPS):
        raise AssertionError(f"{tag} knn_moments launched {kn.knn_moments.launches} times "
                             f"for {tiers} tiers, the chain's steps {counts}")
    if not (torch.isfinite(normals).all() and float((normals.norm(dim=1) - 1).abs().max()) < 1e-4):
        raise AssertionError(f"{tag} normals are not finite unit vectors")
    warm_s = cuda_ms_once(lambda: nm.estimate_normals(map_t, k=K_ROUNDS))[1]
    pg = build_packed_grid(map_t, info["cell_size"], cap=32, auto_cap=True)
    pick = torch.from_numpy(np.random.RandomState(SEED).permutation(len(map_np))[:N_SHUFFLED])
    q = map_t[pick.to(dev)].contiguous()
    ones = torch.ones(q.shape[0], device=dev)
    args = (pg, q, ones, K_ROUNDS, nm.BASE_RADIUS)
    err = compare_knn(f"{tag} kernel vs plain, shuffled sample, cap {pg.cap}",
                      kn.knn_moments(*args), kn.knn_moments_reference(*args))
    reset_launches()
    solver = pt.PlaneICP(**PARAMS, k=K_ROUNDS, device=dev)
    solver.set_target(map_np)
    T = solver.align(scan_np)
    d = solver.last_diagnostics
    counts = launch_counts()
    off_err = float(np.linalg.norm(T[:3, 3] + SCAN_OFFSET))
    log(f"{tag} PlaneICP(k={K_ROUNDS}): {d.iterations} iterations, converged {d.converged}, "
        f"|t - (0, 0, -0.3)| = {off_err:.5f}, max |T - T_jax(k = {K_NORMALS})| = "
        f"{float(np.abs(T[:3] - T_REF_PLANE_ICP).max()):.2e}; launch counts {counts}")
    if not (d.converged and np.isfinite(T).all() and off_err < TOL_OFFSET
            and counts["knn_moments"] == tiers
            and all(counts[key] == 1 for key in CHAIN_STEPS)
            and (counts["point_loop"], counts["plane_point_stats"]) == (1, 0)):
        raise AssertionError(f"{tag} PlaneICP(k={K_ROUNDS}) off its path or its offset")
    return {"first_call_s": first_s, "estimate_normals_ms": warm_s, "max_abs_err": err,
            "iterations": d.iterations, "offset_err": off_err, "chain_launches": chain_launches,
            "plane_icp_chain_launches": {key: counts[key] for key in CHAIN_STEPS}}


def b01_map(seed: int = SEED):
    """A map of the benchmark's plane_icp_b01 cells: the city tile of
    ``perfbench/gen/scenes.py`` from the seed's scene stream, shifted by a
    sub-voxel amount as the rebuild traffic shifts each map."""
    from perfbench.gen.scenes import make_city_map as cell_city_map
    from perfbench.gen.traffic import seed_streams

    streams = seed_streams(seed)
    pts = cell_city_map(streams["scene"], N_MAP, 200.0)
    return (pts + streams["pool"].rand(3).astype(np.float32)).astype(np.float32)


def parent_normals(pg, points, k: int, exact_tail: bool = True) -> tuple:
    """The kernel path of ``estimate_normals`` from the packed grid on, as it
    ran before the chain of ``ops/kernels/normals_chain.py``: host-sized
    lists (``torch.nonzero``), each tier through ``knn_moments`` on gathered
    queries and an ``index_put``, ``smallest_eigvec_sym3`` and the fallback's
    search in PyTorch. ``(normals, cov6, exact, n_wide, n_unresolved)``.
    ``tests/test_torch_normals.py`` holds the chain's plain versions to it on
    the CPU."""
    import torch

    from point_cloud_registration_tpu_torch.ops import normals as nm
    from point_cloud_registration_tpu_torch.ops.eigh3 import smallest_eigvec_sym3
    from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn
    from point_cloud_registration_tpu_torch.ops.pointgrid import _knn_window_pass

    n = points.shape[0]
    ones = torch.ones(n, dtype=torch.float32, device=points.device)
    cov6, _, rk2, unres, exact = kn.knn_moments(pg, points, ones, k, nm.BASE_RADIUS)
    certifiable = rk2 < float(np.float32((6.0 * pg.cell_fine) ** 2))
    cap_t = max(min(n // 4, 1 << 18), min(n, 256))
    tail = torch.nonzero(~exact & ~unres & certifiable)[:, 0][:cap_t if exact_tail else 0]
    n_wide = int(tail.numel())
    if n_wide:
        cov_w, _, _, unres_w, exact_w = kn.knn_moments(pg, points[tail], ones[:n_wide], k,
                                                       nm.WIDE_RADIUS)
        upd = tail[~unres_w]
        cov6[upd] = cov_w[~unres_w]
        exact[upd] = exact_w[~unres_w]
    normals = smallest_eigvec_sym3(cov6)
    cap_q = max(min(n // 16, 8192), min(n, 64))
    un = torch.nonzero(unres)[:, 0]
    n_unresolved = int(un.numel())
    un = un[:cap_q]
    if un.numel():
        _, wi = _knn_window_pass(pg, points[un], k, radius=2 * nm.BASE_RADIUS,
                                 chunk=min(cap_q, 2048))
        normals[un] = nm.normals_from_neighbors(points, wi, points[un])
    return normals, cov6, exact, n_wide, n_unresolved


def profile_kernels(fn, reps: int = 3) -> tuple:
    """``(kernels per call, {kernel name: device ms per call})`` of ``fn``
    on the card, by ``torch.profiler``; copies and sets are no kernels, as
    the benchmark counts them (``perfbench/trace.py::is_kernel``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith(("Memcpy", "Memset"))]
    per = {e.key[:80]: e.self_device_time_total / 1e3 / reps for e in rows}
    return sum(e.count for e in rows) / reps, per


def run_normals_chain(maps: dict, dev) -> dict:
    """Phase 6c: the chain of ``estimate_normals`` (``ops/kernels/normals_chain.py``
    and the k-NN kernel's device-counted grouping and wide-tier launch) on
    each map of ``maps`` at each k of ``K_CHAIN``: every step against its
    plain version on the card, bit for bit (the sampler's cell size, the
    base tier against ``knn_moments``, the lists against ``torch.nonzero``,
    the wide tier's rows against gathered queries and an ``index_put``, the
    normals against ``smallest_eigvec_sym3``, the fallback's normals against
    its search in PyTorch, with the points whose k-th distance is tied
    counted), the whole ``estimate_normals`` against its code before the
    chain (:func:`parent_normals`), each wrapper's launches once a call, the
    host's waits, and the times of both versions and of each kernel alone."""
    import torch

    from point_cloud_registration_tpu_torch.ops import normals as nm
    from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn
    from point_cloud_registration_tpu_torch.ops.kernels import normals_chain as nc
    from point_cloud_registration_tpu_torch.ops.pointgrid import _knn_window_pass, build_packed_grid

    out_all = {}
    for name, map_np in maps.items():
        pts = torch.from_numpy(map_np).to(dev)
        n = pts.shape[0]
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        cap_t = max(min(n // 4, 1 << 18), min(n, 256))
        cap_q = max(min(n // 16, 8192), min(n, 64))
        for k in K_CHAIN:
            tag = f"[normals chain {name} k = {k}]"
            # the sampler on the same draws
            sel, ref, k_eff = nm.sample_draws(n, k)
            sel_t = torch.as_tensor(sel, device=dev)
            ref_t = None if ref is None else torch.as_tensor(ref, device=dev)
            before = nc.sampled_median.launches
            r_kernel = nc.sampled_median(pts, sel_t, ref_t, k_eff)
            sample_launches = nc.sampled_median.launches - before
            r_plain = nc.sampled_median_reference(pts, sel_t, ref_t, k_eff)
            cell = max(r_kernel, 1e-3)
            pg = build_packed_grid(pts, cell, cap=32, auto_cap=True)
            # the base tier: the planar launch is knn_moments' bit for bit
            out = kn.knn_moments_out(pg, pts, None, k, nm.BASE_RADIUS)
            base_equal = torch.equal(out, kn._planar(kn.knn_moments(pg, pts, ones, k,
                                                                    nm.BASE_RADIUS)))
            # the lists against torch.nonzero(...)[:cap]
            cert = float(np.float32((6.0 * pg.cell_fine) ** 2))
            tail, un, totals = nc.tail_lists(out, cert, cap_t, cap_q)
            unres, exact = out[8] > 0, out[9] > 0
            want_t = torch.nonzero(~exact & ~unres & (out[7] < cert))[:, 0]
            want_u = torch.nonzero(unres)[:, 0]
            n_t, n_u = totals.tolist()
            c_t, c_u = min(n_t, cap_t), min(n_u, cap_q)
            lists_equal = (n_t == want_t.numel() and n_u == want_u.numel()
                           and torch.equal(tail[:c_t], want_t[:cap_t])
                           and torch.equal(un[:c_u], want_u[:cap_q]))
            # the wide tier into the planar outputs against gathered queries
            out_k, out_p = out.clone(), out.clone()
            kn.knn_moments_into(pg, pts, tail, totals[0:1], k, nm.WIDE_RADIUS, out_k)
            live = want_t[:cap_t]
            if live.numel():
                cov_w, _, _, unres_w, exact_w = kn.knn_moments(
                    pg, pts[live], ones[:live.numel()], k, nm.WIDE_RADIUS)
                upd = live[~unres_w]
                out_p[0:6, upd] = cov_w[~unres_w].T
                out_p[9, upd] = exact_w[~unres_w].float()
            wide_equal = torch.equal(out_k, out_p)
            # the eigensolve
            eig_k, eig_p = nc.eig_normals(out_k), nc.eig_normals_reference(out_k)
            eig_diff = int((eig_k != eig_p).any(dim=1).sum())
            # the fallback; a tie among a point's k + 1 nearest distances
            # leaves torch.topk's choice or order unspecified
            fb_k, fb_p = eig_k.clone(), eig_k.clone()
            nc.fallback_normals(pg, pts, un, totals[1:2], k, 2 * nm.BASE_RADIUS, fb_k)
            nc.fallback_normals_reference(pg, pts, un, totals[1:2], k, 2 * nm.BASE_RADIUS, fb_p)
            live_u = want_u[:cap_q]
            fb_diff = (fb_k[live_u] != fb_p[live_u]).any(dim=1)
            tied = torch.zeros_like(fb_diff)
            if live_u.numel():
                d, _ = _knn_window_pass(pg, pts[live_u], k + 1, radius=2 * nm.BASE_RADIUS,
                                        chunk=2048)
                tied = ((d[:, 1:] == d[:, :-1]) & torch.isfinite(d[:, 1:])).any(dim=1)
            fb_angle = float((1 - (fb_k[live_u] * fb_p[live_u]).sum(1).abs()).max()) \
                if live_u.numel() else 0.0
            # the whole estimate_normals against its code before the chain
            reset_launches()
            normals_c, info = nm.estimate_normals(pts, k=k, return_info=True)
            counts = {key: v for key, v in launch_counts().items() if v}
            normals_p, _, exact_p, n_wide_p, n_un_p = parent_normals(pg, pts, k)
            whole_diff = (normals_c != normals_p).any(dim=1)
            whole = {"info_cell_equal": info["cell_size"] == pg.cell_fine,
                     "exact_equal": torch.equal(info["exact"], exact_p),
                     "counts_equal": (info["n_wide"], info["n_unresolved"]) == (n_wide_p, n_un_p),
                     "normals_differing": int(whole_diff.sum())}
            want_counts = {"knn_moments": 2, **dict.fromkeys(CHAIN_STEPS, 1)}
            sites = {}
            syncs = count_syncs(lambda: nm.estimate_normals(pts, k=k), sites)[1]
            # times: the whole estimate_normals, then its code before the chain
            # with its sampler and grid, by events; each kernel of one call alone
            chain_ms = cuda_ms(lambda: nm.estimate_normals(pts, k=k), 5)

            def parent_call():
                c = max(nc.sampled_median_reference(pts, sel_t, ref_t, k_eff), 1e-3)
                return parent_normals(build_packed_grid(pts, c, cap=32, auto_cap=True), pts, k)

            parent_ms = cuda_ms(parent_call, 3)
            # each step's plain version on the card, and each kernel's bound: the
            # bytes it needs to move once or its flops, whichever takes longer
            steps = {
                "sample": lambda: nc.sampled_median_reference(pts, sel_t, ref_t, k_eff),
                "tails": lambda: nc.tail_lists_reference(out, cert, cap_t, cap_q),
                "eig": lambda: nc.eig_normals_reference(out_k),
                "fallback": lambda: nc.fallback_normals_reference(
                    pg, pts, un, totals[1:2], k, 2 * nm.BASE_RADIUS, fb_p),
            }
            plain_step_ms = {key: cuda_ms(fn, 2) for key, fn in steps.items()}
            step_ms = {key: cuda_ms(fn, 5) for key, fn in {
                "sample": lambda: nc.sampled_median(pts, sel_t, ref_t, k_eff),
                "tails": lambda: nc.tail_lists(out, cert, cap_t, cap_q),
                "eig": lambda: nc.eig_normals(out_k),
                "fallback": lambda: nc.fallback_normals(pg, pts, un, totals[1:2], k,
                                                        2 * nm.BASE_RADIUS, fb_k),
            }.items()}
            step_err = {"sample": abs(r_kernel - r_plain),
                        "tails": 0.0 if lists_equal else float("inf"),
                        "eig": float((eig_k - eig_p).abs().max()),
                        "fallback": float((fb_k - fb_p).abs().max())}
            n_ref = n if ref is None else len(ref)
            n_cand = (2 * nm.BASE_RADIUS + 1) ** 3 * pg.cap * int(live_u.numel())
            bounds = {
                "sample": bound_ms(20 * n_ref + 20 * len(sel), len(sel) * n_ref * FLOPS_DIST),
                "tails": bound_ms(13 * n + 8 * (c_t + c_u), 0),
                "eig": bound_ms(36 * n, 150 * n),
                "fallback": bound_ms(12 * n_cand + 24 * int(live_u.numel()), n_cand * FLOPS_DIST),
            }
            launches_chain, per_kernel = profile_kernels(lambda: nm.estimate_normals(pts, k=k))
            launches_parent, _ = profile_kernels(parent_call, 1)
            launches_grid, _ = profile_kernels(
                lambda: build_packed_grid(pts, cell, cap=32, auto_cap=True), 1)
            row = {"cell": r_kernel, "cell_equal": r_kernel == r_plain, "k_eff": k_eff,
                   "sample_launches": sample_launches, "base_equal": base_equal,
                   "lists_equal": lists_equal, "n_tail": n_t, "n_unresolved": n_u,
                   "wide_equal": wide_equal, "eig_differing": eig_diff,
                   "fallback_points": int(live_u.numel()),
                   "fallback_differing": int(fb_diff.sum()),
                   "fallback_differing_tied": int((fb_diff & tied).sum()),
                   "fallback_tied": int(tied.sum()), "fallback_max_1_minus_dot": fb_angle,
                   **whole, "launch_counts": counts, "syncs": syncs, "sync_sites": sites,
                   "chain_ms": chain_ms, "parent_ms": parent_ms,
                   "kernels_per_call": launches_chain, "parent_kernels_per_call": launches_parent,
                   "grid_kernels_per_call": launches_grid, "plain_step_ms": plain_step_ms,
                   "step_ms": step_ms,
                   "bound_ms": {key: v[0] for key, v in bounds.items()},
                   "bound_by": {key: v[1] for key, v in bounds.items()},
                   "step_max_abs_err": step_err,
                   "kernel_ms": {key: v for key, v in per_kernel.items()
                                 if any(x in key for x in ("sample_", "median_kernel",
                                                           "tails_mark", "scatter_kernel",
                                                           "eig_kernel", "fallback_kernel",
                                                           "knn_moments_kernel", "box_key",
                                                           "item_mark"))}}
            log(f"{tag} {json.dumps(row)}")
            ok = (row["cell_equal"] and sample_launches == 1
                  and base_equal and lists_equal and wide_equal and eig_diff == 0
                  and row["fallback_differing"] == row["fallback_differing_tied"]
                  and whole["info_cell_equal"] and whole["exact_equal"] and whole["counts_equal"]
                  and whole["normals_differing"] <= row["fallback_differing"]
                  and counts == want_counts)
            if not ok:
                raise AssertionError(f"{tag} the chain is off its plain version or its launches "
                                     f"(launches {counts}, expected {want_counts})")
            out_all[f"{name}_k{k}"] = row
    out_all["edges"] = chain_edge_cases(maps["city"], dev)
    return out_all


def chain_edge_cases(map_np, dev) -> dict:
    """Phase 6c's shapes off the main path, each kernel against its
    plain version on the card: the sampler by each of its ways
    (``normals_chain.sample_plan``), its cell size bit-equal, at k above the
    tiles' 32 (the select), more than 8,192 queries on each way, and k above
    the references; the fallback on ``N_FALLBACK`` points of the map at each
    k of ``K_FALLBACK``, bit-equal below k = 64 (a point whose k + 1 nearest
    distances hold a tie counted apart), within ``FALLBACK_TOL`` from 64.
    Each case is logged before any is judged."""
    import torch

    from point_cloud_registration_tpu_torch.ops import normals as nm
    from point_cloud_registration_tpu_torch.ops.kernels import normals_chain as nc
    from point_cloud_registration_tpu_torch.ops.pointgrid import _knn_window_pass, build_packed_grid

    tag = "[normals chain edges]"
    pts_all = torch.from_numpy(map_np).to(dev)
    n_all = pts_all.shape[0]
    out, bad = {"sample": [], "fallback": []}, []
    for n, k, n_sample in ((100_000, 40, 256), (100_000, 100, 256), (100_000, 5, 9000),
                           (100_000, 33, 9000), (n_all, 300, 256), (20, 40, 256)):
        n = min(n, n_all)
        pts = pts_all[:n].contiguous()
        sel, ref, k_eff = nm.sample_draws(n, k, n_sample)
        sel_t = torch.as_tensor(sel, device=dev)
        ref_t = None if ref is None else torch.as_tensor(ref, device=dev)
        before = nc.sampled_median.launches
        got = nc.sampled_median(pts, sel_t, ref_t, k_eff)
        launches = nc.sampled_median.launches - before
        want = nc.sampled_median_reference(pts, sel_t, ref_t, k_eff)
        case = {"n": n, "k": k, "k_eff": k_eff, "queries": len(sel),
                "plan": nc.sample_plan(len(sel), n if ref is None else len(ref), k_eff),
                "cell": got, "equal": got == want, "launches": launches,
                "ms": cuda_ms(lambda: nc.sampled_median(pts, sel_t, ref_t, k_eff), 2),
                "plain_ms": cuda_ms(lambda: nc.sampled_median_reference(pts, sel_t, ref_t,
                                                                        k_eff), 1)}
        log(f"{tag} sampler {json.dumps(case)}")
        out["sample"].append(case)
        if not (case["equal"] and launches == 1):
            bad.append(f"sampler n = {n}, k_eff = {k_eff}, {len(sel)} queries")
    pg = build_packed_grid(pts_all, max(nm.sample_knn_radius(pts_all, K_NORMALS), 1e-3),
                           cap=32, auto_cap=True)
    pick = torch.from_numpy(np.sort(np.random.RandomState(SEED).choice(
        n_all, N_FALLBACK, replace=False))).to(dev)
    count = torch.tensor([N_FALLBACK], dtype=torch.int32, device=dev)
    radius = 2 * nm.BASE_RADIUS
    for k in K_FALLBACK:
        fb_k, fb_p = (torch.zeros((n_all, 3), device=dev) for _ in range(2))
        before = nc.fallback_normals.launches
        nc.fallback_normals(pg, pts_all, pick, count, k, radius, fb_k)
        launches = nc.fallback_normals.launches - before
        nc.fallback_normals_reference(pg, pts_all, pick, count, k, radius, fb_p)
        a, b = fb_k[pick], fb_p[pick]
        differing = (a != b).any(dim=1)
        d, _ = _knn_window_pass(pg, pts_all[pick], k + 1, radius=radius, chunk=2048)
        tied = ((d[:, 1:] == d[:, :-1]) & torch.isfinite(d[:, 1:])).any(dim=1)
        gap = 1 - (a * b).sum(1).abs()
        case = {"k": k, "points": N_FALLBACK, "cap": pg.cap, "launches": launches,
                "differing": int(differing.sum()), "differing_tied": int((differing & tied).sum()),
                "tied": int(tied.sum()), "max_abs_err": float((a - b).abs().max()),
                "max_1_minus_dot_untied": float(gap[~tied].max()),
                "absent_slots": int((~torch.isfinite(d[:, :k])).sum()),
                "ms": cuda_ms(lambda: nc.fallback_normals(pg, pts_all, pick, count, k, radius,
                                                          fb_k), 3),
                "plain_ms": cuda_ms(lambda: nc.fallback_normals_reference(
                    pg, pts_all, pick, count, k, radius, fb_p), 1)}
        log(f"{tag} fallback {json.dumps(case)}")
        out["fallback"].append(case)
        held = (case["differing"] == case["differing_tied"] if k < 64
                else case["max_1_minus_dot_untied"] <= FALLBACK_TOL)
        if not (held and launches == 1):
            bad.append(f"fallback k = {k}")
    if bad:
        raise AssertionError(f"{tag} off the plain version or its launches: {bad}")
    return out


def run_exact_nn(map_t, scan_np, T_icp, icp_target, dev) -> dict:
    """Phase 7: the exact 1-NN kernel against its plain version, and as the
    oracle of the packed grid's tier-1 search."""
    import torch

    from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
    from point_cloud_registration_tpu_torch.ops.pointgrid import nearest_point_packed

    tag = "[exact_nn]"
    exact_nn_edge_cases(tag, dev)
    sel = np.sort(np.random.RandomState(SEED).choice(len(scan_np), N_EXACT, replace=False))
    T = torch.as_tensor(T_icp, dtype=torch.float32)
    q = (torch.from_numpy(scan_np[sel]).to(dev) @ T[:3, :3].T.to(dev) + T[:3, 3].to(dev))
    q = q.contiguous()
    reset_launches()
    d_k, i_k = en.exact_nn(q, map_t)
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = en.exact_nn.launches
    d_p, i_p = en.exact_nn_reference(q, map_t)
    err = float((d_k - d_p).abs().max())
    n_idx = int((i_k != i_p).sum())
    log(f"{tag} {N_EXACT} queries x {map_t.shape[0]} references: max |d - d_plain| {err:.3e}, "
        f"indices differing {n_idx}; launch counts {counts}")
    if launches != 1 or err != 0.0 or n_idx != 0:
        raise AssertionError(f"{tag} kernel disagrees with its plain version")
    # The oracle: a tier-1 match within cell_fine, in a window of blocks that
    # kept all their points, is the exact nearest neighbour.
    pg = icp_target.packed
    nn = nearest_point_packed(pg, q)
    certain = nn.resolved & ~pg.row_over[torch.clamp(
        _window_rows(pg, q), min=0)].any(dim=1)
    n_cert = int(certain.sum())
    worst = float((nn.dist - d_k)[certain].abs().max())
    log(f"{tag} oracle: {n_cert} of {N_EXACT} queries resolved in untruncated blocks, "
        f"max |tier-1 dist - exact dist| {worst:.3e}")
    if not (n_cert > N_EXACT // 2 and worst == 0.0):
        raise AssertionError(f"{tag} the packed grid's resolved matches are not exact")

    def cdist_min():
        best = torch.full((q.shape[0],), float("inf"), device=dev)
        for a in range(0, map_t.shape[0], 1 << 17):
            best = torch.minimum(best, torch.cdist(q, map_t[a:a + (1 << 17)]).min(dim=1).values)
        return best

    lib_err = float((cdist_min() - d_k).abs().max())
    ms = cuda_ms(lambda: en.exact_nn(q, map_t), 5)
    library_ms = cuda_ms(cdist_min, 3)
    plain_ms = cuda_ms(lambda: en.exact_nn_reference(q, map_t), 1)
    ms_2 = cuda_ms(lambda: en.exact_nn(q, map_t), 5)
    pairs = float(N_EXACT) * map_t.shape[0]
    b_ms, b_by = bound_ms(nbytes(q, map_t) + 8 * N_EXACT, pairs * FLOPS_DIST)
    # The contract forbids fused multiply-adds (each of the 8 operations of a
    # pair is rounded by itself), and an unfused instruction does one operation
    # where the card's peak counts two.
    contract_ms = 1e3 * pairs * FLOPS_DIST / (FP32_FLOP_PER_S / 2)
    log(f"{tag} kernel, cdist().min, plain, kernel: {ms:.3f}, {library_ms:.3f}, {plain_ms:.1f}, "
        f"{ms_2:.3f} ms; bound {b_ms:.4f} ms by {b_by} (8 fused flops per pair), "
        f"contract_bound_ms {contract_ms:.4f} (8 separately rounded operations per pair at half "
        f"the peak); max |cdist - exact| {lib_err:.3e}")
    return {"kernel_ms": [ms, ms_2], "plain_ms": [plain_ms], "library_ms": library_ms,
            "launches": launches, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "contract_bound_ms": contract_ms, "certified": n_cert}


def exact_nn_edge_cases(tag: str, dev) -> None:
    """The exact 1-NN kernel against its plain version, bit for bit, at ragged
    shapes: a reference count that is no multiple of four, one reference, one
    query, a NaN query, and references duplicated across a border of the
    kernel's tiles and of its segments, where the first index must win."""
    import torch

    from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en

    tile = 1024  # reference points per shared-memory tile of the kernel
    rng = np.random.RandomState(SEED)
    for nq, nr in ((1, 1), (7, 513), (1025, 300), (300, 4097), (2000, 1), (4096, 200_001)):
        ref = (rng.rand(nr, 3) * [20, 20, 3]).astype(np.float32)
        q = (rng.rand(nq, 3) * [22, 22, 4] - 1).astype(np.float32)
        segments, seg_len = en.launch_shape(nq, nr, dev)
        # a duplicate across the first border of each kind that this shape has
        borders = {"tile": tile if seg_len > tile else 0, "segment": seg_len if segments > 1 else 0}
        for k, at in enumerate(borders.values()):
            if 0 < at < nr and k < nq:
                ref[at] = ref[at - 1]
                q[k] = ref[at]
        if nq > 2:
            q[2] = np.nan
        q_t, ref_t = torch.from_numpy(q).to(dev), torch.from_numpy(ref).to(dev)
        d_k, i_k = en.exact_nn(q_t, ref_t)
        d_p, i_p = en.exact_nn_reference(q_t, ref_t)
        first = all(int(i_k[k]) == at - 1 and float(d_k[k]) == 0.0
                    for k, at in enumerate(borders.values()) if 0 < at < nr and k < nq)
        nan_kept = nq <= 2 or (int(i_k[2]) == -1 and float(d_k[2]) == float("inf"))
        dups = ", ".join(f"{name} border {at}" for name, at in borders.items() if 0 < at < nr)
        same_d, same_i = torch.equal(d_k, d_p), torch.equal(i_k, i_p)
        log(f"{tag} {nq} x {nr} ({segments} segments of {seg_len}; duplicates across "
            f"{dups or 'no border: one tile'}): distances equal {same_d}, indices equal {same_i}")
        if not (same_d and same_i and first and nan_kept):
            raise AssertionError(f"{tag} kernel disagrees with its plain version at {nq} x {nr}")


def _window_rows(pg, q):
    """(N, 8) packed rows (-1: none) of the 2x2x2 blocks around each query's
    fine cell, the window of ``nearest_point_packed``."""
    import torch

    from point_cloud_registration_tpu_torch.ops.pointgrid import _cells

    lo = torch.div(_cells(q, pg.cell_fine, pg.origin_fine) - 1, 2, rounding_mode="floor")
    nb = torch.tensor(pg.nb_dims, device=q.device)
    rows = []
    for off in np.ndindex(2, 2, 2):
        b = lo + torch.tensor(off, device=q.device)
        ok = ((b >= 0) & (b < nb)).all(dim=1)
        row = pg.block_row[torch.where(ok, b[:, 0] + nb[0] * (b[:, 1] + nb[1] * b[:, 2]), 0)]
        rows.append(torch.where(ok, row, -1).long())
    return torch.stack(rows, dim=1)


def check_T(tag: str, T, d, t_ref, iterations_ref: int) -> float:
    """Hold a transform and its GN diagnostics to the JAX package's result."""
    ref_err = float(np.abs(T[:3] - t_ref).max())
    log(f"{tag} {d.iterations} iterations (JAX: {iterations_ref}), converged {d.converged}; "
        f"max |T - T_jax| = {ref_err:.2e}")
    if not (np.isfinite(T).all() and d.converged and not d.solver_failed
            and ref_err < TOL_REF and d.iterations == iterations_ref):
        raise AssertionError(f"{tag} transform off the JAX package's: {ref_err}, {d}")
    return ref_err


def warm_runs(solver, set_target, scan_t, T_first, reps: int = 3) -> list:
    """``reps`` warm ``set_target`` + ``align`` runs on device-resident
    inputs, each bit-identical to the first run: [(set_target s, align s)]."""
    import torch

    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        set_target(solver)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        T = solver.align(scan_t)
        runs.append((t1 - t0, time.perf_counter() - t1))
        if not np.array_equal(T, T_first):
            raise AssertionError("a warm run gave another result than the first")
    return runs


# The grid stats kernels of phases 9 and 10 (csrc/grid_align.cu): the kinds'
# wrappers by name, their plain versions, the H metric of compare_stats and
# the operations of one inlier's linearization.
GRID_KINDS = {
    "point": ("grid_point_stats", "entry", FLOPS_M3_POINT),
    "plane_pt": ("grid_plane_point_stats", "entry", FLOPS_PLANE_ROW),
    "plane": ("hashed_plane_stats", "max", FLOPS_PLANE_ROW),
    "ndt": ("hashed_ndt_stats", "entry", FLOPS_M3_POINT),
}
TOL_GRID_PLAIN = 1e-5  # max |T - T_plain|: the kernel's align against the plain versions' host loop
GRID_SOURCE = f"{CSRC}/grid_align.cu"
# the XLA code each kernel stands for (no Pallas kernel): the query it runs
GRID_REPLACES = {"point": "point_cloud_registration_tpu/ops/knn.py:410",
                 "plane_pt": "point_cloud_registration_tpu/ops/knn.py:410",
                 "plane": "point_cloud_registration_tpu/ops/knn.py:78",
                 "ndt": "point_cloud_registration_tpu/ops/knn.py:78"}


def ptxas_entries(text: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel entry in a ptxas
    report (``nvcc -Xptxas -v``'s output, as in ``nvcc.log``): ``{mangled
    name: {"registers": r, "stack": s, "spill_stores": a, "spill_loads": b}}``."""
    import re

    out, name, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, props = m.group(1), None
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:  # the entry's own, or a device function's that it calls
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and props in (None, name):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def library_ptxas(library: str, kernel: str, labels: dict) -> dict:
    """:func:`ptxas_entries` of the entries named ``kernel`` in the build of
    ``csrc/<library>.cu``, keyed by ``labels[their kind]`` (the first
    mangled integer template argument, ``ILi0E``, after the name: the
    kernel's own or its stats body's); raises unless every label has a
    report."""
    import re

    from point_cloud_registration_tpu_torch.ops.kernels import _build

    text = (_build.library_path(library).parent / "nvcc.log").read_text()
    out = {}
    for name, v in ptxas_entries(text).items():
        if kernel in name:
            args = re.search(rf"{kernel}\w*?(ILi\d+E)", name)
            out[labels[args.group(1) if args else ""]] = v
    if set(out) != set(labels.values()) or any("registers" not in v for v in out.values()):
        raise AssertionError(f"no ptxas report of every {kernel} in {library}'s nvcc.log: {out}")
    return out


def grid_ptxas() -> dict:
    """Registers, stack frame and spill bytes of each kind's kernel in the
    build of ``csrc/grid_align.cu``, from ptxas's report in ``nvcc.log``:
    ``{kind: {"registers": r, "stack": s, "spill_stores": a, "spill_loads": b}}``."""
    out = library_ptxas("grid_align", "grid_stats_kernel",
                        {"ILi0E": "point", "ILi1E": "plane_pt", "ILi2E": "plane", "ILi3E": "ndt"})
    if set(out) != set(GRID_KINDS):
        raise AssertionError(f"no ptxas report of the four grid kinds in nvcc.log: {out}")
    log("[grid kernel] ptxas: " + "; ".join(
        f"{k} {v['registers']} registers, {v.get('spill_stores', 0)} / {v.get('spill_loads', 0)} "
        f"bytes spilled (stores / loads), {v.get('stack', 0)} bytes stack" for k, v in out.items()))
    return out


def grid_fns(kind: str) -> tuple:
    """``(wrapper, plain version)`` of the grid stats kernel of ``kind``."""
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    plain = (ga.grid_point_stats_reference if kind in ("point", "plane_pt")
             else ga.hashed_voxel_stats_reference)
    return getattr(ga, GRID_KINDS[kind][0]), plain


def grid_operands(kind: str, s) -> tuple:
    """``(grid, table, offsets)``: what solver ``s``'s align binds for the
    grid stats kernel of ``kind``."""
    from point_cloud_registration_tpu_torch.models import _fused, _point_fused

    if kind in ("plane", "ndt"):
        return _fused.hashed_operands(s._target, s.cfg, kind)
    normals = s._target.normals if kind == "plane_pt" else None
    return _point_fused.grid_operands(getattr(s._target, "corr", s._target), s.cfg, normals)


def kernel_alone_ms(fn, reps: int, name: str, tries: int = 3) -> float:
    """Device milliseconds per call of the kernels whose name holds ``name``
    over ``reps`` calls of ``fn``, by ``torch.profiler``; a trace that holds
    no such kernel (the profiler drops one now and then) is logged and taken
    again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if name in e.key and e.self_device_time_total > 0]
        if rows:
            return sum(e.self_device_time_total for e in rows) / 1e3 / reps
        log(f"[profiler] trace {attempt} of {tries} holds no kernel named {name}"
            + ("; taking it again" if attempt < tries else ""))
    raise AssertionError(f"the profiler saw no kernel named {name} in {tries} traces")


def check_grid_launch(label: str, kind: str, grid, table, src, w, T, offsets, max_dist,
                      huber_delta=None, metric: str | None = None) -> float:
    """The grid stats kernel of ``kind`` at ``T`` against its plain version on
    the same tensors: every query's winner and squared distance equal to the
    plain query's (``knn.nearest_point`` / ``nearest_voxel``), and the stats
    within ``compare_stats``' bounds (``metric``: the H metric) or, without
    a metric, within 1e-5 of the largest entry with equal counts (the lattice
    cases). Returns the largest absolute error."""
    import torch

    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    wrapper, plain = grid_fns(kind)
    n, dev = src.shape[0], src.device
    idx, d2 = torch.empty(n, dtype=torch.int32, device=dev), torch.empty(n, device=dev)
    args = (grid, table, src, w, T[:3, :3], T[:3, 3], offsets, max_dist, huber_delta)
    k, p = wrapper(*args, matches=(idx, d2)), plain(*args)
    idx_p, d2_p = ga.plain_matches(grid, table, src, T[:3, :3], T[:3, 3], offsets)
    if not (torch.equal(idx, idx_p) and torch.equal(d2, d2_p)):
        bad = int(((idx != idx_p) | (d2 != d2_p)).sum())
        raise AssertionError(f"{label}: {bad} of {n} winners differ from the plain query's")
    err = float((k - p).abs().max())
    if metric is None:
        ok = (err <= 1e-5 * max(1.0, float(p.abs().max()))
              and abs(float(k[28] - p[28])) <= 1e-5 * max(1.0, float(p[28])))
    else:
        e = compare_stats(k, p)
        log(f"{label}: winners equal to the plain query's ({int((idx >= 0).sum())} of {n} "
            f"found); rel err H {e[metric]:.3e} ({metric}), g {e['g']:.3e}, e2 {e['e2']:.3e}; "
            f"n_inliers diff {e['n']:.0f}; max abs {e['max_abs']:.3e}")
        ok = e[metric] < TOL_H and e["g"] < TOL_G and e["e2"] < TOL_E2 and e["n"] <= TOL_N
    if not ok:
        raise AssertionError(f"{label}: kernel {k.tolist()} against plain {p.tolist()}")
    return err


def grid_sample_max() -> int:
    """``kSampleMax`` of the grid stats body (``csrc/grid_stats.cuh``, which
    ``grid_align.cu`` and ``grid_loop.cu`` run): the most keys of a block's
    sampled key index."""
    import re

    source = (Path(__file__).resolve().parent / CSRC / "grid_stats.cuh").read_text()
    return int(re.search(r"constexpr int kSampleMax = (\d+);", source).group(1))


def grid_work(kind: str, grid, table, src, w, T, offsets, max_dist, idx, d2) -> tuple:
    """``(bytes, operations, design)`` of the stats of ``kind`` on these
    inputs. Bytes: the weighted scan points, all weights, the offsets and
    the 29 sums once; on a grid target the dense table's entries the windows
    probe, the start and count of every slot found and the bucket points
    scanned (an index and a point each), the normals of the winners; on a
    hashed map the key, flag and centroid of every slot found and the
    features of the winners. Operations: the transform and the cell (18 a
    query), a key (2) per probe of an in-box cell and, on a hashed map, its
    lookup as one read and compare (2): the function needs the slot, not a
    search for it; a distance (``FLOPS_DIST``) per candidate, a
    linearization per inlier. ``design``, without a dense key table: the
    kernel's own searches (one per window row with a cell in the box, each
    its steps in the sampled index in shared memory and in the keys it
    leaves), which do more than the function needs and so stay out of the
    bound."""
    import torch

    from point_cloud_registration_tpu_torch.core.se3 import transform_points
    from point_cloud_registration_tpu_torch.ops.hashgrid import (
        coords_to_key,
        lookup_slots,
        query_cells,
    )
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    dev = src.device
    live = w != 0
    q = transform_points(T.to(dev), src)[live]
    off = torch.as_tensor(np.asarray(offsets), dtype=torch.int64, device=dev)
    _, ranks = ga.window_rows(np.asarray(offsets))
    row_of = [torch.as_tensor(r[r >= 0], dtype=torch.int64, device=dev) for r in ranks]
    probed, found = [], []
    in_box = candidates = row_searches = 0.0
    for a in range(0, q.shape[0], 1 << 14):
        key = coords_to_key(query_cells(q[a:a + (1 << 14)], grid.cell_size)[:, None, :]
                            + off[None], grid.origin_cell, grid.dims)
        slot = lookup_slots(grid, key)
        in_box += float((key >= 0).sum())
        row_searches += sum(float((key[:, r] >= 0).any(1).sum()) for r in row_of)
        probed.append(torch.unique(key[key >= 0]))
        found.append(torch.unique(slot[slot >= 0]))
        if table.valid is None:
            candidates += float(table.buckets.counts[slot.clamp(min=0).long()]
                                .clamp(max=table.cap)[slot >= 0].sum())
        else:
            candidates += float(table.valid[slot.clamp(min=0).long()][slot >= 0].sum())
    probed = torch.unique(torch.cat(probed)).numel()
    found = torch.unique(torch.cat(found)).long()
    n_live = int(live.sum())
    inlier = live & (idx >= 0) & (torch.sqrt(d2) < max_dist)
    winners = torch.unique(idx[inlier]).numel()
    n_bytes = 12 * n_live + 4 * w.shape[0] + 12 * off.shape[0] + 29 * 4
    flops = 18.0 * n_live + candidates * FLOPS_DIST + float(inlier.sum()) * GRID_KINDS[kind][2]
    if table.valid is None:
        scanned = int(table.buckets.counts[found].clamp(max=table.cap).sum())
        n_bytes += (4 * probed if grid.dense is not None else 4 * found.numel())
        n_bytes += 8 * found.numel() + 16 * scanned + (12 * winners if kind == "plane_pt" else 0)
        flops += 2 * in_box
    else:
        n_bytes += 17 * found.numel() + table.feats.shape[1] * 4 * winners
        flops += 4 * in_box
    design = None
    if grid.dense is None:
        shift = 0
        while -(-grid.n_cells // (1 << shift)) > grid_sample_max():
            shift += 1
        n_sample = -(-grid.n_cells // (1 << shift))
        design = {"row_searches": int(row_searches), "rows_per_query": len(row_of),
                  "shared_steps": int(np.ceil(np.log2(n_sample + 1))), "global_steps": shift}
    log(f"[{kind} kernel] work at the converged pose: {n_live} weighted queries, {in_box:.0f} "
        f"in-box probes ({probed} distinct cells, {found.numel()} slots found), "
        f"{candidates:.0f} candidates, {int(inlier.sum())} inliers ({winners} distinct winners): "
        f"{n_bytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP"
        + (f"; the kernel's own searches (not in the bound): {design['row_searches']} row "
           f"searches ({design['rows_per_query']} rows a query, those with a cell in the box), "
           f"each up to {design['shared_steps']} steps in the shared sample and "
           f"{design['global_steps']} in the keys" if design else ""))
    return n_bytes, flops, design


def hold_grid_kernel(tag: str, kind: str, s, src, w, T_k, d) -> dict:
    """Phases 9-10: the grid stats kernel of ``kind`` on solver ``s``'s
    align operands. The host loop over the plain version reaches the
    align's T within ``TOL_GRID_PLAIN`` with equal iterations and flags; at
    the initial, a middle and the converged pose of that loop the kernel
    holds to its plain version (:func:`check_grid_launch`) and the launch
    bound once (``resident_launch`` at a pose row on the card) is the
    wrapper's, bit for bit. Then the bound launch's time by events and alone
    (profiler), the plain version's, and the bound at the converged pose."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.core.gn import pose_rows_of, stats_from_packed
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    wrapper, plain = grid_fns(kind)
    grid, table, offsets = grid_operands(kind, s)
    cfg, dev = s.cfg, src.device
    visited = []

    def plain_stats(T):
        visited.append(T.clone())
        return stats_from_packed(plain(grid, table, src, w, T[:3, :3], T[:3, 3], offsets,
                                       cfg.max_dist, cfg.huber_delta).cpu())

    T_p, d_p = pt.gauss_newton(plain_stats, torch.eye(4), cfg.max_iter, cfg.tol)
    dT = float(np.abs(T_p.numpy().astype(np.float64) - T_k).max())
    same = (d_p.iterations, d_p.converged, d_p.solver_failed) == (
        d.iterations, d.converged, d.solver_failed)
    log(f"{tag} host loop over the plain version: {d_p.iterations} iterations, max |dT| vs the "
        f"kernel's align {dT:.3e}; iterations and flags equal {same}")
    if not (dT <= TOL_GRID_PLAIN and same):
        raise AssertionError(f"{tag} the plain versions' host loop is off the kernel's align")
    poses = {"initial": visited[0], "middle": visited[len(visited) // 2],
             "converged": torch.as_tensor(T_k, dtype=torch.float32)}
    worst = 0.0
    for name, T in poses.items():
        worst = max(worst, check_grid_launch(f"{tag} kernel vs plain at the {name} pose", kind,
                                             grid, table, src, w, T, offsets, cfg.max_dist,
                                             cfg.huber_delta, GRID_KINDS[kind][1]))
        bound = ga.resident_launch(kind, grid, table, src, w, offsets,
                                   pose_rows_of(T[None]).to(dev), None, cfg.max_dist,
                                   cfg.huber_delta)()
        bound = bound.reshape(-1)  # (1, 29) from the card's launch
        if not torch.equal(bound, wrapper(grid, table, src, w, T[:3, :3], T[:3, 3], offsets,
                                          cfg.max_dist, cfg.huber_delta)):
            raise AssertionError(f"{tag} the bound launch differs from the wrapper's")
    Tc = poses["converged"]
    n = src.shape[0]
    idx, d2 = torch.empty(n, dtype=torch.int32, device=dev), torch.empty(n, device=dev)
    wrapper(grid, table, src, w, Tc[:3, :3], Tc[:3, 3], offsets, cfg.max_dist, cfg.huber_delta,
            matches=(idx, d2))
    launch = ga.resident_launch(kind, grid, table, src, w, offsets, pose_rows_of(Tc[None]).to(dev),
                                None, cfg.max_dist, cfg.huber_delta)
    plain_call = lambda: plain(grid, table, src, w, Tc[:3, :3], Tc[:3, 3], offsets,  # noqa: E731
                               cfg.max_dist, cfg.huber_delta)
    kernel_ms = [cuda_ms(launch, 20), None]
    plain_ms = [cuda_ms(plain_call, 5), None]
    kernel_ms[1], plain_ms[1] = cuda_ms(launch, 20), cuda_ms(plain_call, 5)
    alone = kernel_alone_ms(launch, 10, "grid_stats_kernel")
    n_bytes, flops, design = grid_work(kind, grid, table, src, w, Tc, offsets, cfg.max_dist,
                                       idx, d2)
    b_ms, b_by = bound_ms(n_bytes, flops)
    log(f"{tag} per-iteration stats at the converged T (the align's bound launch, plain, launch, "
        f"plain): {kernel_ms[0]:.4f}, {plain_ms[0]:.4f}, {kernel_ms[1]:.4f}, {plain_ms[1]:.4f} ms; "
        f"the kernel alone (profiler) {alone:.4f} ms; bound {b_ms:.6f} ms by {b_by}")
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "alone_ms": alone, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": worst, "dT_plain": dT, "library_ms": None,
            "design": design}


def grid_lattice_cases(kind: str, dev) -> float:
    """The grid stats kernel of ``kind`` against its plain version on lattice
    layouts whose ties are exact, each with the dense key table and without
    it (the binary search): for the grid kinds phase 5's lattice scene
    (ties of two cells and in one cell, queries outside the grid, a scan above
    the top layer, 3,000 random queries) in 1 m buckets at caps 64 and 5 (a
    bucket of 8 over the cap), at two poses; for the hashed kinds phase 5's
    voxel lattice (ties of two rows and of two bitmap words, an empty window,
    the grid's faces, one query per launch; 1,000 queries with zero weights)
    as a hashed map whose slots also hold occupied cells that are not valid,
    at radius 2 and 1. Then :func:`quarter_lattice_cases`. Returns the
    largest absolute error."""
    import torch

    from point_cloud_registration_tpu_torch.ops.hashgrid import (
        DENSE_CELL_BUDGET,
        INVALID_KEY,
        Grid,
        bucket_rows,
        build_grid,
        search_offsets,
    )
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    worst = 0.0
    if kind in ("point", "plane_pt"):
        pts, normals, scans = lattice_scene()
        pts_t = torch.from_numpy(pts).to(dev)
        nrm = torch.from_numpy(normals).to(dev) if kind == "plane_pt" else None
        offsets = search_offsets(2.0, 1.0)
        for budget in (DENSE_CELL_BUDGET, 1):
            grid, _, buckets = build_grid(pts_t, 1.0, with_buckets=True, dense_budget=budget)
            rows = bucket_rows(pts_t, buckets)
            for cap in (64, 5):
                table = ga.point_table(pts_t, buckets, cap, nrm, rows=rows)
                for name, scan in scans.items():
                    src = torch.from_numpy(scan).to(dev)
                    w = torch.ones(len(scan), device=dev)
                    for T in (torch.tensor(np.float32([[1, 0, 0, 0.5], [0, 1, 0, 0.25],
                                                       [0, 0, 1, -0.5], [0, 0, 0, 1]])),
                              torch.eye(4)):
                        worst = max(worst, check_grid_launch(
                            f"[{kind} lattice] {name}, cap {cap}, dense table "
                            f"{grid.dense is not None}", kind, grid, table, src, w, T, offsets,
                            2.0))
        log(f"[{kind} kernel] vs plain on the lattice scene ({', '.join(scans)}; caps 64 and 5; "
            f"dense table and binary search; two poses): winners equal, max abs err {worst:.3e}")
        return max(worst, quarter_lattice_cases(kind, dev))
    cells, dims, valid, ties = voxel_lattice(kind, dev)
    n_valid = int(valid.sum())
    rng = np.random.RandomState(SEED + 2)
    occupied = valid | (rng.rand(valid.size) < 0.1)  # a tenth more slots, not valid
    keys = np.flatnonzero(occupied)
    cap = 1 << int(np.ceil(np.log2(len(keys) + 1)))
    xyz = np.stack([keys % dims[0], (keys // dims[0]) % dims[1], keys // (dims[0] * dims[1])], 1)
    means = (xyz + 0.5).astype(np.float32)
    rows = np.cumsum(valid) - 1  # a valid cell's row of the cell index
    width = 3 if kind == "plane" else 6
    feats = np.zeros((len(keys), width), np.float32)
    f = cells.feats[:n_valid, :width].cpu().numpy()
    feats[valid[keys]] = f[rows[keys[valid[keys]]]]
    if kind == "ndt":  # U -> icov = U^T U, packed [xx, yy, zz, xy, xz, yz]
        u = feats
        U = np.zeros((len(keys), 3, 3), np.float32)
        U[:, 0], U[:, 1, 1:], U[:, 2, 2] = u[:, 0:3], u[:, 3:5], u[:, 5]
        S = np.einsum("nki,nkj->nij", U, U)
        feats = S[:, [0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]].astype(np.float32)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dev, dt)  # noqa: E731
    padded = np.full(cap, INVALID_KEY, np.int32)
    padded[:len(keys)] = keys
    slot_pad = lambda a: np.concatenate([a, np.zeros((cap - len(keys),) + a.shape[1:], a.dtype)])  # noqa: E731
    table = ga.voxel_table(t(slot_pad(means)), t(slot_pad(valid[keys]), torch.bool),
                           t(slot_pad(feats)))
    dense = np.full(1 << int(np.ceil(np.log2(valid.size))), -1, np.int32)
    dense[keys] = np.arange(len(keys))
    hi = np.float32(dims)
    singles = {
        "tie": ties,
        "empty window": np.float32([[23.5, 4.5, 3.5]]),
        "faces": np.vstack([rng.rand(40, 3) * (hi + 6) - 3,
                            np.float32([[0.0, 4.2, 3.1], [36.99, 4.2, 3.1], [10.1, 0.0, 6.99],
                                        [10.1, 8.99, 0.0], [-2.5, 4.5, 3.5], [39.4, 8.0, 6.0],
                                        [1e12, 0.0, 0.0], [5.0, -3e9, 2.0]])]),
    }
    many = t((rng.rand(1000, 3) * (hi + 2) - 1).astype(np.float32))
    w_many = t((rng.rand(1000) > 0.33).astype(np.float32) * rng.rand(1000).astype(np.float32))
    eye = torch.eye(4)
    for with_dense in (False, True):
        grid = Grid(origin_cell=(0, 0, 0), cell_size=1.0, dims=tuple(dims), keys=t(padded,
                    torch.int32), n_cells=len(keys), dense=t(dense, torch.int32) if with_dense
                    else None)
        for max_dist in (2.0, 1.0):
            offsets = search_offsets(max_dist, 1.0)
            for name, qs in singles.items():
                for qn in qs:
                    worst = max(worst, check_grid_launch(
                        f"[{kind} lattice] {name} {qn.tolist()} at max_dist {max_dist}", kind,
                        grid, table, t(qn[None]), torch.ones(1, device=dev), eye, offsets,
                        max_dist))
            worst = max(worst, check_grid_launch(
                f"[{kind} lattice] 1000 queries, {int((w_many == 0).sum())} of weight 0", kind,
                grid, table, many, w_many, eye, offsets, max_dist))
            # each tie goes to the cell probed first, the query's own (offset
            # (0, 0, 0)); the dense probe of phase 5 takes the lower key
            idx, _ = ga.plain_matches(grid, table, t(ties), eye[:3, :3], eye[:3, 3], offsets)
            won = keys[idx.cpu().numpy()]
            if not np.array_equal(won, [32, 64, 42, 177]):
                raise AssertionError(f"[{kind} lattice] the tie winners are the keys {won}")
    log(f"[{kind} kernel] vs plain on the voxel lattice as a hashed map ({len(keys)} slots, "
        f"{n_valid} valid; ties of two rows and of two words of a row, an empty window, the "
        f"grid's faces, one query per launch; 1,000 queries with zero weights; radius 2 and 1; "
        f"binary search and dense table): winners equal, max abs err {worst:.3e}")
    return max(worst, quarter_lattice_cases(kind, dev))


def quarter_lattice_cases(kind: str, dev) -> float:
    """The lattices of tests/test_torch_grid_align.py at a size where the
    kernel's searches use a sampled key index (more occupied cells than the
    source's ``kSampleMax``): exact distances everywhere, so that ties fall
    in two lanes of a group and in two rows of the window, rows clipped at
    the box's faces, rows of empty cells (a slab without points), buckets
    over the cap (a site eight times) and searches ending at either end of
    the keys and of the sampled intervals. Grid kinds: points on a half-metre lattice
    (+1/4) in 30 x 30 x 6 m, caps 6 and 64; hashed kinds: the cells of the
    same box, half occupied, 70 % of those valid, centroids a quarter off
    the centre. 4,000 quarter-lattice queries from a cell beyond the box to
    one beyond, a third of weight 0; at T = I and a shift by quarters; with
    the dense key table and without it. Returns the largest absolute
    error."""
    import torch

    from point_cloud_registration_tpu_torch.ops.hashgrid import (
        DENSE_CELL_BUDGET,
        bucket_rows,
        build_grid,
        search_offsets,
    )
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga

    rng = np.random.RandomState(SEED + 3)
    box = np.float32([30.0, 30.0, 6.0])
    q = np.floor(rng.uniform(-1.0, box + 1.0, (4000, 3)) * 4) / 4
    src = torch.from_numpy(q.astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.rand(4000) > 1 / 3).astype(np.float32)).to(dev)
    poses = (torch.eye(4), torch.tensor(np.float32([[1, 0, 0, 0.25], [0, 1, 0, -0.5],
                                                    [0, 0, 1, 0.25], [0, 0, 0, 1]])))
    offsets = search_offsets(2.0, 1.0)
    worst, sizes = 0.0, []
    if kind in ("point", "plane_pt"):
        sites = np.stack(np.meshgrid(*(np.arange(int(2 * b)) for b in box), indexing="ij"),
                         -1).reshape(-1, 3) * 0.5 + 0.25
        keep = (rng.rand(len(sites)) < 0.4) & ((sites[:, 1] < 8) | (sites[:, 1] > 9))
        pts = np.vstack([sites[keep], sites[keep][::9], np.repeat(sites[keep][5:6], 8, 0)])
        pts_t = torch.from_numpy(pts.astype(np.float32)).to(dev)
        nrm = torch.nn.functional.normalize(torch.from_numpy(rng.randn(len(pts), 3).astype(
            np.float32)), dim=1).to(dev) if kind == "plane_pt" else None
        for budget in (DENSE_CELL_BUDGET, 1):
            grid, _, buckets = build_grid(pts_t, 1.0, with_buckets=True, dense_budget=budget)
            sizes.append(grid.n_cells)
            rows = bucket_rows(pts_t, buckets)
            for cap in (6, 64):
                table = ga.point_table(pts_t, buckets, cap, nrm, rows=rows)
                for T in poses:
                    worst = max(worst, check_grid_launch(
                        f"[{kind} quarter lattice] cap {cap}, dense table "
                        f"{grid.dense is not None}", kind, grid, table, src, w, T, offsets, 2.0))
    else:
        cells = np.stack(np.meshgrid(*(np.arange(int(b)) for b in box), indexing="ij"),
                         -1).reshape(-1, 3)
        cells = cells[rng.rand(len(cells)) < 0.5]
        means = (cells + 0.5 + rng.randint(-1, 2, cells.shape) * 0.25).astype(np.float32)
        valid = rng.rand(len(cells)) < 0.7
        if kind == "plane":
            feats = rng.randn(len(cells), 3)
            feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        else:  # a packed SPD inverse covariance [xx, yy, zz, xy, xz, yz]
            A = rng.randn(len(cells), 3, 3) * 0.5
            S = np.einsum("nij,nkj->nik", A, A) + np.eye(3)
            feats = S[:, [0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]]
        for budget in (DENSE_CELL_BUDGET, 1):
            grid, inverse, _ = build_grid(torch.from_numpy((cells + 0.5).astype(np.float32))
                                          .to(dev), 1.0, dense_budget=budget)
            sizes.append(grid.n_cells)
            C, inv = grid.keys.shape[0], inverse.long()
            slot = lambda a, dt=torch.float32: torch.zeros(  # noqa: E731
                (C,) + a.shape[1:], dtype=dt, device=dev).index_copy_(
                    0, inv, torch.from_numpy(np.asarray(a)).to(dev, dt))
            table = ga.voxel_table(slot(means), slot(valid, torch.bool),
                                   slot(feats.astype(np.float32)))
            for T in poses:
                worst = max(worst, check_grid_launch(
                    f"[{kind} quarter lattice] dense table {grid.dense is not None}", kind, grid,
                    table, src, w, T, offsets, 2.0))
    sample_max = grid_sample_max()
    if min(sizes) <= sample_max:
        raise AssertionError(f"[{kind} quarter lattice] {sizes} cells: no sampled interval")
    log(f"[{kind} kernel] vs plain on the quarter lattice ({sizes[0]} occupied cells; 4,000 "
        f"queries, a third of weight 0; two poses; dense table and search"
        f"{'; caps 6 and 64' if kind in ('point', 'plane_pt') else ''}): winners equal, max abs "
        f"err {worst:.3e}")
    return worst


def run_grid_targets(dev) -> dict:
    """Phase 9: ICP and PlaneICP with default configurations on a target below
    ``auto_threshold``, which takes the ``"grid"`` method and the grid stats
    kernel (no packed-grid kernel); PlaneICP's normals through the k-NN
    kernel."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from bench import make_lidar_map, make_scan
    from point_cloud_registration_tpu_torch.models._point_corr import grid_cell_of
    from point_cloud_registration_tpu_torch.models._point_fused import fused_point_stats
    from point_cloud_registration_tpu_torch.models.base import pad_points
    from point_cloud_registration_tpu_torch.ops.hashgrid import search_offsets
    from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
    from point_cloud_registration_tpu_torch.ops.knn import nearest_point

    rng = np.random.RandomState(SEED)
    target = make_lidar_map(rng, N_SMALL)
    scan = make_scan(rng, target, N_SMALL_SCAN)
    target_t, scan_t = torch.from_numpy(target).to(dev), torch.from_numpy(scan).to(dev)
    out = {}
    for name, cls, t_ref, its, kind in (("icp", pt.ICP, T_REF_ICP_GRID, 5, "point"),
                                        ("plane_icp", pt.PlaneICP, T_REF_PLANE_ICP_GRID, 3,
                                         "plane_pt")):
        tag = f"[{name} grid]"
        kernel = GRID_KINDS[kind][0]
        reset_launches()
        t0 = time.perf_counter()
        s = cls(**PARAMS, device=dev)
        s.set_target(target)
        T = s.align(scan)
        first_s = time.perf_counter() - t0
        counts = launch_counts()
        corr = getattr(s._target, "corr", s._target)
        method = s.cfg.corr.resolved_method(N_SMALL)
        log(f"{tag} {N_SMALL}-point LiDAR target, {N_SMALL_SCAN}-point scan: method {method}, "
            f"{corr.grid.n_cells} occupied cells of {grid_cell_of(s.cfg.corr, s.cfg.max_dist)} m, "
            f"largest bucket {int(corr.buckets.counts.max())} (cap {s.cfg.corr.cell_cap}); "
            f"first call {first_s:.3f} s; launch counts {counts}")
        if method != "grid" or corr.packed is not None:
            raise AssertionError(f"{tag} the target is not a grid target")
        if counts["point_stats"] or counts["plane_point_stats"]:
            raise AssertionError(f"{tag} a packed-grid kernel ran on a grid target")
        if name == "plane_icp" and counts["knn_moments"] < 1:
            raise AssertionError(f"{tag} the normals did not go through the k-NN kernel")
        d = s.last_diagnostics
        err = check_T(tag, T, d, t_ref, its)
        resident = check_loop(tag, counts, d.iterations, "grid_loop", (kernel,))
        normals = s._target.normals if name == "plane_icp" else None
        warm = warm_runs(s, lambda x: x.set_target(target_t), scan_t, T)
        loops = host_loop_launches(tag, kernel, lambda: hold_to_host(
            tag, lambda: (s.align(scan_t), s.last_diagnostics), T, d, 1))
        src, w = pad_points(scan_t, device=dev)
        held = hold_grid_kernel(tag, kind, s, src, w, T, d)
        Tc = torch.as_tensor(T, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fused_point_stats(corr, src, w, Tc, s.cfg, kind, normals)
        stats_ms = (time.perf_counter() - t0) * 100.0
        estimated = "; normals estimated in set_target" if normals is not None else ""
        log(f"{tag} warm (device-resident inputs{estimated}), set_target s / align s: "
            + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in warm)
            + f"; align per iteration {min(b for _, b in warm) / d.iterations * 1e3:.2f} ms; "
              f"one stats call (the wrapper's launch + the copy to the host) {stats_ms:.3f} ms")
        out[name] = {"first_call_s": first_s, "set_target_s": min(a for a, _ in warm),
                     "align_s": min(b for _, b in warm), "iterations": d.iterations,
                     "stats_ms": stats_ms, "dT_jax": err, "launches": counts,
                     "resident": resident, "kernel": held, **loops}
    # the grid stats kernels on lattice targets, with and without the dense key table
    out["lattice_max_abs_err"] = {kind: grid_lattice_cases(kind, dev)
                                  for kind in ("point", "plane_pt")}
    out["ptxas"] = grid_ptxas()
    # nearest_point against the exact 1-NN kernel at ICP's converged T: equal
    # wherever the window had no overflow and the match lies within a cell
    s = pt.ICP(**PARAMS, device=dev)
    s.set_target(target_t)
    corr, cell = s._target, grid_cell_of(s.cfg.corr, s.cfg.max_dist)
    T_icp = torch.as_tensor(s.align(scan_t), dtype=torch.float32).to(dev)
    q = (scan_t @ T_icp[:3, :3].T + T_icp[:3, 3]).contiguous()
    nn, over = nearest_point(corr.grid, corr.buckets, corr.points, q,
                             search_offsets(s.cfg.max_dist, cell), s.cfg.corr.cell_cap,
                             with_overflow=True)
    d_x, i_x = en.exact_nn(q, corr.points)
    sure = ~over & (nn.dist < cell)
    d_err = float(((nn.dist - d_x).abs() / d_x.clamp(min=1e-30))[sure].max())
    diff = sure & (nn.idx != i_x)
    tie_err = float((corr.points[nn.idx[diff].long()] - q[diff]).norm(dim=1).sub(d_x[diff])
                    .abs().max()) if bool(diff.any()) else 0.0
    log(f"[icp grid] nearest_point vs exact_nn on the {N_SMALL_SCAN} scan points at the converged "
        f"T: {int(sure.sum())} without overflow within a cell ({int(over.sum())} windows over the "
        f"cap); max rel |d - d_exact| {d_err:.3e}; indices differing {int(diff.sum())} (at equal "
        f"distance within {tie_err:.3e})")
    if not (int(sure.sum()) > N_SMALL_SCAN // 2 and d_err <= 1e-6 and tie_err <= 1e-6):
        raise AssertionError("[icp grid] nearest_point disagrees with the exact 1-NN kernel")
    out["nearest_point_checked"] = int(sure.sum())
    return out


def run_hashed_map(map_np, scan_np, dev) -> dict:
    """Phase 10: VPlaneICP and NDT on a map over the dense budget (two
    districts: the city tile and the same tile 3 km away): hashed, aligned
    through the hashed stats kernel (no fused launch)."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.models.base import pad_points
    from point_cloud_registration_tpu_torch.ops.hashgrid import DENSE_CELL_BUDGET

    two = np.vstack([map_np, map_np + TILE_SHIFT])
    two_t, scan_t = torch.from_numpy(two).to(dev), torch.from_numpy(scan_np).to(dev)
    out = {}
    for name, cls, t_ref, its, kind in (("vplane_icp", pt.VPlaneICP, T_REF_VPLANE_HASHED, 4,
                                         "plane"),
                                        ("ndt", pt.NDT, T_REF_NDT_HASHED, 3, "ndt")):
        tag = f"[{name} hashed]"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        s = cls(voxel_size=1.0, **PARAMS, device=dev)
        s.set_target(two)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        T = s.align(scan_np)
        t2 = time.perf_counter()
        counts = launch_counts()
        vm = s.voxels
        cells = int(np.prod(vm.dims))
        log(f"{tag} {len(two)} points, box {vm.dims} = {cells} cells (budget {DENSE_CELL_BUDGET}): "
            f"hashed {vm.hashed}, {vm.grid.n_cells} occupied of {vm.means.shape[0]} slots, "
            f"{vm.num_voxels} valid; first set_target {t1 - t0:.3f} s, align {t2 - t1:.3f} s; "
            f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB; launch counts "
            f"{counts}")
        if not (vm.hashed and vm.grid.dense is None and cells > DENSE_CELL_BUDGET):
            raise AssertionError(f"{tag} the map is not hashed")
        if counts["fused_plane_stats"] or counts["fused_ndt_stats"]:
            raise AssertionError(f"{tag} the fused kernel ran on a hashed map")
        d = s.last_diagnostics
        err = check_T(tag, T, d, t_ref, its)
        resident = check_loop(tag, counts, d.iterations, "grid_loop", (GRID_KINDS[kind][0],))
        warm = warm_runs(s, lambda x: x.set_target(two_t), scan_t, T)
        loops = host_loop_launches(tag, GRID_KINDS[kind][0], lambda: hold_to_host(
            tag, lambda: (s.align(scan_t), s.last_diagnostics), T, d, 1))
        src, w = pad_points(scan_t, device=dev)
        held = hold_grid_kernel(tag, kind, s, src, w, T, d)
        align_s = min(b for _, b in warm)
        log(f"{tag} warm, set_target s / align s: "
            + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in warm)
            + f"; align per iteration {align_s / its * 1e3:.2f} ms")
        out[name] = {"set_target_s": min(a for a, _ in warm), "align_s": align_s,
                     "iterations": its, "dT_jax": err, "launches": counts,
                     "resident": resident, "kernel": held, **loops,
                     "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20}
    out["lattice_max_abs_err"] = {kind: grid_lattice_cases(kind, dev) for kind in ("plane", "ndt")}
    return out


def run_update_target(map_np, scan_np, dev) -> dict:
    """Phase 11: ``set_target(half 1)``, ``update_target(half 2)``,
    ``align(scan)`` for VPlaneICP and NDT: the updated map's cell index feeds
    the loop kernel, one launch an align; the fused stats kernel on it against
    its plain version; counts and valid cells equal a full rebuild's."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.models import pad_points
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa

    perm = np.random.RandomState(SPLIT_SEED).permutation(len(map_np))
    half = len(map_np) // 2
    part_a, part_b = map_np[perm[:half]], map_np[perm[half:]]
    pb_t = torch.from_numpy(part_b).to(dev)
    out = {}
    for name, cls, kernel, t_ref, its in (
            ("vplane_icp", pt.VPlaneICP, fa.fused_plane_stats, T_REF_VPLANE_UPDATE, 4),
            ("ndt", pt.NDT, fa.fused_ndt_stats, T_REF_NDT_UPDATE, 3)):
        tag = f"[{name} update_target]"
        reset_launches()
        s = cls(voxel_size=1.0, **PARAMS, device=dev)
        s.set_target(part_a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.update_target(part_b)
        torch.cuda.synchronize()
        first_update_s = time.perf_counter() - t0
        T = s.align(scan_np)
        counts = launch_counts()
        d = s.last_diagnostics
        log(f"{tag} halves of {len(part_a)} / {len(part_b)} points; first update "
            f"{first_update_s:.3f} s; launch counts {counts}")
        err = check_T(tag, T, d, t_ref, its)
        launches = kernel.launches  # before the comparisons below launch it again
        resident = check_loop(tag, counts, d.iterations)
        scan_t = torch.from_numpy(scan_np).to(dev)
        loops = hold_to_host(tag, lambda: (s.align(scan_t), s.last_diagnostics), T, d, 1)
        full = cls(voxel_size=1.0, **PARAMS, device=dev)
        full.set_target(map_np)
        a, b = s.voxels, full.voxels
        if not (a.dims == b.dims and torch.equal(a.counts, b.counts)
                and torch.equal(a.valid, b.valid)):
            raise AssertionError(f"{tag} counts or valid cells differ from a full rebuild")
        v = b.valid
        mean_err = float((a.means[v] - b.means[v]).abs().max())
        cov_err = float(((a.covs[v] - b.covs[v]).abs()
                         / b.covs[v].abs().amax(dim=1, keepdim=True).clamp(min=1e-30)).max())
        # the kernel against its plain version on the updated map's cell index
        src, w = pad_points(scan_np, device=dev)
        args = voxel_args(s, src, w, torch.as_tensor(T, dtype=torch.float32))
        kerr = compare_stats(kernel(*args), getattr(fa, f"{kernel.__name__}_reference")(*args))
        if not (kerr["max"] < TOL_H and kerr["g"] < TOL_G and kerr["n"] <= TOL_N):
            raise AssertionError(f"{tag} the kernel disagrees with its plain version: {kerr}")
        times = []
        for _ in range(3):
            s.set_target(part_a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.update_target(pb_t)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f"{tag} against a full rebuild: counts and valid equal ({int(v.sum())} valid "
            f"cells); max |mean - mean_rebuild| {mean_err:.3e} m, max |cov - cov_rebuild| "
            f"{cov_err:.3e} of the cell's largest entry; kernel vs plain at the converged T: "
            f"rel err H {kerr['max']:.3e}, n diff {kerr['n']:.0f}; warm update_target s "
            + ", ".join(f"{x:.4f}" for x in times))
        out[name] = {"iterations": d.iterations, "launches": launches,
                     "loop_launches": counts["fused_loop"], "dT_jax": err,
                     "resident": resident, **loops,
                     "update_s": min(times), "mean_err": mean_err, "cov_err": cov_err}
    return out


def run_utilities(map_np, scan_np, dev) -> dict:
    """Phase 12: ``KDTree``, ``VoxelGrid`` and ``voxel_filter`` at full size."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
    from point_cloud_registration_tpu_torch.ops.knn import brute_force_knn

    tag = "[utilities]"
    map_t, scan_t = torch.from_numpy(map_np).to(dev), torch.from_numpy(scan_np).to(dev)
    out = {}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = pt.KDTree(map_t)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    d, i = tree.query(scan_t, k=1)
    t2 = time.perf_counter()
    build_s, query_s = t1 - t0, t2 - t1
    launches = en.exact_nn.launches
    d_x, i_x = (x.cpu().numpy() for x in en.exact_nn(scan_t, map_t))
    diff = i != i_x
    tie = (float(np.abs(np.linalg.norm(map_np[i[diff]] - scan_np[diff], axis=1) - d_x[diff]).max())
           if diff.any() else 0.0)
    log(f"{tag} KDTree(map): cell {tree.cell_size:.4f} m, build {build_s:.3f} s; query(scan, "
        f"k=1) {query_s:.3f} s with {launches} exact_nn launch(es) for its escapes; against "
        f"exact_nn: distances equal {np.array_equal(d, d_x)}, indices differing {int(diff.sum())} "
        f"(at equal distance within {tie:.2e})")
    if not (launches >= 1 and np.array_equal(d, d_x) and tie <= 1e-6):
        raise AssertionError(f"{tag} KDTree.query(k=1) is not the exact 1-NN")
    q = scan_t[:N_KNN].contiguous()
    t0 = time.perf_counter()
    dk, ik = tree.query(q, k=K_KNN)
    t1 = time.perf_counter()
    db, ib = (x.cpu().numpy() for x in brute_force_knn(q, map_t, K_KNN, chunk=64))
    t2 = time.perf_counter()
    rel = float((np.abs(dk - db) / np.maximum(db, 1e-30)).max())
    diff = ik != ib
    # an index may differ only between neighbours at one distance
    tie_ok = bool(np.all(np.isin(dk[diff], db[diff]))) if diff.any() else True
    log(f"{tag} query({N_KNN} scan points, k={K_KNN}) {t1 - t0:.3f} s against brute_force_knn "
        f"({t2 - t1:.3f} s): max rel |d - d_exact| {rel:.3e}, indices differing "
        f"{int(diff.sum())} (ties only: {tie_ok})")
    if not (rel <= 1e-6 and tie_ok):
        raise AssertionError(f"{tag} KDTree.query(k={K_KNN}) is not the exact k-NN")
    out["kdtree"] = {"build_s": build_s, "query_s": query_s, "knn_query_s": t1 - t0,
                     "exact_nn_launches": launches}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vg = pt.VoxelGrid(1.0, device=dev)
    vg.set_points(map_t)
    vg.calc_icov()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = vg.query(scan_t, ["mean", "norm", "icov"])
    t2 = time.perf_counter()
    if not (np.isfinite(res["dist"]).all() and res["icov"].shape == (len(scan_np), 3, 3)
            and np.isfinite(res["mean"]).all()):
        raise AssertionError(f"{tag} VoxelGrid.query gave non-finite fields")
    log(f"{tag} VoxelGrid(1.0): set_points + calc_icov {t1 - t0:.3f} s ({len(vg.mean)} valid "
        f"voxels); query(scan, mean/norm/icov) {t2 - t1:.3f} s, max dist {res['dist'].max():.3f}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cent = pt.voxel_filter(map_t, 0.5)
    t1 = time.perf_counter()
    scale = np.maximum(1.0, np.abs(VOXEL_FILTER_REF))
    err = float((np.abs(cent[VOXEL_FILTER_ROWS] - VOXEL_FILTER_REF) / scale).max()) \
        if len(cent) == VOXEL_FILTER_COUNT else float("inf")
    again = pt.voxel_filter(map_t, 0.5)
    t2 = time.perf_counter()
    log(f"{tag} voxel_filter(map, 0.5): {len(cent)} centroids (JAX: {VOXEL_FILTER_COUNT}), "
        f"{t1 - t0:.3f} s, warm {t2 - t1:.3f} s; max rel err of {len(VOXEL_FILTER_ROWS)} rows "
        f"against the JAX package's {err:.2e}; a second call bit-equal "
        f"{np.array_equal(cent, again)}")
    if not (len(cent) == VOXEL_FILTER_COUNT and err <= 1e-5 and np.array_equal(cent, again)):
        raise AssertionError(f"{tag} voxel_filter disagrees with the JAX package")
    out["voxel_filter_s"] = t2 - t1
    return out


def device_busy(fn, wall_s: float, expect: str | None = None, tries: int = 3) -> tuple:
    """``(device ms, kernels, busy share)`` of one traced call of ``fn`` by
    ``torch.profiler``: the kernels' own device time over ``wall_s``, the
    untraced wall of the same call. With ``expect``, a trace that holds no
    kernel whose name holds it (the profiler drops kernels now and then) is
    logged and taken again, up to ``tries`` times, the later ones tracing
    the card alone; if none holds it, the device time and busy share are
    NaN: not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * (attempt == 1)
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        # kernel rows only: an aten op's row repeats the time of the kernels it launched
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        if expect is None or any(expect in e.key for e in rows):
            break
        log(f"[profiler] trace {attempt} of {tries} holds no kernel named {expect}"
            + ("; taking it again" if attempt < tries else "; the device time is not measured"))
    else:
        return float("nan"), 0, float("nan")
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return device_ms, sum(e.count for e in rows), device_ms / (1e3 * wall_s)


def batched_align(path: SolverPath, s, src, w, Ts):
    """The batched align of ``path``'s kind on solver ``s``'s target."""
    from point_cloud_registration_tpu_torch.models._fused import fused_voxel_align_batched
    from point_cloud_registration_tpu_torch.models._point_fused import fused_point_align_batched

    kind = BATCHED_KINDS[path.name]
    if path.args is voxel_args:
        return fused_voxel_align_batched(s._target, src, w, Ts, s.cfg, kind)
    return fused_point_align_batched(getattr(s._target, "corr", s._target),
                                     getattr(s._target, "normals", None), src, w, Ts, s.cfg, kind)


def problem_words(state, b: int):
    """Problem ``b``'s words of a batched ``GNState`` in the order of a
    single problem's state words (pose, it, done, failed, converged,
    final_e2, the three histories), as int32: a single align's state compares
    with them bit for bit, NaN payloads included."""
    import torch

    return torch.cat([float_bits(state.poses[b]), state.it[b:b + 1], state.done[b:b + 1],
                      state.failed[b:b + 1], state.converged[b:b + 1],
                      float_bits(state.final_e2[b:b + 1]), float_bits(state.e2[b]),
                      float_bits(state.dx_norm[b]), state.inliers[b]])


def batched_loop_operands(path: SolverPath, s, src, w):
    """``(operands, settings, looper, loop, plain_loop, single_loop, stats_all,
    stats_rows)`` of the batched loop kernel of ``path``'s kind on solver
    ``s``'s target and the scans ``src`` (B, n, 3), ``w`` (B, n): its
    leading arguments and keyword settings, its wrappers, the single-problem
    loop of one scan (``single_loop(src_b, w_b, state)``), the batched host
    loop's stats (``fused_*_stats_packed_batched``) and ``stats_rows(poses)``,
    the batched stats kernel's (B, n_blocks, 29) block rows at pose rows
    ``poses`` (one launch of the host loop's stats)."""
    from point_cloud_registration_tpu_torch.models import _fused, _point_fused
    from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
    from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    kind, cfg = BATCHED_KINDS[path.name], s.cfg
    settings = dict(max_dist=cfg.max_dist, huber_delta=cfg.huber_delta, tol=cfg.tol,
                    max_iter=cfg.max_iter)
    if path.args is voxel_args:
        vm = s._target
        head = (vm.cells, vm.origin_cell, vm.dims, vm.cell_size)
        stats_all = _fused.fused_voxel_stats_packed_batched(vm, src, w, cfg, kind)

        def stats_rows(poses):
            return fa.launch_args(fa._kernel_fn(kind), *head, src, w, poses, None, cfg.max_dist,
                                  cfg.huber_delta)

        return ((kind, *head, src, w), settings, gl.fused_looper_batched, gl.fused_loop_batched,
                gl.fused_loop_batched_reference,
                lambda src_b, w_b, state: gl.fused_loop(kind, *head, src_b, w_b, state,
                                                        **settings),
                stats_all, stats_rows)
    tg = getattr(s._target, "corr", s._target)
    settings["proxy_radius"] = proxy_radius(cfg.corr, cfg.max_dist)
    stats_all = _point_fused.fused_point_stats_packed_batched(tg, src, w, cfg, kind)

    def stats_rows(poses):
        return pa.partials_args(pa._kernel_fn(kind), tg.packed, tg.proxy, src, w, poses, None,
                                cfg.max_dist, settings["proxy_radius"], cfg.huber_delta)

    return ((kind, tg.packed, tg.proxy, src, w), settings, gl.point_looper_batched,
            gl.point_loop_batched, gl.point_loop_batched_reference,
            lambda src_b, w_b, state: gl.point_loop(kind, tg.packed, tg.proxy, src_b, w_b, state,
                                                    **settings),
            stats_all, stats_rows)


def hold_batched_loop(tag: str, path: SolverPath, batched, s, src, w, eye) -> dict:
    """Phases 13-14: the batched loop kernel of ``path``'s kind at the main
    path's shapes, from T = I and from B distinct perturbed starts: the
    first iteration's block rows (its ``rows`` output) bit-equal to the
    batched stats kernel's (``batched``) at the starts; the state's words
    (pose, counters, flags, final e2, histories) bit-equal to the two-launch
    batched loop's (:func:`two_launch` over the batched stats kernel, the
    card reference: the host's solve can differ from the card's in a step's
    last bit, one |dx| entry of the batched ICP stream) and every problem's
    to the single-problem loop kernel's align of that scan; against the
    batched host loop (:func:`host_batched`) equal iterations and flags and
    T within TOL_LOOP, its bit-equality printed, and each problem's T
    against its single host loop (:func:`host_align`) printed; T within
    TOL_T of the plain version (``*_loop_batched_reference``) with equal
    iterations and flags. Then its
    time per align by events (a copy of the initial state and the launch)
    and alone (the profiler), the plain version's, both loops' aligns in
    turns with their device time, busy share, syncs and launches, the
    ptxas report and the bound: the stats' work at each problem's converged
    pose for each iteration it ran (the map's bytes once for all problems)
    and the update's per problem and iteration."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.core import gn
    from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl

    kind = BATCHED_KINDS[path.name]
    name = BATCHED_LOOPS[kind]
    (operands, settings, looper, loop_fn, plain_loop, single_loop, stats_all,
     stats_rows) = batched_loop_operands(path, s, src, w)
    cfg, B, dev = s.cfg, src.shape[0], src.device
    T_pert = torch.stack([pt.plus(torch.eye(4), torch.tensor(PERTURBATION) * (b - 3.5) / 4)
                          for b in range(B)])
    r = {"dT_plain": 0.0, "dT_host": 0.0, "rows_equal": True, "host_bit_equal": [],
         "single_equal": True}
    for label, T0 in (("T=I", eye), ("T=perturbed", T_pert)):
        fn, args, partials = stats_rows(gn.pose_rows_of(T0).to(dev).contiguous())
        if fn(*args) != 0:
            raise AssertionError(f"{tag} the batched stats launch failed")
        rows = torch.full_like(partials, float("nan"))
        state = gn.new_state(T0, cfg.max_iter, dev)
        launch = looper(*operands, state, **settings, rows=rows)
        launch()
        k = gn.read_state(state)
        rows_equal = torch.equal(rows, partials)
        held = hold_to_loops(f"{tag} batched loop {label}:", k,
                             *host_batched(stats_all, T0, cfg, dev),
                             two_launch(stats_all, T0, cfg.max_iter, cfg.tol, dev))
        r["dT_host"] = max(r["dT_host"], held["dT_host"])
        r["host_bit_equal"].append(held["host_bit_equal"])
        T_k = gn.transforms_of(k.poses)
        single_host = [torch.equal(float_bits(T_k[b]), float_bits(
            host_align(s, src[b], w[b], T0[b])[0])) for b in range(B)]
        single_equal = []
        for b in range(B):
            one = gn.new_state(T0[b:b + 1], cfg.max_iter, dev)
            single_loop(src[b], w[b], one)
            single_equal.append(torch.equal(problem_words(k, b), gn.read_state(one).words))
        plain = gn.new_state(T0, cfg.max_iter, "cpu")
        plain_loop(*operands, plain, **settings)
        dT_plain = float((gn.transforms_of(k.poses) - gn.transforms_of(plain.poses)).abs().max())
        flags_plain = all(torch.equal(getattr(k, f), getattr(plain, f))
                          for f in ("it", "failed", "converged"))
        log(f"{tag} batched loop {label}: grid {launch.grid[0]} CTAs for {B} x {launch.grid[1]} "
            f"block ids; first iteration's block rows bit-equal to the batched stats kernel's "
            f"{rows_equal}; iterations {k.it.tolist()}; each problem's words bit-equal to its "
            f"single-problem loop's {single_equal}, its T to its single host loop's "
            f"{single_host}; max |T - T_plain| {dT_plain:.3e}, iterations and flags equal to "
            f"the plain version's {flags_plain}")
        if not (rows_equal and all(single_equal) and dT_plain <= TOL_T and flags_plain
                and bool(k.done.all())):
            raise AssertionError(f"{tag} {label}: the batched loop kernel is off the single "
                                 "aligns or its plain version")
        r["dT_plain"] = max(r["dT_plain"], dT_plain)
        if label == "T=I":
            r["iterations"], k_eye = k.it.tolist(), k

    # time per align at T = I: events (the state's copy and the launch), alone
    init = gn.new_state(eye, cfg.max_iter, dev)
    state = gn.new_state(eye, cfg.max_iter, dev)
    launch = looper(*operands, state, **settings)

    def once():
        state.words.copy_(init.words)
        launch()

    r["ms"] = cuda_ms(once, 50)
    r["alone_ms"] = kernel_alone_ms(once, 20, "gn_loop_batched_kernel")
    # more CTAs than fit at once: the card refuses, the wrapper raises, no
    # launch counted, the state untouched
    fn, block, per_sm, error_string = (gl._batched_kernel_fn if name == "fused_loop_batched"
                                       else gl._point_batched_kernel_fn)(kind)
    wrapper, before = getattr(gl, name), getattr(gl, name).launches
    refused = gn.new_state(eye, cfg.max_iter, dev)
    launch = looper(*operands, refused, **settings,
                    bound=(fn, block, lambda device=None: per_sm(device) + 1, error_string))
    try:
        launch()
    except RuntimeError as err:
        log(f"{tag} batched loop: {launch.grid[0]} CTAs of {B} x {launch.grid[1]} block ids with "
            f"room for {per_sm(dev)} an SM: {err}")
    else:
        raise AssertionError(f"{tag} a cooperative launch of more CTAs than fit ran")
    if wrapper.launches != before or int(gn.read_state(refused).it.max()) != 0:
        raise AssertionError(f"{tag} the refused batched launch counted or ran")
    r["plain_ms"] = cuda_ms(lambda: plain_loop(*operands, gn.new_state(eye, cfg.max_iter, "cpu"),
                                               **settings), 1)
    # both loops' aligns in turns (host, loop, loop, host), each with its
    # launches counted
    loop = functools.partial(loop_fn, *operands, **settings)
    aligns = {"host": lambda: host_batched(stats_all, eye, cfg, dev),
              "loop": lambda: gn.batched_gauss_newton_device(loop, eye, cfg.max_iter, dev)}
    walls = {m: [] for m in aligns}
    for mode in ("host", "loop", "loop", "host"):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aligns[mode]()
            walls[mode].append(time.perf_counter() - t0)
    line = []
    for mode, align in aligns.items():
        device_ms, n_kernels, busy = device_busy(
            align, min(walls[mode]), "gn_loop_batched_kernel" if mode == "loop" else None)
        reset_launches()
        _, syncs = count_syncs(align)
        counts = launch_counts()
        r[mode] = {"align_walls_s": walls[mode], "device_ms": device_ms, "kernels": n_kernels,
                   "busy": busy, "syncs": syncs,
                   "launches": {k: v for k, v in counts.items() if v}}
        line.append(f"{mode}: align ms {', '.join(f'{1e3 * x:.3f}' for x in walls[mode])}; "
                    f"device {device_ms:.3f} ms in {n_kernels} kernels, busy "
                    f"{100 * busy:.1f} %, {syncs} syncs, launches {r[mode]['launches']}")
    log(f"{tag} aligns in turns (host, loop, loop, host): " + "; ".join(line))
    its = r["iterations"]
    # the host loop: one launch of the batched stats kernel an iteration of the batch
    if r["host"]["launches"] != {batched.__name__: max(its)}:
        raise AssertionError(f"{tag} the batched host loop launched {r['host']['launches']}: "
                             f"expected {max(its)} of {batched.__name__}")
    if not (r["loop"]["syncs"] == 1 and r["loop"]["launches"] == {name: 1}):
        raise AssertionError(f"{tag} the align through the batched loop kernel made "
                             f"{r['loop']['syncs']} syncs and launched {r['loop']['launches']}: "
                             f"expected 1 sync and one launch of {name}")
    # bound: the stats' work at each problem's converged pose for each
    # iteration it ran; the map's bytes once for all problems, each scan
    # once, the update's state bytes per problem
    T_conv = gn.transforms_of(k_eye.poses)
    R, t = T_conv[:, :3, :3].to(dev), T_conv[:, :3, 3].to(dev)
    q_all = (torch.einsum("bij,bnj->bni", R, src) + t[:, None, :]).reshape(-1, 3).contiguous()
    inliers = [float(k_eye.inliers[b][its[b] - 1]) for b in range(B)]
    n_bytes, _ = path.work(s, q_all, w.reshape(-1), torch.eye(4), sum(inliers))
    ops = sum(its[b] * (path.work(s, src[b], w[b], T_conv[b], inliers[b])[1] + GN_STEP_FLOPS)
              for b in range(B))
    r["bound_ms"], r["bound_by"] = bound_ms(n_bytes + B * GN_STEP_BYTES, ops)
    r["ptxas"] = library_ptxas(BATCHED_LOOP_LIBRARIES[name], "gn_loop_batched_kernel",
                               LOOP_LABELS if name == "fused_loop_batched"
                               else LOOP_PTXAS_LABELS["point_loop"])[kind]
    log(f"{tag} batched loop kernel, iterations {its}: {r['ms']:.4f} ms by events (the state's "
        f"copy and the launch), alone {r['alone_ms']:.4f} ms (profiler); the plain version "
        f"{r['plain_ms']:.2f} ms; bound {r['bound_ms']:.5f} ms by {r['bound_by']}; ptxas "
        f"{r['ptxas']}")
    return r


def run_batched(path: SolverPath, batched, plain, map_np, dev) -> dict:
    """Phases 13 and 14 for one kind: B = 8 scans of 16,384 points against
    ``path``'s target; the align through the batched loop kernel, held to
    its batched stats kernel ``batched`` (and its plain version ``plain``),
    to the batched host loop and to each scan's single align."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from bench import make_scan

    tag = f"[batched {path.name}]"
    B, n = N_BATCHES, N_BATCH
    s = path.make(dev)
    path.set_target(s, map_np)
    scans = np.stack([make_scan(np.random.RandomState(100 + b), map_np, n) for b in range(B)])
    src = torch.from_numpy(scans).to(dev)
    w = torch.ones((B, n), device=dev)
    eye = torch.eye(4).expand(B, 4, 4).clone()

    # The batched kernel against its plain version and against its single
    # entry, at these shapes and B distinct poses
    Ts_p = torch.stack([pt.plus(torch.eye(4), torch.tensor(PERTURBATION) * (b - 3.5) / 4)
                        for b in range(B)])
    args = path.args(s, src, w, Ts_p)
    k_out, p_out = batched(*args), plain(*args)
    single = torch.stack([path.kernel(*path.args(s, src[b], w[b], Ts_p[b])) for b in range(B)])
    max_abs_err = 0.0
    for b in range(B):
        err = compare_stats(k_out[b], p_out[b])
        if not (err[path.h_metric] < TOL_H and err["g"] < TOL_G and err["e2"] < TOL_E2
                and err["n"] <= TOL_N):
            raise AssertionError(f"{tag} problem {b}: the batched kernel disagrees with its "
                                 f"plain version: {err}")
        max_abs_err = max(max_abs_err, err["max_abs"])
    rows_equal = torch.equal(k_out, single)
    log(f"{tag} batched kernel vs plain at {B} distinct poses: max abs {max_abs_err:.3e}; "
        f"rows bit-equal to {B} single launches: {rows_equal} (max abs "
        f"{float((k_out - single).abs().max()):.3e})")
    # Scans of n points that are no multiple of 8 or of a block: a problem's
    # tail must read nothing of the next problem's points
    for n_t in BATCH_TAILS:
        sub = src[:3, :n_t].contiguous()
        a = path.args(s, sub, w[:3, :n_t].contiguous(), Ts_p[:3])
        k_t, p_t = batched(*a), plain(*a)
        one = torch.stack([path.kernel(*path.args(s, sub[b], w[b, :n_t].contiguous(), Ts_p[b]))
                           for b in range(3)])
        scale = float(p_t.abs().max()) + 1e-30
        d_single = float((k_t - one).abs().max()) / scale
        d_plain = float((k_t - p_t).abs().max()) / scale
        log(f"{tag} n = {n_t}: rel diff vs single launches {d_single:.3e}, vs plain {d_plain:.3e}, "
            f"n_inliers {k_t[:, 28].tolist()} (plain {p_t[:, 28].tolist()})")
        if not (d_single <= 1e-6 and d_plain <= 1e-4
                and torch.equal(k_t[:, 28].round(), p_t[:, 28].round())):
            raise AssertionError(f"{tag} n = {n_t}: the batched kernel's rows are off")

    # 13/14. Main path: the batched align with the counts reset just before:
    # one launch of the batched loop kernel, none of the stats kernels
    loop_name = BATCHED_LOOPS[BATCHED_KINDS[path.name]]
    reset_launches()
    t0 = time.perf_counter()
    Ts, d = batched_align(path, s, src, w, eye)
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = batched.launches
    its = d.iterations.tolist()
    log(f"{tag} {B} x {n} points, first call {first_s:.3f} s: iterations {its}, launch counts "
        f"{counts}")
    if not (bool(d.converged.all()) and not bool(d.solver_failed.any())
            and np.isfinite(Ts.numpy()).all()):
        raise AssertionError(f"{tag} a problem did not converge: {d}")
    resident = check_loop(tag, counts, its, loop_name, (batched.__name__, path.kernel.__name__))
    # Each problem against its single align (bit for bit: T, iterations,
    # flags, histories) and the JAX package's
    dT_single, dT_jax, bit_equal = 0.0, 0.0, True
    for b in range(B):
        T_1 = s.align(scans[b])
        d_1 = s.last_diagnostics
        dT_single = max(dT_single, float(np.abs(Ts[b].numpy() - T_1).max()))
        bit_equal &= bool(np.array_equal(Ts[b].numpy(), T_1.astype(np.float32))) and all(
            torch.equal(float_bits(getattr(d, f)[b]), float_bits(getattr(d_1, f)))
            for f in ("e2_history", "dx_norm_history", "inlier_history"))
        if not (int(d.iterations[b]) == d_1.iterations and bool(d.converged[b]) == d_1.converged
                and bool(d.solver_failed[b]) == d_1.solver_failed):
            raise AssertionError(f"{tag} problem {b}: batched {int(d.iterations[b])} iterations, "
                                 f"single {d_1.iterations}")
        its_ref, rows_ref = BATCHED_REF[BATCHED_KINDS[path.name]][b]
        dT_jax = max(dT_jax, float(np.abs(Ts[b].numpy()[:3].reshape(-1) - rows_ref).max()))
        if int(d.iterations[b]) != its_ref:
            raise AssertionError(f"{tag} problem {b}: {int(d.iterations[b])} iterations, JAX "
                                 f"{its_ref}")
    log(f"{tag} max |T - T_single| {dT_single:.3e} (T and histories bit-equal {bit_equal}), "
        f"max |T - T_jax| {dT_jax:.3e}, iterations equal to both")
    if not (bit_equal and dT_single < TOL_BATCHED and dT_jax < TOL_REF):
        raise AssertionError(f"{tag} a problem's T is off its single align or the JAX package's")
    # The batched loop kernel against the batched host loop, the single
    # aligns and its plain version; its times and bound
    loop = hold_batched_loop(tag, path, batched, s, src, w, eye)
    # A mixed batch: problem 1 moved 100 m up (all outliers), problem 2 with
    # half its weights 0; the others must keep the clean batch's T
    src_m, w_m = src.clone(), w.clone()
    src_m[1, :, 2] += 100.0
    w_m[2, ::2] = 0.0
    Ts_m, d_m = batched_align(path, s, src_m, w_m, eye)
    others = [b for b in range(B) if b not in (1, 2)]
    log(f"{tag} mixed batch: iterations {d_m.iterations.tolist()}, failed "
        f"{d_m.solver_failed.tolist()}; half-weight problem converged {bool(d_m.converged[2])}")
    if not (bool(d_m.solver_failed[1]) and int(d_m.iterations[1]) == 1
            and torch.equal(Ts_m[1], torch.eye(4)) and bool(d_m.converged[2])
            and all(torch.equal(Ts_m[b], Ts[b]) for b in others)):
        raise AssertionError(f"{tag} the mixed batch went wrong: {d_m}")

    # Warm runs, the device time by the profiler, the kernel alone
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Ts_w, _ = batched_align(path, s, src, w, eye)
        walls.append(time.perf_counter() - t0)
        if not torch.equal(Ts_w, Ts):
            raise AssertionError(f"{tag} a warm run gave another result than the first")
    wall = min(walls)
    device_ms, n_kernels, busy = device_busy(lambda: batched_align(path, s, src, w, eye), wall,
                                             "gn_loop_batched_kernel")
    loops = compare_loops(tag, lambda: batched_align(path, s, src, w, eye), Ts, d, 1,
                          n_points=n)
    args = path.args(s, src, w, Ts)
    kernel_ms = cuda_ms(lambda: batched(*args), 20)
    plain_ms = cuda_ms(lambda: plain(*args), 2)
    singles_ms = cuda_ms(lambda: [path.kernel(*path.args(s, src[b], w[b], Ts[b]))
                                  for b in range(B)], 20)
    R, t = Ts[:, :3, :3].to(dev), Ts[:, :3, 3].to(dev)
    q_all = (torch.einsum("bij,bnj->bni", R, src) + t[:, None, :]).reshape(-1, 3).contiguous()
    n_inliers = float(batched(*args)[:, 28].sum())
    b_ms, b_by = bound_ms(*path.work(s, q_all, w.reshape(-1), torch.eye(4), n_inliers))
    log(f"{tag} warm batched align s: " + ", ".join(f"{x:.4f}" for x in walls)
        + f"; batched_regs_per_s {B / wall:.1f}, batched_mpts_per_s {B * n / wall / 1e6:.2f}; "
          f"device {device_ms:.3f} ms in {n_kernels} kernels (busy {100 * busy:.1f} % of the "
          f"untraced wall)")
    log(f"{tag} one batched launch (events) {kernel_ms:.4f} ms, its plain version "
        f"{plain_ms:.2f} ms, {B} single launches {singles_ms:.4f} ms; bound {b_ms:.5f} ms by {b_by}")
    return {"Ts": Ts.numpy(), "launches": launches, "loop_launches": counts[loop_name],
            "loop": loop, "iterations": its, "first_call_s": first_s,
            "align_s": wall, "align_walls_s": walls, "regs_per_s": B / wall, "mpts_per_s": B * n / wall / 1e6,
            "device_ms": device_ms, "kernels": n_kernels, "busy": busy, "ms": kernel_ms,
            "plain_ms": plain_ms, "singles_ms": singles_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": max_abs_err, "rows_bit_equal": rows_equal, "dT_single": dT_single,
            "T_bit_equal": bit_equal, "dT_jax": dT_jax, "resident": resident, **loops}


def run_fast(map_np, scan_np, dev, vplane: dict) -> dict:
    """Phase 15: FastVPlaneICP on the map and the 100k scan. ``"auto"`` is
    VPlaneICP bit for bit (``vplane``: phase 4's results), one launch of the
    loop kernel; ``"always"`` runs phase 1 in one launch of the loop kernel,
    engages the coreset and runs phase 2 on its rows in one more launch of
    the loop kernel, held bit for bit to the host loop's phase 2 on the same
    coreset."""
    import torch

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.core import gn
    from point_cloud_registration_tpu_torch.models import fast_vplane_icp as fvp
    from point_cloud_registration_tpu_torch.models.coreset import create_gn_set, fast_caratheodory
    from point_cloud_registration_tpu_torch.models.fast_vplane_icp import vplane_linearize
    from point_cloud_registration_tpu_torch.models.base import pad_points
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
    from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl

    tag = "[fast_vplane_icp]"
    reset_launches()
    fast = pt.FastVPlaneICP(voxel_size=1.0, **PARAMS, device=dev)
    fast.set_target(map_np)
    T_auto = fast.align(scan_np)
    d = fast.last_diagnostics
    auto_counts = launch_counts()
    auto_launches = fa.fused_plane_stats.launches
    log(f"{tag} auto: {d.iterations} iterations, {auto_counts['fused_loop']} loop launch, "
        f"{auto_launches} fused launches; equal to VPlaneICP: T "
        f"{np.array_equal(T_auto, vplane['T'])}, iterations "
        f"{d.iterations == vplane['iterations']}, launches "
        f"{auto_counts['fused_loop'] == vplane['loop_launches']}")
    if not (np.array_equal(T_auto, vplane["T"]) and d.iterations == vplane["iterations"]
            and auto_counts["fused_loop"] == vplane["loop_launches"] == 1
            and auto_launches == 0):
        raise AssertionError(f"{tag} \"auto\" is not VPlaneICP bit for bit")
    scan_t = torch.from_numpy(scan_np).to(dev)
    auto = hold_to_host(f"{tag} auto", lambda: (fast.align(scan_t), fast.last_diagnostics),
                        T_auto, d, 1)

    # "always": record phase 1, and phase 2's inputs, result and launches
    fast = pt.FastVPlaneICP(voxel_size=1.0, **PARAMS, coreset="always",
                            coreset_switch=FAST_SWITCH, device=dev)
    fast.set_target(map_np)
    phase1, phase2 = {}, {}
    inner = fast._phase1

    def record(*args):
        T, diag = inner(*args)
        phase1.update(T=T, diag=diag, launches=fa.fused_plane_stats.launches,
                      loop_launches=gl.fused_loop.launches)
        return T, diag

    fast._phase1 = record
    phase2_align = fvp._phase2_align

    def record_phase2(*args):
        before = launch_counts()
        T, diag = phase2_align(*args)
        after = launch_counts()
        phase2.update(args=args, T=T, diag=diag,
                      launches={k: v - before[k] for k, v in after.items() if v != before[k]})
        return T, diag

    reset_launches()
    fvp._phase2_align = record_phase2
    try:
        t0 = time.perf_counter()
        T = fast.align(scan_np)
        first_s = time.perf_counter() - t0
    finally:
        fvp._phase2_align = phase2_align
    counts = launch_counts()
    d, d1 = fast.last_diagnostics, phase1["diag"]
    launches = fa.fused_plane_stats.launches
    loop_1, fused_1 = phase1["loop_launches"], phase1["launches"]  # the later aligns move them
    it2 = d.iterations - d1.iterations
    # phase 2 through the host loop on the same coreset and start: the same
    # T, iterations, flags and histories bit for bit; or, where the host's
    # solve differs in a step's last bit (as in phase 14), bit for bit the
    # two-launch loop's (the card's update) with the host loop's iterations
    # and flags and T within TOL_LOOP
    vm, src_sub, w_sub, T1, left, cfg = phase2["args"]
    reset_launches()
    T_host, d_host = host_voxel_align(vm, src_sub, w_sub, T1,
                                    dataclasses.replace(cfg, max_iter=left), "plane")
    host_launches = {k: v for k, v in launch_counts().items() if v}
    d2 = phase2["diag"]
    flags_host = (d2.iterations, d2.converged, d2.solver_failed) == (
        d_host.iterations, d_host.converged, d_host.solver_failed)
    phase2_equal = flags_host and torch.equal(phase2["T"], T_host) and (
        d2.final_e2 == d_host.final_e2) and all(
        torch.equal(float_bits(getattr(d2, f)), float_bits(getattr(d_host, f)))
        for f in ("e2_history", "dx_norm_history", "inlier_history"))
    dT_host = float((phase2["T"] - T_host).abs().max())
    two = two_launch(lambda poses, done: fa.resident_stats(
        "plane", vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src_sub, w_sub, cfg.max_dist,
        cfg.huber_delta, poses, done), T1[None], left, cfg.tol, dev)
    T_two = gn.transforms_of(two.poses)[0]
    two_equal = torch.equal(float_bits(phase2["T"]), float_bits(T_two)) and (
        d2.iterations, d2.converged, d2.solver_failed) == (
        int(two.it[0]), bool(two.converged[0]), bool(two.failed[0])) and all(
        torch.equal(float_bits(a), float_bits(b)) for a, b in (
            (d2.e2_history, two.e2[0]), (d2.dx_norm_history, two.dx_norm[0]),
            (d2.inlier_history, two.inliers[0]),
            (torch.tensor(d2.final_e2, dtype=torch.float32), two.final_e2[0])))
    dT_jax = float(np.abs(T[:3].reshape(-1) - FAST_REF_T).max())
    dT_plain = float(np.abs(T - vplane["T"]).max())
    log(f"{tag} always, switch {FAST_SWITCH}: first call {first_s:.3f} s; phase 1 {d1.iterations} "
        f"iterations (JAX {FAST_REF_PHASE1}), phase 2 {it2} (in all {d.iterations}, JAX "
        f"{FAST_REF_ITERATIONS}), converged {d.converged}; phase 1 in "
        f"{loop_1} loop launch ({fused_1} fused launches); phase 2 on {src_sub.shape[0]} rows "
        f"with launches {phase2['launches']}; the align's launches "
        f"{ {k: v for k, v in counts.items() if v} }; the host loop's phase 2 on the same "
        f"coreset: launches {host_launches}, T, iterations, flags and histories bit-equal "
        f"{phase2_equal} (max |dT| {dT_host:.3e}); the two-launch loop's bit-equal "
        f"{two_equal}; max |T - T_jax| {dT_jax:.3e}, max |T - T_vplane| {dT_plain:.3e}")
    log(f"{tag} T =\n{np.array2string(T, precision=7)}")
    if not (d1.iterations == FAST_REF_PHASE1 and it2 >= 1 and not d.solver_failed
            and loop_1 == 1 and fused_1 == 0 and phase2["launches"] == {"fused_loop": 1}
            and counts["fused_loop"] == 2 and launches == 0
            and src_sub.shape[0] == fast.N_target and left == PARAMS["max_iter"] - d1.iterations
            and (phase2_equal or (two_equal and flags_host and dT_host <= TOL_LOOP))
            and dT_jax < TOL_FAST and dT_plain < TOL_FAST):
        raise AssertionError(f"{tag} \"always\" is off: {d}")

    # The lift against one full-cloud iteration, both on the live points
    src, w = pad_points(scan_np, device=dev)
    J, r, wl = (x.cpu().numpy() for x in vplane_linearize(fast._target, src, w, phase1["T"],
                                                          fast.cfg))
    live = np.where(wl > 0)[0]
    t0 = time.perf_counter()
    P = create_gn_set(J[live], r[live])
    fast_caratheodory(P, wl[live].astype(np.float64), fast.coreset_clusters, fast.N_target)
    lift_s = time.perf_counter() - t0
    iter_s = vplane["align_s"] / vplane["iterations"]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        T_w = fast.align(scan_np)
        walls.append(time.perf_counter() - t0)
        if not np.array_equal(T_w, T):
            raise AssertionError(f"{tag} a warm run gave another result than the first")
    always = hold_to_host(f"{tag} always", lambda: (fast.align(scan_t), fast.last_diagnostics),
                          T, d)
    log(f"{tag} {len(live)} live points; lift (host float64) {lift_s:.3f} s = "
        f"{1e6 * lift_s / len(live):.3f} us a live point; one full-cloud iteration (VPlaneICP's "
        f"warm align / iterations) {1e3 * iter_s:.3f} ms = {1e9 * iter_s / len(live):.2f} ns a "
        f"point; breakeven {lift_s / iter_s:.0f} iterations; warm \"always\" align s "
        + ", ".join(f"{x:.3f}" for x in walls))
    return {"auto_launches": auto_launches, "always_launches": launches,
            "loop_auto": auto_counts["fused_loop"], "loop_always": counts["fused_loop"],
            "loop_phase2": phase2["launches"]["fused_loop"], "phase2_host_loop": host_launches,
            "phase2_host_bit_equal": phase2_equal, "phase2_two_launch_equal": two_equal,
            "phase1_iterations": d1.iterations, "phase2_iterations": it2, "dT_jax": dT_jax,
            "dT_plain": dT_plain, "live": int(len(live)), "lift_s": lift_s,
            "lift_us_per_point": 1e6 * lift_s / len(live), "iteration_s": iter_s,
            "iteration_ns_per_point": 1e9 * iter_s / len(live), "breakeven": lift_s / iter_s,
            "always_align_s": min(walls), "auto_loops": auto, "always_loops": always}


def run_explicit_device(icp_path: SolverPath, map_np, scan_np, T_vplane, Ts_icp) -> dict:
    """Phase 15b: the current card set explicitly (``torch.cuda.set_device``)
    to the last card, and the solvers' tensors there (``device="cuda:<i>"``):
    VPlaneICP's align and the batched ICP align give phase 4's ``T_vplane``
    and phase 14's ``Ts_icp`` bit for bit, each in one launch of its loop
    kernel. Each launcher enters its tensors' card when it binds and when it
    launches; on a machine of one card this is that card."""
    import torch

    import point_cloud_registration_tpu_torch as pt

    index = torch.cuda.device_count() - 1
    dev = torch.device("cuda", index)
    tag = f"[explicit device {dev}]"
    previous = torch.cuda.current_device()
    torch.cuda.set_device(index)
    try:
        s = pt.VPlaneICP(voxel_size=1.0, **PARAMS, device=dev)
        s.set_target(map_np)
        reset_launches()
        T = s.align(scan_np)
        counts = launch_counts()
        icp = icp_path.make(dev)
        icp_path.set_target(icp, map_np)
        scans = batched_scans(map_np, dev)
        eye = torch.eye(4).expand(N_BATCHES, 4, 4).clone()
        reset_launches()
        Ts, d = batched_align(icp_path, icp, scans, torch.ones(scans.shape[:2], device=dev), eye)
        counts_b = launch_counts()
        current = torch.cuda.current_device()
    finally:
        torch.cuda.set_device(previous)
    out = {"T": T, "fused_loop": counts["fused_loop"],
           "point_loop_batched": counts_b["point_loop_batched"],
           "T_equal": bool(np.array_equal(T, T_vplane)),
           "Ts_equal": bool(np.array_equal(Ts.numpy(), Ts_icp))}
    log(f"{tag} current device {current}: VPlaneICP T bit-equal to phase 4's {out['T_equal']}, "
        f"launches {({k: v for k, v in counts.items() if v})}; batched ICP Ts bit-equal to "
        f"phase 14's {out['Ts_equal']}, launches {({k: v for k, v in counts_b.items() if v})}")
    if not (current == index and out["T_equal"] and out["Ts_equal"]
            and {k: v for k, v in counts.items() if v} == {"fused_loop": 1}
            and {k: v for k, v in counts_b.items() if v} == {"point_loop_batched": 1}):
        raise AssertionError(f"{tag} an align on the explicit current device is off: {out}")
    return out


def sharded_targets(map_src, normals, dev) -> dict:
    """Phase 16: name -> (path, solver with its target set) of the four
    solvers, built as phase 4 builds them (PlaneICP on ``normals``)."""
    paths = {p.name: p for p in solver_paths()}
    paths["plane_icp"] = plane_icp_path(normals)
    out = {}
    for name in SHARDED_KINDS:
        s = paths[name].make(dev)
        paths[name].set_target(s, map_src)
        out[name] = (paths[name], s)
    return out


def _result_row(result, counts: dict, kernel: str, **extra) -> dict:
    d = result.diagnostics
    return {"T": result.T.numpy(), "iterations": np.asarray(d.iterations),
            "converged": np.asarray(d.converged), "failed": np.asarray(d.solver_failed),
            "launches": counts[kernel], "launch_counts": counts, **extra}


def drive_sharded(targets: dict, src, w, scans, mesh, mesh_batched, fused_batches) -> dict:
    """Phase 16: ``align_sharded`` of each solver on ``mesh``, then
    ``align_batched_sharded`` and ``align_batched_fused_sharded`` (B of
    ``fused_batches``) of the batched scans ``scans`` on ``mesh_batched``;
    launch counts reset just before each call and read just after."""
    import torch

    from point_cloud_registration_tpu_torch.parallel import (
        align_batched_fused_sharded,
        align_batched_sharded,
        align_sharded,
    )

    eye = torch.eye(4)
    B = scans.shape[0]
    eyes = eye.expand(B, 4, 4).clone()
    ones = torch.ones(scans.shape[:2], device=scans.device)
    out = {}
    for name in SHARDED_KINDS:
        path, s = targets[name]
        single, batched = KERNELS_OF[name]
        reset_launches()
        t0 = time.perf_counter()
        r = align_sharded(name, s._target, src, w, eye, s.cfg, mesh)
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        if src.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        align_sharded(name, s._target, src, w, eye, s.cfg, mesh)
        warm_ms = (time.perf_counter() - t0) * 1e3
        out[f"sharded_{name}"] = _result_row(r, counts, single, first_ms=first_ms,
                                             warm_ms=warm_ms)
        reset_launches()
        r = align_batched_sharded(name, s._target, scans, ones, eyes, s.cfg, mesh_batched)
        out[f"batched_sharded_{name}"] = _result_row(r, launch_counts(), batched)
        kind = BATCHED_KINDS[name]
        if path.args is voxel_args:
            target, normals = s._target, None
        else:  # ICP's target, or PlaneICP's packed target and its normals
            target = getattr(s._target, "corr", s._target)
            normals = getattr(s._target, "normals", None)
        for b in fused_batches:
            reset_launches()
            r = align_batched_fused_sharded(target, normals, scans[:b], ones[:b], eyes[:b], s.cfg,
                                            kind, mesh_batched)
            out[f"batched_fused_sharded_{kind}_{b}"] = _result_row(r, launch_counts(),
                                                                   BATCHED_LOOPS[kind])
    return out


def map_selected(src, w, T, meta, rank: int, max_dist: float) -> int:
    """Phase 16: how many weighted queries of ``src`` at ``T`` reach slab
    ``rank`` (the set ``align_map_sharded`` queries there)."""
    from point_cloud_registration_tpu_torch.parallel.map_sharded import slab_queries

    T = T.to(src.device)
    return int(slab_queries(src @ T[:3, :3].T + T[:3, 3], w, meta, rank, max_dist).sum())


def drive_map(map_src, src, w, targets: dict, mesh, dev) -> dict:
    """Phase 16: ``align_map_sharded`` of VPlaneICP and NDT on slabs that
    ``shard_voxel_map_on_mesh`` (auto axis) builds on each rank."""
    import torch

    from point_cloud_registration_tpu_torch.parallel import (
        align_map_sharded,
        shard_voxel_map_on_mesh,
    )
    from point_cloud_registration_tpu_torch.parallel.mesh import axes_rank

    rank = axes_rank(mesh, ("model",))
    out = {}
    for name in ("vplane_icp", "ndt"):
        cfg = targets[name][1].cfg
        svm, meta = shard_voxel_map_on_mesh(map_src, cfg.voxel_size, mesh,
                                            with_icov=name == "ndt", device=dev)
        reset_launches()
        r = align_map_sharded(name, svm, meta, src, w, torch.eye(4), cfg, mesh)
        counts = launch_counts()
        if src.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        align_map_sharded(name, svm, meta, src, w, torch.eye(4), cfg, mesh)
        warm_ms = (time.perf_counter() - t0) * 1e3
        out[f"map_sharded_{name}"] = _result_row(
            r, counts, KERNELS_OF[name][0], all_launches=sum(counts.values()), warm_ms=warm_ms,
            axis=meta.axis, dims_slab=list(meta.dims_slab),
            valid_cells=int(svm.slabs[rank].valid.sum()),
            selected=map_selected(src, w, r.T, meta, rank, cfg.max_dist))
    return out


def allreduce_host_ms(device, reps: int = 100) -> float:
    """Host milliseconds of one SUM all-reduce of 29 float32 values over the
    world, on ``device`` (synchronized after each on a card)."""
    import torch
    import torch.distributed as dist

    x = torch.ones(29, device=device)
    dist.all_reduce(x)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(x)
        if x.is_cuda:
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def batched_scans(map_np, dev):
    """Phases 13, 14 and 16: bench.py's B = 8 scans of 16,384 points."""
    import torch

    from bench import make_scan

    return torch.from_numpy(np.stack([make_scan(np.random.RandomState(100 + b), map_np, N_BATCH)
                                      for b in range(N_BATCHES)])).to(dev)


def check_sharded(tag: str, out: dict, results: dict, batched: dict, tol: float,
                  fused_batches, batch_mesh: tuple) -> None:
    """Phase 16: hold rank 0's results to phase 4's T (``tol``; 0: bit for
    bit), to JAX's within TOL_REF, with equal iterations and flags and one
    launch per iteration; the batched paths to phases 13-14's per-problem T
    (``align_batched_fused_sharded`` bit for bit, ``align_batched_sharded``
    within ``tol``): ``align_batched_sharded`` with one batched launch per
    batched iteration of rank 0's problems (the first B / ranks of the
    batch, on the (batch, data) mesh ``batch_mesh``), the fused paths with
    one launch of the batched loop kernel on rank 0 and no stats launch."""
    nb, nd = batch_mesh
    for name in SHARDED_KINDS:
        # align_sharded runs the host loop: held to phase 4's host loop
        r, ref = out[f"sharded_{name}"], results[name]
        dT = float(np.abs(r["T"].astype(np.float64) - np.array(ref["T_host"])).max())
        its_jax, rows_jax = SHARDED_REF[name]
        dT_jax = float(np.abs(r["T"][:3].reshape(-1) - rows_jax).max())
        its = int(r["iterations"])
        log(f"{tag} align_sharded {name}: {its} iterations, {r['launches']} launches, "
            f"max |T - T_phase4| {dT:.3e}, max |T - T_jax| {dT_jax:.3e}; first "
            f"{r['first_ms']:.2f} ms, warm {r['warm_ms']:.2f} ms")
        if not (dT <= tol and dT_jax < TOL_REF and its == ref["iterations"] == its_jax
                and bool(r["converged"]) and not bool(r["failed"]) and r["launches"] == its):
            raise AssertionError(f"{tag} align_sharded {name} is off phase 4: {r}")
        cases = [(f"batched_sharded_{name}", N_BATCHES, tol, N_BATCHES // nb)]
        cases += [(f"batched_fused_sharded_{BATCHED_KINDS[name]}_{b}", b, 0.0,
                   b // (nb * nd) if nd > 1 and b % (nb * nd) == 0 else b // nb)
                  for b in fused_batches]
        for key, b, tol_b, mine in cases:
            r, ref = out[key], batched[name]
            # the fused paths run the batched loop kernel, align_batched_sharded the host loop
            fused = key.startswith("batched_fused")
            dT = float(np.abs(r["T"] - (ref["Ts"] if fused else np.array(ref["T_host"]))[:b]).max())
            its = r["iterations"].tolist()
            jax_ref = BATCHED_REF[BATCHED_KINDS[name]][:b]
            dT_jax = max(float(np.abs(T[:3].reshape(-1) - rows_jax).max())
                         for T, (_, rows_jax) in zip(r["T"], jax_ref))
            single = r["launch_counts"][KERNELS_OF[name][0]]
            # a fused path's stats launches: none, its loop's once
            stray = r["launch_counts"][KERNELS_OF[name][1]] if fused else 0
            want = 1 if fused else max(its[:mine])
            log(f"{tag} {key}: iterations {its}, {r['launches']} "
                f"{'batched loop' if fused else 'batched'} launches on rank 0 ({mine} problems), "
                f"max |T - T_phase13/14| {dT:.3e}, max |T - T_jax| {dT_jax:.3e}")
            if not (dT <= tol_b and its == ref["iterations"][:b] == [i for i, _ in jax_ref]
                    and dT_jax < TOL_REF and bool(r["converged"].all())
                    and r["launches"] == want and single == 0 and stray == 0):
                raise AssertionError(f"{tag} {key} is off phases 13-14: {r}")


def check_map(tag: str, out: dict, results: dict) -> None:
    """Phase 16: map-sharded VPlaneICP and NDT within TOL_MAP of phase 4's T,
    equal iterations, no kernel launched (as in the JAX package)."""
    for name in ("vplane_icp", "ndt"):
        r, ref = out[f"map_sharded_{name}"], results[name]
        dT = float(np.abs(r["T"].astype(np.float64) - ref["T"]).max())
        its_jax, rows_jax = MAP_REF[name]
        dT_jax = float(np.abs(r["T"][:3].reshape(-1) - rows_jax).max())
        log(f"{tag} align_map_sharded {name}: axis {r['axis']}, slab {r['dims_slab']} with "
            f"{r['valid_cells']} valid cells, {r['selected']} queries selected at the final T; "
            f"{int(r['iterations'])} iterations, max |T - T_phase4| {dT:.3e}, max |T - T_jax| "
            f"{dT_jax:.3e}; launches {r['all_launches']}; warm {r['warm_ms']:.2f} ms")
        if not (dT < TOL_MAP and dT_jax < TOL_REF
                and int(r["iterations"]) == ref["iterations"] == its_jax
                and r["all_launches"] == 0):
            raise AssertionError(f"{tag} align_map_sharded {name} is off phase 4: {r}")


def run_parallel_nccl1(map_np, scan_np, normals, results: dict, batched: dict, smi: str,
                       dev) -> dict:
    """Phase 16a: the multi-device paths at world size 1 with NCCL, in this
    process: bit for bit phase 4's and phases 13-14's results."""
    import torch.distributed as dist

    from point_cloud_registration_tpu_torch.models.base import pad_points
    from point_cloud_registration_tpu_torch.parallel import distributed, make_map_mesh, make_mesh

    tag = "[16a nccl1]"
    distributed.initialize(world_size=1, rank=0, store=dist.HashStore())
    try:
        info = distributed.process_info()
        log(f"{tag} {smi}; backend {info['backend']}; world size {info['world_size']}; "
            f"device {info['device']}")
        targets = sharded_targets(map_np, normals, dev)
        src, w = pad_points(scan_np, device=dev)
        mesh = make_mesh(1, 1)
        out = drive_sharded(targets, src, w, batched_scans(map_np, dev), mesh, mesh, (N_BATCHES,))
        out.update(drive_map(map_np, src, w, targets, make_map_mesh(1, 1), dev))
        out["allreduce_ms"] = allreduce_host_ms(dev)
    finally:
        distributed.shutdown()
    check_sharded(tag, out, results, batched, 0.0, (N_BATCHES,), (1, 1))
    check_map(tag, out, results)
    log(f"{tag} host ms of one all-reduce of 29 floats (NCCL, one rank, synchronized): "
        f"{out['allreduce_ms']:.4f} on {smi}")
    return out


def phase16_rank(spec: dict) -> None:
    """Phase 16b, one rank: joins the gloo group through a FileStore, runs
    the sharded paths on the card the spec names (``cuda:0``) and writes its
    results to ``rank{r}.npz`` (``python3 chip_smoke.py --phase16-rank SPEC``)."""
    import pathlib

    import torch
    import torch.distributed as dist

    from point_cloud_registration_tpu_torch.models.base import pad_points
    from point_cloud_registration_tpu_torch.parallel import (
        distributed,
        make_map_mesh,
        make_mesh,
        shard_voxel_map,
        shard_voxel_map_on_mesh,
    )

    rank, where = spec["rank"], pathlib.Path(spec["dir"])
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    distributed.initialize(world_size=N_RANKS, rank=rank, device="cpu",
                           store=dist.FileStore(str(where / "store"), N_RANKS))
    tag = f"[16b gloo{N_RANKS} rank {rank}]"
    info = distributed.process_info()
    log(f"{tag} {spec['smi']}; backend {info['backend']}; world size {info['world_size']}; "
        f"compute on {dev}")
    idle_allreduce_ms = allreduce_host_ms("cpu")  # before any work on the card
    map_np = np.load(where / "map.npy")
    normals = torch.from_numpy(np.load(where / "normals.npy")).to(dev)
    targets = sharded_targets(map_np, normals, dev)
    src, w = pad_points(np.load(where / "scan.npy"), device=dev)
    scans = torch.from_numpy(np.load(where / "scans.npy")).to(dev)
    out = drive_sharded(targets, src, w, scans, make_mesh(1, N_RANKS, device_type="cpu"),
                        make_mesh(2, 2, device_type="cpu"), GLOO_FUSED_BATCHES)
    mesh = make_map_mesh(N_RANKS, 1, device_type="cpu")
    out.update(drive_map(map_np, src, w, targets, mesh, dev))
    _, meta_mesh = shard_voxel_map_on_mesh(map_np, 1.0, mesh, axis=2, device=dev)
    _, meta_local = shard_voxel_map(map_np, 1.0, N_RANKS, device=dev)
    out["meta_axis2_equal"] = meta_mesh == meta_local
    out["allreduce_ms"] = allreduce_host_ms("cpu")
    for name in SHARDED_KINDS:
        r = out[f"sharded_{name}"]
        log(f"{tag} align_sharded {name}: {r['launches']} launches, {int(r['iterations'])} "
            f"iterations, warm {r['warm_ms']:.2f} ms on {spec['smi']}")
    out["idle_allreduce_ms"] = idle_allreduce_ms
    log(f"{tag} host ms of one all-reduce of 29 floats (gloo, {N_RANKS} ranks): "
        f"{out['allreduce_ms']:.4f} after the aligns, {idle_allreduce_ms:.4f} before any work "
        f"on the card")
    if "jax" in sys.modules:
        raise AssertionError(f"{tag} jax was imported")
    flat = {}
    for case, row in out.items():
        if isinstance(row, dict):
            for k, v in row.items():
                flat[f"{case}/{k}"] = np.asarray(json.dumps(v) if isinstance(v, dict) else v)
        else:
            flat[case] = np.asarray(row)
    np.savez(where / f"rank{rank}.npz", **flat)
    distributed.shutdown()


def _load_rank(path) -> dict:
    """A rank's ``.npz`` back into phase 16's nested results."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            case, _, field = key.partition("/")
            v = z[key]
            if field == "launch_counts":
                v = json.loads(str(v))
            elif v.ndim == 0 and field not in ("T",):
                v = v.item()
            if field:
                out.setdefault(case, {})[field] = v
            else:
                out[case] = v
    return out


def run_parallel_gloo4(map_np, scan_np, normals, results: dict, batched: dict, smi: str,
                       dev) -> dict:
    """Phase 16b: the multi-device paths on N_RANKS processes on the one
    card, their collectives over gloo on the host. Correctness only: the
    ranks share one card, so no number here is a scaling figure."""
    import pathlib
    import tempfile

    import torch

    tag = f"[16b gloo{N_RANKS}]"
    log(f"{tag} {smi}; backend gloo; world size {N_RANKS}; {N_RANKS} processes on one card "
        f"(correctness runs on one card, not a scaling measurement)")
    with tempfile.TemporaryDirectory() as tmp:
        where = pathlib.Path(tmp)
        np.save(where / "map.npy", map_np)
        np.save(where / "scan.npy", scan_np)
        np.save(where / "normals.npy", normals.cpu().numpy())
        np.save(where / "scans.npy", batched_scans(map_np, "cpu").numpy())
        script = str(pathlib.Path(__file__).resolve())
        device = "cuda:0" if torch.device(dev).type == "cuda" else str(dev)
        logs = [open(where / f"rank{r}.log", "w+") for r in range(N_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, script, "--phase16-rank",
             json.dumps({"rank": r, "dir": tmp, "smi": smi, "device": device})],
            stdout=logs[r], stderr=subprocess.STDOUT, text=True) for r in range(N_RANKS)]
        t0 = time.perf_counter()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for r, f in enumerate(logs):
                f.seek(0)
                for line in f.read().splitlines():
                    log(f"  rank {r}: {line}")
                f.close()
        wall_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"{tag} rank {r} failed with code {p.returncode}")
        ranks = [_load_rank(where / f"rank{r}.npz") for r in range(N_RANKS)]
    log(f"{tag} all {N_RANKS} ranks done in {wall_s:.1f} s (limit {RANK_TIMEOUT_S} s each)")
    out = ranks[0]
    for key, row in out.items():
        if isinstance(row, dict) and "T" in row:
            for r in ranks[1:]:
                if not (np.array_equal(r[key]["T"], row["T"])
                        and np.array_equal(r[key]["iterations"], row["iterations"])):
                    raise AssertionError(f"{tag} {key}: the ranks hold different results")
    check_sharded(tag, out, results, batched, TOL_SHARDED, GLOO_FUSED_BATCHES, (2, 2))
    check_map(tag, out, results)
    if not all(bool(r["meta_axis2_equal"]) for r in ranks):
        raise AssertionError(f"{tag} shard_voxel_map_on_mesh(axis=2) and shard_voxel_map differ")
    log(f"{tag} slabs (auto axis {out['map_sharded_vplane_icp']['axis']}): valid cells "
        f"{[r['map_sharded_vplane_icp']['valid_cells'] for r in ranks]}, queries selected "
        f"{[r['map_sharded_vplane_icp']['selected'] for r in ranks]}; the on-mesh builder's "
        f"meta at axis 2 equals shard_voxel_map's; host ms of one gloo all-reduce of 29 floats "
        f"{[round(float(r['allreduce_ms']), 4) for r in ranks]} (before any work on the card: "
        f"{[round(float(r['idle_allreduce_ms']), 4) for r in ranks]})")
    out["wall_s"] = wall_s
    return out


def run_demo(main, argv: list, tag: str) -> list:
    """Two runs of a demo's ``main(argv)`` (the first, then a warm one), the
    launch counts set to 0 just before each and read just after."""
    runs = []
    for _ in range(2):
        reset_launches()
        r = main(argv)
        r["launch_counts"] = launch_counts()
        log(f"{tag} launches {({k: v for k, v in r['launch_counts'].items() if v})}")
        runs.append(r)
    return runs


def normals_launches(tiers: int) -> dict:
    """The launches of one ``estimate_normals`` on the 1.2M map: the k-NN
    kernel once per tier and each step of the chain once."""
    return {"knn_moments": tiers, **dict.fromkeys(CHAIN_STEPS, 1)}


def check_launches(tag: str, counts: dict, expected: dict) -> None:
    """The launches of a demo run: ``expected`` on its path's kernels, none
    on any other."""
    got = {k: v for k, v in counts.items() if v or k in expected}
    if got != expected:
        raise AssertionError(f"{tag} launches {got}, expected {expected}")


def run_demos(map_np, normals, n_wide: int, smi: str) -> dict:
    """Phase 17: the port's demos, the user's entry points, on the card from a
    PCD file of phase 4's map; ``normals``: phase 6's on the same map."""
    import hashlib
    import tempfile

    import torch

    from point_cloud_registration_tpu_torch import native
    from point_cloud_registration_tpu_torch.utils import read_pcd_xyz, write_pcd

    sys.path.insert(0, str(DEMOS))
    import demo_estimate_normals_torch
    import demo_matching_torch
    import demo_visualize_voxels_torch

    tag = "[demos]"
    t_phase = time.perf_counter()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    tiers = 1 + (n_wide > 0)
    out = {"paths": {}}
    with tempfile.TemporaryDirectory(prefix="pcr_demos_") as tmp:
        # 17.1 The PCD file, bit for bit
        pcd = f"{tmp}/city_map.pcd"
        write_pcd(pcd, map_np)
        back = read_pcd_xyz(pcd)
        native_loaded = native.load() is not None
        log(f"{tag} PCD {map_np.shape[0]} points, binary, {Path(pcd).stat().st_size / 1e6:.1f} "
            f"MB; native reader loaded: {native_loaded}")
        if not (back.dtype == np.float32 and back.shape == map_np.shape
                and np.array_equal(back.view(np.uint32), map_np.view(np.uint32))):
            raise AssertionError(f"{tag} the PCD round trip changed the map")
        out["pcd"] = {"points": int(back.shape[0]), "native_loaded": native_loaded}

        # 17.2 Matching, each method: its kernel once per iteration, T to the JAX package's
        for method, kernel in DEMO_KERNEL.items():
            mtag = f"{tag} demo_matching_torch --method {method}"
            argv = ["--map", pcd, "--method", method, *DEMO_ARGS, "--device", DEVICE,
                    "--out", f"{tmp}/{method}.png"]
            first, warm = run_demo(demo_matching_torch.main, argv, mtag)
            ref = DEMO_REF[method]
            for r in (first, warm):
                expected = {kernel: 1}  # every demo aligns through a loop kernel
                if method == "PlaneICP":  # its normals in set_target, one launch per tier
                    expected.update(normals_launches(tiers))
                check_launches(mtag, r["launch_counts"], expected)
            err = float(np.abs(first["T"][:3] - np.array(ref["T"])).max())
            log(f"{mtag}: {first['iterations']} iterations (JAX: {ref['iterations']}), converged "
                f"{first['converged']} (JAX: {ref['converged']}); max |T - T_jax| = {err:.2e}; warm "
                f"set_target {1e3 * warm['set_target_s']:.2f} ms, align "
                f"{1e3 * warm['align_s']:.2f} ms (first {1e3 * first['set_target_s']:.1f} + "
                f"{1e3 * first['align_s']:.1f} ms) on {card}")
            if not (np.isfinite(first["T"]).all() and not first["solver_failed"] and err < TOL_REF
                    and first["iterations"] == ref["iterations"]
                    and first["converged"] == ref["converged"]):
                raise AssertionError(f"{mtag}: off the JAX package's result")
            if not np.array_equal(warm["T"], first["T"]):
                raise AssertionError(f"{mtag}: the warm run gave another T than the first")
            with host_loop():
                host = demo_matching_torch.main(argv)
            dT_host = float(np.abs(np.asarray(host["T"]) - np.asarray(first["T"])).max())
            log(f"{mtag}: the host loop's align {1e3 * host['align_s']:.2f} ms; max |T - T_host| "
                f"{dT_host:.3e}, iterations {host['iterations']}")
            if not (dT_host <= TOL_HOST and host["iterations"] == first["iterations"]
                    and host["converged"] == first["converged"]
                    and host["solver_failed"] == first["solver_failed"]):
                raise AssertionError(f"{mtag}: the loop kernel is off the host loop")
            out[method] = {"iterations": first["iterations"], "max_err_jax": err,
                           "dT_host": dT_host, "host_align_ms": 1e3 * host["align_s"],
                           "set_target_ms": 1e3 * warm["set_target_s"],
                           "align_ms": 1e3 * warm["align_s"],
                           "first_ms": 1e3 * (first["set_target_s"] + first["align_s"])}
            out["paths"][f"demo_{method}"] = first["launch_counts"]

        # 17.3 Normals: the k-NN kernel once per tier, phase 6's normals bit for bit
        ntag = f"{tag} demo_estimate_normals_torch"
        argv = ["--pcd", pcd, "--k", str(K_NORMALS), "--device", DEVICE,
                "--out", f"{tmp}/normals.png"]
        first, warm = run_demo(demo_estimate_normals_torch.main, argv, ntag)
        for r in (first, warm):
            check_launches(ntag, r["launch_counts"], normals_launches(tiers))
            if not np.array_equal(r["normals"], normals):
                raise AssertionError(f"{ntag}: the normals are not phase 6's")
        log(f"{ntag}: {first['n_points']} normals equal to phase 6's bit for bit; warm "
            f"estimate_normals {1e3 * warm['seconds']:.2f} ms (first {1e3 * first['seconds']:.1f}) "
            f"on {card}")
        out["normals"] = {"ms": 1e3 * warm["seconds"], "first_ms": 1e3 * first["seconds"]}
        out["paths"]["demo_normals"] = first["launch_counts"]

        # 17.4 Voxels: counts, voxel_filter's rows and the colours to the JAX package's
        vtag = f"{tag} demo_visualize_voxels_torch"
        argv = ["--pcd", pcd, "--voxel-size", "1.0", "--device", DEVICE,
                "--out", f"{tmp}/vox.png"]
        first, warm = run_demo(demo_visualize_voxels_torch.main, argv, vtag)
        ref = DEMO_REF["voxels"]
        for r in (first, warm):
            check_launches(vtag, r["launch_counts"], {})
            irgb = np.ascontiguousarray(r["irgb"], dtype="<u4")
            got = {"n_valid": r["n_valid"], "min_points": r["min_points"],
                   "count_mean": r["count_mean"], "count_max": r["count_max"],
                   "count_sum": int(r["counts"].sum()), "n_filtered": int(r["filtered"].shape[0]),
                   "irgb_sha256": hashlib.sha256(irgb.tobytes()).hexdigest()}
            if got != ref:
                raise AssertionError(f"{vtag}: {got}, JAX {ref}")
        log(f"{vtag}: valid voxels, counts, voxel_filter rows and colours equal to the JAX "
            f"package's; warm set_points {1e3 * warm['seconds']:.2f} ms "
            f"(first {1e3 * first['seconds']:.1f}) on {card}")
        out["voxels"] = {"set_points_ms": 1e3 * warm["seconds"],
                         "first_ms": 1e3 * first["seconds"]}

    # 17.5 Where a NumPy map's voxel build goes: the bounding box that
    # build_voxel_map reads on the host before the copy, against the copy and
    # the same box read on the card
    from point_cloud_registration_tpu_torch.ops.hashgrid import _bbox_cells

    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    dev = torch.device(DEVICE)
    box_host = [host_ms(lambda: _bbox_cells(map_np, 1.0)) for _ in range(3)]
    copy = [host_ms(lambda: torch.from_numpy(map_np).to(dev)) for _ in range(3)]
    map_t = torch.from_numpy(map_np).to(dev)
    box_card = [host_ms(lambda: _bbox_cells(map_t, 1.0)) for _ in range(3)]
    if any(not np.array_equal(a, b) for a, b in zip(_bbox_cells(map_np, 1.0),
                                                      _bbox_cells(map_t, 1.0))):
        raise AssertionError(f"{tag} the host and the card read another bounding box")
    log(f"{tag} a NumPy map's bounding box on the host (build_voxel_map, before the copy) "
        f"{', '.join(f'{x:.2f}' for x in box_host)} ms; the map's copy to the card "
        f"{', '.join(f'{x:.2f}' for x in copy)} ms; the same box on the card "
        f"{', '.join(f'{x:.3f}' for x in box_card)} ms, equal cells; on {card}")
    out["bbox"] = {"host_ms": min(box_host), "copy_ms": min(copy), "card_ms": min(box_card)}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"{tag} phase 17 in {out['wall_s']:.1f} s")
    return out


def jsonable(x):
    """Phase 16's results for the summary line: arrays as lists, without
    transforms and launch tables."""
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items() if k not in ("T", "launch_counts")}
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    return x


def no_nan(x):
    """``x`` with every NaN float (a device time not measured) as None, so
    that its JSON is strict."""
    if isinstance(x, dict):
        return {k: no_nan(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [no_nan(v) for v in x]
    return None if isinstance(x, float) and x != x else x


def main() -> None:
    import torch

    # 1. Device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    from bench import make_city_map, make_scan  # numpy only at module level

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"device: {name}, count {torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    log(smi)

    # 2. Build
    build_s = build_kernels()
    log(f"build: {build_s:.2f} s")

    rng = np.random.RandomState(SEED)
    map_np = make_city_map(rng, N_MAP)
    scan_np = make_scan(rng, map_np, N_SCAN)
    log(f"map {map_np.shape}, scan {scan_np.shape}")
    # 2c. The loop kernel against the host loop and its plain version; 2d.
    # the point and grid loops
    gn_loop = run_gn_loop(map_np, scan_np, dev)
    new_loops = run_new_loops(map_np, scan_np, dev)

    map_t = torch.from_numpy(map_np).to(dev)
    paths = {p.name: p for p in solver_paths()}
    results = {}
    # 3-5 for the paths of the earlier slices
    for path in paths.values():
        results[path.name] = run_path(path, map_np, scan_np, dev)
    # 6. Normals, then 3-5 for PlaneICP on them
    normals, results["normals"] = run_normals(map_t, dev)
    paths["plane_icp"] = plane_icp_path(normals)
    results["plane_icp"] = run_path(paths["plane_icp"], map_np, scan_np, dev)
    # 6b. k above one walk of the k-NN kernel
    results["rounds"] = run_rounds(map_np, scan_np, dev)
    results["normals"]["max_abs_err"] = max(results["normals"]["max_abs_err"],
                                            results["rounds"]["max_abs_err"])
    # 6c. The normals chain, step by step, on this map and on a benchmark map
    results["normals_chain"] = run_normals_chain({"city": map_np, "b01": b01_map()}, dev)
    # 7. Exact 1-NN, on ICP's target at ICP's converged T
    icp = paths["icp"].make(dev)
    icp.set_target(map_t)
    results["exact_nn"] = run_exact_nn(map_t, scan_np, results["icp"]["T"], icp._target, dev)

    # 9-12. Small targets (the grid method), an over-budget (hashed) map,
    # update_target, and the utilities
    results["grid"] = run_grid_targets(dev)
    results["hashed"] = run_hashed_map(map_np, scan_np, dev)
    results["update"] = run_update_target(map_np, scan_np, dev)
    results["utilities"] = run_utilities(map_np, scan_np, dev)

    # 13-14. The batched streams (voxel kinds, then point kinds), 15. FastVPlaneICP
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    batched = {}
    for path_name, kernel, plain in (
            ("vplane_icp", fa.fused_plane_stats_batched, fa.fused_plane_stats_batched_reference),
            ("ndt", fa.fused_ndt_stats_batched, fa.fused_ndt_stats_batched_reference),
            ("icp", pa.point_stats_batched, pa.point_stats_batched_reference),
            ("plane_icp", pa.plane_point_stats_batched, pa.plane_point_stats_batched_reference)):
        batched[path_name] = run_batched(paths[path_name], kernel, plain, map_np, dev)
    results["batched"] = batched
    results["fast"] = run_fast(map_np, scan_np, dev, results["vplane_icp"])
    # 15b. Aligns with the current card set explicitly and the tensors there
    results["explicit_device"] = run_explicit_device(paths["icp"], map_np, scan_np,
                                                     results["vplane_icp"]["T"],
                                                     batched["icp"]["Ts"])
    # 16. The multi-device paths: world size 1 with NCCL here, then N_RANKS gloo
    # ranks on the one card
    results["nccl1"] = run_parallel_nccl1(map_np, scan_np, normals, results, batched, smi, dev)
    results["gloo4"] = run_parallel_gloo4(map_np, scan_np, normals, results, batched, smi, dev)
    # 17. The demos, from a PCD file of the map
    results["demos"] = run_demos(map_np, normals.cpu().numpy(), results["normals"]["n_wide"],
                                 smi)

    # 8. No JAX, after every phase (each rank of 16b checked its own)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
    from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn

    rows = [(p.name, p.kernel, p.source, p.replaces, results[p.name]) for p in paths.values()]
    rows.append(("normals", kn.knn_moments, f"{CSRC}/knn_normals.cu",
                 f"{PALLAS}/knn_normals.py:293", results["normals"]))
    rows.append(("exact_nn", en.exact_nn, f"{CSRC}/exact_nn.cu", f"{PALLAS}/exact_nn.py:77",
                 results["exact_nn"]))
    # the steps of the normals chain (csrc/normals_chain.cu), the port's own
    # kernels for XLA code of the JAX package: each wrapper's call alone on
    # phase 6c's benchmark map at k = 5, the profiler's kernels of a call in
    # "extra"
    from point_cloud_registration_tpu_torch.ops.kernels import normals_chain as nc

    chain = results["normals_chain"]["b01_k5"]
    for step, kernel, replaces, names in CHAIN_ROWS:
        rows.append((kernel, getattr(nc, kernel), f"{CSRC}/normals_chain.cu", replaces, {
            "launches": 0,  # its launches on its paths: path_launches below
            "max_abs_err": chain["step_max_abs_err"][step], "kernel_ms": [chain["step_ms"][step]],
            "plain_ms": [chain["plain_step_ms"][step]], "bound_ms": chain["bound_ms"][step],
            "bound_by": chain["bound_by"][step], "library_ms": None,
            "extra": {"kernels_ms": {key: v for key, v in chain["kernel_ms"].items()
                                     if any(x in key for x in names)}}}))
    # the loop kernel: the while_loop of the JAX gauss_newton around the fused
    # stats; its numbers at the main path's shapes, VPlaneICP's at the top, each
    # kind's in "kinds"
    from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl

    plane = gn_loop["plane"]
    rows.append(("fused_loop", gl.fused_loop, LOOP_SOURCE, LOOP_REPLACES, {
        "launches": results["vplane_icp"]["loop_launches"], "max_abs_err": gn_loop["max_abs_err"],
        "kernel_ms": [plane["ms"]], "plain_ms": [plane["plain_ms"]],
        "bound_ms": plane["bound_ms"], "bound_by": plane["bound_by"], "library_ms": None,
        "extra": {"alone_ms": plane["alone_ms"], "stats_of": f"{PALLAS}/fused_align.py:550",
                  "ptxas": gn_loop["ptxas"], "kinds": {kind: {
                      k: gn_loop[kind][k] for k in (
                          "iterations", "ms", "alone_ms", "plain_ms", "bound_ms", "bound_by",
                          "bound_reread_ms", "dT_host", "dT_plain", "e2_rel", "dx_rel")}
                      | {f"{m}_device_ms": gn_loop[kind][m]["device_ms"]
                         for m in ("loop", "host")}
                      for kind in ("plane", "ndt")}}}))
    # the point and grid loops: the same while_loop around the packed-grid
    # stats and the grid stats; their numbers on phase 2d's paths, ICP's at the
    # top, each case's in "kinds"
    for loop, top in (("point_loop", "icp"), ("grid_loop", "icp_grid")):
        cases = [case for case, (l, _, _) in NEW_LOOPS.items() if l == loop]
        first = new_loops[top]
        rows.append((loop, getattr(gl, loop), LOOP_SOURCES[loop], LOOP_REPLACES, {
            "launches": 0,  # its launches on its paths: path_launches below
            "max_abs_err": new_loops[f"{loop}_max_abs_err"], "kernel_ms": [first["ms"]],
            "plain_ms": [first["plain_ms"]], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None,
            "extra": {"alone_ms": first["alone_ms"], "stats_of": LOOP_STATS_OF[loop],
                      "ptxas": new_loops["ptxas"][loop], "kinds": {case: {
                          k: new_loops[case][k] for k in (
                              "iterations", "ms", "alone_ms", "plain_ms", "bound_ms", "bound_by",
                              "bound_reread_ms", "dT_plain", "e2_rel_plain")}
                          | {f"{m}_{q}": new_loops[case][m][q] for m in ("loop", "host")
                             for q in ("device_ms", "syncs")}
                          for case in cases}}}))
    # the batched loops: the while_loop of the JAX batched_gauss_newton around
    # the batched fused and packed-grid stats; their numbers at phases 13 and
    # 14's shapes (B = 8 scans of 16,384 points), VPlaneICP's and ICP's at the
    # top, each kind's in "kinds"
    for loop, top in (("fused_loop_batched", "vplane_icp"), ("point_loop_batched", "icp")):
        names = [n for n in batched if BATCHED_LOOPS[BATCHED_KINDS[n]] == loop]
        first = batched[top]["loop"]
        rows.append((loop, getattr(gl, loop), f"{CSRC}/{BATCHED_LOOP_LIBRARIES[loop]}.cu",
                     BATCHED_LOOP_REPLACES, {
                         "launches": batched[top]["loop_launches"],
                         "max_abs_err": max(batched[n]["loop"]["dT_plain"] for n in names),
                         "kernel_ms": [first["ms"]], "plain_ms": [first["plain_ms"]],
                         "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                         "library_ms": None,
                         "extra": {"alone_ms": first["alone_ms"], "B": N_BATCHES, "n": N_BATCH,
                                   "kinds": {BATCHED_KINDS[n]: {
                                       k: batched[n]["loop"][k] for k in (
                                           "iterations", "ms", "alone_ms", "plain_ms",
                                           "bound_ms", "bound_by", "dT_plain", "ptxas")}
                                       | {f"{m}_{q}": batched[n]["loop"][m][q]
                                          for m in ("loop", "host")
                                          for q in ("device_ms", "syncs")}
                                       for n in names}}}))
    # the grid stats kernels (csrc/grid_align.cu), the port's own kernels for
    # XLA code of the JAX package: their numbers on phases 9 and 10
    grid = results["grid"]
    grid_paths = {"point": ("icp_grid", grid["icp"]),
                  "plane_pt": ("plane_icp_grid", grid["plane_icp"]),
                  "plane": ("hashed_vplane_icp", results["hashed"]["vplane_icp"]),
                  "ndt": ("hashed_ndt", results["hashed"]["ndt"])}
    for kind, (path_name, res) in grid_paths.items():
        held = res["kernel"]
        lattice = (grid if kind in ("point", "plane_pt") else results["hashed"])[
            "lattice_max_abs_err"][kind]
        rows.append((path_name, grid_fns(kind)[0], GRID_SOURCE,
                     GRID_REPLACES[kind], {
                         "launches": res["resident"]["enqueued"],  # 0: its align runs grid_loop
                         "max_abs_err": max(held["max_abs_err"], lattice),
                         "kernel_ms": held["kernel_ms"], "plain_ms": held["plain_ms"],
                         "bound_ms": held["bound_ms"], "bound_by": held["bound_by"],
                         "library_ms": held["library_ms"],
                         "extra": {"alone_ms": held["alone_ms"], "ptxas": grid["ptxas"][kind],
                                   **({"design_searches": held["design"]}
                                      if held["design"] else {})}}))
    # launches on each path that runs the kernel, the main path's first; the
    # host loop's aligns of phases 13-15 (``_host_loop``) last
    host_batched_launches = {name: batched[name]["loop"]["host"]["launches"] for name in batched}
    fast_host = results["fast"]["phase2_host_loop"]
    path_launches = {
        "fused_plane_stats": {"vplane_icp": results["vplane_icp"]["launches"],
                              "fast_vplane_icp_always": results["fast"]["always_launches"],
                              "update_target": results["update"]["vplane_icp"]["launches"],
                              "hashed_map": 0,
                              "batched_vplane_icp": batched["vplane_icp"]["launches"],
                              "fast_vplane_icp_auto": results["fast"]["auto_launches"],
                              "batched_vplane_icp_host_loop":
                                  host_batched_launches["vplane_icp"]["fused_plane_stats_batched"],
                              "fast_vplane_icp_always_phase2_host_loop":
                                  fast_host.get("fused_plane_stats", 0)},
        "fused_ndt_stats": {"ndt": results["ndt"]["launches"],
                            "update_target": results["update"]["ndt"]["launches"],
                            "hashed_map": 0, "batched_ndt": batched["ndt"]["launches"],
                            "batched_ndt_host_loop":
                                host_batched_launches["ndt"]["fused_ndt_stats_batched"]},
        "point_stats": {"icp": results["icp"]["launches"],
                        "icp_grid": grid["icp"]["launches"]["point_stats"],
                        "batched_icp": batched["icp"]["launches"],
                        "batched_icp_host_loop":
                            host_batched_launches["icp"]["point_stats_batched"]},
        "plane_point_stats": {"plane_icp": results["plane_icp"]["launches"],
                              "plane_icp_grid": grid["plane_icp"]["launches"]["plane_point_stats"],
                              "batched_plane_icp": batched["plane_icp"]["launches"],
                              "batched_plane_icp_host_loop":
                                  host_batched_launches["plane_icp"]["plane_point_stats_batched"]},
        "knn_moments": {"estimate_normals": results["normals"]["launches"],
                        "plane_icp_grid": grid["plane_icp"]["launches"]["knn_moments"]},
        "exact_nn": {"oracle": results["exact_nn"]["launches"],
                     "kdtree_k1": results["utilities"]["kdtree"]["exact_nn_launches"]},
        **{kernel: {"estimate_normals": results["normals"]["chain_launches"][kernel],
                    f"estimate_normals_k{K_ROUNDS}": results["rounds"]["chain_launches"][kernel],
                    f"plane_icp_k{K_ROUNDS}":
                        results["rounds"]["plane_icp_chain_launches"][kernel],
                    **{f"normals_chain_{case}": row["launch_counts"][kernel]
                       for case, row in results["normals_chain"].items() if case != "edges"}}
           for _, kernel, _, _ in CHAIN_ROWS},
        **{GRID_KINDS[kind][0]: {path_name: res["launches"][GRID_KINDS[kind][0]],
                                 f"{path_name}_host_loop": res["host_loop_launches"]}
           for kind, (path_name, res) in grid_paths.items()},
    }
    path_launches["fused_loop"] = {
        **{name: results[name]["loop_launches"] for name in ("vplane_icp", "ndt")},
        **{f"update_target_{name}": results["update"][name]["loop_launches"]
           for name in ("vplane_icp", "ndt")},
        "fast_vplane_icp_auto": results["fast"]["loop_auto"],
        "fast_vplane_icp_always": results["fast"]["loop_always"],
        "hashed_map": 0,
        "explicit_device_vplane_icp": results["explicit_device"]["fused_loop"],
        **{f"batched_{name}": 0 for name in batched},
    }
    path_launches["point_loop"] = {
        **{name: results[name]["loop_launches"] for name in ("icp", "plane_icp")},
        **{f"batched_{name}": 0 for name in ("icp", "plane_icp")},
    }
    path_launches["fused_loop_batched"] = {
        **{f"batched_{name}": batched[name]["loop_launches"] for name in ("vplane_icp", "ndt")},
    }
    path_launches["point_loop_batched"] = {
        **{f"batched_{name}": batched[name]["loop_launches"] for name in ("icp", "plane_icp")},
        "explicit_device_batched_icp": results["explicit_device"]["point_loop_batched"],
    }
    path_launches["grid_loop"] = {
        **{path_name: res["resident"]["loop"] for path_name, res in grid_paths.values()},
    }
    # launches of the kernels on phase 16's paths: the single entry's on
    # align_sharded, the batched entry's on the batched paths, none on map-sharded
    modes = {"nccl1": (results["nccl1"], (N_BATCHES,)),
             f"gloo{N_RANKS}_rank0": (results["gloo4"], GLOO_FUSED_BATCHES)}
    for name in SHARDED_KINDS:
        row = path_launches[KERNELS_OF[name][0]]
        loop_row = path_launches[BATCHED_LOOPS[BATCHED_KINDS[name]]]
        for mode, (out, fused_batches) in modes.items():
            row[f"sharded_{name}_{mode}"] = out[f"sharded_{name}"]["launches"]
            row[f"batched_sharded_{name}_{mode}"] = out[f"batched_sharded_{name}"]["launches"]
            for b in fused_batches:
                key = f"batched_fused_sharded_{BATCHED_KINDS[name]}_{b}"
                row[f"{key}_{mode}"] = out[key]["launch_counts"][KERNELS_OF[name][1]]
                loop_row[f"{key}_{mode}"] = out[key]["launches"]
            if f"map_sharded_{name}" in out:
                row[f"map_sharded_{name}_{mode}"] = out[f"map_sharded_{name}"]["all_launches"]
    # launches on phase 17's demo paths, 0 where a demo bypasses the kernel
    for name, row in path_launches.items():
        row.update({path: counts[name] for path, counts in results["demos"]["paths"].items()})
    # each kernel's launches on its main path, the first of its paths; one whose
    # main path's align now runs in the loop kernel (the stats kernels)
    # reports them on the first path that launches it
    launches_on = {}
    for name, kernel, source, replaces, r in rows:
        paths_of = path_launches[kernel.__name__]
        on = next((p for p, n in paths_of.items() if n), None)
        launches_on[name] = (r["launches"] or paths_of.get(on, 0), on)
    for r in results.values():
        r.pop("T", None)
    for r in batched.values():
        r.pop("Ts", None)
    results["explicit_device"].pop("T", None)
    for mode in ("nccl1", "gloo4"):
        results[mode] = jsonable(results[mode])
    log("summary: " + json.dumps({"card": smi, "build_s": build_s, "new_loops": new_loops,
                                  **results}))
    # knn_moments: the top-level numbers are the base tier's; "tiers" holds both
    print(json.dumps(no_nan({"kernels": [{
        "name": kernel.__name__, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches_on[name][0], "launches_path": launches_on[name][1],
        "max_abs_err": r["max_abs_err"],
        "ms": min(r["kernel_ms"]), "plain_ms": min(r["plain_ms"]),
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "paths": path_launches[kernel.__name__],
        **({"contract_bound_ms": r["contract_bound_ms"]} if "contract_bound_ms" in r else {}),
        **r.get("extra", {}),
        # the batched entry of the kernel at the batched main path's shapes
        **({"batched": {k: batched[name][k] for k in (
            "launches", "max_abs_err", "ms", "plain_ms", "singles_ms", "bound_ms", "bound_by")}}
           if name in batched else {}),
        **({"tiers": {name: {"queries": t["queries"], "kernel_ms": min(t["kernel_ms"]),
                             "plain_ms": min(t["plain_ms"]), "bound_ms": t["bound_ms"],
                             "bound_by": t["bound_by"]} for name, t in r["tiers"].items()}}
           if "tiers" in r else {}),
    } for name, kernel, source, replaces, r in rows]})))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase16-rank"]:
        phase16_rank(json.loads(sys.argv[2]))
    else:
        main()
