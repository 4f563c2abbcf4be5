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

Then, for each solver path (VPlaneICP, NDT, ICP and, after the normals
phase, PlaneICP) on bench.py's seed-42 city map (1.2M points) and 100k-point
scan, with the bench parameters:

3. Kernel vs plain version: the path's stats kernel against its plain
   PyTorch version on the card, at the main path's shapes, at T = I and at
   a perturbed T.
4. Main path: ``Solver(...).set_target(map)`` then ``align(scan)`` with every
   launch count set to 0 just before and read just after; it must converge
   near the scan's known offset, to the JAX package's result on the same
   data with the same iteration count, through the kernel (its launch count
   must equal the iteration count). Then three warm runs, bit-identical to
   the first, and the kernel's per-iteration time beside the plain
   version's.
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

7. Exact 1-NN: the kernel against its plain version on 4,096 scan points at
   ICP's converged T against the whole map (distance and index equal), and
   as the oracle of the packed grid: every such query that
   ``nearest_point_packed`` resolves within blocks that are not truncated
   has the exact distance. Timed beside chunked ``torch.cdist(...).min``.
   Before that, bit for bit against the plain version at small ragged shapes
   with a NaN query and with references duplicated across a tile border and
   a segment border of the kernel (the first index must win).
8. No JAX was imported.

The line before the last is a JSON object describing each kernel: its
launches on its path, its error against the plain version, its time, the
plain version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes the function needs of every input
and output once over 3.35 TB/s and the operations over 67 TFLOP/s fp32;
``exact_nn`` also has ``contract_bound_ms``, its 8 separately rounded
operations per pair at half that rate) and, where one PyTorch call computes
the same function, that call's time. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
K_DEEP = (80, 100)  # two and three rounds, checked kernel against plain
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOP_PER_S = 67e12  # H100 SXM, outside the tensor cores
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
    order, starts = kn.box_groups_cuda(pg, q, radius)
    # the grouping's two kernels against its plain version, with int32 keys and, as
    # for a grid of so many blocks that int32 cannot hold a box key, with int64 keys
    vast = pg._replace(nb_dims=(1 << 12, 1 << 12, 1 << 11))
    for grid, got in ((pg, (order, starts)), (vast, kn.box_groups_cuda(vast, q, radius))):
        if not all(torch.equal(a, b) for a, b in zip(got, kn.box_groups(grid, q, radius))):
            raise AssertionError(f"{tag} r = {radius}: box_groups_cuda disagrees with box_groups")
    n_items = starts.shape[0]
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
    """Every kernel wrapper of the package, each with its ``launches`` count."""
    from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
    from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    return [fa.fused_plane_stats, fa.fused_ndt_stats, pa.point_stats, pa.plane_point_stats,
            kn.knn_moments, en.exact_nn]


def reset_launches() -> None:
    for k in all_kernels():
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in all_kernels()}


def voxel_args(s, src, w, T):
    """The arguments of a fused voxel-stats wrapper for solver ``s`` at ``T``."""
    vm = s._target
    return (vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src, w,
            T[:3, :3], T[:3, 3], s.cfg.max_dist, s.cfg.huber_delta)


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
    """The arguments of a packed-grid stats wrapper for solver ``s`` at ``T``."""
    from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius

    tg = getattr(s._target, "corr", s._target)
    return (tg.packed, tg.proxy, src, w, T[:3, :3], T[:3, 3], s.cfg.max_dist,
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
                   T_REF_ICP, 6, f"{CSRC}/point_align.cu", f"{PALLAS}/point_align.py:594"),
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
                      f"{PALLAS}/point_align.py:594")


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
        err = compare_stats(path.kernel(*args), path.plain(*args))
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
    if launches != d.iterations:
        raise AssertionError(f"{tag} kernel launched {launches} times for "
                             f"{d.iterations} iterations")

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

    Tc = torch.as_tensor(T_k, dtype=torch.float32)
    args = path.args(solver, src, w, Tc)
    kernel_ms = cuda_ms(lambda: path.kernel(*args), 50)
    plain_ms = cuda_ms(lambda: path.plain(*args), 5)
    kernel_ms_2 = cuda_ms(lambda: path.kernel(*args), 50)
    plain_ms_2 = cuda_ms(lambda: path.plain(*args), 5)
    log(f"{tag} per-iteration stats at the converged T (kernel, plain, kernel, plain): "
        f"{kernel_ms:.4f}, {plain_ms:.4f}, {kernel_ms_2:.4f}, {plain_ms_2:.4f} ms")

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
        **({"proxy_share": proxy_share} if packed_grid else {}),
    }


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
    if kn.knn_moments.launches != tiers:
        raise AssertionError(f"{tag} knn_moments launched {kn.knn_moments.launches} times "
                             f"for {tiers} tiers")
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
            and counts["plane_point_stats"] == d.iterations == pa.plane_point_stats.launches):
        raise AssertionError(f"{tag} PlaneICP(k={K_ROUNDS}) off its path or its offset")
    return {"first_call_s": first_s, "estimate_normals_ms": warm_s, "max_abs_err": err,
            "iterations": d.iterations, "offset_err": off_err}


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
    # 7. Exact 1-NN, on ICP's target at ICP's converged T
    icp = paths["icp"].make(dev)
    icp.set_target(map_t)
    results["exact_nn"] = run_exact_nn(map_t, scan_np, results["icp"]["T"], icp._target, dev)

    # 8. No JAX
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
    from point_cloud_registration_tpu_torch.ops.kernels import knn_normals as kn

    rows = [(p.kernel, p.source, p.replaces, results[p.name]) for p in paths.values()]
    rows.append((kn.knn_moments, f"{CSRC}/knn_normals.cu", f"{PALLAS}/knn_normals.py:293",
                 results["normals"]))
    rows.append((en.exact_nn, f"{CSRC}/exact_nn.cu", f"{PALLAS}/exact_nn.py:77",
                 results["exact_nn"]))
    for r in results.values():
        r.pop("T", None)
    log("summary: " + json.dumps({"card": smi, "build_s": build_s, **results}))
    # knn_moments: the top-level numbers are the base tier's; "tiers" holds both
    print(json.dumps({"kernels": [{
        "name": kernel.__name__, "route": "cuda", "source": source, "replaces": replaces,
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": min(r["kernel_ms"]), "plain_ms": min(r["plain_ms"]),
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        **({"contract_bound_ms": r["contract_bound_ms"]} if "contract_bound_ms" in r else {}),
        **({"tiers": {name: {"queries": t["queries"], "kernel_ms": min(t["kernel_ms"]),
                             "plain_ms": min(t["plain_ms"]), "bound_ms": t["bound_ms"],
                             "bound_by": t["bound_by"]} for name, t in r["tiers"].items()}}
           if "tiers" in r else {}),
    } for kernel, source, replaces, r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
