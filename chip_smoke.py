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
   reach the kernel's T with the same iteration count.

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

7. Exact 1-NN: the kernel against its plain version on 4,096 scan points at
   ICP's converged T against the whole map (distance and index equal), and
   as the oracle of the packed grid: every such query that
   ``nearest_point_packed`` resolves within blocks that are not truncated
   has the exact distance. Timed beside chunked ``torch.cdist(...).min``.
8. No JAX was imported.

The line before the last is a JSON object describing each kernel: its
launches on its path, its error against the plain version, its time, the
plain version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes of every input and output once over
3.35 TB/s and the operations over 67 TFLOP/s fp32) and, where one PyTorch
call computes the same function, that call's time. The last line is
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
    return (vm.table, vm.origin_cell, vm.dims, vm.cell_size, src, w,
            T[:3, :3], T[:3, 3], s.cfg.max_dist, s.cfg.huber_delta)


def voxel_work(row_flops):
    def work(s, src, w, T, n_inliers):
        # every in-grid cell of each query's window is one distance
        import torch

        from point_cloud_registration_tpu_torch.ops.knn import window_radius

        vm = s._target
        r = window_radius(s.cfg.max_dist, vm.cell_size)
        q = src @ T[:3, :3].T.to(src.device) + T[:3, 3].to(src.device)
        c = torch.floor(q / vm.cell_size).long() - torch.tensor(vm.origin_cell,
                                                                device=src.device)
        dims = torch.tensor(vm.dims, device=src.device)
        span = (torch.minimum(c + r, dims - 1) - torch.clamp(c - r, min=0) + 1).clamp(min=0)
        probes = float((span.prod(dim=1) * (w > 0)).sum())
        return (nbytes(vm.table, src, w) + 29 * 4,
                probes * FLOPS_DIST + n_inliers * row_flops)
    return work


def point_args(s, src, w, T):
    """The arguments of a packed-grid stats wrapper for solver ``s`` at ``T``."""
    from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius

    tg = getattr(s._target, "corr", s._target)
    return (tg.packed, tg.proxy, src, w, T[:3, :3], T[:3, 3], s.cfg.max_dist,
            proxy_radius(s.cfg.corr, s.cfg.max_dist), s.cfg.huber_delta)


def point_work(row_flops):
    def work(s, src, w, T, n_inliers):
        # every kept point of the 2x2x2 blocks around each query is one
        # distance; the proxy window of the few unresolved queries is left out
        import torch

        tg = getattr(s._target, "corr", s._target)
        pg = tg.packed
        q = src @ T[:3, :3].T.to(src.device) + T[:3, 3].to(src.device)
        rows = _window_rows(pg, q)
        cand = torch.where(rows >= 0, pg.row_count[rows.clamp(min=0)], 0).sum(dim=1)
        return (nbytes(pg.pts_packed, pg.row_count, pg.block_row, tg.proxy.table, src, w)
                + 29 * 4,
                float((cand * (w > 0)).sum()) * FLOPS_DIST + n_inliers * row_flops)
    return work


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
                   point_work(FLOPS_M3_POINT), plain_target, "entry",
                   T_REF_ICP, 6, f"{CSRC}/point_align.cu", f"{PALLAS}/point_align.py:594"),
    ]


def plane_icp_path(normals) -> SolverPath:
    """The PlaneICP path; its target takes the map's ``normals`` (a tensor on
    the card)."""
    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    return SolverPath("plane_icp", lambda d: pt.PlaneICP(**PARAMS, k=K_NORMALS, device=d),
                      pa.plane_point_stats, pa.plane_point_stats_reference, point_args,
                      point_work(FLOPS_PLANE_ROW), lambda s, m: s.set_target(m, norm=normals),
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
    def plain_stats(T):
        return stats_from_packed(path.plain(*path.args(solver, src, w, T)).cpu())

    cfg = solver.cfg
    T_p, d_p = pt.gauss_newton(plain_stats, torch.eye(4), cfg.max_iter, cfg.tol)
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
    }


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
    # word) and the buffer of 32 (k > 16), on a fifth of the map
    pg_odd = build_packed_grid(map_t[:n // 5], info["cell_size"], cap=30)
    for k_odd in (K_NORMALS, 20):
        args = (pg_odd, q_s, ones[:N_SHUFFLED], k_odd, nm.BASE_RADIUS)
        max_abs_err = max(max_abs_err, compare_knn(
            f"{tag} kernel vs plain, cap {pg_odd.cap}, k = {k_odd}", kn.knn_moments(*args),
            kn.knn_moments_reference(*args)))
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


def run_exact_nn(map_t, scan_np, T_icp, icp_target, dev) -> dict:
    """Phase 7: the exact 1-NN kernel against its plain version, and as the
    oracle of the packed grid's tier-1 search."""
    import torch

    from point_cloud_registration_tpu_torch.ops.kernels import exact_nn as en
    from point_cloud_registration_tpu_torch.ops.pointgrid import nearest_point_packed

    tag = "[exact_nn]"
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
    b_ms, b_by = bound_ms(nbytes(q, map_t) + 8 * N_EXACT,
                          float(N_EXACT) * map_t.shape[0] * FLOPS_DIST)
    log(f"{tag} kernel, cdist().min, plain, kernel: {ms:.3f}, {library_ms:.3f}, {plain_ms:.1f}, "
        f"{ms_2:.3f} ms; bound {b_ms:.4f} ms by {b_by}; max |cdist - exact| {lib_err:.3e}")
    return {"kernel_ms": [ms, ms_2], "plain_ms": [plain_ms], "library_ms": library_ms,
            "launches": launches, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "certified": n_cert}


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
