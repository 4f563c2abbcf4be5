#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's VPlaneICP main path once on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure raises and the script exits nonzero:

1. Device: a CUDA card must be present; prints torch/CUDA versions, the
   card's name and its ``nvidia-smi`` name and power limit.
2. Build: compiles ``point_cloud_registration_tpu_torch/csrc/*.cu`` with
   nvcc (sm_90a) into ``point_cloud_registration_tpu_torch/_build/`` and
   prints the build seconds and ptxas' register report.
3. Kernel vs plain version: the fused plane-stats kernel against its plain
   PyTorch version on the card, on bench.py's city map (1.2M points) and
   100k-point scan, at T = I and at a perturbed T.
4. Main path: ``VPlaneICP(...).set_target(map)`` then ``align(scan)``; it
   must converge near the scan's known offset, to the JAX package's result
   on the same data, through the kernel (its launch count must equal the
   iteration count). Then warm timings, and the
   kernel's per-iteration time beside the plain version's.
5. The slice with the plain stats: the GN loop over the plain version must
   reach the kernel's T with the same iteration count.
6. No JAX was imported.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
N_MAP = 1_200_000
N_SCAN = 100_000
SEED = 42
PARAMS = dict(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)
SCAN_OFFSET = np.array([0.0, 0.0, 0.3])  # bench.make_scan: scan = map + offset
# Kernel vs plain version on the card. Both sum ~1e5 float32 terms in other
# orders and nvcc contracts FMAs (ulp-level differences in q); a query whose
# distance lies within an ulp of the max_dist gate may flip, which moves the
# sums by about one point's share (1 / n_inliers ~ 1e-5).
TOL_H = 1e-4  # max |dH| / max |H|
TOL_G = 1e-4  # max_i |dg_i| / sqrt(H_ii e2), the Cauchy-Schwarz scale of g_i
TOL_E2 = 1e-4  # |de2| / e2
TOL_N = 2  # |dn_inliers|
TOL_T = 1e-4  # max |dT| between the kernel's and the plain version's GN runs
# The JAX package's VPlaneICP on the same seeded map and scan (JAX 0.9.0 on
# the CPU): 4 iterations to this transform (rows 0-2). The voxelized
# objective itself lands 0.0699 from the generating offset on this scene, so
# the port is held to the reference's result and to a 0.1 offset bound.
T_REF_JAX = np.array([
    [1.0, 4.63e-05, -4.9e-06, -0.0014129],
    [-4.63e-05, 1.0, -5.44e-05, 0.0074022],
    [4.9e-06, 5.44e-05, 1.0, -0.3694947],
])
ITERATIONS_JAX = 4
TOL_REF = 1e-3  # max |T - T_REF_JAX|, the port's parity budget
TOL_OFFSET = 0.1  # |t - (-offset)| of the recovered transform
KERNEL_SOURCE = "point_cloud_registration_tpu_torch/csrc/fused_align.cu"
REPLACES = "point_cloud_registration_tpu/ops/pallas/fused_align.py:550"


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
    _build.load_library()
    seconds = time.perf_counter() - t0
    log_path = _build.library_path().parent / "nvcc.log"
    if log_path.is_file():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log("  ptxas:", line.strip())
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


def compare_stats(k, p) -> dict:
    """Errors of the kernel's packed stats ``k`` against the plain ``p``."""
    from point_cloud_registration_tpu_torch.ops.kernels.fused_align import stats_from_packed

    sk = stats_from_packed(k.double().cpu())
    sp = stats_from_packed(p.double().cpu())
    e2 = float(sp.e2)
    g_scale = np.sqrt(np.maximum(np.diag(sp.H.numpy()) * e2, 1e-30))
    return {
        "H": float((sk.H - sp.H).abs().max() / sp.H.abs().max()),
        "g": float(np.max(np.abs((sk.g - sp.g).numpy()) / g_scale)),
        "e2": abs(float(sk.e2) - e2) / max(e2, 1e-30),
        "n": abs(float(sk.n_inliers) - float(sp.n_inliers)),
        "max_abs": float((k.double() - p.double()).abs().max()),
    }


def main() -> None:
    import torch

    # 1. Device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    from bench import make_city_map, make_scan  # numpy only at module level

    import point_cloud_registration_tpu_torch as pt
    from point_cloud_registration_tpu_torch.models import pad_points
    from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"device: {name}, count {torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    log(smi)

    # 2. Build
    build_s = build_kernels()
    log(f"build: {build_s:.2f} s")

    # 3. Kernel vs plain version at the main path's shapes
    rng = np.random.RandomState(SEED)
    map_np = make_city_map(rng, N_MAP)
    scan_np = make_scan(rng, map_np, N_SCAN)
    log(f"map {map_np.shape}, scan {scan_np.shape}")
    cfg = pt.VPlaneICP(**PARAMS).cfg
    vm = pt.build_voxel_map(map_np, cfg.voxel_size, min_points=cfg.min_points, device=dev)
    torch.cuda.synchronize()
    log(f"voxel map: dims {vm.dims}, {vm.num_voxels} valid voxels")
    src, w = pad_points(scan_np, device=dev)
    geo = (vm.table, vm.origin_cell, vm.dims, vm.cell_size, src, w)
    T_pert = pt.plus(torch.eye(4), torch.tensor([0.05, -0.04, -0.25, 0.01, -0.008, 0.012]))
    max_abs_err = 0.0
    for label, T in (("T=I", torch.eye(4)), ("T=perturbed", T_pert)):
        args = geo + (T[:3, :3], T[:3, 3], cfg.max_dist, cfg.huber_delta)
        err = compare_stats(fa.fused_plane_stats(*args), fa.fused_plane_stats_reference(*args))
        log(f"kernel vs plain at {label}: rel err H {err['H']:.3e}, g {err['g']:.3e}, "
            f"e2 {err['e2']:.3e}; n_inliers diff {err['n']:.0f}; max abs {err['max_abs']:.3e}")
        if not (err["H"] < TOL_H and err["g"] < TOL_G and err["e2"] < TOL_E2
                and err["n"] <= TOL_N):
            raise AssertionError(f"kernel disagrees with its plain version at {label}: {err}")
        max_abs_err = max(max_abs_err, err["max_abs"])

    # 4. Main path at full size, through the user's entry points
    fa.fused_plane_stats.launches = 0
    t0 = time.perf_counter()
    vp = pt.VPlaneICP(**PARAMS, device=dev)
    vp.set_target(map_np)
    T_k = vp.align(scan_np)
    first_s = time.perf_counter() - t0
    launches = fa.fused_plane_stats.launches
    d = vp.last_diagnostics
    log(f"main path (first call, numpy inputs): {first_s:.3f} s, {d.iterations} iterations, "
        f"converged {d.converged}, launches {launches}")
    log(f"T =\n{np.array2string(T_k, precision=6)}")
    if not (d.converged and not d.solver_failed):
        raise AssertionError(f"align did not converge: {d}")
    if not np.isfinite(T_k).all():
        raise AssertionError("non-finite transform")
    off_err = float(np.linalg.norm(T_k[:3, 3] + SCAN_OFFSET))
    ref_err = float(np.abs(T_k[:3] - T_REF_JAX).max())
    log(f"|t - (0, 0, -0.3)| = {off_err:.5f}; max |T - T_jax| = {ref_err:.2e}")
    if not (off_err < TOL_OFFSET and ref_err < TOL_REF and d.iterations == ITERATIONS_JAX):
        raise AssertionError(
            f"transform off the reference: offset error {off_err}, "
            f"JAX difference {ref_err}, {d.iterations} iterations"
        )
    if launches != d.iterations:
        raise AssertionError(f"kernel launched {launches} times for {d.iterations} iterations")

    map_t = torch.from_numpy(map_np).to(dev)
    scan_t = torch.from_numpy(scan_np).to(dev)
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vp.set_target(map_t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        T_w = vp.align(scan_t)
        t2 = time.perf_counter()
        warm.append((t1 - t0, t2 - t1))
        if not (np.allclose(T_w, T_k, rtol=0, atol=0) and vp.last_diagnostics.iterations == d.iterations):
            raise AssertionError("a warm run gave another result than the first")
    set_target_s = min(s for s, _ in warm)
    align_s = min(a for _, a in warm)
    log("warm (device-resident inputs), set_target s / align s: "
        + ", ".join(f"{s:.4f} / {a:.4f}" for s, a in warm))

    Tc = torch.as_tensor(T_k, dtype=torch.float32)
    args = geo + (Tc[:3, :3], Tc[:3, 3], cfg.max_dist, cfg.huber_delta)
    kernel_ms = cuda_ms(lambda: fa.fused_plane_stats(*args), 50)
    plain_ms = cuda_ms(lambda: fa.fused_plane_stats_reference(*args), 5)
    kernel_ms_2 = cuda_ms(lambda: fa.fused_plane_stats(*args), 50)
    plain_ms_2 = cuda_ms(lambda: fa.fused_plane_stats_reference(*args), 5)
    log(f"per-iteration stats at the converged T (kernel, plain, kernel, plain): "
        f"{kernel_ms:.4f}, {plain_ms:.4f}, {kernel_ms_2:.4f}, {plain_ms_2:.4f} ms")

    # 5. The slice with the plain stats function on the card
    vm_k = vp.voxels

    def plain_stats(T):
        packed = fa.fused_plane_stats_reference(
            vm_k.table, vm_k.origin_cell, vm_k.dims, vm_k.cell_size, src, w,
            T[:3, :3], T[:3, 3], cfg.max_dist, cfg.huber_delta,
        )
        return fa.stats_from_packed(packed.cpu())

    T_p, d_p = pt.gauss_newton(plain_stats, torch.eye(4), cfg.max_iter, cfg.tol)
    dT = float(np.abs(T_p.numpy().astype(np.float64) - T_k).max())
    log(f"plain-stats GN: {d_p.iterations} iterations, max |dT| vs kernel {dT:.3e}")
    if not (dT < TOL_T and d_p.iterations == d.iterations):
        raise AssertionError("the plain-stats GN loop disagrees with the kernel's")

    # 6. No JAX
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    summary = {
        "card": smi, "build_s": build_s, "first_call_s": first_s,
        "set_target_s": set_target_s, "align_s": align_s, "iterations": d.iterations,
        "kernel_ms": [kernel_ms, kernel_ms_2], "plain_ms": [plain_ms, plain_ms_2],
        "offset_err": off_err, "dT_jax": ref_err, "dT_plain": dT,
    }
    log("summary: " + json.dumps(summary))
    print(json.dumps({"kernels": [{
        "name": "fused_plane_stats", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_abs_err,
        "ms": min(kernel_ms, kernel_ms_2), "plain_ms": min(plain_ms, plain_ms_2),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
