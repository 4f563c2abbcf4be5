#!/usr/bin/env python3
"""The fused voxel-stats kernels alone, beside other builds of them, on a CUDA card.

    python3 scripts/fused_stats_ablation.py [older_fused_align.cu]

On the seed-42 bench data (1.2M-point map, 100k-point scan, the maps of
VPlaneICP and NDT) it times one launch of ``fused_plane_stats`` and of
``fused_ndt_stats`` as ``torch.profiler`` reads the device time over 20
launches (CUDA events around back-to-back launches of a kernel this short
measure the host), at T = I (the first iteration) and at the scan's known
offset (the last):

* the shipped build, on the scan in the caller's order (the bench scan's
  points are in random order) and ordered by cell (:func:`scan_order`);
* a build whose grid's last block sums the per-block partials, behind a
  counter, in place of the wrapper's ``torch.sum`` (:data:`FINISH`);
* builds with another number of resident blocks per SM (the register
  budget);
* the older source named on the command line (the kernel before its
  redesign for the H100, with its ``gn_accumulate.cuh`` beside it): the
  dense per-cell table, one 16-byte probe per cell of the window, R and t
  passed by value, on the caller's order and by cell;
* the first eighth, quarter and half of the ordered scan (a kernel bound by
  latency keeps its time, one bound by a rate is faster in proportion).

Then the device time and the host time of whole aligns, with the scan in
the caller's order (``align``) and ordered by cell first (the sort inside
the timed call), and of ``scan_order`` alone; and, for the in-kernel sum,
the host time of one launch (200 calls queued without a wait), the shipped
build and that build in turn. Every build's sums are held to the shipped
build's. Prints the card's name and power limit first.
"""

import ctypes
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import point_cloud_registration_tpu_torch as pt
from bench import make_city_map, make_scan
from point_cloud_registration_tpu_torch.core.gn import gauss_newton
from point_cloud_registration_tpu_torch.models import pad_points
from point_cloud_registration_tpu_torch.models._fused import fused_voxel_align, fused_voxel_stats
from point_cloud_registration_tpu_torch.ops.kernels import _build
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.knn import CELL_CLAMP, window_radius
from point_cloud_registration_tpu_torch.ops.voxelize import sqrt_icov_u6

STATS = fa.STATS_WIDTH
PER_SM = "constexpr int kMinBlocks = 3;"
INCLUDE = '#include "gn_accumulate.cuh"'
# The partials summed inside the kernel: block_reduce_store, then the last
# block of the grid to finish (elected by a counter that it finds at
# gridDim.x - 1 and leaves at 0) adds the rows, eight threads per column with
# 16 loads in flight each, then xor-shuffles: one fixed order, no atomics in
# the sums. It writes the sums after the n_blocks rows of `partials` and keeps
# the counter after them, so the C interface stays the shipped one.
FINISH = INCLUDE + '''

__device__ __forceinline__ void block_reduce_finish(const float* acc,
                                                    float* __restrict__ partials) {
  using pcr::kStats;
  static_assert(pcr::kWarps * 32 >= 8 * kStats, "eight threads per column");
  __shared__ bool last;
  const int n = static_cast<int>(gridDim.x);
  float* out = partials + n * kStats;
  unsigned* counter = reinterpret_cast<unsigned*>(out + kStats);
  pcr::block_reduce_store(acc, partials);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int k = threadIdx.x >> 3, j = threadIdx.x & 7;
  constexpr int kLoads = 16;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (k < kStats) {
    for (int b = j; b < n; b += 8 * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        v[u] = b + 8 * u < n ? __ldcg(&partials[(b + 8 * u) * kStats + k]) : 0.f;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) s[u & 3] += v[u];
    }
  }
  float v = (s[0] + s[1]) + (s[2] + s[3]);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (k < kStats && j == 0) out[k] = v;
  if (threadIdx.x == 0) *counter = 0u;
}
'''
IN_KERNEL_SUM = "in-kernel sum (the last block sums the partials)"
VARIANTS = {
    IN_KERNEL_SUM: [("pcr::block_reduce_store(acc, partials);",
                     "block_reduce_finish(acc, partials);"), (INCLUDE, FINISH)],
    "4 blocks per SM": [(PER_SM, "constexpr int kMinBlocks = 4;")],
    "6 blocks per SM": [(PER_SM, "constexpr int kMinBlocks = 6;")],
}


def scan_order(source: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Permutation that sorts the scan by the linear key of its points'
    cells (x fastest), each coordinate modulo 1024 so that the key fits 30
    bits: the lanes of a warp then probe overlapping windows."""
    inv_cell = torch.tensor(fa.inv_cell_f32(cell_size), device=source.device)
    c = torch.floor(source * inv_cell).clamp(-CELL_CLAMP, CELL_CLAMP).to(torch.int32) & 1023
    return torch.argsort(c[:, 0] | (c[:, 1] << 10) | (c[:, 2] << 20), stable=True)


def nvcc_command(k: int, path: str, include: str, out_dir: str) -> tuple[list, str]:
    """The nvcc command that builds ``path`` into library number ``k``."""
    lib = os.path.join(out_dir, f"fused_variant_{k}.so")
    return [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", include, "-o", lib, path], lib


def build_variants(older: list[str], out_dir: str) -> dict:
    """Compile every variant, one nvcc each, all started together; returns
    ``{name: CDLL}`` and prints each build's register report."""
    source = (_build.CSRC_DIR / "fused_align.cu").read_text()
    todo = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: pattern {old!r} is not in csrc/fused_align.cu")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"variant_{len(todo)}.cu")
        with open(path, "w") as f:
            f.write(text)
        todo[name] = nvcc_command(len(todo), path, str(_build.CSRC_DIR), out_dir)
    for src in older:
        src = os.path.abspath(src)
        todo[f"older {src}"] = nvcc_command(len(todo), src, os.path.dirname(src), out_dir)
    procs = {name: (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)) for name, (cmd, lib) in todo.items()}
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        report = "; ".join(line.split(":", 1)[-1].strip() for line in log.splitlines()
                           if "registers" in line or "spill" in line)
        print(f"   built {name}: {report}", flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def device_ms(fn, reps: int = 20, match: str | None = "fused_stats_kernel") -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls, read
    from ``torch.profiler``: of the kernels whose name holds ``match``, or of
    every kernel the call runs (``match=None``)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and (match is None or match in e.key)]
    if match is not None:
        traced = sum(e.count for e in rows)  # the trace may miss a launch
        if traced < reps // 2:
            raise RuntimeError(f"the trace holds {traced} of {reps} launches")
        reps = traced
    return sum(e.self_device_time_total for e in rows) / 1e3 / reps


def older_launcher(lib, kind):
    """The older entry point: (table, geometry, scan, R, t, gate, partials,
    n_blocks, stream), its partials summed by ``torch.sum``."""
    fn = getattr(lib, fa._C_SYMBOLS[kind])
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = ([c_ptr] + [c_int] * 6 + [c_float, c_int] + [c_ptr, c_ptr, c_int]
                   + [c_float] * 12 + [c_float, c_int, c_float] + [c_ptr, c_int, c_ptr])
    fn.restype = c_int

    def run(table, vm, src, w, R, t, max_dist):
        n = src.shape[0]
        n_blocks = min(-(-n // 256), fa.MAX_BLOCKS)
        partials = torch.empty((n_blocks, STATS), dtype=torch.float32, device=src.device)
        rc = fn(table.data_ptr(), *vm.dims, *vm.origin_cell,
                float(fa.inv_cell_f32(vm.cell_size)), window_radius(max_dist, vm.cell_size),
                src.data_ptr(), w.data_ptr(), n,
                *torch.as_tensor(R, dtype=torch.float32).reshape(9).tolist(),
                *torch.as_tensor(t, dtype=torch.float32).reshape(3).tolist(),
                float(max_dist), 0, 0.0, partials.data_ptr(), n_blocks,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"older {kind} kernel: CUDA error {rc}")
        return partials.sum(dim=0)

    return run


def dense_table(vm, kind: str) -> torch.Tensor:
    """The older layout of a voxel map: one row per cell in linear-key order,
    ``[mu, valid, n, 0]`` (8 floats) for plane, ``[mu, valid, u6, 0, 0]``
    (12) for ndt, features zero on invalid cells."""
    feats = vm.normals if kind == "plane" else sqrt_icov_u6(vm.icovs)
    table = torch.zeros((vm.valid.shape[0], 8 if kind == "plane" else 12),
                        dtype=torch.float32, device=vm.valid.device)
    table[:, 0:3] = vm.means
    table[:, 3] = vm.valid.to(torch.float32)
    table[:, 4:4 + feats.shape[1]] = torch.where(vm.valid[:, None], feats, 0.0)
    return table


def launcher(kind, bound, cells, origin_cell, dims, cell_size, src, w, R, t, max_dist,
             huber_delta, partials=None):
    """``launch() -> partials``: one launch of the build ``bound`` of
    ``kind`` on one problem, ``src`` (N, 3) at ``R``, ``t``, whose pose row
    goes to the card once; the partials are (1, n_blocks, 29), or
    ``partials`` when given."""
    fa.check_launch(kind, cells, dims, src, w)
    poses = fa.pose_rows(torch.as_tensor(R)[None], torch.as_tensor(t)[None], src.device)
    fn, args, partials = fa.launch_args(bound, cells, origin_cell, dims, cell_size, src[None],
                                        w[None], poses, None, max_dist, huber_delta, partials)

    def launch():
        if fn(*args) != 0:
            raise RuntimeError("fused stats kernel launch failed")
        return partials

    launch.operands = (poses, src, w)  # the tensors whose pointers args carries
    return launch


def in_kernel_sum_launcher(lib, kind, cells, origin_cell, dims, cell_size, src, w, R, t,
                           max_dist, huber_delta):
    """``launch() -> (29,)``: the in-kernel-sum build on one problem, into a
    buffer of its own (its counter starts at 0 and each launch leaves it
    so)."""
    bound = fa.bind(lib, kind)
    n_blocks = min(-(-src.shape[0] // bound[1]), fa.MAX_BLOCKS)
    buf = torch.zeros((n_blocks + 2) * STATS, dtype=torch.float32, device=src.device)
    go = launcher(kind, bound, cells, origin_cell, dims, cell_size, src, w, R, t, max_dist,
                  huber_delta, partials=buf)
    return lambda: go()[n_blocks * STATS:(n_blocks + 1) * STATS]


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call of ``fn``, ``reps`` calls queued without a
    wait (the card's queue holds them all)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def align_walls(fn, reps: int = 20) -> list:
    """Wall milliseconds of ``reps`` calls of ``fn``, each waited for."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return walls


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("fused_stats_ablation.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as out_dir:
        libs = build_variants(sys.argv[1:], out_dir)
        rng = np.random.RandomState(42)
        map_np = make_city_map(rng, 1_200_000)
        scan_np = make_scan(rng, map_np, 100_000)
        map_t = torch.from_numpy(map_np).cuda()
        src, w = pad_points(scan_np, device="cuda")
        params = dict(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3, device="cuda")
        solvers = {"plane": pt.VPlaneICP(**params), "ndt": pt.NDT(**params)}
        poses = {"T = I": torch.zeros(3), "t = (0, 0, -0.3)": torch.tensor([0.0, 0.0, -0.3])}
        for kind, solver in solvers.items():
            solver.set_target(map_t)
            vm = solver._target
            order = scan_order(src, vm.cell_size)
            scans = {"caller's order": (src, w),
                     "by cell": (src[order].contiguous(), w[order].contiguous())}
            dense = dense_table(vm, kind)  # what the older build reads
            for label, t in poses.items():
                print(f"== {kind}, {src.shape[0]} queries at {label}: device ms per launch",
                      flush=True)
                for order_name, (s_src, s_w) in scans.items():
                    args = (vm.cells, vm.origin_cell, vm.dims, vm.cell_size, s_src, s_w,
                            torch.eye(3), t, solver.cfg.max_dist, None)
                    go_shipped = launcher(kind, fa._kernel_fn(kind), *args)
                    shipped = lambda: go_shipped()[0].sum(dim=0)  # noqa: E731
                    in_kernel = in_kernel_sum_launcher(libs[IN_KERNEL_SUM], kind, *args)
                    want = shipped()
                    print(f"   [{order_name}] shipped build: {device_ms(shipped):.4f}, again "
                          f"{device_ms(shipped):.4f}; whole call "
                          f"{device_ms(shipped, match=None):.4f}", flush=True)
                    for name, lib in libs.items():
                        if name.startswith("older"):
                            go = older_launcher(lib, kind)
                            call = lambda: go(dense, vm, s_src, s_w, torch.eye(3), t,  # noqa: E731
                                              solver.cfg.max_dist)
                        elif name == IN_KERNEL_SUM:
                            call = in_kernel
                        else:
                            go_v = launcher(kind, fa.bind(lib, kind), *args)
                            call = lambda: go_v()[0].sum(dim=0)  # noqa: E731
                        got = call()
                        err = float((got - want).abs().max() / want.abs().max())
                        if not err < 1e-4:
                            raise AssertionError(f"{name}: sums differ from the shipped "
                                                 f"build's by {err}")
                        print(f"   [{order_name}] {name}: {device_ms(call):.4f}; whole call "
                              f"{device_ms(call, match=None):.4f}", flush=True)
                    if order_name == "caller's order":
                        hosts = [host_us(fn) for fn in (shipped, in_kernel, shipped, in_kernel)]
                        print(f"   [{order_name}] host us per launch (shipped, in-kernel "
                              f"sum, shipped, in-kernel sum): "
                              + ", ".join(f"{h:.2f}" for h in hosts), flush=True)
                s_src, s_w = scans["by cell"]
                parts = {}
                for m in (s_src.shape[0] // 8, s_src.shape[0] // 4, s_src.shape[0] // 2):
                    sub = (vm.cells, vm.origin_cell, vm.dims, vm.cell_size,
                           s_src[:m].contiguous(), s_w[:m].contiguous(), torch.eye(3), t,
                           solver.cfg.max_dist, None)
                    parts[m] = device_ms(launcher(kind, fa._kernel_fn(kind), *sub))
                print("   shipped build, by cell, on the first " + ", ".join(
                    f"{m} queries: {ms:.4f}" for m, ms in parts.items()), flush=True)

            # whole aligns: ordered by cell (align) and in the caller's order
            cfg = solver.cfg

            def unordered():
                return fused_voxel_align(vm, src, w, torch.eye(4), cfg, kind)

            def ordered():
                o = scan_order(src, vm.cell_size)
                s_src, s_w = src[o], w[o]
                return gauss_newton(lambda T: fused_voxel_stats(vm, s_src, s_w, T, cfg, kind),
                                    torch.eye(4), cfg.max_iter, cfg.tol)

            for name, fn in (("by cell", ordered), ("caller's order", unordered),
                             ("by cell", ordered), ("caller's order", unordered)):
                T, d = fn()
                walls = align_walls(fn, 5)
                dev_ms = device_ms(fn, reps=5, match=None)
                print(f"== {kind} align, scan {name}: {d.iterations} iterations, device "
                      f"{dev_ms:.4f} ms per align, wall {min(walls):.3f}-{max(walls):.3f} ms; "
                      f"T[:3, 3] = {T[:3, 3].tolist()}", flush=True)
            sort_ms = device_ms(lambda: scan_order(src, vm.cell_size), match=None)
            gather_ms = device_ms(lambda: (src[order], w[order]), match=None)
            print(f"== {kind}: scan_order alone {sort_ms:.4f} ms of device time, the two "
                  f"gathers {gather_ms:.4f} ms", flush=True)

if __name__ == "__main__":
    main()
