#!/usr/bin/env python3
"""The loop kernel (csrc/gn_loop.cu) beside its alternatives, on a CUDA card.

    python3 scripts/gn_loop_ablation.py [--parent DIR] [--out-dir DIR]

On the seed-42 bench data of ``chip_smoke.py`` (the 1.2M-point city map,
the 100k-point scan, VPlaneICP's and NDT's targets, max_iter 30, tol 1e-3),
from T = I, for kinds plane and ndt:

* the shipped build (phase B in CTA 0 behind a second grid sync) against a
  build of ``csrc/gn_loop.cu`` with ``kRedundant = true`` in
  ``csrc/gn_loop.cuh`` (phase B in every
  CTA, one grid sync an iteration): the final state bit for bit, the
  launch alone by ``torch.profiler`` (kernels named ``gn_loop_kernel``) and
  by CUDA events around the state's copy and the launch, in turns (one CTA,
  every CTA, every CTA, one CTA);
* the grid sync's own cost: a cooperative kernel of the loop kernel's grid
  (three CTAs an SM, as many CTAs as the loop kernel launches on the bench
  scan) and block that does nothing but
  ``grid.sync()``, 0 and 2,000 times a launch (its source is in this
  script, built with the package's nvcc flags);
* the yardstick: one ``GN_CHUNK`` of the two-launch resident loop
  (``core.gn.gauss_newton_device``: the stats launch, the sum of its rows
  and ``gn_step``, ``GN_CHUNK`` times) captured in a CUDA graph and
  replayed, beside the same chunk launched from Python and beside the loop
  kernel's whole align (the loop runs the align's iterations, the chunk
  ``GN_CHUNK``);
* where an align's host time goes: ``cProfile`` over 50 warm
  ``VPlaneICP.align`` calls on the card-resident scan, the top functions by
  their own time.

With ``--parent DIR`` (the ``csrc`` directory of another tree, e.g. the
parent commit unpacked by ``git archive``), its ``fused_align.cu``,
``gn_step.cu``, ``gn_loop.cu``, ``point_align.cu`` and ``grid_align.cu``
are built beside this tree's (the same flags, one nvcc each, all started
together) and compared: each kernel's ptxas registers, stack and spills;
the stats kernels' block rows at T = I (the fused kinds on the city map,
ICP and PlaneICP on the city map's packed grid, the four grid kinds on the
data of ``chip_smoke.py`` phases 9 and 10), ``gn_step``'s state and the
loop kernel's final state (VPlaneICP and NDT) bit for bit; each kernel
alone by the profiler in turns (parent, this tree, this tree, parent).
Prints the card's name and power limit first; with ``--out-dir`` it writes
the numbers to ``DIR/gn_loop_ablation.json``.
"""

from __future__ import annotations

import argparse
import cProfile
import ctypes
import functools
import json
import os
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import point_cloud_registration_tpu_torch as pt
from bench import make_city_map, make_scan
from point_cloud_registration_tpu_torch.core import gn
from point_cloud_registration_tpu_torch.models import pad_points
from point_cloud_registration_tpu_torch.models._fused import fused_voxel_stats_resident
from point_cloud_registration_tpu_torch.ops.kernels import _build
from point_cloud_registration_tpu_torch.ops.kernels import fused_align as fa
from point_cloud_registration_tpu_torch.ops.kernels import gn_loop as gl
from point_cloud_registration_tpu_torch.ops.kernels import gn_step as gs

PARAMS = dict(voxel_size=1.0, max_iter=30, max_dist=2.0, tol=1e-3)
# the sources that --parent builds from both trees
PARENT_SOURCES = ("fused_align", "gn_step", "gn_loop", "point_align", "grid_align")
SYNCS = 2000
ONE_CTA = "constexpr bool kRedundant = false;"
# A cooperative kernel of the loop kernel's launch shape that only syncs.
SYNC_SOURCE = r'''
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void __launch_bounds__(256, 3) grid_sync_kernel(int syncs, int* out) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = syncs;
}
extern "C" int grid_sync(int grid, int syncs, int* out, void* stream) {
  void* args[] = {&syncs, &out};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_sync_kernel),
                                     dim3(grid), dim3(256), args, 0,
                                     static_cast<cudaStream_t>(stream));
}
'''


def device_ms(fn, reps: int, match: str) -> float:
    """Mean device milliseconds per call of ``fn`` of the kernels whose name
    holds ``match``, by ``torch.profiler`` over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if match in e.key and e.self_device_time_total > 0]
    traced = sum(e.count for e in rows)
    if traced < reps // 2:
        raise RuntimeError(f"the trace holds {traced} of {reps} launches of {match}")
    return sum(e.self_device_time_total for e in rows) / 1e3 / traced


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build(sources: dict, out_dir: str) -> tuple[dict, dict]:
    """``{name: path of a .cu}`` -> ``({name: CDLL}, {name: nvcc's report})``,
    one nvcc each with the package's flags, all started together."""
    procs = {}
    for name, (path, include) in sources.items():
        lib = os.path.join(out_dir, f"lib_{len(procs)}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", include, "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        libs[name] = ctypes.CDLL(lib)
    return libs, logs


def ptxas(report: str) -> dict:
    """``{kernel: "R registers, S stack, A / B spilled"}`` of a ptxas report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?(fused_stats_kernel|gn_step_kernel|"
                      r"gn_loop_kernel|grid_sync_kernel|point_stats_kernel|grid_stats_kernel)"
                      r"(\w*)", line)
        if m:  # the name and its kind: the first integer template argument after it
            kind = re.search(r"ILi\d+E", m.group(2))
            name = m.group(1) + (kind.group(0) if kind else "")
            out[name] = ""
        elif name and ("registers" in line or "spill" in line):
            out[name] += line.split(":", 1)[-1].strip() + " "
    return out


def turns(runs: dict, order: tuple, measure) -> dict:
    """``{name: [measure(runs[name]) in each turn]}`` over ``order``."""
    out = {name: [] for name in runs}
    for name in order:
        out[name].append(measure(runs[name]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="csrc directory of another tree")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("gn_loop_ablation.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    dev = torch.device("cuda")
    _build.build_all()
    result = {"card": smi}
    rng = np.random.RandomState(42)
    map_np = make_city_map(rng, 1_200_000)
    scan_np = make_scan(rng, map_np, 100_000)
    map_t, scan_t = torch.from_numpy(map_np).to(dev), torch.from_numpy(scan_np).to(dev)
    src, w = pad_points(scan_np, device=dev)
    eye = torch.eye(4)
    solvers = {"plane": pt.VPlaneICP(**PARAMS, device=dev), "ndt": pt.NDT(**PARAMS, device=dev)}
    with tempfile.TemporaryDirectory() as out_dir:
        sync_path = os.path.join(out_dir, "grid_sync.cu")
        Path(sync_path).write_text(SYNC_SOURCE)
        header = (_build.CSRC_DIR / "gn_loop.cuh").read_text()
        if ONE_CTA not in header:
            raise RuntimeError(f"pattern {ONE_CTA!r} is not in csrc/gn_loop.cuh")
        # the loop kernel's header with the substitution beside a copy of gn_loop.cu,
        # where the copy's include finds it first
        every_dir = os.path.join(out_dir, "every_cta")
        os.makedirs(every_dir)
        Path(every_dir, "gn_loop.cuh").write_text(
            header.replace(ONE_CTA, "constexpr bool kRedundant = true;"))
        every_path = os.path.join(every_dir, "gn_loop.cu")
        shutil.copy(_build.CSRC_DIR / "gn_loop.cu", every_path)
        sources = {"grid_sync": (sync_path, out_dir),
                   "gn_loop every CTA": (every_path, str(_build.CSRC_DIR))}
        if args.parent:
            for name in PARENT_SOURCES:
                sources[f"parent {name}"] = (os.path.join(args.parent, f"{name}.cu"),
                                             args.parent)
                sources[f"this {name}"] = (str(_build.CSRC_DIR / f"{name}.cu"),
                                           str(_build.CSRC_DIR))
        libs, logs = build(sources, out_dir)
        for name, report in logs.items():
            print(f"ptxas [{name}]: {ptxas(report)}", flush=True)
        result["ptxas"] = {name: ptxas(report) for name, report in logs.items()}

        # the grid sync alone, at the loop kernel's grid
        sync = libs["grid_sync"]
        sync.grid_sync.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        per_sm = gl._kernel_fn("plane")[2]()  # the loop kernel's CTAs an SM
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = gl.loop_grid(src.shape[0], 256, sms, per_sm)[0]
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def syncs(n):
            def run():
                if sync.grid_sync(grid, n, flag.data_ptr(), stream) != 0:
                    raise RuntimeError("the grid-sync launch failed")
            return run

        sync_ms = {n: device_ms(syncs(n), 10, "grid_sync_kernel") for n in (0, SYNCS)}
        per_sync_us = 1e3 * (sync_ms[SYNCS] - sync_ms[0]) / SYNCS
        print(f"grid sync at {grid} CTAs of 256 ({per_sm} an SM): a launch of 0 syncs "
              f"{sync_ms[0]:.4f} ms, of {SYNCS} {sync_ms[SYNCS]:.4f} ms: {per_sync_us:.3f} us a "
              f"sync", flush=True)
        result["grid_sync"] = {"grid": grid, "launch_ms": sync_ms, "per_sync_us": per_sync_us}

        for kind, solver in solvers.items():
            solver.set_target(map_t)
            vm, cfg = solver._target, solver.cfg
            operands = (kind, vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src, w)
            settings = dict(max_dist=cfg.max_dist, huber_delta=cfg.huber_delta, tol=cfg.tol,
                            max_iter=cfg.max_iter)
            init = gn.new_state(eye[None], cfg.max_iter, dev)
            its = None
            row = {}
            # phase B in CTA 0 (shipped) and in every CTA, in turns
            runs, finals = {}, {}
            for mode, bound in (("one_cta", None),
                                ("every_cta", gl.bind(libs["gn_loop every CTA"], kind))):
                state = gn.new_state(eye[None], cfg.max_iter, dev)
                launch = gl.fused_looper(*operands, state, **settings, bound=bound)

                def once(state=state, launch=launch):
                    state.words.copy_(init.words)
                    launch()

                once()
                finals[mode] = gn.read_state(state).words
                its = int(gn.read_state(state).it[0])
                runs[mode] = once
            order = ("one_cta", "every_cta", "every_cta", "one_cta")
            row["alone_ms"] = turns(runs, order, lambda f: device_ms(f, 20, "gn_loop_kernel"))
            row["events_ms"] = turns(runs, order, lambda f: events_ms(f, 20))
            row["iterations"] = its
            row["states_equal"] = torch.equal(finals["one_cta"], finals["every_cta"])
            print(f"[{kind}] {its} iterations a launch; final states bit-equal "
                  f"{row['states_equal']}; the loop kernel alone (profiler), phase B in CTA 0 / "
                  f"in every CTA: {row['alone_ms']} ms; by events with the state's copy: "
                  f"{row['events_ms']} ms", flush=True)

            # the yardstick: a CUDA graph of one chunk of the two-launch loop
            stats_fn = fused_voxel_stats_resident(vm, src, w, cfg, kind)
            state = gn.new_state(eye[None], cfg.max_iter, dev)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                # bound on the capture stream, warmed once there before the capture
                stats, step = stats_fn(state.poses, state.done), gs.gn_stepper(state, cfg.tol)
                step(stats())
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph, stream=side):
                for _ in range(gn.GN_CHUNK):
                    step(stats())

            def replay():
                state.words.copy_(init.words)
                graph.replay()

            def python_chunk():
                state.words.copy_(init.words)
                for _ in range(gn.GN_CHUNK):
                    step(stats())

            replay()
            graph_state = gn.read_state(state)
            ref = gn.gauss_newton_device(stats_fn, eye, cfg.max_iter, cfg.tol, dev)[1]
            same = int(graph_state.it[0]) == min(ref.iterations, gn.GN_CHUNK)
            with torch.cuda.stream(side):
                chunk_runs = {"graph": replay, "python": python_chunk}
                corder = ("graph", "python", "python", "graph")
                row["chunk_events_ms"] = turns(chunk_runs, corder, lambda f: events_ms(f, 20))
                torch.cuda.synchronize()
            print(f"[{kind}] one chunk of {gn.GN_CHUNK} two-launch iterations (state copy "
                  f"included) by events, a CUDA graph / launched from Python: "
                  f"{row['chunk_events_ms']} ms (the graph's state after a replay has the "
                  f"two-launch loop's iterations: {same})", flush=True)
            result[kind] = row

        # where an align's host time goes
        solver = solvers["plane"]
        solver.set_target(map_t)
        for _ in range(5):
            solver.align(scan_t)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(50):
            solver.align(scan_t)
        prof.disable()
        stats = pstats.Stats(prof)
        top = sorted(((v[2], f"{Path(k[0]).name}:{k[1]}:{k[2]}") for k, v in stats.stats.items()),
                     reverse=True)[:15]
        print("VPlaneICP.align host time, 50 calls (cProfile, own ms a call): " + "; ".join(
            f"{name} {1e3 * t / 50:.4f}" for t, name in top), flush=True)
        result["host_profile"] = [(name, 1e3 * t / 50) for t, name in top]

        if args.parent:
            result["parent"] = compare_parent(libs, solvers, src, w, dev)
            result["parent"].update(compare_parent_stats(libs, map_t, scan_t, dev))
    if args.out_dir:
        path = Path(args.out_dir) / "gn_loop_ablation.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result, indent=1))


def compare_parent(libs: dict, solvers: dict, src, w, dev) -> dict:
    """The parent's and this tree's builds of fused_align.cu and gn_step.cu:
    outputs bit for bit and times alone in turns."""
    out = {}
    pose = gn.pose_rows_of(torch.eye(4)[None]).to(dev)
    for kind, solver in solvers.items():
        vm, cfg = solver._target, solver.cfg
        runs, rows = {}, {}
        for tree in ("parent", "this"):
            fn, args, partials = fa.launch_args(
                fa.bind(libs[f"{tree} fused_align"], kind), vm.cells, vm.origin_cell, vm.dims,
                vm.cell_size, src[None], w[None], pose, None, cfg.max_dist, cfg.huber_delta)

            def run(fn=fn, args=args):
                if fn(*args) != 0:
                    raise RuntimeError("stats launch failed")

            run()
            torch.cuda.synchronize()
            rows[tree] = partials.clone()
            runs[tree] = run
        equal = torch.equal(rows["parent"], rows["this"])
        alone = turns(runs, ("parent", "this", "this", "parent"),
                      lambda f: device_ms(f, 20, "fused_stats_kernel"))
        print(f"[{kind}] fused stats kernel at T = I, parent / this tree: block rows bit-equal "
              f"{equal}; alone (profiler) {alone} ms", flush=True)
        out[f"fused_{kind}"] = {"rows_equal": equal, "alone_ms": alone}
    # gn_step at B = 1 on seeded systems, three steps, then its time alone
    rng = np.random.RandomState(12)
    A = rng.randn(12, 6)
    packed = gn.packed_from_stats(gn.GNStats(
        torch.tensor(A.T @ A, dtype=torch.float32), torch.tensor(rng.randn(6) * 1e-3,
                                                                 dtype=torch.float32),
        torch.tensor(3.0), torch.tensor(5000.0)))[None].to(dev)
    states, runs = {}, {}
    for tree in ("parent", "this"):
        fn = libs[f"{tree} gn_step"].pcr_gn_step
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                ctypes.c_void_p]
        state = gn.new_state(torch.eye(4)[None], 4, dev)
        dx = torch.zeros((1, 6), device=dev)
        bound = [x.data_ptr() for x in state[1:]]
        stream = torch.cuda.current_stream(dev).cuda_stream
        for _ in range(3):
            fn(packed.data_ptr(), *bound, dx.data_ptr(), 1, 4, 1e-4, stream)
        states[tree] = gn.read_state(state).words.clone()
        timing = gn.new_state(torch.eye(4)[None], 1000, dev)
        tb = [x.data_ptr() for x in timing[1:]]
        runs[tree] = functools.partial(fn, packed.data_ptr(), *tb, None, 1, 1000, 0.0, stream)
    equal = torch.equal(states["parent"], states["this"])
    alone = turns(runs, ("parent", "this", "this", "parent"),
                  lambda f: device_ms(f, 50, "gn_step_kernel"))
    print(f"gn_step at B = 1, parent / this tree: state after three steps bit-equal {equal}; "
          f"alone (profiler) {alone} ms", flush=True)
    out["gn_step"] = {"state_equal": equal, "alone_ms": alone}
    # the loop kernel of VPlaneICP and NDT: final states bit for bit, alone in turns
    eye = torch.eye(4)
    for kind, solver in solvers.items():
        vm, cfg = solver._target, solver.cfg
        operands = (kind, vm.cells, vm.origin_cell, vm.dims, vm.cell_size, src, w)
        settings = dict(max_dist=cfg.max_dist, huber_delta=cfg.huber_delta, tol=cfg.tol,
                        max_iter=cfg.max_iter)
        init = gn.new_state(eye[None], cfg.max_iter, dev)
        runs, finals = {}, {}
        for tree in ("parent", "this"):
            state = gn.new_state(eye[None], cfg.max_iter, dev)
            launch = gl.fused_looper(*operands, state, **settings,
                                     bound=gl.bind(libs[f"{tree} gn_loop"], kind))

            def once(state=state, launch=launch):
                state.words.copy_(init.words)
                launch()

            once()
            finals[tree] = gn.read_state(state).words
            runs[tree] = once
        equal = torch.equal(finals["parent"], finals["this"])
        alone = turns(runs, ("parent", "this", "this", "parent"),
                      lambda f: device_ms(f, 20, "gn_loop_kernel"))
        print(f"[{kind}] loop kernel from T = I, parent / this tree: final states bit-equal "
              f"{equal}; alone (profiler) {alone} ms", flush=True)
        out[f"gn_loop_{kind}"] = {"state_equal": equal, "alone_ms": alone}
    return out


def compare_parent_stats(libs: dict, map_t, scan_t, dev) -> dict:
    """The parent's and this tree's builds of point_align.cu (ICP and
    PlaneICP on the city map) and grid_align.cu (ICP and PlaneICP on the
    40k LiDAR target, VPlaneICP and NDT on the two-tile hashed map of
    chip_smoke.py phases 9 and 10): each kernel's block rows at T = I bit
    for bit and its time alone in turns."""
    from bench import make_lidar_map

    from point_cloud_registration_tpu_torch.models import _fused, _point_fused
    from point_cloud_registration_tpu_torch.models._point_corr import proxy_radius
    from point_cloud_registration_tpu_torch.ops.kernels import grid_align as ga
    from point_cloud_registration_tpu_torch.ops.kernels import point_align as pa

    P = {k: v for k, v in PARAMS.items() if k != "voxel_size"}
    pose = gn.pose_rows_of(torch.eye(4)[None]).to(dev)
    src, w = pad_points(scan_t, device=dev)
    rng = np.random.RandomState(42)
    small = torch.from_numpy(make_lidar_map(rng, 40_000)).to(dev)
    small_src, small_w = pad_points(torch.from_numpy(make_scan(rng, small.cpu().numpy(),
                                                               10_000)).to(dev), device=dev)
    two = torch.cat([map_t, map_t + torch.tensor([3000.0, 3000.0, 0.0], device=dev)])
    cases = {}
    for kind, s in (("point", pt.ICP(**P, device=dev)), ("plane_pt", pt.PlaneICP(**P, device=dev))):
        s.set_target(map_t)
        tg = getattr(s._target, "corr", s._target)
        radius = proxy_radius(s.cfg.corr, s.cfg.max_dist)
        cases[f"point_stats {kind}"] = ("point_align", "point_stats_kernel", lambda lib, tg=tg,
                                        s=s, kind=kind, radius=radius: pa.partials_args(
            pa._bind(lib, kind), tg.packed, tg.proxy, src[None], w[None], pose, None,
            s.cfg.max_dist, radius, s.cfg.huber_delta))
    for kind, s, target, (q, qw) in (
            ("point", pt.ICP(**P, device=dev), small, (small_src, small_w)),
            ("plane_pt", pt.PlaneICP(**P, device=dev), small, (small_src, small_w)),
            ("plane", pt.VPlaneICP(**PARAMS, device=dev), two, (src, w)),
            ("ndt", pt.NDT(**PARAMS, device=dev), two, (src, w))):
        s.set_target(target)
        if kind in ("plane", "ndt"):
            grid, table, offsets = _fused.hashed_operands(s._target, s.cfg, kind)
        else:
            grid, table, offsets = _point_fused.grid_operands(
                getattr(s._target, "corr", s._target), s.cfg,
                s._target.normals if kind == "plane_pt" else None)
        off_d, window = ga.bind_window(grid, offsets, dev)
        cases[f"grid_stats {kind}"] = ("grid_align", "grid_stats_kernel", lambda lib, s=s,
                                       kind=kind, grid=grid, table=table, q=q, qw=qw,
                                       off_d=off_d, window=window: ga._launch_args(
            ga._bind(lib, kind), grid, table, q, qw, off_d, window, pose, None, s.cfg.max_dist,
            s.cfg.huber_delta, None))
    out = {}
    for case, (source, kernel, args_of) in cases.items():
        runs, rows = {}, {}
        for tree in ("parent", "this"):
            fn, args, partials = args_of(libs[f"{tree} {source}"])

            def run(fn=fn, args=args):
                if fn(*args) != 0:
                    raise RuntimeError(f"{case} launch failed")

            run()
            torch.cuda.synchronize()
            rows[tree] = partials.clone()
            runs[tree] = run
        equal = torch.equal(rows["parent"], rows["this"])
        alone = turns(runs, ("parent", "this", "this", "parent"),
                      lambda f: device_ms(f, 20, kernel))
        print(f"[{case}] at T = I, parent / this tree: block rows bit-equal {equal}; alone "
              f"(profiler) {alone} ms", flush=True)
        out[case] = {"rows_equal": equal, "alone_ms": alone}
    return out


if __name__ == "__main__":
    main()
