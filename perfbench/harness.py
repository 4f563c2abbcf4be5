"""The benchmark's core: resolve a cell by name, make its inputs from the
seed, set up, measure a closed loop of requests, judge what the timed path
returned against the plain reference, and reduce the traced run.

Everything about one configuration, traffic mix or per-layer metric lives in
a file of its own, found by the name in ``BENCHMARK.json``:
``configs/<config>.json`` (the solver, its parameters, the scene, the scan
protocol and the limits of the comparison), ``solvers/<solver>.py`` (the
program's class API), ``reference/<solver>.py`` (the plain reference),
``traffic/<mix>.json`` (``gen/traffic.py`` reads it) and
``metrics/<metric>.py`` (a reader of the traced run).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

import numpy as np

from perfbench import stats
from perfbench.gen import traffic as gen

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names that may not be loaded where the result is printed:
# the JAX stack and the JAX package the program was ported from.
BANNED = ("jax", "jaxlib", "flax", "point_cloud_registration_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def banned_modules(names=None) -> list[str]:
    """The banned top-level names among ``names`` (default: ``sys.modules``),
    each compared whole: ``point_cloud_registration_tpu_torch`` is not
    ``point_cloud_registration_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(BANNED))


def process_start_wall() -> float:
    """The wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def module_of(package: str, name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.{package}.{name.replace('.', '_').replace('-', '_')}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    solver: ModuleType
    reference: ModuleType
    end_to_end: list
    per_layer: list  # (entry, reader module) of the metrics this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``bench``, with its files; ``KeyError`` for
    a name the benchmark does not hold."""
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf_entry["file"]) as f:
        config = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    gen.check_arrivals(traffic)

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        solver=module_of("solvers", config["solver"]),
        reference=module_of("reference", config["solver"]),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[(m, module_of("metrics", m["name"])) for m in bench["per_layer"]
                   if reports(m)])


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


# The configurations' stated precision, and the backend switches that hold it.
PRECISIONS = {"float32, TF32 off": False}


def host_probe_ms() -> float:
    """A fixed piece of host work, a sort of 2**20 doubles, timed: how fast
    the host's core ran at that moment (a reading for the log)."""
    x = np.random.RandomState(0).rand(1 << 20)
    t = time.perf_counter()
    np.sort(x)
    return 1e3 * (time.perf_counter() - t)


def pose_gap(T_prog: np.ndarray, ref, corners: np.ndarray) -> tuple[float, int]:
    """How far the program's pose lies from the reference's trajectory: the
    largest distance at which the program's T and the reference's pose put a
    corner of the scan's bounding box, at the nearest of the reference's
    poses from one update before its loop's end to two past it.

    Near tol the step norms hover about the gate, and rounding can stop two
    loops that follow one trajectory an update or two apart; a pose off the
    trajectory, or short of its first update, is far from all of them.
    Returns ``(gap, updates of the pose compared)``."""
    c = np.c_[corners, np.ones(len(corners))]
    at = c @ np.asarray(T_prog, np.float64).T
    best = (math.inf, -1)
    for k in range(max(1, ref.updates - 1), min(len(ref.poses), ref.updates + 3)):
        gap = np.linalg.norm((at - c @ ref.poses[k].detach().cpu().numpy().T)[:, :3], axis=1)
        if np.all(np.isfinite(gap)) and gap.max() < best[0]:
            best = (float(gap.max()), k)
    return best


def early_stop_step(iterations: int, k: int, ref, tol: float) -> float:
    """How far past the gate lay the step that the program, stopping before
    the reference, left out: the reference's last applied step norm over
    ``tol``, less one. 0 where the program stopped with the reference or
    after it; ``inf`` where it stopped two or more updates early.

    A float32 loop may rightly stop one update before a float64 one where
    the reference's last step only just cleared the gate; a loop that
    leaves out a step well past the gate has dropped part of the align.
    ``iterations`` are the program's linearizations, ``k`` the updates of
    the reference pose that ``pose_gap`` matched."""
    short = max(ref.iterations - iterations, ref.updates - k)
    if short <= 0:
        return 0.0
    if short > 1 or ref.updates < 1:
        return math.inf
    return ref.dx_norms[ref.updates - 1] / tol - 1.0


def e2_gap(e2: list, ref) -> float:
    """The relative gap between the program's squared error and the
    reference's at the last linearization both loops made."""
    j = min(len(e2), len(ref.e2)) - 1
    if j < 0:
        return math.inf
    return abs(e2[j] - ref.e2[j]) / ref.e2[j]


def box_corners(points: np.ndarray) -> np.ndarray:
    lo, hi = points.min(axis=0).astype(np.float64), points.max(axis=0).astype(np.float64)
    return np.array([[(lo, hi)[i][0], (lo, hi)[j][1], (lo, hi)[k][2]]
                     for i in (0, 1) for j in (0, 1) for k in (0, 1)])


def check(cell: Cell, pool, done: list, rng, device) -> tuple[dict, list, float | None]:
    """Judge a sample of the window's requests, drawn from the seed, by
    the plain reference on the same inputs, in float64 on ``device``.
    Returns ``(numbers, lines, mean loop bound ms)``."""
    import torch

    from perfbench.metrics._roofline import loop_bound_ms

    params, limits = cell.config["params"], cell.config["correct"]
    tol = float(params["tol"])
    n_check = min(int(cell.traffic["checked_requests"]), len(done))
    picks = sorted(rng.choice(len(done), size=n_check, replace=False).tolist())
    buffers, built = gen.Buffers(pool), (None, None)  # (key, target) of the last map
    worst, worst_e2, worst_early, lines, bounds = 0.0, 0.0, 0.0, [], []
    for p in picks:
        req, T, iterations, e2, dx = done[p]
        map_np, scan_np = buffers.fill(pool, req)
        key = (req.map_index, req.shift.tobytes())
        if built[0] != key:
            built = (key, cell.reference.build(map_np, params, device, torch.float64))
        ref = cell.reference.register(built[1], scan_np, req.init_T, params, device,
                                      torch.float64)
        gap, k = pose_gap(T, ref, box_corners(scan_np))
        e2g = e2_gap(e2, ref)
        early = early_stop_step(iterations, k, ref, tol)
        worst, worst_e2 = max(worst, gap), max(worst_e2, e2g)
        worst_early = max(worst_early, early)
        bounds.append(loop_bound_ms(ref.counts))
        lines.append(f"request {req.index}: iterations {iterations} (reference "
                     f"{ref.iterations}; its pose after {k} updates), pose gap {gap:.3e} m, "
                     f"e2 {e2[-1:]} (reference {ref.e2[-1:]}), gap {e2g:.3e}; steps / tol "
                     f"{[round(x / tol, 4) for x in dx[-3:]]} (reference "
                     f"{[round(x / tol, 4) for x in ref.dx_norms[-3:]]}), early stop {early:.4f}")
    numbers = {"pose_gap_m": {"value": worst, "limit": float(limits["pose_gap_m"])},
               "e2_gap": {"value": worst_e2, "limit": float(limits["e2_gap"])},
               "early_stop_step": {"value": worst_early,
                                   "limit": float(limits["early_stop_step"])}}
    return numbers, lines, (sum(bounds) / len(bounds) if bounds else None)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, *, program=None,
        started: float | None = None) -> dict:
    """One run of ``cell``: the result line's object. ``program`` is the
    solver adapter the window drives (the cell's own by default)."""
    import torch

    from perfbench import trace as tr

    started = time.time() if started is None else started
    program = cell.solver if program is None else program
    cuda = torch.device(device).type == "cuda"
    precision = cell.config["precision"]
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {sorted(PRECISIONS)}")
    torch.backends.cuda.matmul.allow_tf32 = PRECISIONS[precision]
    torch.backends.cudnn.allow_tf32 = PRECISIONS[precision]
    # One client is one host thread: no idle intra-op workers that spin
    # between requests. The reference, after the window, gets them back.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    streams = gen.seed_streams(seed)
    pool = gen.make_pool(cell.config, cell.traffic, streams)
    log(f"{cell.name} seed {seed}: pool made at {time.time() - started:.2f} s")
    voxel = float(cell.config["params"].get("voxel_size", 1.0))
    per_request = bool(cell.traffic["set_target_per_request"])
    solver = program.make(cell.config["params"], device)
    if not per_request:
        program.set_target(solver, pool.maps[0])
        sync()
    log(f"solver made, target set at {time.time() - started:.2f} s")
    buffers = gen.Buffers(pool)

    def execute(req, spans=False):
        """One request; returns ``(latency s, T, iterations, e2, step norms)``."""
        def span(name):
            return torch.profiler.record_function(name) if spans else contextlib.nullcontext()

        map_np, scan_np = buffers.fill(pool, req)  # client work, before the clock
        t0 = time.perf_counter()
        if per_request:
            with span("pb.set_target"):
                program.set_target(solver, map_np)
                if spans:
                    sync()  # the span closes when the build has run
        with span("pb.align"):
            T = program.align(solver, scan_np, req.init_T)
        latency = time.perf_counter() - t0
        return (latency, T) + program.outcome(solver)

    warm = gen.Requests(pool, cell.traffic, voxel, streams["warmup"])
    for _ in range(int(cell.traffic["warmup_requests"])):
        execute(warm.next())
    sync()
    gc.collect()
    gc.freeze()

    requests = gen.Requests(pool, cell.traffic, voxel, streams["requests"])
    done, latencies = [], []
    probe = host_probe_ms()
    setup_s = time.time() - started
    log(f"warmed up; the window opens at {setup_s:.2f} s")
    profiler = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))
    with profiler as prof:
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            if trace and len(done) >= int(cell.traffic["traced_requests"]):
                break
            latency, *out = execute(req := requests.next(), spans=trace)
            latencies.append(latency)
            done.append((req, *out))
        window_s = time.perf_counter() - w0
    log(f"host probe: {probe:.2f} ms before the window, {host_probe_ms():.2f} ms after")
    gc.unfreeze()
    torch.set_num_threads(threads)
    failed = sum(1 for d in done if not np.all(np.isfinite(d[1])))

    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    del solver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    log(f"window closed: {len(done)} requests in {window_s:.3f} s; peak {peak} bytes")
    t_check = time.perf_counter()
    numbers, lines, bound = check(cell, pool, done, streams["sample"], device)
    log(f"reference compared {len(lines)} requests in {time.perf_counter() - t_check:.2f} s")
    correct = all(v["value"] <= v["limit"] for v in numbers.values()) and failed == 0
    for line in lines:
        log(line)

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak,
                   "power_limit": power_limit() if cuda else None}
    result = {"correct": correct, "attempted": len(done), "failed": failed}
    if trace:
        tr_data = tr.collect(prof)
        ctx = tr.Context(trace=tr_data, iterations=[d[2] for d in done],
                         loop_kernel=program.LOOP_KERNEL, bound_ms=bound,
                         latencies_ms=[1e3 * x for x in latencies])
        metrics = {}
        for entry, reader in cell.per_layer:
            value = reader.read(ctx) if tr_data.spans else None
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        lo, hi = tr_data.window if tr_data.spans else (0.0, 0.0)
        device_info.update(busy_s=tr_data.busy(lo, hi), window_s=hi - lo)
        result.update(metrics=metrics, device=device_info)
        if tr_data.spans:
            result["breakdown"] = tr.breakdown(tr_data)
    else:
        values = {"reg_per_s": stats.rate(len(done), window_s),
                  "reg_p95_ms": 1e3 * stats.p95(latencies), "setup_s": setup_s}
        result.update(metrics={m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                               for m in cell.end_to_end},
                      device=device_info)
    result["checks"] = numbers
    return result


def check_lines(result: dict) -> list[str]:
    """The numbers compared, each beside its limit: the run's last lines."""
    return [f"check {name}: {v['value']:.6e} (limit {v['limit']:.6e})"
            for name, v in result["checks"].items()] + [f"correct: {result['correct']}"]
