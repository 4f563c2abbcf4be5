"""A whole run on the CPU at a small size, the harness's look for a card
skipped: the result line's keys, the traced run's reduction, the faults the
comparison must catch, and the refusals of the entry point."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.faults import FAULTS, Broken
from perfbench.tests.small import small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload, metrics", [
    ("vplane_b01.track", {"reg_per_s", "reg_p95_ms", "setup_s"}),
    ("plane_icp_b01.track", {"reg_per_s", "reg_p95_ms", "setup_s"}),
    ("plane_icp_b01.rebuild", {"reg_per_s", "setup_s"})])
def test_untraced_result_line(workload, metrics):
    """Each cell reports the end-to-end metrics that list it, and no other."""
    cell = small_cell(workload)
    result = harness.run(cell, 21, 0.5, False, "cpu")
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert set(result["metrics"]) == metrics
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    value, limit = result["checks"]["pose_gap_m"]["value"], result["checks"]["pose_gap_m"]["limit"]
    assert 0 <= value <= limit
    assert harness.check_lines(result)[-1] == "correct: True"
    json.dumps(result)


def test_traced_result_line():
    cell = small_cell("plane_icp_b01.rebuild")
    result = harness.run(cell, 22, 120.0, True, "cpu")
    names = set(result["metrics"])
    assert {"set_target_ms", "align_ms", "reg_p95_traced_ms", "gn_iters",
            "align_host_ms"} <= names
    assert result["metrics"]["reg_p95_traced_ms"]["value"] >= result["metrics"]["align_ms"]["value"]
    assert "reg_per_s" not in names
    assert result["attempted"] == cell.traffic["traced_requests"]
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks" and result["correct"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", ["vplane_b01.track", "plane_icp_b01.rebuild"])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    cell = small_cell(workload)
    result = harness.run(cell, 23, 0.5, False, "cpu", program=Broken(cell.solver, fault))
    assert not result["correct"], result["checks"]


def test_early_stop_step():
    """0 with the reference or after it; one update short, how far past the
    gate the step left out lay; two short, never sound."""
    import math

    from perfbench.reference._common import GNResult

    ref = GNResult(dx_norms=[0.1, 0.01, 0.0012, 0.0004], iterations=4, converged=True)
    assert ref.updates == 3
    assert harness.early_stop_step(4, 3, ref, 1e-3) == 0.0
    assert harness.early_stop_step(5, 5, ref, 1e-3) == 0.0
    assert harness.early_stop_step(3, 2, ref, 1e-3) == pytest.approx(0.2)
    assert harness.early_stop_step(4, 2, ref, 1e-3) == pytest.approx(0.2)
    assert harness.early_stop_step(2, 2, ref, 1e-3) == math.inf


def test_banned_modules_by_whole_top_level_name():
    assert harness.banned_modules(["jax.numpy", "point_cloud_registration_tpu.ops", "numpy"]) == [
        "jax", "point_cloud_registration_tpu"]
    assert harness.banned_modules(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]
    assert harness.banned_modules(["point_cloud_registration_tpu_torch.models",
                                   "jaxtyping", "torch"]) == []


def test_a_cpu_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from perfbench import harness; from perfbench.tests.small import small_cell;"
            "r = harness.run(small_cell('vplane_b01.track'), 1, 0.2, False, 'cpu');"
            "print(harness.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_entry_point_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "vplane_b01.track",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_entry_point_refuses_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "vplane_b01.track",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
