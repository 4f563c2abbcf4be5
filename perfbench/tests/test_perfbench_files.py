"""BENCHMARK.json against the contract's shape, and every cell resolved to
its files by name; a new cell from new files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} == {"reg_per_s", "reg_p95_ms", "setup_s"}


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_metrics_shape():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    cell = harness.resolve(BENCH, workload)
    for fn in ("make", "set_target", "align", "outcome"):
        assert callable(getattr(cell.solver, fn))
    assert callable(cell.reference.build) and callable(cell.reference.register)
    assert cell.per_layer and all(callable(reader.read) for _, reader in cell.per_layer)
    assert set(cell.config["correct"]) == {"pose_gap_m", "e2_gap", "early_stop_step"}
    assert cell.config["precision"] in harness.PRECISIONS
    conf = {c["name"]: c for c in BENCH["configs"]}[cell.config["name"]]
    assert conf["file"].startswith("perfbench/configs/") and conf["reduced"] == cell.config["reduced"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.resolve(BENCH, "no_such.cell")


@pytest.mark.parametrize("arrival", [{"clients": 4}, {"loop": "open"}, {"clients": None}])
def test_a_mix_the_harness_does_not_run_is_refused(tmp_path, arrival):
    """A traffic file may not describe arrivals that the harness would not
    run: only a closed loop of one client."""
    shutil.copytree(harness.ROOT / "perfbench" / "traffic", tmp_path / "perfbench" / "traffic")
    (tmp_path / "perfbench" / "configs").mkdir()
    shutil.copy(harness.ROOT / "perfbench/configs/vplane_b01.json", tmp_path / "perfbench/configs")
    mix = json.loads((harness.ROOT / "perfbench/traffic/track.json").read_text())
    mix.update(arrival)
    (tmp_path / "perfbench/traffic/track.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="closed"):
        harness.resolve(BENCH, "vplane_b01.track", root=tmp_path)


def test_a_precision_the_harness_does_not_hold_is_refused():
    from perfbench.tests.small import small_cell

    cell = small_cell("vplane_b01.track")
    cell.config["precision"] = "bfloat16"
    with pytest.raises(ValueError, match="precision"):
        harness.run(cell, 1, 0.1, False, "cpu")


def test_a_cell_from_new_files_alone(tmp_path, monkeypatch):
    """A new configuration, traffic mix and per-layer metric, each a new
    file, make a new cell that runs; no file of the benchmark changes."""
    import perfbench.metrics

    root = tmp_path
    shutil.copytree(harness.ROOT / "perfbench" / "traffic", root / "perfbench" / "traffic")
    (root / "perfbench" / "configs").mkdir()
    conf = json.loads((harness.ROOT / "perfbench/configs/vplane_b01.json").read_text())
    conf.update(name="vplane_small", scene={"generator": "make_city_map", "points": 60000,
                                            "extent": 40.0},
                scan={"points": 5000, "offset": [0.0, 0.0, 0.3], "sigma": 0.005})
    (root / "perfbench/configs/vplane_small.json").write_text(json.dumps(conf))
    mix = json.loads((harness.ROOT / "perfbench/traffic/track.json").read_text())
    mix.update(scans_per_map=2, warmup_requests=1, checked_requests=2, traced_requests=3)
    (root / "perfbench/traffic/two_scans.json").write_text(json.dumps(mix))
    metrics = tmp_path / "metrics_extra"
    metrics.mkdir()
    (metrics / "align_count.py").write_text("def read(ctx):\n"
                                            "    return len(ctx.trace.spans_named('pb.align'))\n")
    monkeypatch.setattr(perfbench.metrics, "__path__", [*perfbench.metrics.__path__, str(metrics)])
    bench = dict(BENCH, configs=[{"name": "vplane_small", "source": "s",
                                  "file": "perfbench/configs/vplane_small.json", "reduced": [],
                                  "why": "w"}],
                 workloads=[{"name": "vplane_small.two_scans", "config": "vplane_small",
                             "traffic": "two_scans", "chips": 1, "why": "w"}],
                 per_layer=[{"name": "align_count", "unit": "n", "better": "higher",
                             "source": "device_trace", "layer": "API", "moves": "reg_per_s"}])
    cell = harness.resolve(bench, "vplane_small.two_scans", root=root)
    result = harness.run(cell, 5, 1.0, True, "cpu")
    assert result["metrics"]["align_count"]["value"] == result["attempted"] >= 1
    assert result["correct"]
