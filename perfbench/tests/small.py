"""Cells of ``BENCHMARK.json`` cut to a size a CPU test holds: a 40 m
tile of 60,000 points (the full tile's density), scans of 5,000 points,
few requests. The program runs its plain versions on the CPU."""

from __future__ import annotations

import copy

from perfbench import harness

SMALL = {"scene": {"generator": "make_city_map", "points": 60000, "extent": 40.0},
         "scan": {"points": 5000, "offset": [0.0, 0.0, 0.3], "sigma": 0.005}}
TRAFFIC = {"warmup_requests": 1, "checked_requests": 3, "traced_requests": 4}


def small_cell(workload: str, **traffic) -> harness.Cell:
    cell = harness.resolve(harness.load_benchmark(), workload)
    cell.config.update(copy.deepcopy(SMALL))
    cell.traffic.update(TRAFFIC, **traffic)
    return cell
