"""On the card (marker ``card``; skipped without one): the cells at a small
size, sound; and at their own size with the TF32 control in the program's
place, which no limit may let pass.

    python -m pytest perfbench/tests -m card -rP
"""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.control import ReferenceProgram
from perfbench.tests.small import small_cell

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_card_run_is_correct(card, workload):
    result = harness.run(small_cell(workload), 31, 1.0, True, card)
    print(workload, result["checks"])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_tf32_control_is_not_correct(card, workload):
    cell = harness.resolve(harness.load_benchmark(), workload)
    cell.traffic.update(warmup_requests=1, checked_requests=2)
    result = harness.run(cell, 32, 1.0, False, card, program=ReferenceProgram(cell.reference))
    print(workload, result["checks"])
    assert not result["correct"], result["checks"]
