"""A whole run of each cell (but its look for a card) at a tiny size on
the CPU: sound, it comes out correct; with the timed path broken
underneath, in each way the cell can be broken, it does not."""

from __future__ import annotations

import pytest

from perfbench import faults, harness
from perfbench.tests.tiny import cells, run_cell_in_child

CASES = [(cell, fault) for cell in cells()
         for fault in (None,) + faults.FAULTS[
             harness.load_json("workloads", cell)["driver"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_turns_correct_false(cell, fault):
    out = run_cell_in_child(cell, fault)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert not out.get("forbidden"), out["forbidden"]
    assert out["checks"], out
    assert harness.judge(out["checks"], out["failed"]) is (fault is None), \
        out["checks"]


def test_a_failed_solve_turns_correct_false():
    assert not harness.judge([{"name": "x", "value": 0, "limit": 1}], 1)
    assert not harness.judge([], 0)
