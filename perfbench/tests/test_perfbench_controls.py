"""Each cell's control, the plain reference one precision lower
(bfloat16 for the configuration's float32), fails the comparison at a
size a test run holds, on three seeds; the reference in float32 itself
passes it."""

from __future__ import annotations

import pytest
import torch

from perfbench import controls, harness, inputs
from perfbench.reference import compare
from perfbench.reference import heat as heat_ref
from perfbench.tests.tiny import cells, load_cell, sizes


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3, 2 ** 33 + 17])
def test_control_fails_a_number(cell, seed):
    ctx = harness.Context(load_cell(cell), seed, "cpu", sizes(cell))
    rows = controls.readings(ctx)
    assert rows and any(r["value"] > r["limit"] for r in rows), rows


def test_reference_agrees_with_itself_at_the_limit():
    v = inputs.heat_variants(7, 1, 0.0, 100.0)[0]
    a = heat_ref.solve(24, 20, 8, 12, v["ic"], v["bc"], alpha=0.4)
    b = heat_ref.solve(24, 20, 8, 12, v["ic"], v["bc"], alpha=0.4)
    assert compare.max_ulp(a, b) == 0
    assert compare.max_ulp(a, a.to(torch.bfloat16)) > 10
