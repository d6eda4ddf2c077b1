"""On a card: one short run of each one-card cell of ``BENCHMARK.json``
comes out correct, with the contract's result line."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cell", [w["name"] for w in harness.spec()["workloads"] if w["chips"] == 1])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, cell, trace):
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace",
         str(trace)], cwd=str(harness.ROOT), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert res["device"]["busy_s"] > 0 and "breakdown" in res
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
