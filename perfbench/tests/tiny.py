"""A run of a cell on the CPU at the size its workload file gives for tests
(``test_sizes``): the harness's whole run but its look for a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from perfbench import harness

ROOT = str(harness.ROOT)


def cells() -> list[str]:
    """Every cell with a workload file, in ``BENCHMARK.json`` or not yet."""
    return sorted(p.stem for p in (harness.HERE / "workloads").glob("*.json"))


def load_cell(name: str) -> harness.Cell:
    """The cell ``name`` as ``BENCHMARK.json`` declares it, else as its
    workload file alone would (one chip, or a card a rank)."""
    if name in {w["name"] for w in harness.spec()["workloads"]}:
        return harness.Cell.load(name)
    w = harness.load_json("workloads", name)
    return harness.Cell.load(name, {
        "name": name, "config": w["config"], "traffic": w["traffic"],
        "chips": int(w.get("ranks", 1)), "why": "a test run"})


def sizes(cell: str) -> dict:
    return harness.load_json("workloads", cell)["test_sizes"]


def run_cell(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
             trace: bool = False) -> dict:
    """The result fields of one run of ``cell`` in this process (a gang:
    gloo ranks)."""
    c = load_cell(cell)
    ctx = harness.Context(c, seed, "cpu", sizes(cell))
    ranks = int(c.workload.get("ranks", 1))
    if ranks > 1:
        from perfbench import gang

        out, _ = gang.run(ctx, seconds, trace, time.time(), ranks,
                          timeout=240)
        return out
    return harness.measure(ctx, seconds, trace, time.time())


def run_cell_in_child(cell: str, fault: str | None = None, **kw) -> dict:
    """``run_cell`` in a fresh process (with ``PERFBENCH_FAULT`` set to
    ``fault``), so that a planted fault stays there."""
    env = dict(os.environ)
    env.pop("PERFBENCH_FAULT", None)
    if fault:
        env["PERFBENCH_FAULT"] = fault
    code = ("import json, sys; from perfbench.tests.tiny import run_cell; "
            f"out = run_cell({cell!r}, **{kw!r}); out.pop('breakdown', None);"
            " print(json.dumps(out))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
