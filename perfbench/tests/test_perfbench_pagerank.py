"""GAP ``pr``'s cell at a tiny size on the CPU: the generator, the plain
reference against a straightforward dense count, the planted faults (each
turns ``correct`` false in a child that registers them), the bfloat16
control, and the readers over a traced run."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from perfbench import devtrace, harness, kron, pagerank_hooks
from perfbench.reference import pagerank as ref
from perfbench.tests.tiny import ROOT, load_cell, run_cell, sizes

CELL = "pr-kron26"


def _child(fault: str | None) -> dict:
    env = dict(os.environ)
    env.pop("PERFBENCH_FAULT", None)
    if fault:
        env["PERFBENCH_FAULT"] = fault
    code = ("import json; import perfbench.pagerank_hooks; "
            "from perfbench.tests.tiny import run_cell; "
            f"out = run_cell({CELL!r}); print(json.dumps(out))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", (None,) + pagerank_hooks.FAULTS)
def test_a_planted_fault_turns_correct_false(fault):
    out = _child(fault)
    assert out["attempted"] >= 1 and out["failed"] == 0 and out["checks"]
    assert harness.judge(out["checks"], out["failed"]) is (fault is None), \
        out["checks"]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3, 2 ** 33 + 17])
def test_the_control_fails_by_ten_times(seed):
    ctx = harness.Context(load_cell(CELL), seed, "cpu", sizes(CELL))
    rows = pagerank_hooks.control_readings(ctx)
    assert max(r["value"] / r["limit"] for r in rows) >= 10, rows


def test_the_generator_repeats_for_a_seed_and_moves_with_it():
    a = kron.kron_edges(9, 16, 2 ** 40 + 7, "cpu")
    b = kron.kron_edges(9, 16, 2 ** 40 + 7, "cpu")
    c = kron.kron_edges(9, 16, 2 ** 40 + 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (16 << 9,) and int(a[0].max()) < 512


@pytest.mark.parametrize("chunk_pairs", [1 << 27, 3000])
def test_the_adjacency_is_the_squished_symmetric_graph(chunk_pairs):
    src, dst = kron.kron_edges(8, 16, 3, "cpu")
    adj = ref.Adjacency(src, dst, 256, chunk_pairs=chunk_pairs)
    dense = torch.zeros(256, 256, dtype=torch.bool)
    dense[src.long(), dst.long()] = True
    dense |= dense.t().clone()
    dense.fill_diagonal_(False)
    got = torch.zeros_like(dense)
    for rows, cols in adj.chunks:
        got[rows.long(), cols.long()] = True
    assert torch.equal(got, dense) and adj.entries == int(dense.sum())
    assert torch.equal(adj.deg, dense.sum(1))


def test_the_reference_solve_stops_at_gaps_sweep():
    src, dst = kron.kron_edges(9, 16, 11, "cpu")
    adj = ref.Adjacency(src, dst, 512)
    stop, kept = ref.solve(adj, 0.85, 1e-4, 1000, keep=(1, 3))
    assert 3 < stop < 40 and set(kept) == {1, 3}
    again, more = ref.solve(adj, 0.85, 1e-4, 1000, keep=(stop + 1,))
    assert again == stop
    assert ref.residual(adj, more[stop + 1], 0.85) < 1e-4
    capped, _ = ref.solve(adj, 0.85, 0.0, 2)
    assert capped == 2


def test_the_readers_read_a_traced_run():
    """On the CPU the program's counters are read; the readers of the
    card's trace find no card work and leave their metrics out."""
    out = run_cell(CELL, trace=True)
    got = out["metrics"]
    assert "pr.sweeps_per_solve" in got, got
    for name in ("pr.sync_us_per_sweep", "pr.kernel_roofline_pct"):
        assert name not in got, got
    assert 3 < got["pr.sweeps_per_solve"]["value"] < 40
    assert harness.judge(out["checks"], out["failed"])


MS = 1e-3


@pytest.mark.parametrize("case", ["kernels end inside", "kernels end before",
                                  "no kernel"])
def test_the_sync_reader_counts_the_read_alone(case):
    """Three sweeps, each a pull and an update and then the host's read:
    only the range's tail after the sweep's last kernel counts (the copy
    down is part of the read), or the whole range where the kernels ended
    before it opened."""
    ops, host = [], []
    for k in range(3):
        t = 10 * MS * k
        ops += [("pull_tiles", t, t + 6 * MS),
                ("update_scores", t + 6 * MS, t + 7 * MS),
                ("Memcpy DtoH (Device -> Pinned)", t + 7 * MS,
                 t + 7.01 * MS)]
        opened = t + (1 * MS if case == "kernels end inside" else 8 * MS)
        host.append(("pagerank.converged", opened, t + 7.2 * MS
                     if case == "kernels end inside" else t + 8.5 * MS))
    if case == "no kernel":
        ops = [o for o in ops if o[0].startswith("Memcpy")]
    tr = devtrace.DeviceTrace(0.0, 1.0, ops=ops, host=host)
    run = SimpleNamespace(trace=tr, units=3)
    got = harness.load_module("metrics", "pr.sync_us_per_sweep").read(run)
    if case == "no kernel":
        assert got is None
    else:
        want = 200.0 if case == "kernels end inside" else 500.0
        assert got == pytest.approx(want)
