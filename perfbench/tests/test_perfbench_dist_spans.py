"""The readers of the distributed solve's per-layer metrics
(``dist.kernel_roofline_pct``, ``dist.outside_steps_pct``,
``dist.enqueue_us_per_step``) on hand-made traces, and a traced CPU run
of the gang cell ``hw5-gang4-16k-o8`` (a gloo gang at its test sizes)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import devtrace, harness
from perfbench.reference import costs
from perfbench.tests.tiny import run_cell_in_child

MS = 1e-3
#: 2 x 2 ranks over a 100 x 80 grid: 50 x 40 blocks, 58 x 48 padded
PARAMS = {"nx": 80, "ny": 100, "ranks": 4, "grid_method": 2, "order": 8,
          "dtype": "float32", "iters": 3}

#: two solves of 3 steps; the second's gather and download are longer
HOST = [
    ("dist.solve", 0 * MS, 10 * MS),
    ("dist.prepare", 0.2 * MS, 0.5 * MS),
    ("dist.steps", 1 * MS, 7 * MS),
    ("dist.enqueue", 1.1 * MS, 2.0 * MS),
    ("dist.gather", 7.5 * MS, 8 * MS),
    ("dist.download", 8 * MS, 9.5 * MS),
    ("dist.solve", 20 * MS, 32 * MS),
    ("dist.prepare", 20.2 * MS, 20.4 * MS),
    ("dist.steps", 21 * MS, 27 * MS),
    ("dist.enqueue", 21.1 * MS, 21.6 * MS),
    ("dist.gather", 27.5 * MS, 29 * MS),
    ("dist.download", 29 * MS, 31.5 * MS),
]
#: three heat launches a solve inside its steps, one outside any (a
#: probe's), NCCL and copies beside them
OPS = [("void heat_ksteps<float, 8, 1>", 2 * MS, 3 * MS),
       ("ncclDevKernel_SendRecv", 3 * MS, 3.2 * MS),
       ("void heat_ksteps<float, 8, 1>", 3.5 * MS, 4.5 * MS),
       ("void heat_ksteps<float, 8, 1>", 5 * MS, 6 * MS),
       ("Memcpy DtoH (Device -> Pinned)", 8 * MS, 9 * MS),
       ("void heat_ksteps<float, 8, 1>", 22 * MS, 23 * MS),
       ("void heat_ksteps<float, 8, 1>", 23.5 * MS, 24.5 * MS),
       ("void heat_ksteps<float, 8, 1>", 25 * MS, 26 * MS),
       ("void heat_ksteps<float, 8, 1>", 40 * MS, 41 * MS)]


def _read(metric: str, run):
    return harness.load_module("metrics", metric).read(run)


def _run(host=HOST, ops=OPS):
    tr = devtrace.DeviceTrace(0.0, 1.0, ops=sorted(ops, key=lambda o: o[1]),
                              host=list(host))
    return SimpleNamespace(trace=tr, params=dict(PARAMS), counters={},
                           spans={})


def test_roofline_is_the_launches_least_time_over_their_device_time():
    nbytes = 6 * (costs.heat_bytes(58, 48) + costs.heat_bytes(50, 40)) / 2
    least, bound = costs.least_seconds(nbytes,
                                       costs.heat_flops(50, 40, 8, 6))
    assert bound == "bytes"
    assert _read("dist.kernel_roofline_pct", _run()) == \
        pytest.approx(100 * least / (6 * MS))


def test_outside_steps_is_the_solves_time_beyond_their_steps():
    assert _read("dist.outside_steps_pct", _run()) == \
        pytest.approx(100 * (4 + 6) / (10 + 12))


def test_enqueue_is_the_loops_host_time_over_their_steps():
    assert _read("dist.enqueue_us_per_step", _run()) == \
        pytest.approx(1e3 * (0.9 + 0.5) / 6)


METRICS = ["dist.kernel_roofline_pct", "dist.outside_steps_pct",
           "dist.enqueue_us_per_step"]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", ["no trace", "no ranges"])
def test_none_where_the_ranges_are_absent(metric, case):
    """As at a program that records none of the ranges: each reads
    nothing, and raises nothing."""
    if case == "no trace":
        run = SimpleNamespace(trace=None, params=dict(PARAMS))
    else:
        run = _run(host=[("aten::cat", 0.0, 0.5), ("heat.run", 0.1, 0.2)])
    assert _read(metric, run) is None


def test_roofline_reads_nothing_without_heat_launches_in_the_steps():
    ops = [o for o in OPS if "heat" not in o[0] or o[1] >= 40 * MS]
    assert _read("dist.kernel_roofline_pct", _run(ops=ops)) is None


def test_a_traced_cpu_run_of_the_gang_cell_reads_the_program_s_ranges():
    """At its test sizes on the CPU (a gloo gang of 4): the host ranges
    give values; the device's metrics have no card to read."""
    out = run_cell_in_child("hw5-gang4-16k-o8", trace=True)
    assert harness.judge(out["checks"], out["failed"]), out["checks"]
    for name in ("dist.outside_steps_pct", "dist.enqueue_us_per_step"):
        assert out["metrics"][name]["value"] > 0, name
    for name in ("dist.kernel_roofline_pct", "dist.device_idle_pct",
                 "dist.nccl_pct"):
        assert name not in out["metrics"], name
