"""The readers of the heat solve's host work (``spans.py`` and the
``heat.host_ms_per_solve``, ``heat.admit_ms_per_solve`` and
``heat.dispatch_us_per_launch`` metrics) on hand-made traces, and on a
traced CPU run of each heat cell."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import devtrace, harness, spans
from perfbench.tests.tiny import run_cell_in_child

MS = 1e-3


def _read(metric: str, run):
    return harness.load_module("metrics", metric).read(run)


def _run(host, ops=(), launches=None):
    tr = devtrace.DeviceTrace(0.0, 1.0, ops=sorted(ops, key=lambda o: o[1]),
                              host=list(host))
    counters = {} if launches is None else {"heat.launches": launches}
    return SimpleNamespace(trace=tr, counters=counters)


#: two solves: the first served after a demotion (two overlapping
#: ``heat.run``, each holding its phase span), the second plain; one
#: ``admission.admit`` outside any solve, which no solve owns
HOST = [
    ("heat.solve", 0 * MS, 10 * MS),
    ("admission.admit", 0.5 * MS, 1.5 * MS),
    ("heat.run", 2 * MS, 5 * MS),
    ("heat.run", 4 * MS, 8 * MS),
    ("gpu computation shared", 4.5 * MS, 7.5 * MS),
    ("heat.launch_loop", 4.6 * MS, 5.0 * MS),
    ("heat.solve", 20 * MS, 30 * MS),
    ("admission.admit", 20.5 * MS, 21 * MS),
    ("heat.run", 22 * MS, 29 * MS),
    ("heat.launch_loop", 22.1 * MS, 22.6 * MS),
    ("admission.admit", 40 * MS, 41 * MS),
]


def test_covered_is_the_union_inside_the_interval():
    ivs = sorted([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (8.0, 12.0)])
    assert spans.covered(1.5, 10.0, ivs) == pytest.approx(1.5 + 1.0 + 2.0)
    assert spans.covered(3.0, 5.0, ivs) == 0.0


@pytest.mark.parametrize("metric", ["heat.host_ms_per_solve",
                                    "heat.host_ms_per_solve.l2"])
def test_host_time_is_the_solves_self_time_outside_their_runs(metric):
    # (10 - 6) + (10 - 7) ms over two solves: overlapping runs count once
    assert _read(metric, _run(HOST)) == pytest.approx(3.5)


def test_admission_counts_only_inside_the_solves():
    assert _read("heat.admit_ms_per_solve", _run(HOST)) == \
        pytest.approx((1.0 + 0.5) / 2)


def test_dispatch_is_the_launch_loops_over_the_launches():
    run = _run(HOST, launches=9)
    assert _read("heat.dispatch_us_per_launch.l2", run) == \
        pytest.approx(1e3 * (0.4 + 0.5) / 9)


@pytest.mark.parametrize("metric", ["heat.host_ms_per_solve",
                                    "heat.host_ms_per_solve.l2",
                                    "heat.admit_ms_per_solve",
                                    "heat.dispatch_us_per_launch.l2"])
@pytest.mark.parametrize("case", ["no trace", "no spans", "no launches"])
def test_none_where_the_spans_are_absent(metric, case):
    if case == "no trace":
        run = SimpleNamespace(trace=None, counters={"heat.launches": 9})
    elif case == "no spans":
        run = _run([("aten::add", 0.0, 0.5), ("heat.run", 0.1, 0.2)],
                   launches=9)
    else:
        run = _run(HOST, launches=0)
    value = _read(metric, run)
    if case == "no launches" and "dispatch" not in metric:
        assert value is not None
    else:
        assert value is None


def test_an_idle_gap_reads_as_the_innermost_program_span():
    ops = [("heat_ksteps", 0.0, 4.7 * MS), ("heat_ksteps", 4.9 * MS, 1.0)]
    gaps = dict(_run(HOST, ops=ops).trace.breakdown()["idle_gaps"])
    assert gaps == {"heat.launch_loop": pytest.approx(0.2 * MS)}


@pytest.mark.parametrize("cell,metrics", [
    ("heat4000-o8", ["heat.host_ms_per_solve", "heat.admit_ms_per_solve"]),
    ("heat512-o8", ["heat.host_ms_per_solve.l2"])])
def test_a_traced_cpu_run_reads_the_program_s_spans(cell, metrics):
    """On the CPU the solve takes the plain version: no launch loop, so
    ``heat.dispatch_us_per_launch.l2`` reads nothing there."""
    out = run_cell_in_child(cell, trace=True)
    for name in metrics:
        assert out["metrics"][name]["value"] > 0, name
    assert "heat.dispatch_us_per_launch.l2" not in out["metrics"]
