"""The readers of the SpMV-scan solve's host work (the
``spmv.validate_ms_per_solve``, ``spmv.upload_ms_per_solve`` and
``spmv.download_ms_per_solve`` metrics) on a hand-made trace, and on a
traced CPU run of the ``pwtk-spmv`` cell."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import devtrace, harness
from perfbench.tests.tiny import run_cell_in_child

MS = 1e-3
READERS = ["spmv.validate_ms_per_solve", "spmv.upload_ms_per_solve",
           "spmv.download_ms_per_solve"]

#: two solves, each with its four parts; one upload outside any solve,
#: which no solve owns
HOST = [
    ("spmv_scan.solve", 0 * MS, 100 * MS),
    ("spmv_scan.validate", 1 * MS, 4 * MS),
    ("spmv_scan.upload", 5 * MS, 45 * MS),
    ("spmv_scan.run", 46 * MS, 86 * MS),
    ("spmv_scan.download", 87 * MS, 99 * MS),
    ("spmv_scan.solve", 200 * MS, 300 * MS),
    ("spmv_scan.validate", 201 * MS, 206 * MS),
    ("spmv_scan.upload", 207 * MS, 257 * MS),
    ("spmv_scan.run", 258 * MS, 288 * MS),
    ("spmv_scan.download", 289 * MS, 299 * MS),
    ("spmv_scan.upload", 400 * MS, 420 * MS),
]


def _read(metric: str, run):
    return harness.load_module("metrics", metric).read(run)


def _run(host):
    return SimpleNamespace(trace=devtrace.DeviceTrace(0.0, 1.0, ops=[],
                                                      host=list(host)))


@pytest.mark.parametrize("metric,want", [
    ("spmv.validate_ms_per_solve", (3 + 5) / 2),
    ("spmv.upload_ms_per_solve", (40 + 50) / 2),
    ("spmv.download_ms_per_solve", (12 + 10) / 2)])
def test_each_part_counts_only_inside_the_solves(metric, want):
    assert _read(metric, _run(HOST)) == pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("case", ["no trace", "no solves", "no part"])
def test_none_where_the_ranges_are_absent(metric, case):
    if case == "no trace":
        run = SimpleNamespace(trace=None)
    elif case == "no solves":
        run = _run([h for h in HOST if h[0] != "spmv_scan.solve"])
    else:
        part = metric.split(".")[1].split("_")[0]
        run = _run([h for h in HOST if h[0] != f"spmv_scan.{part}"])
    assert _read(metric, run) is None


def test_a_traced_cpu_run_reads_the_program_s_ranges():
    out = run_cell_in_child("pwtk-spmv", trace=True)
    for name in READERS + ["spmv.outside_run_pct"]:
        assert out["metrics"][name]["value"] > 0, name
