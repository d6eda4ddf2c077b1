"""The port's hw4 sorts driver, its ``sort`` tune space and the five sweeps
the slice ports, against the JAX package, on the CPU.

Exact where there is a value to hold: every sort equals ``np.sort``; the
sweeps' rows carry the JAX package's columns, sizes and labels, and their
correctness columns (``ok``, ``rel_l2``) pass; ``sort_auto`` serves the
winner the ``sort`` space persisted.  Timings are CPU timings of plain
torch and no device's.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from cme213_tpu import bench as j_bench
from cme213_tpu.apps import sorts as j_sorts
from cme213_tpu_torch import models, tune_cli
from cme213_tpu_torch.apps import sorts
from cme213_tpu_torch.bench import run_all, sweeps
from cme213_tpu_torch.core import programs, trace, tune
from cme213_tpu_torch.ops.sort import sort_auto


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in (tune.KILL_ENV, "CME213_FAULTS", "CME213_CONFORMANCE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "tune.json"))
    tune.reset()
    trace.clear_events()
    yield
    tune.reset()


# ------------------------------------------------------------ the driver

def test_sort_drivers_match_the_reference(capsys):
    assert sorts.run_merge_sort(50_000)
    assert sorts.run_radix_sort(50_000, device="cpu")
    assert sorts.run_radix_sort(20_000, num_bits=4, block_size=1024,
                                run_serial=False, device="cpu")
    assert j_sorts.run_merge_sort(50_000)
    out = capsys.readouterr().out
    assert out.count("parallel merge sort:") == 2
    assert "serial radix:" in out


def test_sorts_cli_and_workload(capsys, monkeypatch):
    assert models.dispatch(["sorts", "64", "64", "30000", "0",
                            "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "parallel radix:" in out and "serial radix:" not in out
    assert sorts.main(["sorts", "--bogus"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sorts.main(["sorts"])


def test_workloads_are_the_reference_s_but_serving():
    from cme213_tpu.models import WORKLOADS as J_WORKLOADS

    assert set(J_WORKLOADS) - set(models.WORKLOADS) == set()
    assert set(models.WORKLOADS) == set(J_WORKLOADS)
    for name in ("cipher", "pagerank", "vigenere", "sorts", "serve",
                 "fleet", "chaos"):
        assert models.WORKLOADS[name].reference_unit == \
            J_WORKLOADS[name].reference_unit
        assert name in models.usage()


# ------------------------------------------------------------ tuning

def test_sort_space_gates_times_and_sort_auto_serves_the_winner():
    rep = tune.run("sort", n=3000, runs=1, device="cpu")
    assert rep["shape_class"] == f"n{programs.canonical_size(3000)}"
    assert [t["candidate"] for t in rep["trials"]] == ["lax", "radix",
                                                       "bitonic"]
    assert all(t["ok"] for t in rep["trials"])
    probes = {(e["rung"], e["ok"]) for e in trace.events("conformance-probe")
              if e["op"] == "sort"}
    assert probes == {("radix", True), ("bitonic", True)}
    keys = np.random.default_rng(0).integers(0, 2**32, 3000,
                                             dtype=np.uint32)
    np.testing.assert_array_equal(sort_auto(torch.from_numpy(keys)).numpy(),
                                  np.sort(keys))
    hit = trace.events("tune-hit")[-1]
    assert json.loads(hit["statics"]) == rep["winner"]["statics"]


@pytest.mark.parametrize("kernel", ["radix", "bitonic", "lax"])
def test_sort_auto_dispatches_each_winner(kernel, monkeypatch):
    n = 5000
    shape = f"n{programs.canonical_size(n)}"
    tune.store("sort", shape, "uint32", statics={"kernel": kernel},
               candidate=kernel, ms=1.0, gbs=1.0, device="cpu")
    called = []
    # the module itself: ``ops.sort`` is the re-exported sort function
    sort_module = importlib.import_module("cme213_tpu_torch.ops.sort")
    for name in ("radix_sort", "bitonic_sort", "sort"):
        real = getattr(sort_module, name)
        monkeypatch.setattr(sort_module, name,
                            lambda k, _r=real, _n=name: called.append(_n)
                            or _r(k))
    keys = np.random.default_rng(1).integers(0, 2**32, n, dtype=np.uint32)
    out = sort_auto(torch.from_numpy(keys))
    np.testing.assert_array_equal(out.numpy(), np.sort(keys))
    assert called == [{"radix": "radix_sort", "bitonic": "bitonic_sort",
                       "lax": "sort"}[kernel]]
    monkeypatch.setenv(tune.KILL_ENV, "0")
    called.clear()
    sort_auto(torch.from_numpy(keys))
    assert called == ["sort"]


def test_tune_cli_runs_the_sort_space(capsys):
    assert tune_cli.main(["run", "--op", "sort", "--n", "2048", "--runs",
                          "1", "--device=cpu", "--json"]) == 0
    (rep,) = json.loads(capsys.readouterr().out)
    assert rep["op"] == "sort" and rep["dtype"] == "uint32"
    assert tune.build_space("serve.sort", device="cpu").op == "serve.sort"


# ------------------------------------------------------------ the sweeps

def _schema(rows):
    return [list(r) for r in rows]


def test_cipher_sweep_is_the_reference_table(tmp_path):
    rows = sweeps.cipher_vector_length_sweep(steps=2, max_bytes=1 << 16,
                                             device="cpu")
    ref = j_bench.cipher_vector_length_sweep(steps=2, max_bytes=1 << 16)
    assert _schema(rows) == _schema(ref)
    assert [r["length"] for r in rows] == [r["length"] for r in ref]
    assert all(r["char_gbs"] > 0 and r["pct_peak"] == "" for r in rows)
    f = tmp_path / "c.csv"
    sweeps.write_csv(rows, str(f))
    assert f.read_text().count("\n") == 3


def test_pagerank_sweep_is_the_reference_table():
    rows = sweeps.pagerank_avg_edges_sweep(num_nodes=2048,
                                           edges_range=range(2, 4),
                                           iterations=4, device="cpu")
    ref = j_bench.pagerank_avg_edges_sweep(num_nodes=2048,
                                           edges_range=range(2, 4),
                                           iterations=4)
    assert _schema(rows) == _schema(ref)
    assert [(r["avg_edges"], r["bytes"]) for r in rows] == \
        [(r["avg_edges"], r["bytes"]) for r in ref]
    assert all(r["gbs"] > 0 for r in rows)


def test_sort_thread_sweep_is_the_reference_table():
    rows = sweeps.sort_thread_sweep(num_elements=20_000, threads=(1, 2),
                                    device="cpu")
    ref = j_bench.sort_thread_sweep(num_elements=20_000, threads=(1, 2))
    assert _schema(rows) == _schema(ref)
    assert [r["threads"] for r in rows] == [1, 2]
    assert all(r["pct_peak"] == "" for r in rows)  # host work


def test_sort_sweep_rows_are_exact():
    from cme213_tpu.bench.sweeps import sort_sweep as j_sort_sweep

    rows = sweeps.sort_sweep(ns=(1 << 10, 3000), device="cpu")
    assert _schema(rows) == _schema(j_sort_sweep(ns=(1 << 10, 3000)))
    assert [(r["n"], r["kernel"]) for r in rows] == [
        (n, k) for n in (1 << 10, 3000)
        for k in ("lax", "radix", "bitonic", "auto")]
    assert all(r["ok"] and r["error"] == "" for r in rows)


def test_spmv_suite_sweep_rows():
    rows = sweeps.spmv_suite_sweep(names=["jonheart", "dense2"], scale=0.01,
                                   device="cpu")
    ref = j_bench.spmv_suite_sweep(names=["jonheart", "dense2"], scale=0.01)
    assert _schema(rows) == _schema(ref)
    assert [(r["matrix"], r["n"], r["p"], r["iters"]) for r in rows] == \
        [(r["matrix"], r["n"], r["p"], r["iters"]) for r in ref]
    assert all(float(r["rel_l2"]) < 1e-3 and r["cpu_threads"] == 4
               for r in rows)


def test_run_all_runs_the_five_sweeps_at_quick(tmp_path):
    assert run_all.NOT_PORTED == ()
    names = ("data_bandwidth_vector_length", "bandwidth_vs_avg_edges",
             "sort_threads", "spmv_suite", "sort_sweep")
    assert run_all.main(["--quick", "--device=cpu", "--out", str(tmp_path),
                         "--only", ",".join(names)]) == 0
    assert json.loads((tmp_path / "failures.json").read_text()) == \
        {"failed": [], "retried": []}
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert set(metrics) == set(names)
    for name in names:
        assert (tmp_path / f"{name}.csv").exists()
