"""The port's sweep harness (``cme213_tpu_torch/bench``) against the JAX
package's (``cme213_tpu/bench``).

Each ported sweep runs at its ``--quick`` size on the CPU and must give the
JAX sweep's rows: the same keys in the same order, and the same labels
(kernel names, sizes, k, tile_y, schemes, matrices).  Timings are not
compared: the JAX sweeps run here with their timers stubbed
(``_time_ms``/``_time_donated_ms`` return 1 ms without running the Pallas
interpreter), so the JAX code builds its rows and labels in seconds; the
distributed and SpMV-scan sweeps, which time themselves, run as they are
(the suite coverage sweep with its engine stubbed).  The harness
(``run_all``) is held to the JAX one's retry, manifest and exit-code
contract.
"""

import json

import numpy as np
import pytest
import torch

import cme213_tpu.bench.sweeps as jsweeps
from cme213_tpu_torch.bench import run_all, sweeps
from cme213_tpu_torch.core import FrameworkError, flight, virtual_devices

LABELS = {
    "heat_bandwidth": ("size", "order", "kernel", "dtype", "iters"),
    "pallas_tile": ("tile_y",),
    "heat_kernels": ("kernel",),
    "pipeline_tune": ("kernel", "k", "tile_y"),
    "transfer_bandwidth": ("bytes",),
    "scan_bandwidth": ("op", "n"),
    "dist_heat_scaling": ("devices", "method", "scheme", "requested",
                          "local_kernel", "mode"),
    "dist_heat_compile_coverage": ("devices", "method", "scheme",
                                   "local_kernel", "iters", "ok"),
    "spmv_pallas_coverage": ("matrix", "source", "n", "p", "iters", "ok"),
    "spmv_scan_sweep": ("n", "p", "iters", "kernel", "tuned", "error"),
}

#: the JAX package's mode names off the TPU -> the port's on the CPU
MODES = {"interpret": "plain", "compiled": "compiled"}


@pytest.fixture(autouse=True)
def _disarm_flight():
    """``run_all.main`` arms the flight recorder for the process, as its
    CLI does; later tests in the same worker must not dump into the
    working directory."""
    yield
    flight._uninstall_for_tests()


@pytest.fixture
def jax_sweeps(monkeypatch):
    """The JAX sweeps module with its timers stubbed."""
    monkeypatch.setattr(jsweeps, "_time_ms", lambda fn, *a, **kw: 1.0)
    monkeypatch.setattr(jsweeps, "_time_donated_ms", lambda runner, u0: 1.0)
    return jsweeps


def _port_rows(name, **extra):
    fn_name, quick, _ = run_all.JOBS[name]
    return getattr(sweeps, fn_name)(**quick, **extra, device="cpu")


def _assert_same_rows(name, port, ref):
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        assert list(p) == list(r), (name, list(p), list(r))
        for key in LABELS[name]:
            want = MODES.get(r[key], r[key]) if key == "mode" else r[key]
            assert p[key] == want, (name, key, p, r)


@pytest.mark.parametrize("name,jax_call", [
    ("heat_bandwidth", lambda s: s.heat_sweep(sizes=(64,), orders=(2, 4, 8),
                                              iters=3)),
    ("pallas_tile", lambda s: s.pallas_tile_sweep(size=32, order=2, iters=2,
                                                  tiles=(8, 16))),
    ("heat_kernels", lambda s: s.heat_kernel_sweep(size=64, order=8,
                                                   iters=8, ks=(2, 4))),
    ("pipeline_tune", lambda s: s.pipeline_tune_sweep(
        size=64, order=8, iters=4, ks=(1, 2), targets=(16,))),
    ("transfer_bandwidth", lambda s: s.transfer_bandwidth_sweep(
        sizes=(1 << 16,))),
    ("scan_bandwidth", lambda s: s.scan_sweep(n=1 << 16,
                                              num_segments=1 << 8)),
    ("spmv_scan_sweep", lambda s: s.spmv_scan_sweep(
        ns=(1 << 12,), iters=2, kernels=("flat", "blocked"))),
])
def test_sweep_rows_and_labels_match_jax(jax_sweeps, name, jax_call):
    _assert_same_rows(name, _port_rows(name), jax_call(jax_sweeps))


@pytest.mark.parametrize("name,jax_call", [
    ("dist_heat_scaling", lambda s: s.dist_heat_sweep(
        size=32, order=2, iters=3, ndevs=(1, 2), pallas=None)),
    ("dist_heat_compile_coverage", lambda s: s.dist_heat_compile_coverage(
        size=32, order=2, iters=2, ndevs=(1, 2))),
])
def test_dist_sweep_rows_match_jax(name, jax_call):
    # the JAX tests run on 8 virtual CPU devices; two virtual devices of
    # the CPU give the port the same meshes
    port = _port_rows(name, devices=virtual_devices(2, "cpu"))
    _assert_same_rows(name, port, jax_call(jsweeps))
    assert all(r["mode"] == ("plain" if r["local_kernel"] == "pallas"
                             else "compiled") for r in port)


def test_spmv_coverage_rows_match_jax(monkeypatch, capsys):
    # the JAX engine would run the Pallas interpreter over the whole suite
    # (dense2 has 4 M values); its rows' labels do not depend on it
    import cme213_tpu.apps.spmv_scan as jsp

    monkeypatch.setattr(jsp, "run_spmv_scan",
                        lambda prob, **kw: np.zeros(prob.n, np.float32))
    ref = jsweeps.spmv_pallas_coverage(scale=0.002, iters=1)
    port = _port_rows("spmv_pallas_coverage")
    _assert_same_rows("spmv_pallas_coverage", port, ref)
    assert all(r["mode"] == "plain" and r["error"] == "" for r in port)
    assert [r["matrix"] for r in port][-2:] == ["gr_30_30", "dense2"]


def test_sweep_rows_name_no_card_peak_on_the_cpu():
    rows = _port_rows("heat_kernels")
    assert all(r["error"] == "" and r["ms"] > 0 for r in rows)
    assert all(r["pct_peak"] == "" and r["bound"] == "" for r in rows)


# ------------------------------------------------ error rows and device errors


def test_device_errors_fail_the_sweep_cell_errors_are_rows(monkeypatch):
    from cme213_tpu_torch.ops import stencil_pallas

    def refuse(*a, **kw):
        raise ValueError("tile does not fit")

    monkeypatch.setattr(stencil_pallas, "run_heat_pallas", refuse)
    rows = _port_rows("heat_kernels")
    bad = [r for r in rows if r["error"]]
    assert [(r["kernel"], r["error"], r["ms"]) for r in bad] == \
        [("pallas-roll", "ValueError", -1.0)]
    assert list(bad[0]) == list(rows[0])

    def sticky(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(stencil_pallas, "run_heat_pallas", sticky)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _port_rows("heat_kernels")


@pytest.mark.parametrize("exc,reraised", [
    (RuntimeError("CUDA error: an illegal memory access"), True),
    (FrameworkError("heat_band launch failed: invalid argument "
                    "(cudaError 1; order=8)"), True),
    (ValueError("ny=30 must divide by tile_y=8"), False),
    (FrameworkError("nvcc failed on heat_band.cu"), False),
    (RuntimeError("UNAVAILABLE: tunnel"), False),
])
def test_raise_if_device_error(exc, reraised):
    if reraised:
        with pytest.raises(type(exc)):
            sweeps._raise_if_device_error(exc)
    else:
        sweeps._raise_if_device_error(exc)


# ------------------------------------------------ run_all


def test_run_all_writes_csvs_manifest_and_metrics(tmp_path):
    only = "heat_kernels,pallas_tile,scan_bandwidth"
    rc = run_all.main(["--out", str(tmp_path), "--quick", "--device=cpu",
                       "--only", only])
    assert rc == 0
    for name in only.split(","):
        text = (tmp_path / f"{name}.csv").read_text().splitlines()
        assert len(text) > 1
    assert json.loads((tmp_path / "failures.json").read_text()) == \
        {"failed": [], "retried": []}
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert sorted(metrics) == sorted(only.split(","))
    assert metrics["heat_kernels"]["rows"] == 14
    assert all(m["ms"] > 0 for m in metrics.values())


def test_run_all_every_ported_sweep(tmp_path, capsys):
    assert run_all.main(["--out", str(tmp_path), "--quick",
                         "--device=cpu"]) == 0
    assert sorted(p.stem for p in tmp_path.glob("*.csv")) == \
        sorted(run_all.JOBS)


def _flaky(monkeypatch, failures: int):
    """Replace ``scan_sweep`` by one that fails ``failures`` times."""
    calls = []
    real = sweeps.scan_sweep

    def flaky(**kw):
        calls.append(kw)
        if len(calls) <= failures:
            raise RuntimeError(f"flake {len(calls)}")
        return real(**kw)

    monkeypatch.setattr(sweeps, "scan_sweep", flaky)
    return calls


def test_run_all_retries_a_failed_sweep_once(tmp_path, monkeypatch):
    calls = _flaky(monkeypatch, 1)
    rc = run_all.main(["--quick", "--device=cpu", "--out", str(tmp_path),
                       "--only", "scan_bandwidth"])
    assert rc == 0 and len(calls) == 2
    assert (tmp_path / "scan_bandwidth.csv").exists()
    manifest = json.loads((tmp_path / "failures.json").read_text())
    assert manifest["failed"] == []
    assert [(r["sweep"], r["attempt"], r["error"], r["message"])
            for r in manifest["retried"]] == \
        [("scan_bandwidth", 1, "RuntimeError", "flake 1")]


def test_run_all_double_failure_exits_1(tmp_path, monkeypatch):
    calls = _flaky(monkeypatch, 2)
    rc = run_all.main(["--quick", "--device=cpu", "--out", str(tmp_path),
                       "--only", "scan_bandwidth,pallas_tile"])
    assert rc == 1 and len(calls) == 2
    assert not (tmp_path / "scan_bandwidth.csv").exists()
    assert (tmp_path / "pallas_tile.csv").exists()  # the others still run
    manifest = json.loads((tmp_path / "failures.json").read_text())
    assert [r["sweep"] for r in manifest["failed"]] == ["scan_bandwidth"]
    assert [r["sweep"] for r in manifest["retried"]] == ["scan_bandwidth"]
    assert "scan_bandwidth" not in json.loads(
        (tmp_path / "metrics.json").read_text())


@pytest.mark.parametrize("only", ["no_such_sweep", "sort_sweeps",
                                  "heat_kernels,spmv_suites"])
def test_run_all_unknown_or_unported_name_exits_2(tmp_path, only, capsys):
    # every sweep of the JAX package is ported: a name outside the job
    # table is unknown, even beside a known one
    assert run_all.main(["--quick", "--device=cpu", "--out",
                         str(tmp_path / "o"), "--only", only]) == 2
    assert not (tmp_path / "o").exists()
    err = capsys.readouterr().err
    assert "unknown sweep name" in err and "not ported" not in err


def test_run_all_default_out_is_not_the_jax_evidence(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert run_all.main(["--quick", "--device=cpu", "--only",
                         "pallas_tile"]) == 0
    assert (tmp_path / "bench_results_torch" / "pallas_tile.csv").exists()
    assert not (tmp_path / "bench_results").exists()


def test_run_all_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_all.main(["--quick", "--out", str(tmp_path), "--only",
                      "pallas_tile"])


def test_job_table_covers_the_jax_table():
    # every CSV of the JAX harness is ported or named as waiting
    jax_csvs = {"data_bandwidth_vector_length", "bandwidth_vs_avg_edges",
                "heat_bandwidth", "pallas_tile", "heat_kernels",
                "pipeline_tune", "transfer_bandwidth", "scan_bandwidth",
                "dist_heat_scaling", "dist_heat_compile_coverage",
                "sort_threads", "spmv_pallas_coverage", "spmv_suite",
                "spmv_scan_sweep", "sort_sweep"}
    assert set(run_all.JOBS) | set(run_all.NOT_PORTED) == jax_csvs
    assert not set(run_all.JOBS) & set(run_all.NOT_PORTED)
