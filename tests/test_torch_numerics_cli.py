"""The port's ``numerics`` CLI (``cme213_tpu_torch/numerics_cli.py``)
against the JAX package's, and ``trace flight`` over the port's dumps.

Ports the CLI cases of ``tests/test_numerics.py`` over sinks that hold
``solver-progress`` records from the port's checkpointed runner, with
``numeric-drift`` records built in the test (the shadow sampler that
writes them comes with serving), and the ``trace flight`` cases of
``tests/test_flight.py`` over a dump the port's aborting checkpointed
solve leaves.  Report documents, text and exit codes must equal the
reference's over the same sinks.
"""

import io
import json

import pytest

import torch_telemetry_records as R
from cme213_tpu import numerics_cli as jnumerics_cli
from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import trace as jtrace
from cme213_tpu_torch import numerics_cli, trace_cli
from cme213_tpu_torch.core import faults, flight, metrics, numerics, trace


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in ("CME213_FAULTS", "CME213_TRACE_FILE", "CME213_FLIGHT_DIR"):
        monkeypatch.delenv(var, raising=False)
    flight._uninstall_for_tests()
    for tr, me in ((jtrace, jmetrics), (trace, metrics)):
        tr.flush_sink()
        tr.clear_events()
        me.reset()
    numerics.reset()
    yield
    flight._uninstall_for_tests()
    faults.reset()
    numerics.reset()
    metrics.reset()
    jmetrics.reset()


def _write_sink(tmp_path):
    return R.write_sink(tmp_path / "trace.jsonl", R.numerics_records())


def _checkpointed_sink(tmp_path, monkeypatch, iters=40, every=5):
    """The port's checkpointed heat solve on the CPU, traced, plus the
    drift records a shadow sampler would add."""
    from cme213_tpu_torch.apps.heat2d import run_heat_checkpointed
    from cme213_tpu_torch.config import SimParams

    path = tmp_path / "ck.jsonl"
    monkeypatch.setenv(trace.TRACE_FILE_ENV, str(path))
    run_heat_checkpointed(SimParams(nx=24, ny=24, order=4, iters=iters),
                          str(tmp_path / "h.npz"), every=every,
                          device="cpu")
    trace.flush_sink()
    monkeypatch.delenv(trace.TRACE_FILE_ENV)
    with open(path, "a") as f:
        for rec in R.numerics_records()[:4]:
            f.write(json.dumps(rec) + "\n")
    return str(path)


def test_numerics_cli_report_and_gates(tmp_path, capsys):
    sink = _write_sink(tmp_path)
    assert numerics_cli.main(["report", sink, "--max-over-budget", "1"]) == 0
    out = capsys.readouterr().out
    assert "2 shadow sample(s)" in out and "DEMOTED serve.echo.fast" in out
    assert "solver heat2d" in out and "converging" in out
    assert numerics_cli.main(["report", sink, "--max-over-budget", "0"]) == 1
    assert "over the drift budget" in capsys.readouterr().err
    assert numerics_cli.main(["report", sink, "--min-samples", "3"]) == 1
    assert "only 2 shadow sample(s)" in capsys.readouterr().err
    assert numerics_cli.main(["report", sink, "--forbid-stall"]) == 0
    doc = numerics_cli.report([sink])
    assert doc["numerics"]["samples"] == 2
    assert doc["numerics"]["over_budget"] == 1
    assert doc["numerics"]["demotions"] == ["serve.echo.fast"]
    assert doc["numerics"]["sentinels"]["trips"] == 1
    assert doc["convergence"]["heat2d"]["epochs"] == 2
    assert not doc["convergence"]["heat2d"]["stalled"]


def test_numerics_cli_forbid_stall_gate(tmp_path):
    recs = [{"event": "solver-progress", "t": float(i), "op": "s",
             "step": i, "residual": 1.0, "delta_norm": 0.0,
             "iters_per_s": 1.0} for i in range(7)]
    sink = R.write_sink(tmp_path / "stalled.jsonl", recs)
    assert numerics_cli.main(["report", sink]) == 0
    assert numerics_cli.main(["report", sink, "--forbid-stall"]) == 1
    assert numerics_cli.report([sink])["convergence"]["s"]["stalled"]


def test_trace_summary_numeric_sections(tmp_path):
    sink = _write_sink(tmp_path)
    buf = io.StringIO()
    agg = trace_cli.summarize(trace_cli.load_events([sink]), out=buf)
    text = buf.getvalue()
    assert "numeric health:" in text and "convergence:" in text
    assert agg["numerics"]["samples"] == 2
    assert agg["numerics"]["drift"]["serve.echo.fast"]["over_budget"] == 1
    assert agg["convergence"]["heat2d"]["last_residual"] == 0.25
    assert agg["counts"]["numeric-drift"] == 2


def test_checkpointed_runner_feeds_a_converging_row(tmp_path, monkeypatch,
                                                    capsys):
    sink = _checkpointed_sink(tmp_path, monkeypatch)
    assert numerics_cli.main(["report", sink, "--forbid-stall",
                              "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    row = doc["convergence"]["heat2d"]
    assert row["epochs"] == 8 and row["last_step"] == 40
    assert row["stalled"] is False
    assert row["last_residual"] < row["first_residual"]
    assert numerics_cli.main(["report", sink, "--min-samples", "2",
                              "--max-over-budget", "1"]) == 0
    assert "solver heat2d: 8 epoch(s)" in capsys.readouterr().out


def test_stalled_runner_fails_the_gate(tmp_path, monkeypatch):
    """A solve run past its convergence: the residual stops falling, the
    row ends STALLED and ``--forbid-stall`` exits 1 in both packages."""
    recs = [{"event": "solver-progress", "t": float(i), "op": "heat2d",
             "step": 5 * i, "residual": 1e-7, "delta_norm": 1e-9,
             "iters_per_s": 10.0} for i in range(1, 8)]
    sink = R.write_sink(tmp_path / "flat.jsonl", recs)
    for cli in (numerics_cli, jnumerics_cli):
        assert cli.main(["report", sink, "--forbid-stall"]) == 1


@pytest.mark.parametrize("argv", [
    [], ["--json"], ["--max-over-budget", "0"], ["--min-samples", "3"],
    ["--forbid-stall"], ["--json", "--forbid-stall", "--min-samples", "1"]])
def test_report_equals_reference(tmp_path, monkeypatch, capsys, argv):
    sinks = [_write_sink(tmp_path), _checkpointed_sink(tmp_path, monkeypatch)]
    for files in ([sinks[0]], [sinks[1]], sinks):
        assert numerics_cli.report(files) == jnumerics_cli.report(files)
        rc = numerics_cli.main(["report", *files, *argv])
        ours = capsys.readouterr()
        assert jnumerics_cli.main(["report", *files, *argv]) == rc
        ref = capsys.readouterr()
        assert (ours.out, ours.err) == (ref.out, ref.err)


def test_render_without_numeric_records(tmp_path):
    sink = R.write_sink(tmp_path / "t.jsonl", R.gang_records()[
        "trace-0.jsonl"])
    out, ref = io.StringIO(), io.StringIO()
    numerics_cli.render(numerics_cli.report([sink]), out)
    jnumerics_cli.render(jnumerics_cli.report([sink]), ref)
    assert out.getvalue() == ref.getvalue()
    assert out.getvalue().startswith("numeric health: no shadow samples")


def test_unreadable_sinks_exit_2(tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    assert numerics_cli.main(["report", str(bad)]) == 2
    assert "bad.jsonl:1" in capsys.readouterr().err
    assert numerics_cli.main(["report", str(tmp_path / "absent")]) == 2


def test_numerics_workload_dispatches(tmp_path, capsys):
    from cme213_tpu_torch import models

    sink = _write_sink(tmp_path)
    assert models.dispatch(["numerics", "report", sink, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["numerics"]["samples"] == 2


# ------------------------------------------------ trace flight, the port

def test_trace_flight_renders_the_abort_of_a_checkpointed_solve(
        tmp_path, monkeypatch, capsys):
    """The port's checkpointed solve whose chunk stays non-finite after
    its one rollback dumps the recorder inside ``checkpoint.chunk``;
    ``trace flight`` renders the dump, names torch, and lists the open
    span and the rollback."""
    import torch

    from cme213_tpu_torch.apps.heat2d import run_heat_checkpointed
    from cme213_tpu_torch.config import SimParams
    from cme213_tpu_torch.core.resilience import NonFiniteError

    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    with faults.injected("nan:heat2d:1,nan:heat2d:2"):
        with pytest.raises(NonFiniteError):
            run_heat_checkpointed(SimParams(nx=20, ny=20, order=2, iters=8),
                                  str(tmp_path / "h.npz"), every=4,
                                  max_retries=1, device="cpu")
    dumps = sorted(tmp_path.glob("flight-*.json"))
    assert len(dumps) == 1
    assert trace_cli.main(["flight", str(dumps[0])]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("flight dump: reason 'numeric-abort'")
    assert f"torch {torch.__version__}" in lines[1]
    assert "open spans at death (1):" in out
    assert "  checkpoint.chunk (id" in out
    assert "NonFiniteError" in out and "checkpoint-rollback" in out
    assert "metrics at death:" in lines[-1]
