"""The port's crash flight recorder against the JAX package's: explicit
dumps, the crash paths (unhandled exception, fatal signal, the
``rankkill`` hard exit), atomic dump files, and the abort of a
checkpointed solve.

Counterpart of ``tests/test_flight.py`` (the dump and crash-path cases; its
supervised-gang and ``trace flight`` cases wait for the gang and the trace
CLI).  A dump of each package, made at the same point, has the same keys,
reason, open spans and metrics; the port's platform facts name torch and
the card instead of JAX, and a dump never initialises CUDA.
"""

import glob
import json
import os
import signal
import subprocess
import sys

import pytest

from cme213_tpu.core import diag as jdiag
from cme213_tpu.core import flight as jflight
from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import numerics as jnumerics
from cme213_tpu.core import trace as jtrace
from cme213_tpu_torch.core import diag, faults, flight, metrics, numerics, trace

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.delenv(flight.FLIGHT_DIR_ENV, raising=False)
    for mod in (flight, jflight):
        mod._uninstall_for_tests()
    for mod in (trace, jtrace):
        mod.clear_events()
    # the dump embeds process-wide diag and numerics state that earlier
    # tests in the same process may have left behind
    for mod in (metrics, jmetrics, diag, jdiag, numerics, jnumerics):
        mod.reset()
    yield
    for mod in (flight, jflight):
        mod._uninstall_for_tests()
    faults.reset()
    metrics.reset()
    jmetrics.reset()


def _dumps(d):
    return sorted(glob.glob(os.path.join(str(d), "flight-*.json")))


def _run(body, tmp_path, **env):
    """Run a python -c body of the port with the flight dir at
    ``tmp_path``."""
    full = {k: v for k, v in os.environ.items()
            if k not in ("CME213_FAULTS", "CME213_INCARNATION", "RANK")}
    full.update({flight.FLIGHT_DIR_ENV: str(tmp_path),
                 "PYTHONPATH": _REPO}, **env)
    return subprocess.run([sys.executable, "-c", body], env=full, cwd=_REPO,
                          capture_output=True, text=True, timeout=120)


# ------------------------------------------------------------ dump basics

def test_dump_unarmed_is_noop(tmp_path):
    assert not flight.installed()
    assert flight.dump("nothing-listening") is None
    assert _dumps(tmp_path) == []


def test_explicit_dump_contents(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    metrics.counter("faults.fail").inc(3)
    with trace.span("heat.run", shape_class="32x32"):
        path = flight.dump("operator-requested")
    assert path and os.path.dirname(path) == str(tmp_path)
    doc = json.loads(open(path).read())
    assert doc["flight"] == 1
    assert doc["reason"] == "operator-requested"
    assert doc["pid"] == os.getpid()
    assert doc["platform"]["python"] == sys.version.split()[0]
    assert doc["traceback"] is None
    assert doc["metrics"]["counters"]["faults.fail"] == 3
    assert [s["span"] for s in doc["open_spans"]] == ["heat.run"]
    assert any(e["event"] == "span-begin" for e in doc["events"])
    (ev,) = trace.events("flight-dump")
    assert ev["reason"] == "operator-requested" and ev["path"] == path


def test_dump_matches_reference_dump(tmp_path, monkeypatch):
    """The same point in both packages: the same keys, reason, open spans,
    metrics and health/forensics/numerics sections."""
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    docs = {}
    for name, (fl, tr, me) in {"jax": (jflight, jtrace, jmetrics),
                               "torch": (flight, trace, metrics)}.items():
        me.counter("checkpoint.rollbacks").inc(2)
        with tr.span("checkpoint.chunk", op="heat2d", start=4, iters=4):
            try:
                raise ValueError("poisoned state at step 8")
            except ValueError as e:
                docs[name] = json.loads(open(fl.dump("numeric-abort",
                                                     exc=e)).read())
    j, t = docs["jax"], docs["torch"]
    assert set(t) == set(j)
    for key in ("flight", "reason", "incarnation", "health", "forensics",
                "numerics", "metrics"):
        assert t[key] == j[key], key
    assert [(s["span"], s["op"], s["start"]) for s in t["open_spans"]] == \
        [(s["span"], s["op"], s["start"]) for s in j["open_spans"]]
    assert "poisoned state at step 8" in t["traceback"]
    assert t["platform"]["torch"] and t["platform"]["card"] is None


def test_dump_is_atomic_no_tmp_leftovers(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    for i in range(3):
        metrics.counter("x").inc()
        assert flight.dump(f"r{i}")
    paths = _dumps(tmp_path)
    assert len(paths) == 3
    for p in paths:
        json.loads(open(p).read())
    assert glob.glob(os.path.join(str(tmp_path), "*.tmp*")) == []


def test_dump_with_exception_carries_traceback(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    try:
        raise ValueError("poisoned state at step 7")
    except ValueError as e:
        path = flight.dump("numeric-abort", exc=e)
    doc = json.loads(open(path).read())
    assert "poisoned state at step 7" in doc["traceback"]
    assert "ValueError" in doc["traceback"]


def test_install_from_env_is_opt_in(tmp_path, monkeypatch):
    assert not flight.install_from_env() and not flight.installed()
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    assert flight.install_from_env() and flight.installed()
    assert sys.excepthook is flight._excepthook


def test_platform_facts_never_import_torch_or_start_cuda(tmp_path,
                                                       monkeypatch):
    import torch

    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    info = flight._platform_info()
    assert info["torch"] == torch.__version__
    assert info["cuda"] == torch.version.cuda
    doc = json.loads(open(flight.dump("probe")).read())
    assert doc["platform"]["card"] is None  # CUDA was never started
    assert not torch.cuda.is_initialized()
    monkeypatch.setitem(sys.modules, "torch", None)  # as if not imported
    info = flight._platform_info()
    assert (info["torch"], info["cuda"], info["card"]) == (None, None, None)


# ------------------------------------------------------------ crash paths

def test_unhandled_exception_dumps_before_death(tmp_path):
    proc = _run(
        "from cme213_tpu_torch.core import flight\n"
        "flight.install()\n"
        "raise RuntimeError('solver blew up')\n", tmp_path)
    assert proc.returncode == 1
    assert "solver blew up" in proc.stderr  # the chained hook still prints
    (path,) = _dumps(tmp_path)
    doc = json.loads(open(path).read())
    assert doc["reason"] == "unhandled-exception"
    assert "solver blew up" in doc["traceback"]


def test_rankkill_hard_exit_dumps(tmp_path):
    """``os._exit`` skips atexit and the excepthook: the kill guard dumps
    inline, so the hard-exit path leaves a black box too."""
    proc = _run(
        "from cme213_tpu_torch.core import faults\n"
        "faults.maybe_kill_rank(step=0)\n", tmp_path,
        CME213_FAULTS="rankkill:0:0", RANK="0")
    assert proc.returncode == faults.KILL_EXIT
    (path,) = _dumps(tmp_path)
    doc = json.loads(open(path).read())
    assert doc["reason"] == "rankkill"
    assert doc["rank"] == "0" and doc["incarnation"] == "0"
    assert doc["metrics"]["counters"]["faults.rankkill"] == 1
    assert any(e["event"] == "fault-injected" for e in doc["events"])


def test_replica_kill_dumps_before_sigkill(tmp_path):
    proc = _run(
        "from cme213_tpu_torch.core import faults\n"
        "faults.maybe_kill_replica()\n", tmp_path,
        CME213_FAULTS="replica-kill:0", RANK="0")
    assert proc.returncode == -signal.SIGKILL
    (path,) = _dumps(tmp_path)
    assert json.loads(open(path).read())["reason"] == "replica-kill"


def test_fatal_signal_dumps_then_dies_by_signal(tmp_path):
    proc = _run(
        "import os, signal\n"
        "from cme213_tpu_torch.core import flight\n"
        "flight.install()\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n", tmp_path)
    assert proc.returncode == -signal.SIGTERM
    (path,) = _dumps(tmp_path)
    assert json.loads(open(path).read())["reason"] == "signal:SIGTERM"


def test_checkpointed_solve_abort_leaves_its_black_box(tmp_path):
    """A checkpointed heat solve whose chunk stays non-finite after its
    one rollback dies of the unhandled ``NonFiniteError``: one dump taken
    at the abort, inside the open ``checkpoint.chunk`` span, and one by
    the excepthook."""
    ck = tmp_path / "ck"
    ck.mkdir()
    proc = _run(
        "from cme213_tpu_torch.apps.heat2d import run_heat_checkpointed\n"
        "from cme213_tpu_torch.config import SimParams\n"
        "run_heat_checkpointed(SimParams(nx=20, ny=20, order=2, iters=8),\n"
        f"    {str(ck / 'h.npz')!r}, every=4, max_retries=1,\n"
        "    device='cpu')\n", tmp_path,
        CME213_FAULTS="nan:heat2d:1,nan:heat2d:2")
    assert proc.returncode == 1 and "NonFiniteError" in proc.stderr
    docs = {d["reason"]: d for d in
            (json.loads(open(p).read()) for p in _dumps(tmp_path))}
    assert set(docs) == {"numeric-abort", "unhandled-exception"}
    abort = docs["numeric-abort"]
    assert [s["span"] for s in abort["open_spans"]] == ["checkpoint.chunk"]
    assert abort["metrics"]["counters"]["checkpoint.rollbacks"] == 1
    assert "NonFiniteError" in abort["traceback"]
    assert [e["event"] for e in abort["events"]
            if e["event"] in ("numeric-abort", "checkpoint-rollback")] == \
        ["numeric-abort", "checkpoint-rollback", "numeric-abort"]
