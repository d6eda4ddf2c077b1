"""The port's device doctor and staged forensics against the JAX
package's: the health report's shape, the stage heuristics, the forensics
state, the health ring, and the ``doctor`` CLI.

``health_report(device="cpu")`` is compared with the JAX package's report
on its CPU backend; without ``device`` and without a card the port's
report is unhealthy (it never probes the CPU in the card's place).
"""

import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

from cme213_tpu.core import diag as jdiag
from cme213_tpu.core import faults as jfaults
from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import resilience as jres
from cme213_tpu.core import trace as jtrace
from cme213_tpu.core.platform import device_preflight as jpreflight
from cme213_tpu_torch import doctor_cli
from cme213_tpu_torch.core import diag as tdiag
from cme213_tpu_torch.core import faults as tfaults
from cme213_tpu_torch.core import metrics as tmetrics
from cme213_tpu_torch.core import resilience as tres
from cme213_tpu_torch.core import trace as ttrace
from cme213_tpu_torch.core.platform import device_preflight

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIDES = ((jdiag, jfaults, jtrace, jmetrics, jres),
         (tdiag, tfaults, ttrace, tmetrics, tres))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("CME213_FAULTS", "CME213_INCARNATION", "CME213_DIAG_DIR",
                "CME213_TRACE_FILE", "CME213_DOCTOR_TIMEOUT_S"):
        monkeypatch.delenv(var, raising=False)
    for diag, faults, trace, metrics, _ in SIDES:
        diag.reset()
        faults.reset()
        trace.clear_events()
        metrics.reset()
    yield
    for diag, faults, trace, metrics, _ in SIDES:
        diag.reset()
        faults.reset()
        trace.clear_events()
        metrics.reset()


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a card, wherever the test runs."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ------------------------------------------------------------ health ladder

def test_cpu_report_has_the_reference_s_shape():
    port = tdiag.health_report(timeout_s=60.0, device="cpu")
    ref = jdiag.health_report(timeout_s=60.0)
    assert sorted(port) == sorted(ref)
    assert [s["stage"] for s in port["stages"]] == \
        [s["stage"] for s in ref["stages"]] == \
        ["enumerate", "memory", "liveness"]
    for a, b in zip(port["stages"], ref["stages"]):
        assert sorted(a) == sorted(b)
        assert a["ok"] == b["ok"]
    assert port["healthy"] is ref["healthy"] is True
    assert port["platform"] == ref["platform"] == "cpu"
    assert sorted(port["stages"][0]["detail"]["devices"][0]) == \
        sorted(ref["stages"][0]["detail"]["devices"][0])
    assert port["probe_ms"] >= 0
    evs = ttrace.events("device-health")
    assert evs and ttrace.validate_record(evs[-1]) == [] and \
        evs[-1]["healthy"] is True
    assert sorted(tmetrics.snapshot()["gauges"]) == \
        sorted(jmetrics.snapshot()["gauges"])
    assert "cme213_diag_device_healthy 1" in tmetrics.render_prometheus()


def test_without_a_card_the_report_is_unhealthy(no_card):
    rep = tdiag.health_report(timeout_s=60.0)
    assert rep["healthy"] is False and rep["device_count"] == 0
    assert [s["stage"] for s in rep["stages"]] == ["enumerate"]
    assert "no CUDA device" in rep["stages"][0]["detail"]
    assert ttrace.events("device-health")[-1]["healthy"] is False
    assert tmetrics.snapshot()["gauges"]["diag.device.healthy"] == 0.0


def test_probe_timeout_is_a_report_not_a_hang(monkeypatch):
    hang = threading.Event()
    monkeypatch.setattr(tdiag, "_probe_liveness",
                        lambda device=None: hang.wait(30))
    rep = tdiag.health_report(timeout_s=0.2, device="cpu")
    assert rep["healthy"] is False
    live = next(s for s in rep["stages"] if s["stage"] == "liveness")
    assert live["timed_out"] and not live["ok"]
    hang.set()


def test_injected_unreachable_matches_reference():
    got = []
    for diag, faults, trace, _, _ in SIDES:
        kw = {"device": "cpu"} if diag is tdiag else {}
        with faults.injected("unreachable:1"):
            rep = diag.health_report(timeout_s=60.0, **kw)
        got.append([(s["stage"], s["ok"], "unreachable" in str(s["detail"]))
                    for s in rep["stages"]] + [rep["healthy"]])
    assert got[0] == got[1]
    assert got[1][-1] is False and got[1][2] == ("liveness", False, True)


def test_unreachable_is_incarnation_gated(monkeypatch):
    monkeypatch.setenv("CME213_INCARNATION", "1")
    with tfaults.injected("unreachable:1"):
        assert tdiag.health_report(device="cpu")["healthy"] is True


def test_device_preflight_consults_unreachable():
    with tfaults.injected("unreachable:1"):
        assert device_preflight(30.0, device="cpu") is False
    with jfaults.injected("unreachable:1"):
        assert jpreflight(30.0) is False
    assert device_preflight(30.0, device="cpu") is True
    assert jpreflight(30.0) is True


def test_device_preflight_never_probes_the_cpu_for_the_card(no_card):
    assert device_preflight(5.0) is False


# -------------------------------------------------------- staged forensics

#: ``tests/test_diag.py``'s messages, and more of the JAX package's
MESSAGES = [
    "RuntimeError: Mosaic lowering failed",
    "RuntimeError: XLA compilation oom: vmem",
    "RuntimeError: boring crash",
    "MLIR verification failed",
    "unimplemented primitive",
    "probe output diverged: conformance failed",
    "preflight: device unreachable",
    "timeout (900s)",
    "",
]


@pytest.mark.parametrize("msg", MESSAGES)
@pytest.mark.parametrize("default", ["execute", "conformance", "bogus"])
def test_stage_for_message_matches_reference(msg, default):
    assert tdiag.stage_for_message(msg, default=default) == \
        jdiag.stage_for_message(msg, default=default)


@pytest.mark.parametrize("msg,tag", [
    ("Mosaic lowering failed", None), ("XLA compilation oom: vmem", None),
    ("boring crash", None), ("boring crash", "conformance"),
    ("Mosaic unsupported op", "compile"), ("fine", "lower"),
])
def test_failure_stage_matches_reference(msg, tag):
    got = []
    for diag, *_ in SIDES:
        e = RuntimeError(msg)
        if tag:
            diag.mark_stage(e, tag)
        got.append(diag.failure_stage(e))
    assert got[0] == got[1]


def test_stage_tag_travels_the_cause_chain():
    try:
        try:
            raise tdiag.mark_stage(RuntimeError("x"), "lower")
        except RuntimeError as e:
            raise ValueError("wrapped") from e
    except ValueError as e:
        assert tdiag.failure_stage(e) == "lower"


def test_stage_scope_records_forensics_state():
    for diag, *_ in SIDES:
        with pytest.raises(ValueError):
            with diag.stage_scope("op.r", "lower"):
                raise ValueError("nope")
    a, b = tdiag.forensics_state(), jdiag.forensics_state()
    assert a["open"] is b["open"] is None
    drop = lambda d: {k: v for k, v in d.items() if k != "t"}  # noqa: E731
    assert drop(a["last_failed"]) == drop(b["last_failed"]) == \
        {"op": "op.r", "stage": "lower", "error": "ValueError"}


@pytest.mark.parametrize("stage", ["lower", "compile", "execute",
                                   "conformance"])
def test_stage_attribution_through_with_fallback(stage):
    """A ``stage:`` clause raises a fault tagged with its stage, and the
    ladder's ``kernel-failure`` event carries it, in both packages."""
    got = []
    for diag, faults, trace, _, res in SIDES:
        def fancy(diag=diag, faults=faults):
            if stage != "execute":
                with diag.stage_scope("diagop.fancy", stage):
                    faults.maybe_fail_stage("diagop.fancy", stage)
            return "fancy"

        with faults.injected(f"stage:diagop.fancy:{stage}:1"):
            r = res.with_fallback("diagop", [("fancy", fancy),
                                             ("safe", lambda: "safe")])
        kf = trace.events("kernel-failure")
        got.append((r.rung, [(e["kernel"], e["stage"]) for e in kf]))
    assert got[0] == got[1] == ("safe", [("fancy", stage)])


# -------------------------------------------------------- ring persistence

def test_ring_caps_entries(tmp_path, monkeypatch):
    monkeypatch.setenv(tdiag.DIAG_DIR_ENV, str(tmp_path))
    monkeypatch.setattr(tdiag, "RING_CAP", 3)
    for i in range(5):
        tdiag._append_ring({"doctor": 1, "n": i})
    assert [e["n"] for e in tdiag.read_ring()] == [2, 3, 4]
    assert tdiag.RING_NAME == jdiag.RING_NAME


def test_health_ring_persists_reports(tmp_path, monkeypatch):
    monkeypatch.setenv(tdiag.DIAG_DIR_ENV, str(tmp_path))
    for _ in range(2):
        rep = tdiag.health_report(device="cpu")
    assert rep["ring_path"] == str(tmp_path / tdiag.RING_NAME)
    assert [e["healthy"] for e in tdiag.read_ring()] == [True, True]
    assert tdiag.last_health()["t"] == rep["t"]


# ------------------------------------------------------------------- CLI

def test_doctor_json_on_the_cpu_round_trips(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("CME213_DIAG_DIR", str(tmp_path))
    assert doctor_cli.main(["--json", "--device=cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["healthy"] is True and rep["platform"] == "cpu"
    assert [s["stage"] for s in rep["stages"]] == \
        ["enumerate", "memory", "liveness"]
    assert json.loads(json.dumps(rep)) == rep
    assert len(tdiag.read_ring()) == 1
    assert doctor_cli.main(["--device=cpu"]) == 0
    assert "HEALTHY" in capsys.readouterr().out


def test_doctor_injected_unreachable_exits_1(capsys):
    with tfaults.injected("unreachable:1"):
        assert doctor_cli.main(["--json", "--device=cpu"]) == 1
    rep = json.loads(capsys.readouterr().out)
    live = next(s for s in rep["stages"] if s["stage"] == "liveness")
    assert not rep["healthy"] and "unreachable" in live["detail"]


def test_doctor_calibrate_is_not_ported(capsys):
    assert doctor_cli.main(["calibrate"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_doctor_cli_without_a_card_exits_1():
    """Run where no card is visible (``CUDA_VISIBLE_DEVICES`` empty)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CME213_FAULTS", "CME213_DIAG_DIR")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "cme213_tpu_torch", "doctor", "--json"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 1, proc.stderr
    rep = json.loads(proc.stdout)
    assert rep["healthy"] is False and rep["platform"] is None
    ok = subprocess.run(
        [sys.executable, "-m", "cme213_tpu_torch", "doctor", "--json",
         "--device=cpu"], capture_output=True, text=True, env=env,
        timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert json.loads(ok.stdout)["healthy"] is True
