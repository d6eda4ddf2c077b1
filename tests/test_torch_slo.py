"""The port's SLO burn-rate monitoring (``cme213_tpu_torch/serve/slo.py``),
the JAX package's ``tests/test_slo.py`` cases ported one for one, plus a
parity case: the same observations give the same burns, states and events
in both packages.

SLO burn-rate monitoring (``serve/slo.py``): objective validation,
the two-window AND filter (a short burst alone never fires), recovery
hysteresis (no flapping at the threshold), and the server integration —
sustained overload trips degraded mode through the SLO hook and recovery
releases it.  Every test runs on a ``VirtualClock``; no wall-time."""

import io

import pytest

from cme213_tpu_torch.core import faults, metrics, trace
from cme213_tpu_torch.core.resilience import VirtualClock
from cme213_tpu_torch.serve import Objective, Server, SLOMonitor
from cme213_tpu_torch.serve.slo import from_flags


@pytest.fixture(autouse=True)
def _clean_slate():
    trace.clear_events()
    metrics.reset()
    yield
    faults.reset()
    metrics.reset()


def monitor(objective, **kw):
    clock = VirtualClock()
    kw.setdefault("short_window_s", 5.0)
    kw.setdefault("long_window_s", 60.0)
    kw.setdefault("min_samples", 5)
    return SLOMonitor([objective], clock=clock, **kw), clock


# ------------------------------------------------------------ objectives

def test_objective_validates_kind_and_target():
    with pytest.raises(ValueError, match="unknown objective kind"):
        Objective("x", "p42_latency", 1.0)
    with pytest.raises(ValueError, match="target must be > 0"):
        Objective("x", "shed_rate", 0.0)


def test_from_flags_builds_requested_objectives_only():
    assert from_flags() is None
    mon = from_flags(p99_ms=50.0, shed_rate=0.1)
    assert [o.name for o in mon.objectives] == ["p99-latency", "shed-rate"]
    assert [o.kind for o in mon.objectives] == ["p99_latency_ms", "shed_rate"]


# ------------------------------------------------------------- transitions

def test_burn_fires_on_sustained_violation():
    mon, clock = monitor(Objective("p99", "p99_latency_ms", 100.0))
    for _ in range(10):
        clock.advance(0.1)
        mon.observe(latency_ms=500.0)
    state = mon.evaluate()
    assert mon.burning and state["p99"]["burning"]
    (ev,) = trace.events("slo-burn")
    assert ev["objective"] == "p99"
    assert ev["burn_short"] >= ev["threshold"]
    # the worst short-window burn is exported as a gauge
    assert metrics.gauge("serve.slo.burn").value == ev["burn_short"]


def test_min_samples_gate_blocks_early_fire():
    mon, _ = monitor(Objective("p99", "p99_latency_ms", 100.0),
                     min_samples=10)
    for _ in range(9):
        mon.observe(latency_ms=500.0)
    mon.evaluate()
    assert not mon.burning and not trace.events("slo-burn")
    mon.observe(latency_ms=500.0)            # the tenth sample arms it
    mon.evaluate()
    assert mon.burning


def test_short_burst_alone_does_not_fire():
    """The two-window AND: the long window must agree the problem is
    sustained before the monitor fires."""
    mon, clock = monitor(
        Objective("p99", "p99_latency_ms", 100.0, budget=0.2))
    for _ in range(40):                       # 40s of healthy history
        clock.advance(1.0)
        mon.observe(latency_ms=10.0)
        mon.observe(latency_ms=10.0)
    for _ in range(10):                       # burst: short window only
        mon.observe(latency_ms=500.0)
    mon.evaluate()
    assert not mon.burning and not trace.events("slo-burn")
    # sustained violation degrades the long window too -> fires ONCE
    for _ in range(15):
        clock.advance(1.0)
        for _ in range(6):
            mon.observe(latency_ms=500.0)
        mon.evaluate()
    assert mon.burning
    assert len(trace.events("slo-burn")) == 1


def test_recovery_hysteresis_no_flap():
    """Recovery needs the short burn to fall to threshold*hysteresis —
    a burn hovering between the recovery bound and the fire threshold
    produces neither a new burn nor a premature slo-ok."""
    mon, clock = monitor(Objective("shed", "shed_rate", 0.1))
    for _ in range(10):
        mon.observe(shed=True)                # rate 1.0 -> burn 10
    mon.evaluate()
    assert mon.burning and len(trace.events("slo-burn")) == 1
    clock.advance(6.0)                        # old samples leave the
    for i in range(20):                       # short window
        mon.observe(shed=(i < 3))             # rate 0.15 -> burn 1.5
    mon.evaluate()
    assert mon.burning                        # 1.0 < 1.5 < 2.0: hold
    assert len(trace.events("slo-burn")) == 1
    assert not trace.events("slo-ok")
    clock.advance(6.0)
    for i in range(20):
        mon.observe(shed=(i < 1))             # rate 0.05 -> burn 0.5
    mon.evaluate()
    assert not mon.burning
    assert len(trace.events("slo-ok")) == 1
    mon.evaluate()                            # stable: no flap
    assert len(trace.events("slo-ok")) == 1
    assert len(trace.events("slo-burn")) == 1


def test_error_rate_objective_and_state():
    mon, _ = monitor(Objective("err", "error_rate", 0.05))
    for _ in range(10):
        mon.observe(latency_ms=10.0)
        mon.observe(failed=True)              # rate 0.5 -> burn 10
    out = mon.evaluate()
    assert mon.burning and out["err"]["kind"] == "error_rate"
    assert mon.state() == out


def test_empty_and_shed_only_windows_burn_nothing():
    mon, _ = monitor(Objective("p99", "p99_latency_ms", 100.0))
    out = mon.evaluate()
    assert out["p99"]["burn_short"] is None and not mon.burning
    assert metrics.gauge("serve.slo.burn").value == 0.0
    for _ in range(10):                       # shed samples carry no
        mon.observe(shed=True)                # latency: excluded from p99
    out = mon.evaluate()
    assert out["p99"]["burn_short"] is None and not mon.burning


# ------------------------------------------------------ server integration

class _EchoAdapter:
    op = "echo"

    def shape_class(self, payload, coarse=False):
        return "any" if coarse else payload[0]

    def rungs(self, degraded=False):
        return ("fast",) if degraded else ("fast", "safe")

    def run_batch(self, payloads, rung, coarse=False, device=None):
        return [p[1] for p in payloads]

    def preflight_builder(self, payloads, rung, coarse=False, device=None):
        return None


def test_server_slo_burn_trips_and_releases_degraded_mode():
    """The acceptance cycle: sustained injected overload (every batch
    200ms against a 50ms objective) trips slo-burn -> degraded mode via
    the SLO hook; once the violations age out of the windows, slo-ok
    fires and degraded mode exits."""
    clock = VirtualClock()
    mon = SLOMonitor([Objective("p99", "p99_latency_ms", 50.0)],
                     clock=clock, short_window_s=30.0, long_window_s=30.0,
                     burn_threshold=2.0, min_samples=4)
    server = Server(adapters={"echo": _EchoAdapter()}, clock=clock,
                    max_batch=1, slo=mon, device="cpu")
    with faults.injected("slow:serve.echo:200:1:8"):
        for v in range(6):
            server.submit("echo", ("k", v))
            server.step()
    assert server.degraded and server._degrade_reason == "slo-burn"
    (ev,) = trace.events("slo-burn")
    assert ev["objective"] == "p99"
    begun = [e for e in trace.events("span-begin")
             if e.get("span") == "degraded-mode"]
    assert begun and begun[-1]["reason"] == "slo-burn"
    # recovery: the bad samples age out, fast traffic resumes
    clock.advance(31.0)
    for v in range(3):
        server.submit("echo", ("k", v))
        server.step()
    assert trace.events("slo-ok") and not mon.burning
    assert not server.degraded and server._degrade_reason is None
    assert len(trace.events("slo-burn")) == 1   # no flap across the cycle


def test_trace_summary_reports_slo_section():
    from cme213_tpu_torch.trace_cli import summarize

    mon, clock = monitor(Objective("shed", "shed_rate", 0.1))
    for _ in range(10):
        mon.observe(shed=True)
    mon.evaluate()
    clock.advance(6.0)
    for _ in range(20):
        mon.observe(shed=False)
    mon.evaluate()
    out = io.StringIO()
    summary = summarize(trace.events(), out=out)
    assert summary["slo"]["burns"] == 1 and summary["slo"]["oks"] == 1
    assert summary["slo"]["objectives"] == ["shed"]
    assert summary["slo"]["last_burn"]["objective"] == "shed"
    text = out.getvalue()
    assert "slo: 1 burn(s), 1 recover(ies) [shed]" in text


@pytest.mark.parametrize("kind,target", [("p99_latency_ms", 50.0),
                                         ("shed_rate", 0.1),
                                         ("error_rate", 0.2),
                                         ("drift_rate", 0.25)])
def test_burns_states_and_events_match_the_jax_package(kind, target):
    """One seeded stream of outcomes through both packages' monitors on
    their own virtual clocks: every evaluation's state, the burn gauge
    and the slo-burn / slo-ok events agree field for field."""
    import numpy as np

    from cme213_tpu.core import metrics as jmetrics
    from cme213_tpu.core import trace as jtrace
    from cme213_tpu.core.resilience import VirtualClock as JClock
    from cme213_tpu.serve.slo import Objective as JObjective
    from cme213_tpu.serve.slo import SLOMonitor as JSLOMonitor

    jtrace.clear_events()
    jmetrics.reset()
    ours, clock = monitor(Objective("o", kind, target), min_samples=3)
    jclock = JClock()
    theirs = JSLOMonitor([JObjective("o", kind, target)], clock=jclock,
                         short_window_s=5.0, long_window_s=60.0,
                         min_samples=3)
    rng = np.random.default_rng(4)
    for step in range(40):
        bad = step < 15 or 28 <= step < 32
        for _ in range(3):
            kw = {"latency_ms": float(rng.uniform(60, 90) if bad
                                      else rng.uniform(1, 40)),
                  "shed": bool(bad and rng.random() < 0.5),
                  "failed": bool(bad and rng.random() < 0.5),
                  "drift": (bool(bad) if rng.random() < 0.7 else None)}
            ours.observe(**kw)
            theirs.observe(**kw)
        assert ours.evaluate() == theirs.evaluate()
        assert ours.burning == theirs.burning
        assert metrics.gauge("serve.slo.burn").value == \
            jmetrics.gauge("serve.slo.burn").value
        clock.advance(1.0)
        jclock.advance(1.0)
    for event in ("slo-burn", "slo-ok"):
        strip = ("ts", "t", "seq", "pid", "trace", "host", "rank",
                 "incarnation", "span_id", "parent")
        mine = [{k: v for k, v in e.items() if k not in strip}
                for e in trace.events(event)]
        ref = [{k: v for k, v in e.items() if k not in strip}
               for e in jtrace.events(event)]
        assert mine == ref and (event == "slo-ok" or mine)
