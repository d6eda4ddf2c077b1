"""The port's fleet router (``cme213_tpu_torch/serve/router.py``) on the CPU.

The in-process router and autoscaler cases of the JAX package's
``tests/test_fleet_serving.py`` (deficit round robin, weights, the
front-tier shed, breakers, the zero-loss requeue ledger, autoscaler
hysteresis), run against both packages; then the parity arcs: the same
seeded event script (submits, assignments, completions, transport
failures, replica deaths and relaunches, clock advances) drives both
packages' ``Router``, and the same burn/occupancy script both packages'
``Autoscaler``, on a ``VirtualClock`` each, and every assignment,
requeue, breaker state, routing snapshot, trace event and scale action
(with its time) must agree.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import cme213_tpu.core.faults as jfaults
import cme213_tpu.core.metrics as jmetrics
import cme213_tpu.core.resilience as jresilience
import cme213_tpu.core.trace as jtrace
import cme213_tpu.serve.router as jrouter
from cme213_tpu_torch.core import faults, metrics, resilience, trace
from cme213_tpu_torch.serve import router

PORT = SimpleNamespace(name="port", router=router, trace=trace,
                       metrics=metrics, faults=faults,
                       VirtualClock=resilience.VirtualClock)
JAX = SimpleNamespace(name="jax", router=jrouter, trace=jtrace,
                      metrics=jmetrics, faults=jfaults,
                      VirtualClock=jresilience.VirtualClock)


def _reset_all():
    for pkg in (PORT, JAX):
        pkg.trace.clear_events()
        pkg.metrics.reset()
        pkg.faults.reset()


@pytest.fixture(autouse=True)
def _clean_slate():
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(params=[PORT, JAX], ids=lambda p: p.name)
def pkg(request):
    return request.param


def _doc(tenant="default", op="cipher"):
    return {"op": op, "tenant": tenant, "payload": {}}


def test_router_imports_the_port_s_core():
    """The port's router runs on the port's breaker, clock and trace."""
    r = router.Router(clock=resilience.VirtualClock())
    assert isinstance(r.breaker, resilience.CircuitBreaker)
    assert router.ROUTE_OP == jrouter.ROUTE_OP == "fleet.route"
    assert router.Ticket.__module__ == "cme213_tpu_torch.serve.router"


# ------------------------------------------------------ router: DRR

def test_drr_noisy_tenant_cannot_starve_quiet(pkg):
    r = pkg.router.Router(clock=pkg.VirtualClock())
    r.register_replica(0, capacity=1)
    for _ in range(40):
        assert r.submit(_doc("noisy")) is not None
    quiet = [r.submit(_doc("quiet")) for _ in range(4)]
    assert all(q is not None for q in quiet)

    order = []
    while True:
        picked = r.next_assignment()
        if picked is None:
            break
        ticket, rank = picked
        order.append(ticket.tenant)
        r.complete(ticket, rank)
    assert len(order) == 44
    quiet_positions = [i for i, t in enumerate(order) if t == "quiet"]
    assert len(quiet_positions) == 4
    assert max(quiet_positions) < 10
    ev = pkg.trace.events("request-routed")
    assert len(ev) == 44 and all(e["replica"] == 0 for e in ev)


def test_drr_weights_bias_dispatch_share(pkg):
    r = pkg.router.Router(clock=pkg.VirtualClock(),
                          weights={"best-effort": 0.5})
    r.register_replica(0, capacity=1)
    for _ in range(30):
        r.submit(_doc("gold"))
        r.submit(_doc("best-effort"))
    order = []
    for _ in range(18):
        ticket, rank = r.next_assignment()
        order.append(ticket.tenant)
        r.complete(ticket, rank)
    assert order.count("gold") == 2 * order.count("best-effort")


def test_router_sheds_when_backlog_full(pkg):
    r = pkg.router.Router(clock=pkg.VirtualClock(), capacity=2)
    assert r.submit(_doc()) is not None
    assert r.submit(_doc()) is not None
    assert r.submit(_doc()) is None
    assert pkg.metrics.counter("fleet.shed.queue-full").value == 1
    assert r.backlog() == 2


# ------------------------------------------ router: breakers + loss

def test_breaker_opens_and_routes_around_bad_replica(pkg):
    clock = pkg.VirtualClock()
    r = pkg.router.Router(clock=clock, breaker_threshold=2,
                          breaker_cooldown_s=5.0)
    r.register_replica(0, capacity=4)
    r.register_replica(1, capacity=4)
    r.submit(_doc())
    for _ in range(2):
        ticket, rank = r.next_assignment()
        assert rank == 0
        r.fail_transport(ticket, rank)
    assert r.state()["replicas"]["r0"]["breaker"] == "open"
    ticket, rank = r.next_assignment()
    assert rank == 1
    assert ticket.requeues == 2
    r.complete(ticket, rank)
    assert r.total_requeues == 2 and r.requeues[0] == 2
    clock.advance(6.0)
    r.submit(_doc())
    _, rank = r.next_assignment()
    assert rank == 0


def test_mark_down_requeues_inflight_at_front_zero_loss(pkg):
    r = pkg.router.Router(clock=pkg.VirtualClock())
    r.register_replica(0, capacity=4)
    t_old = r.submit(_doc("a"))
    t_new = r.submit(_doc("a"))
    assigned = [r.next_assignment() for _ in range(2)]
    assert all(a is not None and a[1] == 0 for a in assigned)
    assert r.inflight() == 2

    lost = r.mark_down(0, reason="sigkill")
    assert {t.seq for t in lost} == {t_old.seq, t_new.seq}
    assert r.inflight() == 0 and r.backlog() == 2
    ev = pkg.trace.events("request-requeued")
    assert len(ev) == 2 and all(e["from_replica"] == 0 for e in ev)
    assert r.complete(t_old, 0) is False

    r.register_replica(1, capacity=4)
    redone = [r.next_assignment() for _ in range(2)]
    assert {a[0].seq for a in redone} == {t_old.seq, t_new.seq}
    assert all(a[1] == 1 for a in redone)
    assert all(a[0].requeues == 1 for a in redone)


def test_retiring_replica_takes_no_new_work(pkg):
    r = pkg.router.Router(clock=pkg.VirtualClock())
    r.register_replica(0, capacity=4)
    r.register_replica(1, capacity=4)
    r.mark_retiring(0)
    r.submit(_doc())
    _, rank = r.next_assignment()
    assert rank == 1
    assert r.state()["replicas"]["r0"]["retiring"] is True
    assert r.occupancy() == pytest.approx(1 / 8)


# ------------------------------------------------ autoscaler hysteresis

def _scaler(pkg, clock, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 2)
    kw.setdefault("burn_sustain_s", 3.0)
    kw.setdefault("ok_sustain_s", 6.0)
    kw.setdefault("cooldown_s", 10.0)
    return pkg.router.Autoscaler(clock=clock, **kw)


def test_autoscaler_burn_must_sustain_before_scale_up(pkg):
    clock = pkg.VirtualClock()
    a = _scaler(pkg, clock)
    assert a.evaluate(True, 0.9, 1) is None
    clock.advance(2.0)
    assert a.evaluate(True, 0.9, 1) is None
    clock.advance(1.5)
    assert a.evaluate(True, 0.9, 1) == "up"
    ev = pkg.trace.events("scale-up")
    assert ev[-1]["replicas"] == 2 and ev[-1]["reason"] == "slo-burn"
    clock.advance(4.0)
    assert a.evaluate(True, 0.9, 2) is None


def test_autoscaler_scale_down_needs_health_idle_and_cooldown(pkg):
    clock = pkg.VirtualClock()
    a = _scaler(pkg, clock)
    assert a.evaluate(True, 0.9, 1) is None
    clock.advance(3.0)
    assert a.evaluate(True, 0.9, 1) == "up"
    assert a.evaluate(False, 0.1, 2) is None
    clock.advance(6.0)
    assert a.evaluate(False, 0.1, 2) is None
    clock.advance(4.5)
    assert a.evaluate(False, 0.1, 2) == "down"
    ev = pkg.trace.events("scale-down")
    assert ev[-1]["replicas"] == 1 and ev[-1]["reason"] == "slo-ok"
    clock.advance(20.0)
    assert a.evaluate(False, 0.0, 1) is None
    clock.advance(20.0)
    assert a.evaluate(False, 0.0, 1) is None


def test_autoscaler_busy_fleet_resets_the_idle_timer(pkg):
    clock = pkg.VirtualClock()
    a = _scaler(pkg, clock)
    assert a.evaluate(False, 0.1, 2) is None
    clock.advance(5.0)
    assert a.evaluate(False, 0.8, 2) is None
    clock.advance(5.0)
    assert a.evaluate(False, 0.1, 2) is None
    clock.advance(6.0)
    assert a.evaluate(False, 0.1, 2) == "down"


def test_autoscaler_is_deterministic_under_virtual_clock(pkg):
    script = [(True, 0.9, 1), (True, 0.9, 1), (True, 0.9, 1),
              (False, 0.2, 2), (False, 0.2, 2), (False, 0.2, 2),
              (False, 0.2, 2), (False, 0.2, 2)]

    def run():
        clock = pkg.VirtualClock()
        a = _scaler(pkg, clock)
        out = []
        for burning, occ, n in script:
            out.append(a.evaluate(burning, occ, n))
            clock.advance(2.0)
        return out

    first, second = run(), run()
    assert first == second
    assert "up" in first and "down" in first


def test_replica_kill_clause_parses_and_misses_other_ranks(monkeypatch):
    """The port's ``replica-kill`` clause reads ``RANK`` (the JAX package
    reads ``JAX_PROCESS_ID``): another rank's clause is a no-op."""
    monkeypatch.setenv("RANK", "3")
    plan = faults.FaultPlan.parse("replica-kill:1:3")
    (clause,) = plan.clauses
    assert clause.kind == "replica-kill" and clause.op == "1"
    assert clause.nth == 3
    with faults.injected("replica-kill:7"):
        faults.maybe_kill_replica()
    with pytest.raises(faults.FaultSpecError):
        faults.FaultPlan.parse("replica-kill")


# ------------------------------------------------------------- parity

_EVENT_KEYS = ("event", "rid", "op", "tenant", "replica", "from_replica",
               "replicas", "reason")


def _events(pkg, names):
    return [{k: e.get(k) for k in _EVENT_KEYS if k in e}
            for e in pkg.trace.events() if e["event"] in names]


def _drive_router(pkg, seed: int, steps: int = 400):
    """One seeded event script against ``pkg``'s router; returns every
    decision it made, its snapshot after each step, and its events."""
    rng = np.random.default_rng(seed)
    clock = pkg.VirtualClock()
    r = pkg.router.Router(clock=clock, capacity=24, breaker_threshold=2,
                          breaker_cooldown_s=3.0,
                          weights={"t1": 0.5, "t2": 2.0})
    for rank in range(3):
        r.register_replica(rank, capacity=2)
    live: list = []                      # (ticket, rank) in flight
    log = []
    for _ in range(steps):
        act = int(rng.integers(0, 10))
        if act <= 2:
            t = r.submit(_doc(f"t{int(rng.integers(0, 3))}",
                              op=("cipher", "sort")[int(rng.integers(0, 2))]))
            log.append(("submit", None if t is None else t.seq))
        elif act <= 4:
            a = r.next_assignment()
            if a is not None:
                live.append(a)
            log.append(("assign", None if a is None
                        else (a[0].seq, a[0].tenant, a[1])))
        elif act == 5 and live:
            ticket, rank = live.pop(int(rng.integers(0, len(live))))
            log.append(("complete", ticket.seq,
                        r.complete(ticket, rank, ok=bool(rng.integers(0, 4)))))
        elif act == 6 and live:
            ticket, rank = live.pop(int(rng.integers(0, len(live))))
            r.fail_transport(ticket, rank)
            log.append(("fail", ticket.seq, rank))
        elif act == 7:
            rank = int(rng.integers(0, 3))
            lost = r.mark_down(rank, reason="kill")
            log.append(("down", rank, sorted(t.seq for t in lost)))
        elif act == 8:
            rank = int(rng.integers(0, 3))
            inc = r.replicas[rank].incarnation + 1
            r.register_replica(rank, capacity=2, incarnation=inc)
            log.append(("up", rank, inc))
        else:
            dt = float(rng.choice((0.5, 1.0, 2.5)))
            clock.advance(dt)
            log.append(("tick", dt))
        log.append(r.state())
    return log, _events(pkg, ("request-routed", "request-requeued"))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_router_decisions_equal_reference(seed):
    """Same script, same decisions: assignments in the same order to the
    same ranks, the same requeues, breaker transitions and snapshots."""
    _reset_all()
    port_log, port_ev = _drive_router(PORT, seed)
    jax_log, jax_ev = _drive_router(JAX, seed)
    assert port_log == jax_log
    assert port_ev == jax_ev
    kinds = {entry[0] for entry in port_log if isinstance(entry, tuple)}
    assert {"assign", "fail", "down", "up"} <= kinds
    states = {rep["breaker"] for entry in port_log if isinstance(entry, dict)
              for rep in entry["replicas"].values()}
    assert {"closed", "open"} <= states


def test_router_metrics_equal_reference():
    """The routing counters (routed, requeued, shed) agree too."""
    _drive_router(PORT, 5)
    _drive_router(JAX, 5)
    names = ("fleet.routed", "fleet.requeued", "fleet.shed.queue-full")
    port = {n: metrics.counter(n).value for n in names}
    ref = {n: jmetrics.counter(n).value for n in names}
    assert port == ref and port["fleet.routed"] > 0


def _drive_scaler(pkg, seed: int, steps: int = 300):
    rng = np.random.default_rng(seed)
    clock = pkg.VirtualClock()
    a = pkg.router.Autoscaler(clock=clock, min_replicas=2, max_replicas=3,
                              burn_sustain_s=2.0, ok_sustain_s=4.0,
                              cooldown_s=5.0)
    n = 2
    actions = []
    for step in range(steps):
        # alternating stormy and calm phases, each with some noise
        stormy = (step // 25) % 2 == 0
        burning = bool(rng.random() < (0.85 if stormy else 0.1))
        occupancy = float(rng.choice((0.1, 0.4, 0.7)))
        decision = a.evaluate(burning, occupancy, n)
        if decision is not None:
            actions.append((decision, clock.now(), n))
            n += 1 if decision == "up" else -1
        clock.advance(float(rng.choice((0.5, 1.0, 1.5))))
    return actions, _events(pkg, ("scale-up", "scale-down"))


@pytest.mark.parametrize("seed", [0, 7])
def test_autoscaler_actions_and_times_equal_reference(seed):
    port_actions, port_ev = _drive_scaler(PORT, seed)
    jax_actions, jax_ev = _drive_scaler(JAX, seed)
    assert port_actions == jax_actions
    assert port_ev == jax_ev
    assert {d for d, _, _ in port_actions} == {"up", "down"}
