"""The port's serving front end (``cme213_tpu_torch/serve``) on the CPU.

The JAX package's ``tests/test_serve.py`` cases, ported one for one
(bounded-queue backpressure, deadline rejection, breaker arcs, batch
conformance, degradation, the load generator, request lifecycles), every
server on ``device="cpu"`` and every timing decision on a
``VirtualClock``; then the cross-package checks: each op of the loadgen
mix served by both packages from the same seeded requests (cipher, sort
and stub bitwise, heat within 10 ULP, spmv within rel-L2 1e-5 and bitwise
on integer-valued inputs), the same report text from the same results,
the batched sorts, byte-count admission, and the device rule.

The serving contract these pin: a request served from a batch is BITWISE
its serial solve on the same device; batching is a scheduling decision,
never a numerics decision.
"""

import time

import numpy as np
import pytest
import torch

from cme213_tpu_torch.core import admission, faults, metrics, trace
from cme213_tpu_torch.core.compare import ulp_distance
from cme213_tpu_torch.core.errors import FrameworkError
from cme213_tpu_torch.core.resilience import VirtualClock
from cme213_tpu_torch.serve import (
    ADMISSION,
    DEADLINE,
    FAILED,
    OK,
    QUEUE_FULL,
    SHED,
    CipherRequest,
    Server,
    SolveResult,
)
from cme213_tpu_torch.serve.loadgen import (build_mix, format_report,
                                            run_load, slo_report)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.delenv(admission.BUDGET_ENV, raising=False)
    trace.clear_events()
    metrics.reset()
    yield
    faults.reset()
    metrics.reset()


def one_rung_sorts(rung):
    """The sort adapter serving ``rung`` alone (its default ladder starts
    at ``lax``)."""
    from cme213_tpu_torch.serve.workloads import SortAdapter

    class OneRung(SortAdapter):
        def rungs(self, degraded=False):
            return (rung,)

    return OneRung()


class EchoAdapter:
    """Minimal adapter for scheduler-behaviour tests: payloads are
    (class_key, value) tuples, two rungs both echoing the values; failure
    comes from ``fail:serve.echo.<rung>`` clauses, never the workload."""

    op = "echo"

    def __init__(self):
        self.calls: list[tuple[str, int]] = []  # (rung, batch size)

    def shape_class(self, payload, coarse: bool = False) -> str:
        return "any" if coarse else payload[0]

    def rungs(self, degraded: bool = False):
        return ("fast",) if degraded else ("fast", "safe")

    def run_batch(self, payloads, rung: str, coarse: bool = False,
                  device=None):
        self.calls.append((rung, len(payloads)))
        return [p[1] for p in payloads]

    def preflight_builder(self, payloads, rung, coarse=False, device=None):
        return None


def echo_server(**kw):
    adapter = EchoAdapter()
    kw.setdefault("clock", VirtualClock())
    kw.setdefault("device", CPU)
    server = Server(adapters={"echo": adapter}, **kw)
    return server, adapter


# ----------------------------------------------------- queue backpressure

def test_queue_full_sheds_newest_keeps_fifo():
    server, adapter = echo_server(capacity=2, max_batch=2)
    r0 = server.submit("echo", ("k", 10))
    r1 = server.submit("echo", ("k", 11))
    shed = server.submit("echo", ("k", 12))   # over capacity: refused NOW
    assert isinstance(r0, int) and isinstance(r1, int)
    assert isinstance(shed, SolveResult)
    assert shed.status == SHED and shed.reason == QUEUE_FULL
    ev = trace.events("queue-shed")
    assert ev and ev[-1]["reason"] == QUEUE_FULL and ev[-1]["depth"] == 2
    assert metrics.counter(f"serve.shed.{QUEUE_FULL}").value == 1

    served = server.drain()                    # admitted requests unharmed
    assert [r.rid for r in served] == [r0, r1]  # FIFO order retained
    assert [r.value for r in served] == [10, 11]
    assert all(r.status == OK for r in served)


def test_unknown_op_rejected():
    server, _ = echo_server()
    with pytest.raises(ValueError, match="unknown op"):
        server.submit("nope", None)


# --------------------------------------------------------------- deadlines

def test_expired_deadline_rejected_before_execution():
    clock = VirtualClock()
    server, adapter = echo_server(clock=clock)
    rid = server.submit("echo", ("k", 1), deadline_ms=50)
    assert isinstance(rid, int)
    clock.advance(0.2)                         # deadline long gone
    results = server.step()
    assert [r.status for r in results] == [SHED]
    assert results[0].reason == DEADLINE
    assert adapter.calls == []                 # never executed late
    ev = trace.events("deadline-shed")
    assert ev[-1]["rid"] == rid and ev[-1]["late_ms"] >= 150
    assert metrics.counter(f"serve.shed.{DEADLINE}").value == 1


def test_nonpositive_deadline_shed_at_submit():
    server, adapter = echo_server()
    out = server.submit("echo", ("k", 1), deadline_ms=0)
    assert isinstance(out, SolveResult)
    assert out.status == SHED and out.reason == DEADLINE
    assert adapter.calls == []


def test_deadline_met_serves():
    clock = VirtualClock()
    server, _ = echo_server(clock=clock)
    server.submit("echo", ("k", 7), deadline_ms=100)
    clock.advance(0.05)                        # inside the deadline
    results = server.step()
    assert [r.status for r in results] == [OK]
    assert results[0].value == 7


def test_deadline_sweep_spares_undated_requests():
    clock = VirtualClock()
    server, _ = echo_server(clock=clock, max_batch=4)
    server.submit("echo", ("k", 1), deadline_ms=10)
    keep = server.submit("echo", ("k", 2))     # no deadline
    clock.advance(1.0)
    results = server.step()
    assert {r.status for r in results} == {SHED, OK}
    ok = [r for r in results if r.status == OK]
    assert [r.rid for r in ok] == [keep]


# ---------------------------------------------------------- batch buckets

def test_batches_form_within_shape_class_only():
    server, adapter = echo_server(max_batch=8)
    for v in range(3):
        server.submit("echo", ("A", v))
    for v in range(2):
        server.submit("echo", ("B", 10 + v))
    first = server.step()                      # head bucket: all of A
    assert [r.value for r in first] == [0, 1, 2]
    assert adapter.calls == [("fast", 3)]
    second = server.step()                     # then B
    assert [r.value for r in second] == [10, 11]
    ev = trace.events("batch-executed")
    assert [e["size"] for e in ev] == [3, 2]
    assert ev[0]["shape_class"] == "A" and ev[1]["shape_class"] == "B"


def test_max_batch_caps_batch_size():
    server, adapter = echo_server(max_batch=2)
    for v in range(5):
        server.submit("echo", ("k", v))
    server.drain()
    assert [size for _, size in adapter.calls] == [2, 2, 1]
    ev = trace.events("batch-executed")
    assert ev[0]["occupancy"] == 1.0 and ev[-1]["occupancy"] == 0.5


# -------------------------------------------------------- circuit breaker

def test_breaker_open_routes_around_then_recovers():
    """The full arc: 3 classified failures open the circuit for the fast
    rung; while open, requests are routed to the safe rung WITHOUT
    executing the broken one; after the cooldown a half-open probe runs
    the healed rung and closes the circuit."""
    clock = VirtualClock()
    server, adapter = echo_server(
        clock=clock, max_batch=1, breaker_threshold=3,
        breaker_cooldown_s=10.0)
    with faults.injected("fail:serve.echo.fast:1:3"):
        for v in range(3):                     # three faulted serves
            server.submit("echo", ("k", v))
            (res,) = server.step()
            assert res.status == OK and res.rung == "safe"
        ev = trace.events("breaker-open")
        assert ev[-1]["op"] == "serve.echo" and ev[-1]["rung"] == "fast"
        assert ev[-1]["failures"] == 3

        # circuit open: fast is skipped (not executed, not a demotion)
        server.submit("echo", ("k", 99))
        (res,) = server.step()
        assert res.rung == "safe"
        assert metrics.counter("breaker.skipped").value == 1
        assert ("fast", 1) not in adapter.calls  # fast never ran at all

        # past the cooldown: half-open probe; the fault budget (3) is
        # exhausted, so the probe succeeds and the circuit closes
        clock.advance(11.0)
        server.submit("echo", ("k", 100))
        (res,) = server.step()
        assert res.rung == "fast"
        assert trace.events("breaker-half-open")
        assert trace.events("breaker-close")
    server.submit("echo", ("k", 101))
    (res,) = server.step()
    assert res.rung == "fast" and res.value == 101


def test_breaker_halfopen_failure_reopens():
    clock = VirtualClock()
    server, _ = echo_server(clock=clock, max_batch=1, breaker_threshold=2,
                            breaker_cooldown_s=5.0)
    with faults.injected("fail:serve.echo.fast:1:5"):
        for v in range(2):
            server.submit("echo", ("k", v))
            server.step()
        assert len(trace.events("breaker-open")) == 1
        clock.advance(6.0)
        server.submit("echo", ("k", 2))
        (res,) = server.step()                 # probe fails -> reopen
        assert res.status == OK and res.rung == "safe"
        assert len(trace.events("breaker-open")) == 2
        assert len(trace.events("breaker-close")) == 0


def test_breaker_events_feed_slo_report():
    clock = VirtualClock()
    server, _ = echo_server(clock=clock, max_batch=1, breaker_threshold=2,
                            breaker_cooldown_s=1e9)
    before = metrics.snapshot()
    t0 = clock.now()
    with faults.injected("fail:serve.echo.fast:1:2"):
        results = []
        for v in range(3):
            server.submit("echo", ("k", v))
            results.extend(server.step())
    report = slo_report({"results": results, "elapsed_s": clock.now() - t0},
                        before, metrics.snapshot())
    assert report["served"] == 3 and report["breaker"]["opened"] == 1
    assert report["breaker"]["skipped"] == 1
    assert report["demotions"] == 2


# ------------------------------------------------------- slow: straggler

def test_slow_clause_stretches_latency_on_server_clock():
    clock = VirtualClock()
    server, _ = echo_server(clock=clock, max_batch=1)
    with faults.injected("slow:serve.echo:250"):
        server.submit("echo", ("k", 1))
        (res,) = server.step()
    assert res.status == OK
    assert res.latency_ms >= 250                # straggler visible in SLO
    ev = trace.events("fault-injected")
    assert any(e["kind"] == "slow" and e["op"] == "serve.echo" for e in ev)


def test_slow_clause_can_push_next_request_past_deadline():
    clock = VirtualClock()
    server, _ = echo_server(clock=clock, max_batch=1)
    with faults.injected("slow:serve.echo:500:1"):
        server.submit("echo", ("k", 1))
        server.submit("echo", ("k", 2), deadline_ms=100)
        first = server.step()                  # pays the 500ms straggler
        second = server.step()                 # sweep finds rid 2 expired
    assert [r.status for r in first] == [OK]
    assert [(r.status, r.reason) for r in second] == [(SHED, DEADLINE)]


# ---------------------------------------------------- admission (budget)

class RejectingAdapter(EchoAdapter):
    """Echo adapter whose preflight admits nothing."""

    def preflight_builder(self, payloads, rung, coarse=False, device=None):
        def preflight_at(size):
            return admission.Decision(False, 10**9, 1, "over budget")

        return preflight_at


class ShrinkingAdapter(EchoAdapter):
    """Preflight admits at most 2 lanes: forces a batch shrink, the
    leftover stays queued."""

    def preflight_builder(self, payloads, rung, coarse=False, device=None):
        def preflight_at(size):
            return admission.Decision(size <= 2, size, 2, f"size {size}")

        return preflight_at


def test_admission_rejection_sheds_with_reason(monkeypatch):
    monkeypatch.setenv(admission.BUDGET_ENV, "1")
    adapter = RejectingAdapter()
    server = Server(adapters={"echo": adapter}, clock=VirtualClock(),
                    max_batch=4, device=CPU)
    for v in range(3):
        server.submit("echo", ("k", v))
    results = server.step()
    assert [r.status for r in results] == [SHED] * 3
    assert all(r.reason == ADMISSION for r in results)
    assert adapter.calls == []
    assert metrics.counter(f"serve.shed.{ADMISSION}").value == 3
    assert len(server.queue) == 0              # nothing left to spin on


def test_admission_shrinks_batch_keeps_overflow_queued(monkeypatch):
    monkeypatch.setenv(admission.BUDGET_ENV, "1")
    adapter = ShrinkingAdapter()
    server = Server(adapters={"echo": adapter}, clock=VirtualClock(),
                    max_batch=4, device=CPU)
    for v in range(4):
        server.submit("echo", ("k", v))
    first = server.step()
    assert [r.value for r in first] == [0, 1]  # admitted pair served
    assert len(server.queue) == 2              # overflow queued, not shed
    second = server.step()
    assert [r.value for r in second] == [2, 3]
    assert all(size <= 2 for _, size in adapter.calls)


# ------------------------------------------------- graceful degradation

def test_degraded_mode_enters_exits_with_hysteresis():
    clock = VirtualClock()
    server, adapter = echo_server(clock=clock, max_batch=2,
                                  degrade_depth=3)
    for v in range(4):                         # depth 4 >= 3: degrade
        server.submit("echo", ("A" if v % 2 else "B", v))
    first = server.step()
    assert server.degraded
    # degraded keying is coarse ("any"): A and B merge into one batch
    assert adapter.calls[-1] == ("fast", 2)
    assert all(r.degraded for r in first)
    assert any(e["span"] == "degraded-mode"
               for e in trace.events("span-begin"))
    assert metrics.gauge("serve.degraded").value == 1

    server.step()                              # depth 2 > 3//2: still in
    assert server.degraded
    server.step()                              # depth 0 <= 1: exits
    assert not server.degraded
    assert metrics.gauge("serve.degraded").value == 0


def test_degraded_mode_uses_degraded_ladder():
    server, adapter = echo_server(max_batch=8, degrade_depth=2)
    with faults.injected("fail:serve.echo.fast:1:1"):
        for v in range(3):
            server.submit("echo", ("k", v))
        results = server.step()
    # degraded ladder is ("fast",) only: the injected failure has no safe
    # rung to demote to, so the batch FAILS (predictable over peak-fast)
    assert all(r.status == "failed" for r in results)


# --------------------------------------- batch conformance: real workloads

def _spmv_serial(prob, rung):
    from cme213_tpu_torch.apps.spmv_scan import _iterate, problem_tensors

    a, xx, flags, _ = problem_tensors(prob, torch.float32, CPU)
    return _iterate(a, xx, flags, prob.iters, scan=rung).numpy()


def test_spmv_batch_bitwise_equal_serial():
    from cme213_tpu_torch.apps.spmv_scan import generate_problem

    probs = [generate_problem(256, p=6, q=64, iters=5, seed=s)
             for s in range(4)]
    server = Server(max_batch=4, clock=VirtualClock(), device=CPU)
    for p in probs:
        server.submit("spmv_scan", p)
    results = server.drain()
    assert [r.status for r in results] == [OK] * 4
    assert results[0].batch_size == 4          # one solve served all
    for r, p in zip(results, probs):
        np.testing.assert_array_equal(r.value, _spmv_serial(p, r.rung))


def test_heat_batch_bitwise_equal_serial():
    from cme213_tpu_torch.config import SimParams
    from cme213_tpu_torch.grid import make_initial_grid
    from cme213_tpu_torch.ops.stencil import run_heat

    params = [SimParams(nx=16, ny=16, order=2, iters=3, alpha=a)
              for a in (0.5, 1.0, 2.0)]
    server = Server(max_batch=4, clock=VirtualClock(), device=CPU)
    for p in params:
        server.submit("heat", p)
    results = server.drain()
    assert [r.status for r in results] == [OK] * 3
    assert results[0].batch_size == 3
    for r, p in zip(results, params):
        ref = run_heat(make_initial_grid(p, device=CPU), p.iters, p.order,
                       p.xcfl, p.ycfl).numpy()
        np.testing.assert_array_equal(r.value, ref)


def test_cipher_batch_bitwise_equal_serial_both_rungs():
    from cme213_tpu_torch.ops.elementwise import (shift_cipher,
                                                  shift_cipher_packed)

    rng = np.random.default_rng(3)
    reqs = [CipherRequest(rng.integers(0, 200, 256).astype(np.uint8),
                          int(rng.integers(0, 56))) for _ in range(5)]
    server = Server(max_batch=8, clock=VirtualClock(), device=CPU)
    for q in reqs:
        server.submit("cipher", q)
    results = server.drain()
    assert [r.status for r in results] == [OK] * 5
    for r, q in zip(results, reqs):
        t = torch.from_numpy(q.text)
        np.testing.assert_array_equal(
            r.value, shift_cipher_packed(t, q.shift).numpy())
        np.testing.assert_array_equal(r.value,
                                      shift_cipher(t, q.shift).numpy())


def test_cipher_breaker_fallback_bitwise_equal():
    """The acceptance arc on a real workload: fail the packed rung until
    its circuit opens, verify the bytes rung serves BITWISE-equal
    results, then recover via the half-open probe."""
    from cme213_tpu_torch.ops.elementwise import shift_cipher

    clock = VirtualClock()
    server = Server(max_batch=1, clock=clock, breaker_threshold=3,
                    breaker_cooldown_s=10.0, device=CPU)
    rng = np.random.default_rng(7)
    reqs = [CipherRequest(rng.integers(0, 200, 128).astype(np.uint8), s)
            for s in range(5)]
    with faults.injected("fail:serve.cipher.packed:1:3"):
        for q in reqs[:4]:
            server.submit("cipher", q)
            (res,) = server.step()
            assert res.status == OK and res.rung == "bytes"
            ref = shift_cipher(torch.from_numpy(q.text), q.shift).numpy()
            np.testing.assert_array_equal(res.value, ref)
        assert trace.events("breaker-open")
        clock.advance(11.0)
        server.submit("cipher", reqs[4])
        (res,) = server.step()                 # half-open probe succeeds
        assert res.rung == "packed"
        assert trace.events("breaker-close")


def test_spmv_coarse_bucket_pads_and_stays_bitwise():
    """Degraded-mode coarse keying: two near sizes merge into one pow2
    bucket; the padded tail is quarantined, so each request's prefix is
    still bitwise its serial solve."""
    from cme213_tpu_torch.apps.spmv_scan import generate_problem

    probs = [generate_problem(200, p=4, q=32, iters=4, seed=1),
             generate_problem(250, p=4, q=32, iters=4, seed=2)]
    server = Server(max_batch=4, clock=VirtualClock(), degrade_depth=2,
                    device=CPU)
    for p in probs:
        server.submit("spmv_scan", p)
    results = server.drain()
    assert [r.status for r in results] == [OK] * 2
    assert results[0].batch_size == 2          # merged despite n mismatch
    assert results[0].shape_class == "n256/i4"
    assert all(r.degraded for r in results)
    for r, p in zip(results, probs):
        assert r.value.shape == (p.n,)
        np.testing.assert_array_equal(r.value, _spmv_serial(p, r.rung))


@pytest.mark.parametrize("rung", ["lax", "radix", "bitonic"])
def test_sort_batch_bitwise_equal_serial_every_rung(rung):
    """Each sort rung served as one batch: every lane is bitwise its 1-D
    sort on the same rung and the ``np.sort`` golden."""
    from cme213_tpu_torch.serve.workloads import _sort_one

    rng = np.random.default_rng(11)
    keys = [rng.integers(0, 2**32, 300, dtype=np.uint32) for _ in range(3)]
    server = Server(max_batch=4, clock=VirtualClock(), device=CPU,
                    adapters={"sort": one_rung_sorts(rung)})
    for k in keys:
        server.submit("sort", k)
    results = server.drain()
    assert [(r.status, r.rung, r.batch_size) for r in results] == \
        [(OK, rung, 3)] * 3
    for r, k in zip(results, keys):
        assert r.value.dtype == np.uint32
        np.testing.assert_array_equal(r.value, np.sort(k))
        np.testing.assert_array_equal(r.value, _sort_one(k, rung, CPU))


# ------------------------------------------------------------- throughput

def test_batched_serving_at_least_2x_serial():
    """The tier's reason to exist: B same-class solves through one stacked
    solve beat B one-at-a-time dispatches by >= 2x (warmed, CPU)."""
    from cme213_tpu_torch.apps.spmv_scan import generate_problem

    B = 32
    probs = [generate_problem(256, p=4, q=128, iters=4, seed=s)
             for s in range(B)]

    def run(max_batch):
        server = Server(max_batch=max_batch, capacity=B, device=CPU)
        for p in probs:
            server.submit("spmv_scan", p)
        t0 = time.perf_counter()
        results = server.drain()
        dt = time.perf_counter() - t0
        assert sum(r.status == OK for r in results) == B
        return dt

    # one intra-op thread: the stacked solve's tensors are large enough
    # for torch's CPU kernels to go parallel, and beside other test
    # workers those threads oversubscribe the host (a batch once took
    # 10x its serial solves that way); the 256-lane serial ops never do
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run(B)   # warm the batched program (build outside the clock)
        run(1)   # warm the serial program
        batched = min(run(B) for _ in range(3))
        serial = min(run(1) for _ in range(3))
    finally:
        torch.set_num_threads(threads)
    assert serial >= 2 * batched, (
        f"batched {batched:.4f}s vs serial {serial:.4f}s "
        f"({serial / batched:.2f}x)")


# ---------------------------------------------------------------- loadgen

def test_loadgen_closed_loop_serves_everything():
    specs = build_mix("cipher", 12, seed=0)
    server = Server(max_batch=4, capacity=16, device=CPU)
    before = metrics.snapshot()
    run = run_load(server, specs, mode="closed", concurrency=6)
    report = slo_report(run, before, metrics.snapshot())
    assert report["requests"] == 12 and report["served"] == 12
    assert report["shed"] == 0
    assert report["batches"] >= 3
    assert report["latency_ms"]["p50"] is not None
    assert report["throughput_rps"] > 0


def test_loadgen_open_burst_sheds_over_capacity():
    specs = build_mix("cipher", 24, seed=0)
    server = Server(max_batch=2, capacity=6, device=CPU)
    before = metrics.snapshot()
    run = run_load(server, specs, mode="open", burst=24)
    report = slo_report(run, before, metrics.snapshot())
    assert report["requests"] == 24
    assert report["shed"] >= 10                # overload MUST shed
    assert report["shed_by_reason"].get(QUEUE_FULL, 0) == report["shed"]
    assert report["served"] == 24 - report["shed"]
    assert trace.events("queue-shed")


def test_loadgen_mix_round_robins_ops():
    specs = build_mix("spmv,heat,cipher", 6, seed=0)
    assert [s.op for s in specs] == ["spmv_scan", "heat", "cipher"] * 2


def test_loadgen_rejects_unknown_mix():
    with pytest.raises(ValueError, match="unknown mix"):
        build_mix("spmv,warp", 4)


def test_serve_cli_registered(capsys):
    from cme213_tpu_torch.models import dispatch

    assert dispatch(["serve"]) == 2            # no subcommand: usage
    assert dispatch(["serve", "--help"]) == 0
    out = capsys.readouterr().out
    assert "loadgen" in out and "cme213_tpu_torch serve" in out
    assert dispatch(["serve", "nope"]) == 2


# ----------------------------------------------------- trace integration

def test_trace_summary_serving_section():
    from cme213_tpu_torch.trace_cli import summarize

    clock = VirtualClock()
    server, _ = echo_server(clock=clock, capacity=2, max_batch=2,
                            degrade_depth=2)
    for v in range(3):
        server.submit("echo", ("k", v))        # third sheds
    server.drain()
    serving = summarize(trace.events())["serving"]
    assert serving is not None
    assert serving["batches"] >= 1
    assert serving["shed"].get("echo:queue-full") == 1
    assert serving["degraded_batches"] >= 1


# ----------------------------------------------------- request lifecycle

def test_request_timing_phases_sum_to_total():
    clock = VirtualClock()
    server, _ = echo_server(clock=clock, max_batch=2)
    server.submit("echo", ("k", 1))
    clock.advance(0.05)                        # 50ms queued before step
    with faults.injected("slow:serve.echo:20"):
        (res,) = server.step()
    t = res.timing
    assert t["queue_ms"] == 50.0 and t["run_ms"] == 20.0
    phase_sum = (t["queue_ms"] + t["admit_ms"] + t["batch_wait_ms"]
                 + t["run_ms"])
    assert abs(phase_sum - t["total_ms"]) < 0.005
    ev = trace.events("request-served")[-1]
    assert ev["status"] == OK and ev["total_ms"] == t["total_ms"]
    assert ev["run_ms"] == 20.0
    assert metrics.histogram("serve.request.total_ms").count == 1
    assert metrics.histogram("serve.request.run_ms").percentile(1.0) == 20.0


def test_request_served_event_links_batch_span():
    server, _ = echo_server(max_batch=4)
    server.submit("echo", ("k", 1))
    server.submit("echo", ("k", 2))
    server.drain()
    reqs = trace.events("request-served")
    assert len(reqs) == 2
    batch_ids = {e["batch"] for e in reqs}
    assert len(batch_ids) == 1                 # same batch -> same span
    span_ids = {e["id"] for e in trace.events("span-begin")
                if e.get("span") == "serve.batch"}
    assert batch_ids <= span_ids               # rid -> serve.batch linkage


def test_failed_request_lifecycle_and_tenant_counter():
    server, _ = echo_server()
    server.submit("echo", ("k", 1), tenant="acme")
    with faults.injected("fail:serve.echo.fast,fail:serve.echo.safe"):
        (res,) = server.step()
    assert res.status == FAILED and res.tenant == "acme"
    assert res.timing["total_ms"] is not None
    ev = trace.events("request-served")[-1]
    assert ev["status"] == FAILED and ev["tenant"] == "acme"
    assert metrics.counter("serve.tenant.acme.failed").value == 1


def test_tenant_counters_and_shed_tags():
    server, _ = echo_server(capacity=1)
    server.submit("echo", ("k", 1), tenant="a")
    shed = server.submit("echo", ("k", 2), tenant="b")   # queue full
    assert shed.status == SHED and shed.tenant == "b"
    server.drain()
    assert metrics.counter("serve.tenant.a.requests").value == 1
    assert metrics.counter("serve.tenant.a.served").value == 1
    assert metrics.counter("serve.tenant.b.requests").value == 1
    assert metrics.counter("serve.tenant.b.shed").value == 1
    ev = trace.events("queue-shed")[-1]
    assert ev["tenant"] == "b" and ev["age_ms"] == 0.0 and ev["depth"] == 1


def test_deadline_shed_carries_depth_and_age():
    clock = VirtualClock()
    server, _ = echo_server(clock=clock)
    server.submit("echo", ("k", 1), deadline_ms=50, tenant="late")
    clock.advance(0.2)
    (res,) = server.step()
    assert res.status == SHED and res.reason == DEADLINE
    ev = trace.events("deadline-shed")[-1]
    assert ev["depth"] == 0                    # already pulled off queue
    assert ev["age_ms"] == 200.0 and ev["tenant"] == "late"


def test_summary_zero_count_shed_keys_and_lifecycle_sections():
    import io

    from cme213_tpu_torch.trace_cli import summarize

    server, _ = echo_server(max_batch=2)
    server.submit("echo", ("k", 1), tenant="a")
    server.submit("echo", ("k", 2), tenant="b")
    server.drain()                             # all served, nothing shed
    out = io.StringIO()
    agg = summarize(trace.events(), out=out)
    assert agg["serving"]["shed"] == {"echo:admission": 0,
                                      "echo:deadline": 0,
                                      "echo:queue-full": 0}
    assert set(agg["phases"]) == {"echo", "overall"}
    assert agg["phases"]["overall"]["total_ms"]["p50"] is not None
    assert agg["tenants"]["a"]["served"] == 1
    assert agg["tenants"]["b"]["served"] == 1
    assert agg["slo"] is None                  # no monitor ran
    text = out.getvalue()
    assert "request phases" in text and "tenants:" in text


def test_loadgen_report_phases_tenants_slo_sections():
    from cme213_tpu_torch.serve.slo import Objective, SLOMonitor

    specs = build_mix("cipher", 12, seed=0, tenants=2)
    assert {s.tenant for s in specs} == {"t0", "t1"}
    mon = SLOMonitor([Objective("p99-latency", "p99_latency_ms", 1e9)])
    server = Server(max_batch=4, capacity=16, slo=mon, device=CPU)
    before = metrics.snapshot()
    run = run_load(server, specs, mode="closed", concurrency=6)
    report = slo_report(run, before, metrics.snapshot(), slo=mon)
    assert report["served"] == 12
    overall = report["phases"]["overall"]
    assert set(overall) == {"queue", "admit", "batch_wait", "run", "total"}
    assert overall["total"]["p50"] is not None
    assert overall["total"]["p99"] >= overall["total"]["p50"]
    tn = report["tenants"]
    assert tn["t0"]["served"] + tn["t1"]["served"] == 12
    assert tn["t0"]["latency_ms"]["p50"] is not None
    assert report["slo"]["objectives"]["p99-latency"]["burning"] is False
    assert report["slo"]["burn_events"] == 0
    text = format_report(report)
    assert "phase attribution" in text and "tenants:" in text
    assert "slo:" in text


# ------------------------------------------ admission from counted bytes

def test_admit_batch_halves_under_budget_with_chunk_shrunk(monkeypatch):
    """``admit_batch`` halves the width until the counted bytes fit, a
    ``chunk-shrunk`` event and ``admission.chunk_shrunk`` a halving; a
    single lane still over the budget raises."""
    monkeypatch.setenv(admission.BUDGET_ENV, "300")

    def at(size):
        return admission.preflight("serve.toy", 100 * size, CPU)

    assert admission.admit_batch("serve.toy", 8, at) == 2
    ev = trace.events("chunk-shrunk")
    assert [(e["from_size"], e["to_size"]) for e in ev] == [(8, 4), (4, 2)]
    assert metrics.counter("admission.chunk_shrunk").value == 2
    with pytest.raises(admission.AdmissionError, match="floor size 1"):
        admission.admit_batch("serve.toy", 4, lambda s: admission.preflight(
            "serve.toy", 1000, CPU))
    assert admission.admit_chunk("serve.toy", 16, at,
                                 halve=lambda s: s - 5) == 1


def test_radix_batch_shrinks_under_memory_budget(monkeypatch):
    """The server preflights a radix batch at the one-hot's counted peak
    (``ops.sort.radix_peak_bytes``): under a budget of two lanes the
    batch of four serves as two batches of two, every lane bitwise."""
    from cme213_tpu_torch.ops.sort import radix_peak_bytes
    from cme213_tpu_torch.serve.workloads import _sort_block

    n = 2048
    lane = radix_peak_bytes(n, block_size=_sort_block(n))
    monkeypatch.setenv(admission.BUDGET_ENV, str(2 * lane + 1))
    rng = np.random.default_rng(5)
    keys = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(4)]
    server = Server(max_batch=4, clock=VirtualClock(), device=CPU,
                    adapters={"sort": one_rung_sorts("radix")})
    for k in keys:
        server.submit("sort", k)
    results = server.drain()
    assert [(r.status, r.batch_size) for r in results] == [(OK, 2)] * 4
    ev = trace.events("chunk-shrunk")
    assert ev and ev[0]["op"] == "serve.sort" and ev[0]["to_size"] == 2
    for r, k in zip(results, keys):
        np.testing.assert_array_equal(r.value, np.sort(k))


def test_heat_and_spmv_preflights_count_bytes(monkeypatch):
    from cme213_tpu_torch.apps.spmv_scan import (generate_problem,
                                                 spmv_chunk_bytes)
    from cme213_tpu_torch.config import SimParams
    from cme213_tpu_torch.ops.stencil import run_heat_bytes
    from cme213_tpu_torch.serve.workloads import HeatAdapter, SpmvAdapter

    monkeypatch.setenv(admission.BUDGET_ENV, "1G")
    p = SimParams(nx=30, ny=30, order=4, iters=2)
    d = HeatAdapter().preflight_builder([p], "xla", device=CPU)(3)
    assert d.required_bytes == 3 * (run_heat_bytes(p.gy, p.gx, 4, 4)
                                    + 4 * p.gy * p.gx)
    prob = generate_problem(300, p=5, q=40, iters=2, seed=0)
    d = SpmvAdapter().preflight_builder([prob], "blocked", device=CPU)(2)
    assert d.required_bytes == 2 * spmv_chunk_bytes(512, prob.p + 1, 4,
                                                    "blocked")


# ------------------------------------------------------- the device rule

def test_server_and_entry_points_need_a_card_or_the_cpu(monkeypatch,
                                                         capsys):
    """No card and no ``device``: every serving entry point raises
    ``FrameworkError``, never falling back to the CPU on its own."""
    from cme213_tpu_torch.models import dispatch
    from cme213_tpu_torch.serve.workloads import ADAPTERS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FrameworkError, match="device='cpu'"):
        Server()
    with pytest.raises(FrameworkError):
        ADAPTERS["cipher"].run_batch(
            [CipherRequest(np.zeros(8, np.uint8), 1)], "bytes")
    for argv in (["serve", "loadgen", "--requests", "2"],
                 ["serve", "warmup", "--mix", "cipher"]):
        with pytest.raises(FrameworkError):
            dispatch(argv)
    assert dispatch(["serve", "loadgen", "--requests", "4", "--mix",
                     "cipher,stub", "--device=cpu"]) == 0
    assert "requests 4: 4 served" in capsys.readouterr().out
    assert Server(device=CPU).device == torch.device(CPU)


# -------------------------------------------------- across the packages

def _jax_server(**kw):
    from cme213_tpu.serve import Server as JServer

    return JServer(**kw)


def _serve_all(server, specs):
    for s in specs:
        assert isinstance(server.submit(s.op, s.payload), int)
    out = server.drain()
    assert [r.status for r in out] == [OK] * len(specs)
    return sorted(out, key=lambda r: r.rid)


def test_served_results_match_the_jax_package_every_mix_op():
    """The same seeded requests served by both packages' servers on the
    CPU: cipher, sort and stub bitwise, heat within 10 ULP (order 2),
    spmv within rel-L2 1e-5."""
    from cme213_tpu.serve import loadgen as jloadgen

    mix = "spmv,heat,cipher,sort,stub"
    specs = build_mix(mix, 10, seed=3)
    jspecs = jloadgen.build_mix(mix, 10, seed=3)
    ours = _serve_all(Server(max_batch=4, clock=VirtualClock(), device=CPU),
                      specs)
    theirs = _serve_all(_jax_server(max_batch=4, clock=VirtualClock()),
                        jspecs)
    assert [(r.op, r.shape_class, r.batch_size, r.rung) for r in ours] == \
        [(r.op, r.shape_class, r.batch_size, r.rung) for r in theirs]
    for a, b in zip(ours, theirs):
        va, vb = np.asarray(a.value), np.asarray(b.value)
        assert va.dtype == vb.dtype and va.shape == vb.shape, a.op
        if a.op == "heat":
            assert int(ulp_distance(va, vb).max()) <= 10
        elif a.op == "spmv_scan":
            rel = np.linalg.norm(va - vb) / np.linalg.norm(vb)
            assert rel <= 1e-5, rel
        else:
            np.testing.assert_array_equal(va, vb)


def test_spmv_integer_valued_inputs_serve_bitwise_across_packages():
    """Integer-valued values and segments of at most 4: every product and
    partial sum is an exact f32 integer, so both packages' batched
    scans agree bit for bit."""
    from cme213_tpu.apps.spmv_scan import Problem as JProblem
    from cme213_tpu_torch.apps.spmv_scan import Problem

    rng = np.random.default_rng(8)
    probs, jprobs = [], []
    for _ in range(3):
        n = 512
        starts = np.concatenate([[0], np.sort(rng.choice(
            np.arange(4, n, 4), size=n // 4 - 1, replace=False))])
        s = np.concatenate([starts, [n]]).astype(np.int32)
        a = rng.integers(0, 2, n).astype(np.float32)
        k = rng.integers(0, 64, n).astype(np.int32)
        x = rng.integers(0, 2, 64).astype(np.float32)
        probs.append(Problem(a, s, k, x, 6))
        jprobs.append(JProblem(a, s, k, x, 6))
    ours = Server(max_batch=4, clock=VirtualClock(), device=CPU)
    theirs = _jax_server(max_batch=4, clock=VirtualClock())
    for p, jp in zip(probs, jprobs):
        ours.submit("spmv_scan", p)
        theirs.submit("spmv_scan", jp)
    for a, b in zip(ours.drain(), theirs.drain()):
        assert a.status == b.status == OK
        np.testing.assert_array_equal(a.value, np.asarray(b.value))


def test_report_text_and_json_match_the_jax_package():
    """``slo_report`` and ``format_report`` give the same JSON and text
    from the same results and metric snapshots (the trace id is each
    process-session's own)."""
    import json

    from cme213_tpu.core import metrics as jmetrics
    from cme213_tpu.serve import loadgen as jloadgen
    from cme213_tpu.serve.slo import Objective as JObjective
    from cme213_tpu.serve.slo import SLOMonitor as JSLOMonitor
    from cme213_tpu_torch.serve.slo import Objective, SLOMonitor

    jmetrics.reset()
    clock = VirtualClock()
    mon = SLOMonitor([Objective("p99-latency", "p99_latency_ms", 30.0)],
                     clock=clock, min_samples=1)
    server, _ = echo_server(clock=clock, max_batch=2, slo=mon)
    before = metrics.snapshot()
    results = []
    with faults.injected("slow:serve.echo:40:1"):
        for v in range(5):
            server.submit("echo", ("k", v), tenant=f"t{v % 2}")
            clock.advance(0.01)
            results.extend(server.step())
    after = metrics.snapshot()
    run = {"results": results, "elapsed_s": 0.25}
    ours = slo_report(run, before, after, slo=mon)
    jmon = JSLOMonitor([JObjective("p99-latency", "p99_latency_ms", 30.0)])
    jmon._last = mon.state()
    theirs = jloadgen.slo_report(run, before, after, slo=jmon)
    for rep in (ours, theirs):
        rep.pop("trace_id")
        rep["slo"].pop("burn_events")
        rep["slo"].pop("ok_events")
    theirs["numerics"]["demoted"] = ours["numerics"]["demoted"]
    assert json.dumps(ours, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)
    assert format_report(ours) == jloadgen.format_report(theirs)
    assert "latency ms: p50" in format_report(ours)
