"""Trace records shared by the telemetry-tooling parity tests.

Three kinds of sink feed both packages' tools:

- synthetic records in the shape of the JAX package's own fixtures
  (``tests/test_telemetry.py``, ``test_perf_observability.py``,
  ``test_waterfall.py``, ``test_fleet_telemetry.py``, ``test_numerics.py``),
  with request-hop records built here because serving is not ported;
- a sink written by the port's own CPU runs (``heat2d``, ``spmv_scan``, a
  checkpointed solve);
- a sink written by the JAX package's CPU runs.

Each function returns plain dicts; ``write_sink`` writes one JSON line a
record.
"""

import json
import os

from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import trace as jtrace
from cme213_tpu_torch.core import metrics as tmetrics
from cme213_tpu_torch.core import trace as ttrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_sink(path, recs) -> str:
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(path)


def gang_records() -> dict[str, list]:
    """A launcher and two ranks shaped like a rankkill run
    (``tests/test_telemetry.py``)."""
    base = {"pid": 1, "incarnation": 0}
    launcher = [
        {"event": "gang-launch", "t": 0.0, "rank": None, "incarnation": 0,
         "world": 2, "coordinator": "127.0.0.1:1", "pid": 9},
        {"event": "rank-failed", "t": 3.0, "rank": 1, "incarnation": 0,
         "reason": "exit", "code": 113, "pid": 9},
        {"event": "gang-restart", "t": 3.1, "rank": None, "incarnation": 1,
         "reason": "exit", "pid": 9},
        {"event": "gang-launch", "t": 3.2, "rank": None, "incarnation": 1,
         "world": 2, "coordinator": "127.0.0.1:2", "pid": 9},
        {"event": "gang-exit", "t": 9.0, "rank": None, "incarnation": 1,
         "rc": 0, "pid": 9},
    ]
    r0 = [
        {"event": "heartbeat", "t": 1.0, "rank": 0, "step": 0, **base},
        {"event": "epoch-commit", "t": 2.0, "rank": 0, "epoch": 1,
         "step": 2, "world": 2, "shards": 2, "ms": 5.0, **base},
        {"event": "epoch-commit", "t": 2.5, "rank": 0, "epoch": 2,
         "step": 4, "world": 2, "shards": 2, "ms": 7.0, **base},
        {"event": "commit-loaded", "t": 4.0, "rank": 0, "epoch": 2,
         "step": 4, "candidate": "COMMIT", "pid": 2, "incarnation": 1},
        {"event": "epoch-commit", "t": 5.0, "rank": 0, "epoch": 3,
         "step": 8, "world": 2, "shards": 2, "ms": 6.0, "pid": 2,
         "incarnation": 1},
        {"event": "span-begin", "t": 0.5, "rank": 0, "span": "solve",
         "id": "a.1", "parent": None, **base},
        {"event": "span-end", "t": 6.0, "rank": 0, "span": "solve",
         "id": "a.1", "parent": None, "ms": 5500.0, "pid": 2,
         "incarnation": 1},
    ]
    r1 = [
        {"event": "heartbeat", "t": 1.1, "rank": 1, "step": 0, **base},
        {"event": "fault-injected", "t": 2.9, "rank": 1, "kind": "rankkill",
         "op": "1", "step": 1, **base},
    ]
    return {"trace-main.jsonl": launcher, "trace-0.jsonl": r0,
            "trace-1.jsonl": r1}


def perf_gang_records() -> dict[str, list]:
    """Two ranks with nested spans, an orphaned end and an open span
    (``tests/test_perf_observability.py``), plus roofline-attributed
    ``heat.run`` spans, rungs, probes and forensics the summary reports."""
    base = {"pid": 11, "incarnation": 0}
    r0 = [
        {"event": "span-begin", "t": 1.0, "rank": 0, "span": "solve",
         "id": "a.1", "parent": None, **base},
        {"event": "span-begin", "t": 1.1, "rank": 0, "span": "solve.compile",
         "id": "a.2", "parent": "a.1", "shape_class": "n64", **base},
        {"event": "span-end", "t": 1.4, "rank": 0, "span": "solve.compile",
         "id": "a.2", "parent": "a.1", "ms": 300.0, "shape_class": "n64",
         **base},
        {"event": "heartbeat", "t": 1.5, "rank": 0, "step": 1, **base},
        {"event": "span-end", "t": 2.0, "rank": 0, "span": "solve",
         "id": "a.1", "parent": None, "ms": 1000.0, **base},
    ]
    r1 = [
        {"event": "span-begin", "t": 1.2, "rank": 1, "span": "solve",
         "id": "b.1", "parent": None, "pid": 12, "incarnation": 0},
        {"event": "span-end", "t": 1.9, "rank": 1, "span": "solve",
         "id": "b.1", "parent": None, "ms": 700.0, "pid": 12,
         "incarnation": 0},
        {"event": "span-end", "t": 2.1, "rank": 1, "span": "orphan",
         "id": "b.9", "parent": None, "ms": 50.0, "pid": 12,
         "incarnation": 0},
        {"event": "span-begin", "t": 2.2, "rank": 1, "span": "open",
         "id": "b.5", "parent": None, "pid": 12, "incarnation": 0},
    ]
    launcher = [
        {"event": "gang-launch", "t": 0.5, "rank": None, "incarnation": 0,
         "world": 2, "coordinator": "127.0.0.1:1", "pid": 9},
    ]
    attributed = [
        {"event": "span-end", "t": 3.0 + i, "rank": 0, "span": "heat.run",
         "id": f"h.{i}", "parent": None, "ms": ms, "kernel": "pipeline",
         "shape_class": "4008x4008/order8/k1", "achieved_gbs": gbs,
         "pct_peak": round(100 * gbs / 3350.0, 2), "bound": "memory",
         **base}
        for i, (ms, gbs) in enumerate(((55.8, 2293.907), (57.1, 2241.681)))
    ] + [
        {"event": "served", "t": 5.0, "rank": 0, "op": "heat",
         "rung": "pipeline2d", "demoted": True, "failed_rungs": ["pipeline"],
         **base},
        {"event": "rung-failed", "t": 4.9, "rank": 0, "op": "heat",
         "rung": "pipeline", "error": "ProbeMismatch", **base},
        {"event": "conformance-probe", "t": 4.8, "rank": 0, "op": "heat",
         "rung": "pipeline", "shape_class": "s", "ok": False, "ms": 4.3,
         **base},
        {"event": "conformance-failed", "t": 4.85, "rank": 0, "op": "heat",
         "rung": "pipeline", "shape_class": "s", "detail": "2 ULP",
         **base},
        {"event": "kernel-failure", "t": 4.86, "rank": 0, "op": "heat",
         "kernel": "pipeline", "stage": "conformance",
         "error": "ProbeMismatch: 2 ULP", **base},
        {"event": "kernel-failure", "t": 4.87, "rank": 0, "op": "spmv_scan",
         "kernel": "pallas", "stage": "execute",
         "error": "KernelError: launch failed", **base},
        {"event": "attribution-mismatch", "t": 4.88, "rank": 0,
         "op": "heat", "rung": "pipeline", "shape_class": "s",
         "metric": "bytes", "predicted": 100, "measured": 180,
         "ratio": 1.8, **base},
        {"event": "admission-rejected", "t": 4.89, "rank": 0, "op": "heat",
         "requested_bytes": 10, "budget_bytes": 5, **base},
        {"event": "chunk-shrunk", "t": 4.9, "rank": 0, "op": "heat_chunk",
         "from_size": 250, "to_size": 125, "reason": "oom", **base},
        {"event": "program-cache-miss", "t": 4.91, "rank": 0, "op": "heat",
         "rung": "pipeline", "shape_class": "s", **base},
        {"event": "program-cache-hit", "t": 4.92, "rank": 0, "op": "heat",
         "rung": "pipeline", "shape_class": "s", **base},
        {"event": "compile-retrace", "t": 4.93, "rank": 0, "op": "heat",
         "shape_class": "s", "kernel": "pipeline", "count": 2, **base},
        {"event": "device-health", "t": 4.94, "rank": 0, "healthy": True,
         "platform": "cuda", "devices": 1, "probe_ms": 3.1, **base},
        {"event": "tune-trial", "t": 4.95, "rank": 0, "op": "heat",
         "shape_class": "s", "candidate": "tile_y=64", "ok": True,
         **base},
        {"event": "tune-winner", "t": 4.96, "rank": 0, "op": "heat",
         "shape_class": "s", "candidate": "tile_y=64",
         "statics": {"tile_y": 64}, "gbs": 2300.0, **base},
        {"event": "retry", "t": 4.97, "rank": 0, "op": "heat", **base},
        {"event": "checkpoint-rollback", "t": 4.98, "rank": 0, "op": "heat",
         **base},
    ]
    return {"trace-main.jsonl": launcher, "trace-0.jsonl": r0 + attributed,
            "trace-1.jsonl": r1}


def _hop(event, span, sid, parent, pid, t, trace_id="T", **tags):
    return {"event": event, "span": span, "id": sid, "parent": parent,
            "pid": pid, "rank": None, "incarnation": 0, "trace": trace_id,
            "t": t, **tags}


def skewed_fleet_records() -> list[dict]:
    """One requeued request across three pids with skewed clocks
    (``tests/test_waterfall.py``): the front tier (pid 200) is the
    reference, the client's clock (pid 100) runs 2 s ahead and the
    replica's (pid 300) 500 ms behind."""
    c, r = 2.0, -0.5
    return [
        {"event": "clock-offset", "pid": 100, "rank": None,
         "incarnation": 0, "trace": "T", "t": 0.9 + c, "peer_pid": 200,
         "offset_ms": -2000.0, "err_ms": 1.5, "rtt_ms": 3.0, "samples": 5},
        {"event": "clock-offset", "pid": 200, "rank": None,
         "incarnation": 0, "trace": "T", "t": 0.95, "peer_pid": 300,
         "offset_ms": -500.0, "err_ms": 2.0, "rtt_ms": 4.0, "samples": 3},
        _hop("span-begin", "serve.hop.client", "c.1", None, 100,
             1.000 + c, rid=7),
        _hop("span-begin", "serve.hop.route", "f.1", "c.1", 200,
             1.010, rid=3),
        _hop("span-begin", "serve.hop.dispatch", "f.2", "f.1", 200,
             1.012, rid=3),
        _hop("span-end", "serve.hop.dispatch", "f.2", "f.1", 200,
             1.015, ms=3.0, rid=3, requeued=True),
        _hop("span-begin", "serve.hop.requeue", "f.3", "f.1", 200,
             1.015, rid=3),
        _hop("span-end", "serve.hop.requeue", "f.3", "f.1", 200,
             1.030, ms=15.0, rid=3),
        _hop("span-begin", "serve.hop.dispatch", "f.4", "f.1", 200,
             1.030, rid=3),
        _hop("span-begin", "serve.hop.replica", "r.1", "f.1", 300,
             1.032 + r, rid=1),
        _hop("span-begin", "serve.hop.run", "r.2", "r.1", 300,
             1.035 + r, rid=1),
        _hop("span-end", "serve.hop.run", "r.2", "r.1", 300,
             1.045 + r, ms=10.0, rid=1),
        _hop("span-end", "serve.hop.replica", "r.1", "f.1", 300,
             1.050 + r, ms=18.0, rid=1),
        _hop("span-end", "serve.hop.dispatch", "f.4", "f.1", 200,
             1.052, ms=22.0, rid=3),
        _hop("span-end", "serve.hop.route", "f.1", "c.1", 200,
             1.055, ms=45.0, rid=3, requeues=1),
        _hop("span-end", "serve.hop.client", "c.1", None, 100,
             1.060 + c, ms=60.0, rid=7),
    ]


def slowest_hop_records() -> list[dict]:
    """Twelve client hops of rising latency, the last one requeued."""
    return [_hop("span-end", "serve.hop.client", f"c.{rid}", None, 100,
                 1.0 + rid * 0.01, ms=float(10 + rid * 10), rid=rid,
                 status="ok", requeues=1 if rid == 11 else 0)
            for rid in range(12)]


def fleet_records() -> dict[str, list]:
    """A launcher and two per-rank sinks shaped like a rankkill run
    (``tests/test_fleet_telemetry.py``)."""
    launcher = [
        {"event": "gang-launch", "t": 0.0, "rank": None, "incarnation": 0,
         "world": 2, "coordinator": "c:1", "pid": 9, "trace": "T1"},
        {"event": "rank-failed", "t": 3.0, "rank": 1, "incarnation": 0,
         "reason": "exit", "code": 113, "pid": 9, "trace": "T1"},
        {"event": "gang-restart", "t": 3.1, "rank": None, "incarnation": 1,
         "reason": "exit", "pid": 9, "trace": "T1"},
        {"event": "gang-launch", "t": 3.2, "rank": None, "incarnation": 1,
         "world": 2, "coordinator": "c:2", "pid": 9, "trace": "T1"},
        {"event": "gang-exit", "t": 9.0, "rank": None, "incarnation": 1,
         "rc": 0, "pid": 9, "trace": "T1"},
    ]
    r0 = [
        {"event": "heartbeat", "t": 1.0, "rank": 0, "step": 2, "pid": 10,
         "incarnation": 0, "trace": "T1"},
        {"event": "epoch-commit", "t": 2.0, "rank": 0, "epoch": 1,
         "step": 2, "world": 2, "shards": 2, "ms": 5.0, "pid": 10,
         "incarnation": 0, "trace": "T1"},
        {"event": "span-begin", "t": 4.0, "rank": 0, "span": "solve",
         "id": "a.1", "parent": None, "pid": 12, "incarnation": 1,
         "trace": "T1"},
        {"event": "span-end", "t": 6.0, "rank": 0, "span": "solve",
         "id": "a.1", "parent": None, "ms": 2000.0, "pid": 12,
         "incarnation": 1, "trace": "T1"},
        {"event": "metrics-snapshot", "t": 8.0, "rank": 0,
         "metrics": {"counters": {"fleet.steps": 6}, "gauges": {},
                     "histograms": {}},
         "pid": 12, "incarnation": 1, "trace": "T1"},
    ]
    r1 = [
        {"event": "heartbeat", "t": 1.1, "rank": 1, "step": 1, "pid": 11,
         "incarnation": 0, "trace": "T1"},
        {"event": "heartbeat", "t": 7.0, "rank": 1, "step": 5, "pid": 13,
         "incarnation": 1, "trace": "T1"},
    ]
    return {"f-main.jsonl": launcher, "f-0.jsonl": r0, "f-1.jsonl": r1}


def numerics_records() -> list[dict]:
    """Drift samples, a budget burn, a sentinel trip and two
    ``solver-progress`` epochs (``tests/test_numerics.py``)."""
    return [
        {"event": "numeric-drift", "t": 1.0, "op": "serve.echo",
         "rung": "fast", "shape_class": "k", "rel_l2": 0.5, "max_ulps": 9,
         "over_budget": True},
        {"event": "numeric-drift", "t": 2.0, "op": "serve.echo",
         "rung": "fast", "shape_class": "k", "rel_l2": 0.0, "max_ulps": 0,
         "over_budget": False},
        {"event": "drift-budget-burn", "t": 3.0, "op": "serve.echo",
         "rung": "fast", "burn_short": 10.0, "burn_long": 10.0,
         "threshold": 2.0},
        {"event": "numeric-sentinel", "t": 4.0, "op": "serve.heat",
         "rung": "xla", "kind": "non-finite", "count": 3, "size": 64},
        {"event": "solver-progress", "t": 5.0, "op": "heat2d", "step": 1,
         "residual": 0.5, "delta_norm": 1.0, "iters_per_s": 3.0},
        {"event": "solver-progress", "t": 6.0, "op": "heat2d", "step": 2,
         "residual": 0.25, "delta_norm": 0.5, "iters_per_s": 3.0},
    ]


def _sink_run(trace, metrics, path, monkeypatch, run) -> str:
    """Run ``run()`` with one package's sink at ``path``, then close it and
    append the package's final metrics snapshot (what its exit writes)."""
    trace.flush_sink()
    trace.clear_events()
    metrics.reset()
    monkeypatch.setenv(trace.TRACE_FILE_ENV, str(path))
    try:
        run()
        trace.record_event("metrics-snapshot", metrics=metrics.snapshot())
    finally:
        trace.flush_sink()
        monkeypatch.delenv(trace.TRACE_FILE_ENV)
    return str(path)


def port_cpu_sink(path, monkeypatch) -> str:
    """A sink of the port's CPU runs: the heat2d ladder, the SpMV-scan
    ladder with the fused kernel's rung, and a checkpointed heat solve."""
    from cme213_tpu_torch.apps import heat2d, spmv_scan
    from cme213_tpu_torch.config import SimParams
    from cme213_tpu_torch.core import conformance

    def run():
        conformance.reset()
        p = SimParams(nx=32, ny=32, order=8, iters=8)
        heat2d.run_single(p, check_cpu=True, device="cpu")
        prob = spmv_scan.generate_problem(2048, 32, 31, iters=3, seed=0)
        spmv_scan.run_spmv_scan(prob, kernel="pallas-fused", device="cpu")
        heat2d.run_heat_checkpointed(
            SimParams(nx=32, ny=32, order=2, iters=8),
            os.path.join(os.path.dirname(str(path)), "port-ck.npz"),
            every=2, device="cpu")

    return _sink_run(ttrace, tmetrics, path, monkeypatch, run)


def jax_cpu_sink(path, monkeypatch) -> str:
    """A sink of the JAX package's CPU runs (Pallas in interpret mode)."""
    from cme213_tpu.apps import heat2d, spmv_scan
    from cme213_tpu.config import SimParams
    from cme213_tpu.core import conformance

    def run():
        conformance.reset()
        p = SimParams(nx=32, ny=32, order=8, iters=8)
        heat2d.run_single(p, check_cpu=True)
        prob = spmv_scan.generate_problem(2048, 32, 31, iters=3, seed=0)
        spmv_scan.run_spmv_scan(prob, kernel="pallas-fused")
        heat2d.run_heat_checkpointed(
            SimParams(nx=32, ny=32, order=2, iters=8),
            os.path.join(os.path.dirname(str(path)), "jax-ck.npz"),
            every=2)

    return _sink_run(jtrace, jmetrics, path, monkeypatch, run)
