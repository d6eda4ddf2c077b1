"""The port's telemetry core against the JAX package's: the event schema,
spans, sinks, the metrics registry and its Prometheus text.

The same operations go to ``cme213_tpu.core.{trace,metrics}`` and to
``cme213_tpu_torch.core.{trace,metrics}``; the results are compared
exactly.  Each package keeps its own event buffer and registry, so both
are reset around every test, and the environment variables both read are
cleared.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import cme213_tpu_torch
from cme213_tpu.core import faults as jfaults
from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import trace as jtrace
from cme213_tpu.core.timing import PhaseTimer as JPhaseTimer
from cme213_tpu_torch.core import errors as terrors
from cme213_tpu_torch.core import faults as tfaults
from cme213_tpu_torch.core import metrics as tmetrics
from cme213_tpu_torch.core import trace as ttrace
from cme213_tpu_torch.core.timing import PhaseTimer as TPhaseTimer

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = ("CME213_FAULTS", "CME213_TRACE_FILE", "CME213_TRACE_BUFFER",
       "CME213_TRACE_CONTEXT", "CME213_TRACE_TAIL", "CME213_TRACE_HEAD_RATE",
       "CME213_TRACE_TAIL_SLOW_MS", "CME213_INCARNATION", "RANK",
       "JAX_PROCESS_ID", "CME213_METRICS_FILE",
       "CME213_METRICS_SUMMARY_COMPAT")
PAIRS = ((jtrace, jmetrics, jfaults), (ttrace, tmetrics, tfaults))


def _reset():
    for trace, metrics, faults in PAIRS:
        trace.flush_sink()
        trace.clear_events()
        metrics.reset()
        faults.reset()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    _reset()
    yield
    _reset()


def _strip(rec):
    """A record without the per-process tags and clock."""
    return {k: v for k, v in rec.items()
            if k not in ("t", "pid", "trace", "id", "parent", "ms")}


# ------------------------------------------------------------------ schema

def test_event_schema_is_the_reference_s():
    assert ttrace.EVENT_SCHEMA == jtrace.EVENT_SCHEMA


RECORDS = [
    {"event": "served", "op": "x"},
    {"event": "served", "op": "x", "rung": "a", "demoted": False,
     "failed_rungs": []},
    {"event": "kernel-failure", "op": "heat2d", "kernel": "pipeline-k1"},
    {"event": "sweep-complete", "sweep": "s", "rows": 1, "ms": 2.0},
    {"event": "device-health"},
    {"event": "unknown-event"},
    {"no": "event"},
    {"event": ""},
]


@pytest.mark.parametrize("rec", RECORDS, ids=range(len(RECORDS)))
def test_validate_record_matches_reference(rec):
    assert ttrace.validate_record(rec) == jtrace.validate_record(rec)


def _record_event_calls():
    pkg_dir = pathlib.Path(cme213_tpu_torch.__file__).parent
    for py in sorted(pkg_dir.rglob("*.py")):
        tree = ast.parse(py.read_text(), filename=str(py))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute) else None)
            if name == "record_event":
                yield py.relative_to(pkg_dir), node


def test_every_port_call_site_uses_a_registered_event():
    sites = 0
    for src, node in _record_event_calls():
        assert node.args and isinstance(node.args[0], ast.Constant), (
            f"{src}:{node.lineno}: record_event needs a literal event name")
        assert node.args[0].value in ttrace.EVENT_SCHEMA, (
            f"{src}:{node.lineno}: {node.args[0].value!r} not registered")
        sites += 1
    assert sites >= 15


def test_port_call_sites_emit_their_documented_fields():
    auto = {"pid", "rank", "incarnation"}
    for src, node in _record_event_calls():
        event = node.args[0].value
        kw = [k.arg for k in node.keywords]
        if None in kw:  # **expansion: driven at run time below
            continue
        missing = set(ttrace.EVENT_SCHEMA[event]) - set(kw) - auto
        assert not missing, f"{src}:{node.lineno}: {event!r} lacks {missing}"


def test_runtime_records_validate_against_schema():
    from cme213_tpu_torch.core.resilience import RetryPolicy, with_fallback

    with tfaults.injected("fail:rt.a"):
        with_fallback("rt", [("a", lambda: 1), ("b", lambda: 2)],
                      policy=RetryPolicy(max_retries=0))
    with ttrace.span("s", kernel="k"):
        pass
    recs = ttrace.events()
    assert {r["event"] for r in recs} >= {"fault-injected", "rung-failed",
                                          "kernel-failure", "served",
                                          "span-begin", "span-end"}
    for rec in recs:
        assert ttrace.validate_record(rec) == [], rec


# ------------------------------------------------------------------- spans

def _nest(trace, raise_inner=False):
    with trace.span("outer", kind="test"):
        for i in range(2):
            try:
                with trace.span("inner", i=i):
                    with trace.span("leaf", shape_class="n8"):
                        if raise_inner and i == 1:
                            raise ValueError("boom")
            except ValueError:
                pass
    return trace.events()


def _linked(recs):
    """Records with span ids replaced by their order of first
    appearance, so two processes' trees compare."""
    ids = {}
    out = []
    for r in recs:
        for key in ("id", "parent"):
            if r.get(key) is not None and r[key] not in ids:
                ids[r[key]] = len(ids)
        row = _strip(r)
        row["id"] = ids.get(r.get("id"))
        row["parent"] = ids.get(r.get("parent"))
        row["keys"] = sorted(r)
        out.append(row)
    return out


@pytest.mark.parametrize("raise_inner", [False, True])
def test_span_nesting_same_keys_and_parent_links(raise_inner):
    ref = _linked(_nest(jtrace, raise_inner))
    port = _linked(_nest(ttrace, raise_inner))
    assert port == ref
    assert [r["event"] for r in port][:3] == ["span-begin"] * 3
    assert port[0]["parent"] is None and port[1]["parent"] == port[0]["id"]


def test_span_error_tagged_and_reraised():
    for trace in (jtrace, ttrace):
        with pytest.raises(KeyError):
            with trace.span("bad"):
                raise KeyError("x")
    assert _strip(ttrace.events("span-end")[0]) == \
        _strip(jtrace.events("span-end")[0])
    assert ttrace.events("span-end")[0]["error"] == "KeyError"
    assert ttrace.current_span_id() is None


def test_span_block_synchronises_registered_tensors(monkeypatch):
    """``.block`` synchronises each CUDA device of the registered tensors
    once; CPU tensors need no wait."""
    synced = []

    class FakeCuda:
        is_cuda = True
        device = "cuda:0"

    with monkeypatch.context() as m:
        m.setattr(torch, "is_tensor", lambda t: True)
        m.setattr(torch.cuda, "synchronize", synced.append)
        with ttrace.span("dev") as s:
            s.block(FakeCuda(), FakeCuda())
    assert synced == ["cuda:0"]
    with ttrace.span("cpu") as s:
        s.block(torch.ones(3))
    assert ttrace.events("span-end")[-1]["ms"] >= 0


def test_span_durations_feed_metrics():
    for trace, metrics, _ in PAIRS:
        for _ in range(3):
            with trace.span("timed"):
                pass
    assert tmetrics.snapshot()["histograms"]["span.timed.ms"]["count"] == 3
    assert sorted(tmetrics.snapshot()["histograms"]) == \
        sorted(jmetrics.snapshot()["histograms"])


def test_compile_spans_feed_the_retrace_detector():
    for trace, _, _ in PAIRS:
        for _ in range(2):
            with trace.span("op.compile", shape_class="n8", kernel="k"):
                pass
        with trace.span("op.run", shape_class="n8"):
            pass
    assert ttrace.compile_counts() == jtrace.compile_counts()
    assert [_strip(r) for r in ttrace.events("compile-retrace")] == \
        [_strip(r) for r in jtrace.events("compile-retrace")]
    assert tmetrics.snapshot()["counters"] == jmetrics.snapshot()["counters"]


def test_phase_timer_emits_spans_outside_its_clock():
    for trace, timer in ((jtrace, JPhaseTimer()), (ttrace, TPhaseTimer())):
        with timer.phase("gpu computation shared") as ph:
            ph.block(torch.ones(2) if trace is ttrace else np.ones(2))
    assert [_strip(r) for r in ttrace.events()] == \
        [_strip(r) for r in jtrace.events()]
    end = ttrace.events("span-end")[0]
    assert end["span"] == "gpu computation shared"


@pytest.mark.parametrize("rank", [None, "3"])
def test_process_tags_read_the_rank(monkeypatch, rank):
    """The port reads ``RANK`` where the JAX package reads
    ``JAX_PROCESS_ID``."""
    if rank is not None:
        monkeypatch.setenv("RANK", rank)
        monkeypatch.setenv("JAX_PROCESS_ID", rank)
    monkeypatch.setenv("CME213_INCARNATION", "2")
    a = ttrace.record_event("heartbeat", rank=0, step=1)
    b = jtrace.record_event("heartbeat", rank=0, step=1)
    tags = ("pid", "incarnation")
    assert {k: a[k] for k in tags} == {k: b[k] for k in tags}
    a = ttrace.record_event("sweep-complete", sweep="s", rows=1, ms=1.0)
    b = jtrace.record_event("sweep-complete", sweep="s", rows=1, ms=1.0)
    assert a["rank"] == b["rank"] == (None if rank is None else 3)


def test_trace_context_is_inherited(monkeypatch):
    ctx = json.dumps({"trace_id": "abc", "parent_span_id": "p.1"})
    monkeypatch.setenv("CME213_TRACE_CONTEXT", ctx)
    for trace in (jtrace, ttrace):
        with trace.span("root"):
            env = trace.propagation_env()
    assert ttrace.events("span-begin")[0]["parent"] == "p.1"
    assert ttrace.events()[0]["trace"] == jtrace.events()[0]["trace"] == "abc"
    assert json.loads(env["CME213_TRACE_CONTEXT"])["trace_id"] == "abc"


def test_ring_buffer_cap(monkeypatch):
    monkeypatch.setenv("CME213_TRACE_BUFFER", "3")
    for trace in (jtrace, ttrace):
        trace.clear_events()
        for i in range(7):
            trace.record_event("heartbeat", rank=0, step=i)
    assert [e["step"] for e in ttrace.events()] == \
        [e["step"] for e in jtrace.events()] == [4, 5, 6]


def test_sink_appends_jsonl_with_rank_template(tmp_path, monkeypatch):
    monkeypatch.setenv("CME213_TRACE_FILE", str(tmp_path / "t-{rank}.jsonl"))
    ttrace.record_event("sweep-complete", sweep="a", rows=1, ms=1.0)
    monkeypatch.setenv("RANK", "2")
    ttrace.record_event("sweep-complete", sweep="b", rows=1, ms=1.0)
    ttrace.flush_sink()
    main = [json.loads(ln) for ln in
            (tmp_path / "t-main.jsonl").read_text().splitlines()]
    two = [json.loads(ln) for ln in
           (tmp_path / "t-2.jsonl").read_text().splitlines()]
    assert [r["sweep"] for r in main] == ["a"] and main[0]["rank"] is None
    assert [r["sweep"] for r in two] == ["b"] and two[0]["rank"] == 2


def test_sink_broken_path_never_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CME213_TRACE_FILE",
                       str(tmp_path / "missing" / "dir" / "t.jsonl"))
    ttrace.record_event("heartbeat", rank=0, step=1)
    assert len(ttrace.events()) == 1


def test_tail_sampling_matches_reference(monkeypatch):
    monkeypatch.setenv("CME213_TRACE_TAIL", "1")
    for trace in (jtrace, ttrace):
        for rid in range(4):
            s = trace.begin_span("serve.hop.queue", tail_key=f"r{rid}",
                                 rid=rid)
            s.end()
        assert trace.tail_pending() == 4
        assert trace.tail_decide("r1", keep=True, reason="slow") == 2
        assert trace.tail_decide("r2", keep=False) == 2
        assert trace.tail_decide("r2", keep=True) == 0
    assert [_strip(r) for r in ttrace.events()] == \
        [_strip(r) for r in jtrace.events()]
    assert tmetrics.snapshot()["counters"] == jmetrics.snapshot()["counters"]
    for args in [dict(status="shed"), dict(requeues=1), dict(drift=True),
                 dict(latency_ms=5.0), dict()]:
        assert ttrace.tail_keep_reason(**args) == \
            jtrace.tail_keep_reason(**args)


def test_clock_sync_matches_reference():
    samples = [(0.0, 10.0, 0.002), (1.0, 11.0005, 1.004), (2.0, 12.0, 2.001)]
    a, b = ttrace.ClockSync(alpha=0.3), jtrace.ClockSync(alpha=0.3)
    for s in samples:
        assert a.update(*s) == b.update(*s)
    assert (a.rtt_ms, a.samples) == (b.rtt_ms, b.samples)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with ttrace.device_trace(str(tmp_path)):
        torch.ones(64).sum()
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


# ----------------------------------------------------------------- metrics

def _drive(metrics):
    metrics.counter("fallback.demotions").inc()
    metrics.counter("fallback.demotions").inc(2)
    metrics.counter("faults.fail").inc()
    metrics.counter("served.spmv_scan.pallas").inc(5)
    metrics.counter("serve.shed.queue_full").inc()
    metrics.counter("serve.tenant.a.requests").inc(3)
    metrics.gauge("gang.world").set(4)
    metrics.gauge("diag.device.healthy").set(1.0)
    metrics.gauge("label").set("not-a-number")
    h = metrics.histogram("commit.ms")
    for v in (0.1, 0.3, 1.0, 2.5, 12.3, 99.0, 4e4):
        h.observe(v)
    before = metrics.snapshot()
    metrics.counter("fallback.demotions").inc()
    metrics.histogram("commit.ms").observe(7.0)
    metrics.histogram("other.ms").observe(1.0)
    return before, metrics.snapshot()


def test_metrics_snapshot_delta_and_text_match_reference(monkeypatch):
    jb, ja = _drive(jmetrics)
    tb, ta = _drive(tmetrics)
    assert ta == ja and tb == jb
    assert tmetrics.delta(tb, ta) == jmetrics.delta(jb, ja)
    assert tmetrics.render_prometheus() == jmetrics.render_prometheus()
    assert tmetrics.render_prometheus(help_lines=False) == \
        jmetrics.render_prometheus(help_lines=False)
    fleet = {"0": tb, "1": ta}
    assert tmetrics.merge_snapshots(fleet) == jmetrics.merge_snapshots(fleet)
    assert tmetrics.render_prometheus(fleet=fleet) == \
        jmetrics.render_prometheus(fleet=fleet)
    monkeypatch.setenv("CME213_METRICS_SUMMARY_COMPAT", "1")
    assert tmetrics.render_prometheus() == jmetrics.render_prometheus()


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_percentiles_match_reference(q):
    rng = np.random.default_rng(0)
    vals = rng.exponential(3.0, size=5000)  # wraps the KEEP ring
    for metrics in (jmetrics, tmetrics):
        h = metrics.histogram("lat.ms")
        for v in vals:
            h.observe(v)
    assert tmetrics.histogram("lat.ms").percentile(q) == \
        jmetrics.histogram("lat.ms").percentile(q)
    assert tmetrics.histogram("empty").percentile(q) is None


def test_write_exposition_atomic(tmp_path, monkeypatch):
    assert tmetrics.write_exposition() is None
    tmetrics.counter("x").inc()
    path = tmp_path / "m.prom"
    monkeypatch.setenv("CME213_METRICS_FILE", str(path))
    assert tmetrics.write_exposition() == str(path)
    assert path.read_text() == tmetrics.render_prometheus()
    assert not list(tmp_path.glob("*.tmp.*"))


def test_exit_snapshot_ends_the_sink(tmp_path):
    sink = tmp_path / "t.jsonl"
    prom = tmp_path / "m.prom"
    code = ("from cme213_tpu_torch.core import metrics;"
            "metrics.counter('retry.attempts').inc(2)")
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(PYTHONPATH=str(ROOT), CME213_TRACE_FILE=str(sink),
               CME213_METRICS_FILE=str(prom))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    last = json.loads(sink.read_text().splitlines()[-1])
    assert last["event"] == "metrics-snapshot"
    assert last["metrics"]["counters"] == {"retry.attempts": 2}
    assert "cme213_retry_attempts_total 2" in prom.read_text()


# ------------------------------------------------------------ op barriers

def test_data_error_emits_its_record():
    from cme213_tpu.core.errors import data_error as jdata_error

    a = terrors.data_error("a.txt", "header", "3 columns, want 2")
    b = jdata_error("a.txt", "header", "3 columns, want 2")
    assert str(a) == str(b)
    assert _strip(a.record) == _strip(b.record)
    assert [_strip(r) for r in ttrace.events()] == \
        [_strip(r) for r in jtrace.events()]


def test_check_op_records_a_device_fault(monkeypatch):
    """A CUDA fault at the barrier becomes a ``FrameworkError`` naming the
    op, with its ``op-failure`` record; the timer gets the wait."""
    from cme213_tpu_torch.core.diag import failure_stage
    from cme213_tpu_torch.core.resilience import (FailureKind,
                                                  classify_failure)

    class FakeCuda:
        is_cuda = True
        device = "cuda:0"

    def boom(device):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    timer = TPhaseTimer()
    with pytest.raises(terrors.FrameworkError) as info:
        terrors.check_op("heat.pipeline", FakeCuda(), timer=timer)
    rec = info.value.record
    assert rec["event"] == "op-failure" and rec["op"] == "heat.pipeline"
    assert ttrace.validate_record(rec) == []
    assert ttrace.events("op-failure") == [rec]
    assert [r.label for r in timer.records] == ["heat.pipeline"]
    assert classify_failure(info.value) == FailureKind.RUNTIME
    assert failure_stage(info.value) == "execute"


def test_check_op_passes_cpu_tensors_through():
    t = torch.ones(3)
    assert terrors.check_op("x", t) is t
    assert terrors.check_op("x", t, t) == (t, t)
    assert ttrace.events() == []
