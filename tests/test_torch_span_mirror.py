"""The port's spans on the profiler's clock (``core/trace.span``'s profiler
mirror), the spans of a solve's host work on the heat and SpMV-scan paths,
and the phase timer's one wait for its tensors."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cme213_tpu_torch.apps import spmv_scan as sp
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import PhaseTimer, conformance, faults, metrics
from cme213_tpu_torch.core import trace
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import stencil_pipeline

ENV = ("CME213_FAULTS", "CME213_TRACE_FILE", "CME213_TRACE_BUFFER",
       "CME213_TRACE_CONTEXT", "CME213_TRACE_TAIL", "CME213_MEMORY_BUDGET")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    trace.clear_events()
    metrics.reset()
    faults.reset()
    conformance.reset()
    yield
    trace.clear_events()


def _ranges(prof, name):
    """``(start, end)`` ns of the profiler's host ranges named ``name``."""
    return sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                  for ev in prof.profiler.kineto_results.events()
                  if ev.name() == name and "CPU" in str(ev.device_type()))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _spans(name=None):
    return [e for e in trace.events("span-begin")
            if name is None or e["span"] == name]


def test_span_and_its_child_are_nested_host_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer.op", tag=1):
            with trace.span("inner.op"):
                torch.ones(4).add_(1)
    (outer,) = _ranges(prof, "outer.op")
    (inner,) = _ranges(prof, "inner.op")
    assert _inside(inner, outer) and inner != outer
    # the JSON records are those of an unprofiled span
    begins = _spans()
    assert [b["span"] for b in begins] == ["outer.op", "inner.op"]
    assert begins[1]["parent"] == begins[0]["id"]
    assert begins[0]["tag"] == 1
    assert [e["span"] for e in trace.events("span-end")] == \
        ["inner.op", "outer.op"]


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("quiet.outer"):
        with trace.span("quiet.inner"):
            pass
    assert [e["span"] for e in trace.events("span-end")] == \
        ["quiet.inner", "quiet.outer"]


def test_a_span_after_the_session_is_not_mirrored(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("during"):
            pass
    assert len(_ranges(prof, "during")) == 1
    monkeypatch.setattr(torch.profiler, "record_function", None)
    with trace.span("after"):
        pass
    assert trace.events("span-end")[-1]["span"] == "after"


def test_hop_spans_are_never_mirrored():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hop = trace.begin_span("serve.hop.test", rid=3)
        with trace.span("beside.hop"):
            pass
        hop.end()
    assert _ranges(prof, "serve.hop.test") == []
    assert len(_ranges(prof, "beside.hop")) == 1
    assert [e["span"] for e in trace.events("span-end")] == \
        ["beside.hop", "serve.hop.test"]


def _heat_args():
    p = SimParams(nx=24, ny=20, order=4, iters=6)
    u0 = make_initial_grid(p, dtype=torch.float32, device="cpu")
    return u0, p.iters, p.order, p.xcfl, p.ycfl, p.bc


def test_a_host_range_is_a_profiler_range_and_no_record():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer.op"):
            with trace.host_range("host.part"):
                torch.ones(4).add_(1)
    (outer,) = _ranges(prof, "outer.op")
    (part,) = _ranges(prof, "host.part")
    assert _inside(part, outer)
    assert [e["span"] for e in _spans()] == ["outer.op"]
    assert "span.host.part.ms" not in metrics.snapshot()["histograms"]


def test_a_host_range_with_no_profiler_is_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.host_range("quiet.part"):
        pass
    with pytest.raises(KeyError):
        with trace.host_range("quiet.raises"):
            raise KeyError("x")
    assert trace.events() == []


@pytest.mark.parametrize("calls", [1, 3])
def test_heat_solve_holds_its_admission_and_run(calls):
    args = _heat_args()
    stencil_pipeline.run_heat_resilient(*args, k=2)  # the gate's first use
    trace.clear_events()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            stencil_pipeline.run_heat_resilient(*args, k=2)
    solves = _ranges(prof, "heat.solve")
    admits = _ranges(prof, "admission.admit")
    runs = _ranges(prof, "heat.run")
    assert len(solves) == len(admits) == len(runs) == calls
    for solve, admit, run in zip(solves, admits, runs):
        assert _inside(admit, solve) and _inside(run, solve)
        assert admit[1] <= run[0]
    # the solve and its admission write no record: the JSON log is the
    # one an uninstrumented solve writes
    assert [e["span"] for e in _spans()
            if e["span"] in ("heat.solve", "admission.admit")] == []
    assert len(_spans("heat.run")) == calls


def test_spmv_scan_solve_holds_its_steps():
    prob = sp.generate_problem(512, 8, 7, iters=3, seed=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp.run_spmv_scan(prob, kernel="flat", device="cpu")
    (solve,) = _ranges(prof, "spmv_scan.solve")
    steps = [_ranges(prof, f"spmv_scan.{s}")
             for s in ("validate", "upload", "run", "download")]
    assert [len(s) for s in steps] == [1, 1, 1, 1]
    steps = [s[0] for s in steps]
    assert all(_inside(s, solve) for s in steps)
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))
    assert not [e for e in _spans() if e["span"] in (
        "spmv_scan.solve", "spmv_scan.validate", "spmv_scan.upload",
        "spmv_scan.download")]
    assert len(_spans("spmv_scan.run")) == 1


def test_a_profiled_sweep_names_the_spmv_solve_s_host_work(
        tmp_path, monkeypatch):
    """The operator's view of these ranges: ``bench/run_all`` under
    ``CME213_PROFILE_DIR`` writes a Chrome trace that holds them."""
    from cme213_tpu_torch.bench import run_all

    monkeypatch.setenv(run_all.PROFILE_DIR_ENV, str(tmp_path / "prof"))
    assert run_all.main(["--out", str(tmp_path / "out"), "--quick",
                         "--only", "spmv_scan_sweep", "--device=cpu"]) == 0
    (path,) = (tmp_path / "prof").glob("trace-*.json")
    names = {ev.get("name") for ev in
             json.loads(path.read_text())["traceEvents"]}
    assert {f"spmv_scan.{s}" for s in ("solve", "validate", "upload", "run",
                                       "download")} <= names


def test_a_phase_waits_once_for_its_tensors(monkeypatch):
    synced = []

    class FakeCuda:
        is_cuda = True
        device = "cuda:0"

    monkeypatch.setattr(torch, "is_tensor", lambda t: True)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timer = PhaseTimer()
    with timer.phase("gpu computation shared") as ph:
        ph.block(FakeCuda())
    assert synced == ["cuda:0"]
    assert timer.records[-1].label == "gpu computation shared"
    assert trace.events("span-end")[-1]["span"] == "gpu computation shared"
