"""The port's resilience layer against the JAX package's: failure
classification, the finiteness guard, bounded retry, the fallback ladder
and the circuit breaker; and the port's own failures (a failed ``nvcc``
build, a launch error, device out-of-memory) in their kinds and stages.

The same inputs go to ``cme213_tpu.core.resilience`` and to
``cme213_tpu_torch.core.resilience``, on ``VirtualClock``s, and the
results are compared exactly.
"""

import stat

import numpy as np
import pytest
import torch

from cme213_tpu.core import faults as jfaults
from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import resilience as jres
from cme213_tpu.core import trace as jtrace
from cme213_tpu.core.errors import FrameworkError as JFrameworkError
from cme213_tpu_torch.core import diag as tdiag
from cme213_tpu_torch.core import faults as tfaults
from cme213_tpu_torch.core import metrics as tmetrics
from cme213_tpu_torch.core import resilience as tres
from cme213_tpu_torch.core import trace as ttrace
from cme213_tpu_torch.core.errors import FrameworkError as TFrameworkError
from cme213_tpu_torch.core.errors import KernelError
from cme213_tpu_torch.ops import _kernels

SIDES = ((jres, jfaults, jtrace, jmetrics, JFrameworkError),
         (tres, tfaults, ttrace, tmetrics, TFrameworkError))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("CME213_FAULTS", "CME213_INCARNATION", "CME213_TRACE_FILE"):
        monkeypatch.delenv(var, raising=False)
    for _, faults, trace, metrics, _ in SIDES:
        faults.reset()
        trace.clear_events()
        metrics.reset()
    yield
    for _, faults, trace, metrics, _ in SIDES:
        faults.reset()
        trace.clear_events()
        metrics.reset()


def _records(trace):
    return [{k: v for k, v in r.items()
             if k not in ("t", "pid", "trace", "id", "parent", "ms")}
            for r in trace.events()]


# ---------------------------------------------------------- classification

#: the cases of ``tests/test_resilience.py`` (the injected fault is each
#: package's own), plus wrapped and message-only ones
CASES = [
    (lambda res, f, E: res.NonFiniteError("nan state"), "numeric"),
    (lambda res, f, E: FloatingPointError("overflow"), "numeric"),
    (lambda res, f, E: RuntimeError("output contains NaN values"), "numeric"),
    (lambda res, f, E: NotImplementedError("no lowering rule"), "compile"),
    (lambda res, f, E: RuntimeError("Mosaic failed to compile the kernel"),
     "compile"),
    (lambda res, f, E: ValueError("unsupported op in lowering"), "compile"),
    (lambda res, f, E: f.InjectedFault("injected failure in op"), "runtime"),
    (lambda res, f, E: OSError("connection reset"), "runtime"),
    (lambda res, f, E: f.InjectedResourceExhausted("RESOURCE_EXHAUSTED"),
     "resource"),
    (lambda res, f, E: RuntimeError("RESOURCE_EXHAUSTED: Out of memory"),
     "resource"),
    (lambda res, f, E: ZeroDivisionError("x"), "numeric"),
    (lambda res, f, E: RuntimeError("XLA compilation oom: vmem"), "compile"),
    (lambda res, f, E: E("error in op"), "runtime"),
]


def _wrapped(inner, E):
    try:
        try:
            raise inner
        except Exception as e:
            raise E("error in op") from e
    except E as fe:
        return fe


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("wrap", [False, True])
def test_classify_failure_matches_reference(case, wrap):
    make, want = CASES[case]
    got = []
    for res, faults, _, _, E in SIDES:
        exc = make(res, faults, E)
        if wrap:
            exc = _wrapped(exc, E)
        got.append(res.classify_failure(exc).value)
    assert got == [want, want]


def _nvcc_failure(tmp_path, monkeypatch):
    """A real ``FrameworkError`` out of ``_kernels.build``: an ``nvcc``
    that fails the way a ptxas error does."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'ptxas fatal   : Unresolved extern "
                    "function' >&2\nexit 255\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(TFrameworkError) as info:
        _kernels.build("transpose")
    return info.value


def _nvcc_missing(monkeypatch):
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    monkeypatch.setattr(_kernels.Path, "is_file", lambda self: False)
    with pytest.raises(TFrameworkError) as info:
        _kernels._nvcc()
    return info.value


def test_failed_build_is_compile(tmp_path, monkeypatch):
    e = _nvcc_failure(tmp_path, monkeypatch)
    assert str(e).startswith("nvcc failed on transpose.cu")
    assert tres.classify_failure(e) == tres.FailureKind.COMPILE
    assert tdiag.failure_stage(e) == "compile"
    assert tdiag.stage_for_message(str(e)) == "compile"


def test_missing_nvcc_is_compile(monkeypatch):
    e = _nvcc_missing(monkeypatch)
    assert "nvcc not found" in str(e)
    assert tres.classify_failure(e) == tres.FailureKind.COMPILE
    assert tdiag.failure_stage(e) == "compile"


#: the port's own failure texts: its launch errors (``ops/_kernels.py``),
#: torch's CUDA errors and out-of-memory
PORT_CASES = [
    ("heat_ksteps launch failed: an illegal memory access was encountered "
     "(cudaError 700; order=8 k=1 tile=64x128 run=1 smem=84992 1 shard(s) "
     "of 4008x4008 torch.float32)", "runtime", "execute"),
    ("segmented_scan launch failed: unspecified launch failure (cudaError "
     "719; n=11634424 fused=True workspace=11370 words, epoch 3)",
     "runtime", "execute"),
    ("heat_band launch failed: invalid argument (cudaError 1; order 8)",
     "runtime", "execute"),
    ("CUDA error: an illegal memory access was encountered\nCUDA kernel "
     "errors might be asynchronously reported at some other API call, so "
     "the stacktrace below might be incorrect.\nCompile with "
     "`TORCH_USE_CUDA_DSA` to enable device-side assertions.",
     "runtime", "execute"),
    ("CUDA error: out of memory\nCompile with `TORCH_USE_CUDA_DSA` to "
     "enable device-side assertions.", "resource", "execute"),
    ("transpose_tiles launch failed: out of memory (cudaError 2; 4096x4096 "
     "torch.float32)", "resource", "execute"),
    ("CUDA out of memory. Tried to allocate 64.00 GiB", "resource",
     "execute"),
    ("nvcc failed on heat_stencil.cu (rc 1):\nptxas error   : Entry "
     "function uses too much shared data", "compile", "compile"),
]


@pytest.mark.parametrize("text,kind,stage", PORT_CASES,
                         ids=[f"{k}-{i}" for i, (_, k, _) in
                              enumerate(PORT_CASES)])
def test_port_failures_classify_and_stage(text, kind, stage):
    for exc in (TFrameworkError(text), RuntimeError(text)):
        assert tres.classify_failure(exc).value == kind
        assert tdiag.failure_stage(exc) == stage
    assert tdiag.stage_for_message(text) == stage
    wrapped = _wrapped(RuntimeError(text), TFrameworkError)
    assert tres.classify_failure(wrapped).value == kind


def test_torch_out_of_memory_is_resource():
    e = torch.cuda.OutOfMemoryError("CUDA out of memory.")
    assert tres.classify_failure(e) == tres.FailureKind.RESOURCE
    assert tres.classify_failure(_wrapped(e, TFrameworkError)) == \
        tres.FailureKind.RESOURCE
    assert tres.classify_failure(
        tfaults.InjectedResourceExhausted("x")) == tres.FailureKind.RESOURCE


# ------------------------------------------------------------- all_finite

@pytest.mark.parametrize("tree,ok", [
    ({"a": np.ones(3), "b": (np.arange(4),)}, True),
    (np.arange(5, dtype=np.int32), True),
    ({"a": np.array([1.0, np.nan])}, False),
    ([np.ones(2), [np.array([np.inf], np.float32)]], False),
    ((), True),
])
def test_all_finite_matches_reference(tree, ok):
    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_torch(v) for v in x)
        return torch.from_numpy(np.array(x))

    assert jres.all_finite(tree) == ok
    assert tres.all_finite(to_torch(tree)) == ok
    assert tres.all_finite(tree) == ok  # arrays too


# ------------------------------------------------------------ retry policy

def _flaky(exc_for_call):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        e = exc_for_call(calls["n"])
        if e is not None:
            raise e
        return f"done after {calls['n']}"

    return fn, calls


@pytest.mark.parametrize("script", [
    [RuntimeError("transient"), RuntimeError("transient"), None],
    [RuntimeError("transient")] * 5,
    [NotImplementedError("no lowering rule"), None],
    [RuntimeError("output contains NaN"), None],
    [None],
])
def test_retry_policy_matches_reference(script):
    outcome = []
    for res, _, trace, metrics, _ in SIDES:
        clock = res.VirtualClock()
        fn, calls = _flaky(lambda n: script[n - 1] if n <= len(script)
                           else None)
        pol = res.RetryPolicy(max_retries=3, base_delay_s=0.01,
                              multiplier=2.0, clock=clock)
        try:
            out = pol.run(fn, op="op.flaky")
        except Exception as e:  # noqa: BLE001
            out = type(e).__name__
        outcome.append((out, calls["n"], round(clock.now(), 9),
                        pol.delays(), _records(trace),
                        metrics.snapshot()["counters"]))
    assert outcome[0] == outcome[1]


# ------------------------------------------------------------ the ladder

def _ladder(res, faults, E, kind):
    def boom(msg, cls=RuntimeError):
        def thunk():
            raise cls(msg)
        return thunk

    if kind == "first-holds":
        return [("pallas", lambda: 1), ("xla", lambda: 2)], None
    if kind == "compile-then-runtime":
        return [("pallas", boom("Mosaic lowering failed")),
                ("blocked", boom("transient")), ("flat", lambda: 3)], None
    if kind == "gate-refuses":
        return ([("pallas", lambda: 1), ("xla", lambda: 2)],
                lambda rung: rung != "pallas")
    if kind == "gate-raises":
        def gate(rung):
            if rung == "pallas":
                raise RuntimeError("probe compile failed")
            return True
        return [("pallas", lambda: 1), ("xla", lambda: 2)], gate
    if kind == "all-fail":
        return [("a", boom("x")), ("b", boom("RESOURCE_EXHAUSTED"))], None
    raise AssertionError(kind)


LADDERS = ["first-holds", "compile-then-runtime", "gate-refuses",
           "gate-raises", "all-fail"]


@pytest.mark.parametrize("kind", LADDERS)
@pytest.mark.parametrize("spec", ["", "fail:op.pallas",
                                  "stage:op.pallas:execute:1"])
def test_with_fallback_matches_reference(kind, spec):
    got = []
    for res, faults, trace, metrics, E in SIDES:
        ladder, gate = _ladder(res, faults, E, kind)
        with faults.injected(spec):
            try:
                r = res.with_fallback(
                    "op", ladder, gate=gate,
                    policy=res.RetryPolicy(max_retries=1, base_delay_s=0.0,
                                           clock=res.VirtualClock()))
                out = (r.value, r.rung, r.demoted,
                       [(f.rung, f.kind.value, f.error) for f in r.failures])
            except E as e:
                out = ("raised", str(e))
        got.append((out, _records(trace), metrics.snapshot()["counters"]))
    assert got[0] == got[1]


def test_breaker_matches_reference():
    got = []
    for res, faults, trace, metrics, E in SIDES:
        clock = res.VirtualClock()
        br = res.CircuitBreaker(threshold=2, cooldown_s=10.0, clock=clock)
        state = {"broken": True}

        def fast():
            if state["broken"]:
                raise RuntimeError("launch failed")
            return "fast"

        served = []
        for step in range(8):
            if step == 5:
                clock.advance(11.0)
                state["broken"] = False
            r = res.with_fallback("op", [("fast", fast),
                                         ("safe", lambda: "safe")],
                                  breaker=br)
            served.append((r.rung, br.state("op", "fast")))
        got.append((served, _records(trace),
                    metrics.snapshot()["counters"]))
    assert got[0] == got[1]
    with pytest.raises(ValueError):
        tres.CircuitBreaker(threshold=0)


def test_a_failed_build_is_a_recorded_rung_failure(tmp_path, monkeypatch):
    """A rung whose kernel cannot be built is recorded as a
    ``kernel-failure`` (COMPILE, stage ``compile``) and raises out of the
    ladder: a kernel that cannot build is an error, not a demotion, even
    where the caller listed another rung."""
    def build():
        _kernels.build("transpose")

    _nvcc_failure(tmp_path, monkeypatch)  # arms the failing nvcc
    with pytest.raises(KernelError) as info:
        tres.with_fallback("heat", [("pipeline", build),
                                    ("xla", lambda: "plain")])
    assert tres.classify_failure(info.value) == tres.FailureKind.COMPILE
    kf = ttrace.events("kernel-failure")
    assert kf[0]["stage"] == "compile" and kf[0]["kernel"] == "pipeline"
    assert not ttrace.events("served")
    with pytest.raises(TFrameworkError):
        tres.with_fallback("heat", [("pipeline", build)])
