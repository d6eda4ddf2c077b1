"""Failure classification, bounded retry, and the kernel fallback ladder.

Counterpart of ``cme213_tpu/core/resilience.py``.  The reference's failure
model is binary — ``check_launch`` aborts, or the job is fine
(``hw/hw1/programming/mp1-util.h:8-18``).  This module is the middle
ground, in three pieces:

- ``classify_failure`` buckets an exception as COMPILE (a kernel that
  cannot be built: ``nvcc``/``ptxas`` failures, and the JAX package's
  lowering markers — deterministic, never retried on the same rung),
  NUMERIC (non-finite values), RESOURCE (``torch.cuda.OutOfMemoryError``,
  "CUDA out of memory", an injected RESOURCE_EXHAUSTED — retrying the same
  program refinds the same wall; the response is to shrink), or RUNTIME
  (everything else: launch errors such as ``cudaError 700``, injected
  faults — retryable).  A fifth kind, WRONG_ANSWER, is never produced by
  classification: a conformance gate assigns it.  A launch error is
  RUNTIME, but an in-process retry cannot cure a sticky CUDA error (the
  context stays poisoned), so callers that must survive one retry in a
  new process, as ``bench/headline.py`` does.
- ``RetryPolicy`` — bounded attempts with a deterministic geometric backoff
  (no jitter: CI reproducibility first).
- ``with_fallback`` — run a ladder of (rung, thunk) candidates in order,
  consult the fault plan per rung (``faults.maybe_fail``), record every
  demotion through the structured trace log, and report which rung
  actually served the request.  A rung whose kernel cannot be built or
  launched is an error, not a demotion: a ``KernelError`` out of a rung or
  out of its conformance probe is recorded as a ``kernel-failure`` and
  re-raised, so the ladder never hides a broken kernel behind a slower
  rung.  What demotes is what the JAX package demotes on with a working
  kernel: injected faults (``fail:``, ``stage:``, ``oom:``, ``wrong:``),
  a conformance verdict, a RESOURCE failure the caller chose not to absorb,
  and an open circuit breaker.  On a CUDA device the callers' ladders hold
  only kernel rungs unless the caller asks for a plain one
  (``allows_plain_rungs``), so a demotion moves between kernels, and a
  ladder whose rungs are all refused raises.

Every guard here runs in host Python at solve level: zero device work,
and zero work at all when no faults are installed and the first rung holds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum

from . import metrics
from .diag import failure_stage
from .errors import FrameworkError, KernelError
from .faults import maybe_fail, maybe_fail_stage
from .trace import record_event


class FailureKind(str, Enum):
    COMPILE = "compile"
    RUNTIME = "runtime"
    NUMERIC = "numeric"
    RESOURCE = "resource"           # out of device memory: shrink, don't retry
    WRONG_ANSWER = "wrong_answer"   # conformance probe diverged: demote
    BREAKER_OPEN = "breaker_open"   # circuit open: routed around, not a crash


@dataclass
class Clock:
    """Injectable time source: ``now()`` (monotonic seconds) + ``sleep``.

    Every wall-time consumer in the serving/retry path takes one of these
    so tests substitute :class:`VirtualClock` and never sleep for real.
    """

    now: object = field(default=time.monotonic, repr=False)
    sleep: object = field(default=time.sleep, repr=False)


class VirtualClock:
    """Deterministic test clock: ``sleep`` advances ``now`` instantly."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self._t += max(0.0, float(seconds))

    def advance(self, seconds: float) -> None:
        self._t += float(seconds)


class NonFiniteError(ArithmeticError):
    """A finiteness guard tripped: the state contains NaN/Inf."""


# substrings (lowercased) marking a deterministic build/lowering failure —
# retrying the identical program cannot succeed, but a different kernel
# formulation of the same op can.  The port's kernel build names nvcc or
# ptxas (``ops/_kernels.py``); the rest are the JAX package's markers.
_BUILD_MARKERS = ("nvcc", "ptxas")
_COMPILE_MARKERS = ("mosaic", "lowering", "lower", "compil", "unsupported",
                    "unimplemented", "vmem", "mlir")
_NUMERIC_MARKERS = ("nan", "non-finite", "not finite", "overflow")
# device memory exhaustion; tested before the launch markers, since
# "CUDA error: out of memory" holds both
_RESOURCE_MARKERS = ("resource_exhausted", "resource exhausted",
                     "out of memory", "out-of-memory")
# a kernel launch or device fault ("... launch failed: ... (cudaError N;
# ...)", torch's "CUDA error: ..."); tested before the compile markers,
# since torch's CUDA error text advises to "Compile with
# TORCH_USE_CUDA_DSA"
_LAUNCH_MARKERS = ("cudaerror", "cuda error")


def classify_failure(exc: BaseException) -> FailureKind:
    """COMPILE / NUMERIC / RESOURCE / RUNTIME bucket for a caught
    exception."""
    import torch

    from .faults import InjectedResourceExhausted

    if isinstance(exc, (NonFiniteError, FloatingPointError, ZeroDivisionError)):
        return FailureKind.NUMERIC
    if isinstance(exc, (InjectedResourceExhausted,
                        torch.cuda.OutOfMemoryError)):
        return FailureKind.RESOURCE
    if isinstance(exc, FrameworkError) and exc.__cause__ is not None:
        return classify_failure(exc.__cause__)
    if isinstance(exc, NotImplementedError):
        return FailureKind.COMPILE
    msg = f"{type(exc).__name__}: {exc}".lower()
    if any(m in msg for m in _BUILD_MARKERS):
        return FailureKind.COMPILE
    if any(m in msg for m in _NUMERIC_MARKERS):
        return FailureKind.NUMERIC
    if any(m in msg for m in _RESOURCE_MARKERS):
        return FailureKind.RESOURCE
    if any(m in msg for m in _LAUNCH_MARKERS):
        return FailureKind.RUNTIME
    if any(m in msg for m in _COMPILE_MARKERS):
        return FailureKind.COMPILE
    return FailureKind.RUNTIME


def _leaves(tree):
    """The leaves of nested lists, tuples and dicts (dicts by sorted
    key)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def all_finite(state) -> bool:
    """Finiteness guard over nested lists, tuples and dicts of tensors
    (or arrays): False when a float leaf holds a NaN or an infinity.  A
    CUDA tensor is checked on its device; only the verdict crosses."""
    import numpy as np
    import torch

    for leaf in _leaves(state):
        if torch.is_tensor(leaf):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                return False
            continue
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) \
                and not np.isfinite(arr).all():
            return False
    return True


@dataclass
class RetryPolicy:
    """Bounded retry with deterministic geometric backoff.

    ``run(fn)`` retries only RUNTIME-classified failures (by default):
    compile failures are deterministic and numeric failures belong to the
    checkpoint-rollback path, so retrying either wastes device minutes.
    """

    max_retries: int = 2
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    retry_on: tuple = (FailureKind.RUNTIME,)
    sleep: object = field(default=time.sleep, repr=False)
    # when set, the clock's sleep wins over ``sleep`` — callers that already
    # hold an injectable Clock/VirtualClock pass it straight through
    clock: object = field(default=None, repr=False)

    def delays(self) -> list[float]:
        return [min(self.base_delay_s * self.multiplier ** i,
                    self.max_delay_s) for i in range(self.max_retries)]

    def _sleep(self, seconds: float) -> None:
        (self.clock.sleep if self.clock is not None else self.sleep)(seconds)

    def run(self, fn, op: str = "retry"):
        last = None
        for attempt, delay in enumerate([0.0] + self.delays()):
            if delay:
                self._sleep(delay)
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classify, then decide
                kind = classify_failure(e)
                last = e
                if kind not in self.retry_on or attempt >= self.max_retries:
                    raise
                metrics.counter("retry.attempts").inc()
                record_event("retry", op=op, attempt=attempt + 1,
                             kind=kind.value, error=type(e).__name__,
                             next_delay_s=self.delays()[attempt])
        raise last  # pragma: no cover — loop always returns or raises


@dataclass
class RungFailure:
    rung: str
    kind: FailureKind
    error: str
    message: str


@dataclass
class FallbackResult:
    """What ``with_fallback`` actually ran: the value, the serving rung,
    and every rung that failed on the way down the ladder."""

    value: object
    rung: str
    failures: list[RungFailure] = field(default_factory=list)

    @property
    def demoted(self) -> bool:
        return bool(self.failures)


@dataclass
class _BreakerState:
    state: str = "closed"       # closed | open | half-open
    failures: int = 0           # consecutive classified failures
    opened_at: float = 0.0
    transitions: int = 0        # total open events (observability)


class CircuitBreaker:
    """Per-(op, rung) circuit breaker layered on the fallback ladder.

    A rung that keeps failing burns a full classify-and-demote cycle on
    every request.  The breaker remembers: after ``threshold`` consecutive
    classified failures of ``(op, rung)`` the circuit *opens* and
    ``with_fallback`` routes around the rung without executing it (a
    ``rung-failed`` event with kind ``breaker_open``, not an exception).
    After ``cooldown_s`` (on the injectable clock) the next request is
    admitted as a *half-open probe*: success closes the circuit and the
    rung serves again, failure re-opens it for another cooldown.  While a
    probe is the admitted call, concurrent requests keep routing around —
    one probe at a time.

    Only execution failures trip the breaker; a conformance-gate rejection
    is deterministic and cached by the conformance gate, so
    counting it here would be redundant.  State transitions emit
    ``breaker-open`` / ``breaker-half-open`` / ``breaker-close`` events
    and ``breaker.<transition>`` counters, so SLO reports and
    ``trace summary`` show the full arc.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Clock | None = None):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock if clock is not None else Clock()
        self._states: dict[tuple[str, str], _BreakerState] = {}

    def _st(self, op: str, rung: str) -> _BreakerState:
        return self._states.setdefault((op, rung), _BreakerState())

    def state(self, op: str, rung: str) -> str:
        return self._st(op, rung).state

    def allow(self, op: str, rung: str) -> bool:
        """May this call execute ``(op, rung)``?  Advances open->half-open
        when the cooldown has elapsed (the admitted call is the probe)."""
        st = self._st(op, rung)
        if st.state == "closed":
            return True
        if st.state == "open":
            if self._clock.now() - st.opened_at >= self.cooldown_s:
                st.state = "half-open"
                metrics.counter("breaker.half_open").inc()
                record_event("breaker-half-open", op=op, rung=rung)
                return True
            return False
        # half-open: a probe is already in flight this cycle
        return False

    def record_failure(self, op: str, rung: str, kind: FailureKind) -> None:
        st = self._st(op, rung)
        if st.state == "half-open":
            # failed probe: straight back to open, fresh cooldown
            st.state = "open"
            st.opened_at = self._clock.now()
            st.transitions += 1
            metrics.counter("breaker.open").inc()
            record_event("breaker-open", op=op, rung=rung,
                         failures=st.failures, kind=kind.value)
            return
        st.failures += 1
        if st.state == "closed" and st.failures >= self.threshold:
            st.state = "open"
            st.opened_at = self._clock.now()
            st.transitions += 1
            metrics.counter("breaker.open").inc()
            record_event("breaker-open", op=op, rung=rung,
                         failures=st.failures, kind=kind.value)

    def record_success(self, op: str, rung: str) -> None:
        st = self._st(op, rung)
        if st.state == "half-open":
            record_event("breaker-close", op=op, rung=rung)
            metrics.counter("breaker.close").inc()
        st.state = "closed"
        st.failures = 0


def allows_plain_rungs(device, plain_fallback: bool = False) -> bool:
    """May a ladder over tensors on ``device`` end at a plain PyTorch rung?

    On the CPU every rung is a plain version, so the ladder keeps the JAX
    package's rungs.  On a CUDA device it ends at its kernel rungs unless
    the caller asks for the plain one (``plain_fallback``): a kernel that
    is refused raises rather than being replaced, unasked, by the plain
    version."""
    import torch

    return plain_fallback or torch.device(device).type != "cuda"


def _kernel_failed(op: str, rung: str, exc: KernelError,
                   default: str) -> None:
    """Forensics for a kernel that cannot build or launch, which the
    ladder re-raises rather than demotes."""
    metrics.counter("fallback.kernel_errors").inc()
    record_event("kernel-failure", op=op, kernel=rung,
                 error=type(exc).__name__,
                 stage=failure_stage(exc, default=default))


def with_fallback(op: str, ladder, policy: RetryPolicy | None = None,
                  gate=None, breaker: CircuitBreaker | None = None,
                  ) -> FallbackResult:
    """Run the first rung of ``ladder`` (a sequence of ``(name, thunk)``)
    that succeeds, demoting down the ladder on failure.

    Per rung: the conformance ``gate`` is consulted first when given
    (``gate(name) -> bool`` — typically a closure over
    a conformance check; a False verdict or a raising probe demotes
    with ``FailureKind.WRONG_ANSWER`` exactly like a rung exception), then
    the fault plan (``maybe_fail(f"{op}.{name}")`` — an injected failure
    demotes exactly like a real one), then the thunk runs (under
    ``policy`` when given, which retries transient RUNTIME failures
    *within* the rung before demoting).  A ``breaker`` (``CircuitBreaker``)
    is consulted before everything: a rung with an open circuit is routed
    around without executing (kind ``breaker_open``), and execution
    successes/failures feed its state machine.  Each failed rung emits a
    structured ``rung-failed`` event plus a stage-attributed
    ``kernel-failure`` forensics event (``core/diag.py`` decides the
    ``lower``/``compile``/``execute``/``conformance`` bucket from the
    exception's stage tag or message); the serving rung emits ``served``
    with ``demoted`` and the failure list, so capture logs show which
    kernel actually handled the request.  All-rungs-failed raises
    FrameworkError chained to the last failure.  A ``KernelError`` (a
    kernel that cannot build or launch) out of a rung or its probe is
    re-raised as it is, after its ``kernel-failure`` event: no demotion.
    """
    failures: list[RungFailure] = []
    last: Exception | None = None
    for name, thunk in ladder:
        if breaker is not None and not breaker.allow(op, name):
            # open circuit: route around without executing — cheaper than a
            # guaranteed failure, and NOT counted as a fallback demotion
            # (nothing ran, nothing failed)
            failures.append(RungFailure(
                name, FailureKind.BREAKER_OPEN, "BreakerOpen",
                "circuit open for this rung; routed to next rung"))
            metrics.counter("breaker.skipped").inc()
            record_event("rung-failed", op=op, rung=name,
                         kind=FailureKind.BREAKER_OPEN.value,
                         error="BreakerOpen")
            continue
        if gate is not None:
            try:
                admitted = gate(name)
            except KernelError as e:
                _kernel_failed(op, name, e, "conformance")
                raise
            except Exception as e:  # noqa: BLE001 — a crashed probe is a
                # rung failure: the rung cannot even run its probe problem
                kind = classify_failure(e)
                failures.append(RungFailure(name, kind, type(e).__name__,
                                            str(e)[:300]))
                metrics.counter("fallback.demotions").inc()
                record_event("rung-failed", op=op, rung=name,
                             kind=kind.value, error=type(e).__name__)
                # forensics: a raising probe usually died while building/
                # warming its probe program — the stage tag (or message
                # heuristics) says which phase, defaulting to conformance
                record_event("kernel-failure", op=op, kernel=name,
                             error=type(e).__name__,
                             stage=failure_stage(e, default="conformance"))
                last = e
                continue
            if not admitted:
                failures.append(RungFailure(
                    name, FailureKind.WRONG_ANSWER, "ConformanceFailed",
                    "probe output diverged from the reference rung"))
                metrics.counter("fallback.demotions").inc()
                record_event("rung-failed", op=op, rung=name,
                             kind=FailureKind.WRONG_ANSWER.value,
                             error="ConformanceFailed")
                record_event("kernel-failure", op=op, kernel=name,
                             error="ConformanceFailed", stage="conformance")
                continue
        try:
            maybe_fail(f"{op}.{name}")
            maybe_fail_stage(f"{op}.{name}", "execute")
            value = (thunk() if policy is None
                     else policy.run(thunk, op=f"{op}.{name}"))
        except KernelError as e:
            _kernel_failed(op, name, e, "execute")
            raise
        except Exception as e:  # noqa: BLE001 — every rung failure is data
            kind = classify_failure(e)
            failures.append(RungFailure(name, kind, type(e).__name__,
                                        str(e)[:300]))
            metrics.counter("fallback.demotions").inc()
            record_event("rung-failed", op=op, rung=name, kind=kind.value,
                         error=type(e).__name__)
            record_event("kernel-failure", op=op, kernel=name,
                         error=type(e).__name__, stage=failure_stage(e))
            if breaker is not None:
                breaker.record_failure(op, name, kind)
            last = e
            continue
        if breaker is not None:
            breaker.record_success(op, name)
        metrics.counter(f"served.{op}.{name}").inc()
        record_event("served", op=op, rung=name, demoted=bool(failures),
                     failed_rungs=[f.rung for f in failures])
        return FallbackResult(value, name, failures)
    raise FrameworkError(
        f"all {len(failures)} rungs of {op} failed: "
        + "; ".join(f"{f.rung}[{f.kind.value}] {f.error}" for f in failures)
    ) from last
