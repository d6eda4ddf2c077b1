"""Telemetry: trace spans, structured events, and hardened per-rank sinks.

Counterpart of ``cme213_tpu/core/trace.py``: the same event schema, record
tags, span ids, sinks and environment variables, so traces of the two
packages read alike and merge.  Its pieces:

- **Structured events** (``record_event``): op failures
  (``core/errors.check_op``), fallback-ladder demotions and retries
  (``core/resilience.py``), injected faults (``core/faults.py``), device
  health (``core/diag.py``) and the bench harness's sweep and kernel
  records all flow through here as dicts.  Every record carries process
  tags: ``pid``, ``rank`` (``RANK``, the variable ``torch.distributed``
  launchers set), ``incarnation`` (``CME213_INCARNATION``) and ``trace``,
  so per-rank files can be merged back into one view.  The registry of
  known event names and their required fields is :data:`EVENT_SCHEMA`.

- **Spans** (``span``): causally linked begin/end pairs, with unique ids,
  parent links via a contextvar stack, monotonic durations, and a
  ``.block(*tensors)`` hook that synchronises the CUDA devices of the
  given tensors before the clock stops (CUDA work is asynchronous; this
  is the ``cudaEventSynchronize`` before ``stop_timer``, the same
  discipline as ``core/timing.PhaseTimer``, whose phases emit spans).
  Span durations also feed the metrics registry (``core/metrics.py``) as
  ``span.<name>.ms`` histograms.

- **The profiler mirror**: while a ``torch.profiler`` session is
  recording, ``span`` also holds ``torch.profiler.record_function(name)``
  open over the span's measured extent, so the span appears among the
  profiler's host ranges, nested as it ran and on the device trace's own
  clock: a gap on the card's timeline reads as the innermost program span
  that was open.  With no session the mirror costs one
  ``_profiler_enabled()`` check a span (entering ``record_function``
  costs many times that even with no session), made only when torch is
  already imported, so a process that never loads torch never loads it
  here.  Cross-thread hop spans (``begin_span``) are not mirrored: a
  profiler range must close on the thread that opened it.  The JSON
  records are the same either way.  ``host_range`` is the mirror alone,
  for host work that is read only on the profiler's clock (a solve's
  admission, ladder and launch loop): a range while a session records,
  and no record, histogram or id otherwise, so that with no session it
  costs the one check.

- **Cross-process context**: every record is stamped with a ``trace`` id
  that spans the whole job.  A launcher exports ``CME213_TRACE_CONTEXT``
  (JSON ``{"trace_id", "parent_span_id"}``) into its children via
  :func:`propagation_env`; a child inherits the id (else mints one per
  process) and parents its root spans under the launcher's open span.

- **Sinks**: set ``CME213_TRACE_FILE`` to append each record as a JSON
  line.  The handle is opened once and cached, guarded by a lock, flushed
  per line (a hard-killed process keeps everything it recorded) and
  closed at exit.  A ``{rank}`` placeholder in the path is expanded per
  process (from ``RANK``, or ``main`` outside a gang).
  ``CME213_TRACE_BUFFER`` caps the in-process event list as a ring buffer
  (default unbounded).

With no sink configured, an event is one dict append under a lock.

``device_trace`` captures a ``torch.profiler`` trace of CPU and CUDA
activity into a directory, as a Chrome trace: the kernel-level view that
spans deliberately do not replace.
"""

from __future__ import annotations

import atexit
import contextvars
import itertools
import json
import os
import sys
import threading
import time
import zlib
from collections import deque
from contextlib import contextmanager

#: JSON-lines sink path; may contain a ``{rank}`` placeholder
TRACE_FILE_ENV = "CME213_TRACE_FILE"
#: ring-buffer cap on the in-process event list (0/unset = unbounded)
TRACE_BUFFER_ENV = "CME213_TRACE_BUFFER"
#: cross-process trace context a launcher exports to its children:
#: JSON ``{"trace_id": str, "parent_span_id": str|null}``
TRACE_CONTEXT_ENV = "CME213_TRACE_CONTEXT"
#: truthy -> tail-based sampling: request-hop spans are buffered per
#: request and only written when the tail decision keeps them (slow /
#: shed / failed / requeued / drift-flagged), so always-on tracing costs
#: ~0 sink traffic on the happy path
TRACE_TAIL_ENV = "CME213_TRACE_TAIL"
#: head-sampling rate (0..1): this deterministic fraction of requests
#: bypasses the tail buffer entirely and is always kept
TRACE_HEAD_RATE_ENV = "CME213_TRACE_HEAD_RATE"
#: explicit "slow" latency threshold (ms) for the tail keep decision;
#: unset means latency alone never forces a keep
TRACE_TAIL_SLOW_MS_ENV = "CME213_TRACE_TAIL_SLOW_MS"

#: Known event names -> required fields (beyond the automatic
#: event/t/pid/rank/incarnation/trace tags).  The JAX package's table,
#: entry for entry, so one validator reads both packages' records; the
#: comments name the modules that emit each event in that package, and
#: their counterparts here where ported.  ``tests/test_torch_telemetry.py``
#: checks every ``record_event`` call site of the port against it.
EVENT_SCHEMA: dict[str, tuple[str, ...]] = {
    # op barriers / ingestion (core/errors.py)
    "op-failure": ("op", "error", "ms", "message"),
    "data-validation": ("source", "invariant", "detail"),
    # resilience ladder (core/resilience.py)
    "retry": ("op", "attempt", "kind", "error", "next_delay_s"),
    "rung-failed": ("op", "rung", "kind", "error"),
    "served": ("op", "rung", "demoted", "failed_rungs"),
    # fault injection (core/faults.py)
    "fault-injected": ("kind", "op"),
    # conformance gating (core/conformance.py)
    "conformance-probe": ("op", "rung", "shape_class", "ok", "ms"),
    "conformance-failed": ("op", "rung", "shape_class", "detail"),
    # admission control (core/admission.py, core/checkpoint.py,
    # ops/stencil_pipeline.py, dist solvers)
    "admission-rejected": ("op", "requested_bytes", "budget_bytes", "detail"),
    "chunk-shrunk": ("op", "from_size", "to_size", "reason"),
    # single-process checkpoints (core/checkpoint.py)
    "checkpoint-quarantine": ("path", "quarantined_to", "error", "message"),
    "numeric-abort": ("op", "step", "retries"),
    "checkpoint-rollback": ("op", "resumed_step", "retries"),
    # bench harness (bench/run_all.py, bench.py)
    "sweep-failed": ("sweep", "attempt", "error"),
    "sweep-complete": ("sweep", "rows", "ms"),
    "kernel-failure": ("op", "kernel", "error", "stage"),
    "device-memory": ("path", "bytes"),
    # device-health doctor + staged forensics (core/diag.py)
    "device-health": ("healthy", "platform", "devices", "probe_ms"),
    "attribution-mismatch": ("op", "rung", "shape_class", "metric",
                             "predicted", "measured", "ratio"),
    # compile/run split (this module; ROADMAP item 5's measurement half)
    "compile-retrace": ("op", "shape_class", "kernel", "count"),
    # program cache (core/programs.py; ROADMAP item 5's amortization half)
    "program-cache-hit": ("op", "rung", "shape_class"),
    "program-cache-miss": ("op", "rung", "shape_class"),
    # autotuner (core/tune.py; ROADMAP item 2b): trial/winner from the
    # measured search, hit/default from every dispatch-time consult
    "tune-trial": ("op", "shape_class", "candidate", "ok", "ms", "gbs"),
    "tune-winner": ("op", "shape_class", "dtype", "candidate", "statics",
                    "gbs"),
    "tune-hit": ("op", "shape_class", "statics"),
    "tune-default": ("op", "shape_class"),
    # distributed commits (dist/ckpt.py)
    "epoch-commit": ("epoch", "step", "world", "shards", "ms"),
    "commit-invalid": ("candidate", "error", "message"),
    "commit-loaded": ("epoch", "step", "candidate"),
    # gang supervision (dist/launch.py, dist/supervisor.py)
    "rank-failed": ("rank", "reason", "incarnation"),
    "gang-restart": ("incarnation", "reason", "rank"),
    "gang-launch": ("incarnation", "world", "coordinator"),
    "gang-exit": ("incarnation", "rc"),
    "heartbeat": ("rank", "step"),
    # circuit breaker (core/resilience.py)
    "breaker-open": ("op", "rung", "failures", "kind"),
    "breaker-half-open": ("op", "rung"),
    "breaker-close": ("op", "rung"),
    # serving front end (serve/server.py)
    "queue-shed": ("op", "reason", "depth", "age_ms"),
    "deadline-shed": ("op", "rid", "late_ms", "depth", "age_ms"),
    "batch-executed": ("op", "shape_class", "size", "occupancy"),
    # request lifecycle (serve/server.py): one per served/failed request,
    # linking the request id to the batch span that executed it
    "request-served": ("rid", "op", "tenant", "batch", "status", "total_ms"),
    # wire codec span tags (serve/transport.py): one per encode/decode
    # on either side of a v2 frame, sampled past the first 64 rids of a
    # connection — the serve.request.{encode,decode}_ms histograms see
    # the full population
    "request-serialized": ("rid", "op", "ms", "nbytes"),
    "request-deserialized": ("rid", "op", "ms", "nbytes"),
    # SLO burn-rate monitor (serve/slo.py)
    "slo-burn": ("objective", "burn_short", "burn_long", "threshold"),
    "slo-ok": ("objective", "burn_short"),
    # replicated serving fleet (serve/fleet.py, serve/router.py)
    "replica-up": ("replica", "incarnation", "addr"),
    "replica-down": ("replica", "incarnation", "reason"),
    "request-routed": ("rid", "op", "tenant", "replica"),
    "request-requeued": ("rid", "op", "tenant", "from_replica"),
    "scale-up": ("replicas", "reason"),
    "scale-down": ("replicas", "reason"),
    # numeric-health observatory (core/numerics.py): shadow conformance
    # sampling, output sentinels, convergence tracing
    "numeric-drift": ("op", "rung", "shape_class", "rel_l2", "max_ulps",
                      "over_budget"),
    "numeric-sentinel": ("op", "rung", "kind", "count", "size"),
    "solver-progress": ("op", "step", "residual", "delta_norm",
                        "iters_per_s", "job"),
    "drift-budget-burn": ("op", "rung", "burn_short", "burn_long",
                          "threshold"),
    "drift-budget-ok": ("op", "rung", "burn_short"),
    # durable long-job lane (serve/jobs.py): one per accepted submit,
    # one per committed epoch (emitted only after the record publish —
    # epoch numbers are unique per job across crashes by construction),
    # one per epoch-boundary preemption, one per resume (preempted /
    # crash / restart), one per terminal transition
    "job-submitted": ("job", "op", "total_epochs"),
    "job-epoch": ("job", "op", "epoch", "residual"),
    "job-preempted": ("job", "op", "epoch", "reason"),
    "job-resumed": ("job", "op", "epoch", "source"),
    "job-done": ("job", "op", "state", "epochs"),
    "job-reassigned": ("job", "source", "target"),
    # game-day chaos campaigns (core/chaos.py): one per campaign run,
    # one per invariant violation, one per completed ddmin shrink
    "chaos-campaign": ("seed", "campaign", "cocktail", "backend"),
    "chaos-violation": ("campaign", "invariant", "detail"),
    "chaos-shrunk": ("campaign", "from_clauses", "to_clauses", "cocktail"),
    # flight recorder (core/flight.py)
    "flight-dump": ("reason", "path", "events"),
    # wall-clock alignment (this module + serve/transport.py): one per
    # completed ping-train sync; offset_ms is "peer wall clock minus
    # mine", err_ms the midpoint-of-RTT uncertainty bound
    "clock-offset": ("peer_pid", "offset_ms", "err_ms", "rtt_ms",
                     "samples"),
    # telemetry itself
    "span-begin": ("span", "id", "parent"),
    "span-end": ("span", "id", "parent", "ms"),
    "metrics-snapshot": ("metrics",),
}


def validate_record(rec: dict) -> list[str]:
    """Required fields missing from ``rec`` for its (known) event name;
    ``[]`` when the record is valid or the event name is unregistered."""
    required = EVENT_SCHEMA.get(rec.get("event", ""))
    if not required:
        return []
    return [k for k in required if k not in rec]


_LOCK = threading.Lock()
_EVENTS: deque = deque()
_BUFFER_CONFIGURED = False

_SINK_PATH: str | None = None   # resolved path the cached handle points at
_SINK_FILE = None
_ATEXIT_INSTALLED = False


# -------------------------------------------------- cross-process context

_CONTEXT_RAW: str | None = None   # env string the cached parse came from
_CONTEXT: dict = {}
_LOCAL_TRACE_ID: str | None = None


def _context() -> dict:
    """The inherited cross-process context (``{}`` outside a launched
    child).  Re-parsed only when the env string changes — the same
    string-compare discipline as the sink handle, so monkeypatched tests
    see context flips without a process restart."""
    global _CONTEXT_RAW, _CONTEXT
    raw = os.environ.get(TRACE_CONTEXT_ENV) or None
    if raw != _CONTEXT_RAW:
        ctx: dict = {}
        if raw:
            try:
                doc = json.loads(raw)
                if isinstance(doc, dict):
                    ctx = doc
            except ValueError:
                pass  # a torn context must never kill the workload
        _CONTEXT_RAW, _CONTEXT = raw, ctx
    return _CONTEXT


def trace_id() -> str:
    """The process-spanning trace id stamped on every record: inherited
    from the launcher (``CME213_TRACE_CONTEXT``) when present, else
    minted once per process — so a gang (or a loadgen session under the
    launcher) shares one id across every pid it touches."""
    global _LOCAL_TRACE_ID
    inherited = _context().get("trace_id")
    if inherited:
        return str(inherited)
    if _LOCAL_TRACE_ID is None:
        _LOCAL_TRACE_ID = (f"{os.getpid():x}-"
                           f"{time.time_ns() & 0xFFFFFFFFFF:010x}")
    return _LOCAL_TRACE_ID


def inherited_parent_id() -> str | None:
    """Span id (in the spawning process) this process's root spans parent
    under — the launcher's open ``gang-launch`` span, typically."""
    p = _context().get("parent_span_id")
    return str(p) if p else None


def propagation_env() -> dict:
    """Env entries a launcher injects into a child process so the child
    joins this trace: the shared ``trace_id`` plus the currently open
    span id as the child's root-span parent."""
    ctx = {"trace_id": trace_id(),
           "parent_span_id": current_span_id() or inherited_parent_id()}
    return {TRACE_CONTEXT_ENV: json.dumps(ctx)}


def _proc_tags() -> dict:
    """The per-record process tags (pid/rank/incarnation/trace) that let
    ``trace merge`` and the live collector (``core/collector.py``)
    reconstruct a gang view from per-rank files."""
    rank = os.environ.get("RANK")
    return {
        "pid": os.getpid(),
        "rank": int(rank) if rank else None,
        "incarnation": int(os.environ.get("CME213_INCARNATION", "0") or 0),
        "trace": trace_id(),
    }


def format_trace_path(template: str, rank) -> str:
    """Expand the ``{rank}`` placeholder of a sink-path template.  A
    non-rank process (``rank`` None or the empty string) expands to
    ``main`` — a leftover literal ``{rank}`` must never reach ``open``."""
    if rank is None or rank == "":
        rank = "main"
    return template.replace("{rank}", str(rank))


def _resolve_sink_path() -> str | None:
    path = os.environ.get(TRACE_FILE_ENV)
    if not path:
        return None
    if "{rank}" in path:
        # a launcher may hand its children a concrete path; this covers
        # processes using the template directly, including an empty RANK
        path = format_trace_path(path, os.environ.get("RANK"))
    return path


def _sink_file():
    """The cached append handle for the current sink path (caller holds
    ``_LOCK``).  Re-resolved per event only by string compare, so a test
    flipping the env (or a ``flush_sink``) rotates the handle; a broken
    sink caches ``None`` and is never retried until the path changes."""
    global _SINK_PATH, _SINK_FILE, _ATEXIT_INSTALLED
    path = _resolve_sink_path()
    if path != _SINK_PATH:
        if _SINK_FILE is not None:
            try:
                _SINK_FILE.close()
            except OSError:
                pass
        _SINK_FILE = None
        _SINK_PATH = path
        if path:
            try:
                _SINK_FILE = open(path, "a")
            except OSError:
                _SINK_FILE = None  # broken sink must never kill the workload
        if not _ATEXIT_INSTALLED:
            atexit.register(flush_sink)
            _ATEXIT_INSTALLED = True
    return _SINK_FILE


def flush_sink() -> None:
    """Flush and close the cached sink handle (reopened lazily by the
    next event).  Registered atexit; also the test hook for rotating the
    handle after an env change without recording an event."""
    global _SINK_PATH, _SINK_FILE
    with _LOCK:
        if _SINK_FILE is not None:
            try:
                _SINK_FILE.flush()
                _SINK_FILE.close()
            except OSError:
                pass
        _SINK_FILE = None
        _SINK_PATH = None


def _buffer() -> deque:
    """The in-process event buffer, ring-capped by ``CME213_TRACE_BUFFER``
    (read once; ``clear_events`` re-reads).  Caller holds ``_LOCK``."""
    global _EVENTS, _BUFFER_CONFIGURED
    if not _BUFFER_CONFIGURED:
        raw = os.environ.get(TRACE_BUFFER_ENV, "")
        try:
            cap = int(raw) if raw.strip() else 0
        except ValueError:
            cap = 0
        if cap > 0 and _EVENTS.maxlen != cap:
            _EVENTS = deque(_EVENTS, maxlen=cap)
        _BUFFER_CONFIGURED = True
    return _EVENTS


def record_event(event: str, **fields) -> dict:
    """Append a structured event to the in-process log (and the
    ``CME213_TRACE_FILE`` JSON-lines sink, when set).  Returns the record.

    Every record carries ``pid``/``rank``/``incarnation``/``trace``
    process tags (explicit fields win, e.g. the launcher reporting on a
    worker's rank).  Sink writes reuse one cached handle and flush per line, so a
    rank hard-killed mid-solve (``os._exit``) loses nothing it recorded.

    A ``_tail=<key>`` kwarg (used by the request-hop spans) diverts the
    record into the per-request tail-sampling buffer instead — it is
    withheld from the buffer and sink until :func:`tail_decide` keeps or
    drops the request, and never appears as a record field.
    """
    tail_key = fields.pop("_tail", None)
    rec = {"event": event, "t": round(time.time(), 6),
           **_proc_tags(), **fields}
    if tail_key is not None:
        _tail_defer(str(tail_key), rec)
        return rec
    with _LOCK:
        _buffer().append(rec)
        f = _sink_file()
        if f is not None:
            try:
                f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
            except OSError:
                pass  # a broken sink must never take down the workload
    return rec


def events(event: str | None = None) -> list[dict]:
    """Snapshot of recorded events, optionally filtered by event name."""
    with _LOCK:
        snap = list(_EVENTS)
    if event is None:
        return snap
    return [e for e in snap if e["event"] == event]


def clear_events() -> None:
    """Drop recorded events (and the retrace detector's compile counts
    and pending tail buffers) and re-read the ring-buffer cap env.  The
    program cache (``core/programs.py``) resets with the compile counts:
    the two move together, so "the first call builds, later calls hit"
    stays an invariant a fresh telemetry slate can rely on."""
    global _EVENTS, _BUFFER_CONFIGURED
    with _LOCK:
        _EVENTS = deque()
        _BUFFER_CONFIGURED = False
        _COMPILE_COUNTS.clear()
        _TAIL_BUFFERS.clear()
    from . import programs

    programs.reset()


# ------------------------------------------------- tail-based sampling

#: per-request deferred hop-span records, keyed by a process-unique
#: request key; flushed (kept) or discarded (dropped) by ``tail_decide``
_TAIL_BUFFERS: dict[str, list] = {}
_TAIL_ATEXIT_INSTALLED = False


def tail_enabled() -> bool:
    """Whether tail-based sampling is on (``CME213_TRACE_TAIL`` truthy)."""
    raw = os.environ.get(TRACE_TAIL_ENV, "")
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


def head_keep(key) -> bool:
    """Deterministic head-sampling decision for a request: a stable
    ``CME213_TRACE_HEAD_RATE`` fraction of keys (hashed with the trace
    id, so reruns under one trace are reproducible) bypasses the tail
    buffer and is always written."""
    raw = os.environ.get(TRACE_HEAD_RATE_ENV, "")
    try:
        rate = float(raw) if raw.strip() else 0.0
    except ValueError:
        rate = 0.0
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = zlib.crc32(f"{trace_id()}:{key}".encode()) / 0xFFFFFFFF
    return h < rate


def tail_slow_threshold_ms() -> float | None:
    """The explicit "slow" latency keep-threshold, or None when unset."""
    raw = os.environ.get(TRACE_TAIL_SLOW_MS_ENV, "")
    if not raw.strip():
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def tail_keep_reason(status=None, latency_ms=None, requeues=0,
                     drift=False) -> str | None:
    """The tail keep-decision shared by every layer: the reason a
    request's buffered hops must be kept (``shed``/``failed``/
    ``requeued``/``drift``/``slow``), or None for the happy-path drop."""
    if status in ("shed", "failed"):
        return str(status)
    if requeues:
        return "requeued"
    if drift:
        return "drift"
    thresh = tail_slow_threshold_ms()
    if (thresh is not None and latency_ms is not None
            and float(latency_ms) > thresh):
        return "slow"
    return None


def _tail_defer(key: str, rec: dict) -> None:
    """Park ``rec`` in the per-request buffer until ``tail_decide``."""
    global _TAIL_ATEXIT_INSTALLED
    with _LOCK:
        _TAIL_BUFFERS.setdefault(key, []).append(rec)
        if not _TAIL_ATEXIT_INSTALLED:
            atexit.register(_tail_flush_all)
            _TAIL_ATEXIT_INSTALLED = True
    from . import metrics

    metrics.counter("trace.sampling.buffered").inc()


def tail_pending() -> int:
    """Number of requests with undecided buffered hops (test hook)."""
    with _LOCK:
        return len(_TAIL_BUFFERS)


def tail_decide(key, keep: bool, reason: str = "ok") -> int:
    """Resolve one request's buffered hop spans: flush them to the event
    buffer/sink in recorded order (``keep``) or discard them.  Returns
    the number of buffered records resolved (0 for an unknown/undecided
    key — the decision is idempotent).  Feeds the ``trace.sampling.*``
    counters that prove the drop rate."""
    if key is None:
        return 0
    with _LOCK:
        recs = _TAIL_BUFFERS.pop(str(key), None)
    if recs is None:
        return 0
    from . import metrics

    if keep:
        metrics.counter("trace.sampling.kept").inc()
        metrics.counter(f"trace.sampling.kept.{reason}").inc()
        with _LOCK:
            buf = _buffer()
            f = _sink_file()
            for rec in recs:
                buf.append(rec)
                if f is not None:
                    try:
                        f.write(json.dumps(rec, default=str) + "\n")
                    except OSError:
                        pass
            if f is not None:
                try:
                    f.flush()
                except OSError:
                    pass
    else:
        metrics.counter("trace.sampling.dropped").inc()
    return len(recs)


def _tail_flush_all() -> None:
    """Atexit safety net: a process dying with undecided requests keeps
    them — losing the happy path is cheap, losing a crash is not."""
    with _LOCK:
        keys = list(_TAIL_BUFFERS)
    for k in keys:
        tail_decide(k, keep=True, reason="exit")


# ------------------------------------------------------------------ spans

_SPAN_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "cme213_span_stack", default=())
_SPAN_COUNTER = itertools.count(1)
_SPAN_PREFIX: str | None = None


def _span_prefix() -> str:
    """The per-process span-id prefix.  A bare pid collides across
    incarnations sharing one fleet trace (pid reuse after a relaunch) —
    widen it with the incarnation and a random per-process nonce, minted
    once so ids stay stable within a process."""
    global _SPAN_PREFIX
    if _SPAN_PREFIX is None:
        inc = int(os.environ.get("CME213_INCARNATION", "0") or 0)
        _SPAN_PREFIX = (f"{os.getpid():x}-{inc}-"
                        f"{os.urandom(3).hex()}")
    return _SPAN_PREFIX


def _mint_span_id() -> str:
    return f"{_span_prefix()}.{next(_SPAN_COUNTER)}"


class SpanHandle:
    """Yielded by ``span``: ``.block(*tensors)`` registers tensors whose
    CUDA devices are synchronised before the span's clock stops, so
    asynchronous device work is attributed to the span that launched it
    (``cudaEventSynchronize`` before ``stop_timer``).  ``.roofline(nbytes,
    flops)`` declares the op's cost-model traffic so the ``span-end``
    record carries ``achieved_gbs``/``pct_peak``/``bound`` computed from
    the measured duration (``core/roofline.py``)."""

    __slots__ = ("_blocked", "_roofline")

    def __init__(self) -> None:
        self._blocked: list = []
        self._roofline: tuple | None = None

    def block(self, *tensors) -> None:
        for t in tensors:
            self._blocked.append(t)

    def roofline(self, nbytes: float, flops: float = 0.0) -> None:
        """Declare this span's useful traffic (bytes moved, flops) so its
        end record gains roofline attribution once the duration is known."""
        self._roofline = (float(nbytes), float(flops))


def current_span_id() -> str | None:
    """Id of the innermost open span in this context (None outside any)."""
    stack = _SPAN_STACK.get()
    return stack[-1] if stack else None


class OpenSpan:
    """A manually-closed span for request hops that begin and end on
    different threads (submit on the caller, completion on a receiver
    loop) — no contextvar stack, the parent is wired explicitly.
    ``end`` is idempotent and returns the duration; hop durations feed
    both ``span.<name>.ms`` and, for ``serve.hop.*`` spans, the
    ``serve.hop.<hop>.ms`` histograms."""

    __slots__ = ("name", "id", "parent", "tail_key", "_tags", "_start",
                 "_done")

    def __init__(self, name: str, sid: str, parent: str | None,
                 tail_key: str | None, tags: dict) -> None:
        self.name = name
        self.id = sid
        self.parent = parent
        self.tail_key = tail_key
        self._tags = tags
        self._start = time.perf_counter()
        self._done = False

    def end(self, **extra) -> float | None:
        if self._done:
            return None
        self._done = True
        ms = round((time.perf_counter() - self._start) * 1e3, 3)
        record_event("span-end", span=self.name, id=self.id,
                     parent=self.parent, ms=ms, _tail=self.tail_key,
                     **{**self._tags, **extra})
        from . import metrics

        metrics.histogram(f"span.{self.name}.ms").observe(ms)
        if self.name.startswith("serve.hop."):
            metrics.histogram(f"{self.name}.ms").observe(ms)
        return ms


def begin_span(name: str, parent: str | None = None, tail_key=None,
               head_key=None, **tags) -> OpenSpan:
    """Open a cross-thread request-hop span (see :class:`OpenSpan`).

    ``parent`` overrides the contextvar/inherited default — this is how
    a hop parents under a span id carried over the wire.  When tail
    sampling is on and ``tail_key`` is given (a process-unique request
    key), the begin/end records are deferred under that key until
    :func:`tail_decide`; ``head_key`` (default ``tail_key``) is the
    stable identity hashed for the deterministic head-sampling bypass.
    ``tags`` ride on both records.
    """
    sid = _mint_span_id()
    if parent is None:
        stack = _SPAN_STACK.get()
        parent = stack[-1] if stack else inherited_parent_id()
    key = None
    if tail_key is not None and tail_enabled():
        hk = head_key if head_key is not None else tail_key
        if not head_keep(hk):
            key = str(tail_key)
    record_event("span-begin", span=name, id=sid, parent=parent,
                 _tail=key, **tags)
    return OpenSpan(name, sid, parent, key, tags)


# --------------------------------------------------- clock alignment

class ClockSync:
    """Per-peer wall-clock offset estimator from ping round trips.

    Each sample is the classic midpoint-of-RTT estimate: with local send
    /receive times ``t0``/``t1`` and the peer's reply timestamp ``tr``,
    ``offset = tr - (t0 + t1)/2`` with uncertainty ``rtt/2`` (the true
    offset always lies within ±rtt/2 of the estimate, whatever the
    path asymmetry).  Samples are EWMA-smoothed with one ``alpha`` for
    both the offset and its error bound, which preserves the invariant
    ``|offset_ms - true| <= err_ms`` by convexity.  Pure arithmetic over
    caller-supplied timestamps, so tests drive it from a
    ``VirtualClock``."""

    __slots__ = ("alpha", "offset_ms", "err_ms", "rtt_ms", "samples")

    def __init__(self, alpha: float = 0.4) -> None:
        self.alpha = float(alpha)
        self.offset_ms = 0.0
        self.err_ms = float("inf")
        self.rtt_ms = 0.0
        self.samples = 0

    def update(self, t_send_s: float, t_remote_s: float,
               t_recv_s: float) -> tuple[float, float]:
        """Fold one ping exchange (all seconds; local send/recv on one
        clock, remote timestamp on the peer's).  Returns the smoothed
        ``(offset_ms, err_ms)``."""
        rtt_ms = max(0.0, (t_recv_s - t_send_s) * 1e3)
        off_ms = (t_remote_s - (t_send_s + t_recv_s) / 2.0) * 1e3
        err_ms = rtt_ms / 2.0
        if self.samples == 0:
            self.offset_ms, self.err_ms, self.rtt_ms = off_ms, err_ms, rtt_ms
        else:
            a = self.alpha
            self.offset_ms += a * (off_ms - self.offset_ms)
            self.err_ms += a * (err_ms - self.err_ms)
            self.rtt_ms += a * (rtt_ms - self.rtt_ms)
        self.samples += 1
        return self.offset_ms, self.err_ms


def _profiler_range(name: str):
    """``record_function(name)``, entered, while a ``torch.profiler``
    session records on this process; ``None`` otherwise (and always when
    torch is not loaded: no session can be running then)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


@contextmanager
def host_range(name: str):
    """The profiler mirror alone: ``name`` as a ``record_function`` host
    range over the enclosed block while a ``torch.profiler`` session
    records, nothing otherwise.  No JSON record, no metrics histogram:
    readers of the profiler's trace see it nested among the spans'
    ranges; ``trace summary`` never sees it."""
    mirror = _profiler_range(name)
    try:
        yield
    finally:
        if mirror is not None:
            mirror.__exit__(None, None, None)


@contextmanager
def span(name: str, **tags):
    """Trace the enclosed block as a ``span-begin``/``span-end`` pair.

    Ids are unique across a gang and across relaunches
    (``<pid hex>-<incarnation>-<nonce>.<counter>``); the parent
    link comes from a contextvar stack, so nesting — including across
    threads started inside a span — produces a causal tree ``trace
    summary`` can aggregate.  ``tags`` ride on both records (kernel rung,
    epoch number, ...).  The span-end carries the monotonic duration
    ``ms`` (after synchronising on any ``.block()``-registered tensors) and an
    ``error`` tag when the block raised; the duration also feeds the
    ``span.<name>.ms`` metrics histogram.  While a profiler session
    records, the same extent is a ``record_function`` range of ``name``
    (the module's profiler mirror).
    """
    sid = _mint_span_id()
    stack = _SPAN_STACK.get()
    # a root span in a launched child parents under the spawning
    # process's open span (CME213_TRACE_CONTEXT), so a merged multi-rank
    # trace is one causal tree
    parent = stack[-1] if stack else inherited_parent_id()
    record_event("span-begin", span=name, id=sid, parent=parent, **tags)
    token = _SPAN_STACK.set(stack + (sid,))
    handle = SpanHandle()
    err: str | None = None
    mirror = _profiler_range(name)
    start = time.perf_counter()
    try:
        yield handle
        if handle._blocked:
            synchronize(handle._blocked)
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        ms = round((time.perf_counter() - start) * 1e3, 3)
        if mirror is not None:
            mirror.__exit__(None, None, None)
        _SPAN_STACK.reset(token)
        end = dict(span=name, id=sid, parent=parent, ms=ms, **tags)
        if err is not None:
            end["error"] = err
        if handle._roofline is not None and err is None and ms > 0:
            try:
                from . import roofline

                nbytes, flops = handle._roofline
                gbs = nbytes / 1e9 / (ms / 1e3)
                att = roofline.attribute(gbs, flops / 1e9 / (ms / 1e3))
                end["achieved_gbs"] = round(gbs, 3)
                if att["pct_peak"] is not None:
                    end["pct_peak"] = att["pct_peak"]
                    end["bound"] = att["bound"]
            except Exception:  # noqa: BLE001 — attribution never kills work
                pass
        record_event("span-end", **end)
        from . import metrics

        metrics.histogram(f"span.{name}.ms").observe(ms)
        if err is None:
            _note_compile_run(name, tags.get("shape_class"), ms,
                              tags.get("kernel"))


# --------------------------------------------------- compile/run split

#: (op, shape_class, kernel) -> completed ``<op>.compile`` span count —
#: the retrace detector's state (ROADMAP item 5: heterogeneous traffic
#: must not re-trace known shape classes).  The kernel rung is part of
#: the key: a fallback ladder (or conformance gate) compiling a SECOND
#: rung for a class it already serves builds a fresh program, not a
#: retrace.  Reset by ``clear_events``.
_COMPILE_COUNTS: dict[tuple, int] = {}


def compile_counts() -> dict[tuple, int]:
    """Snapshot of per-(op, shape_class, kernel) compile counts this
    process (``kernel`` is ``None`` for spans without a kernel tag)."""
    with _LOCK:
        return dict(_COMPILE_COUNTS)


def _note_compile_run(name: str, shape_class, ms: float,
                      kernel=None) -> None:
    """Feed per-(op, shape-class) ``compile.ms``/``run.ms`` histograms
    from ``<op>.compile``/``<op>.run`` spans, and fire the retrace
    detector: a (shape class, kernel) whose compile span completes more
    than once in a process re-entered the trace/compile path — the
    retracing cost the program cache (``core/programs.py``) exists to
    kill — so it emits a ``compile-retrace`` event and bumps the
    ``compile.retraces`` counter.  Errored spans are excluded upstream
    (a rung that failed to compile is a demotion, not a retrace)."""
    if shape_class is None:
        return
    from . import metrics

    if name.endswith(".compile"):
        op = name[: -len(".compile")]
        metrics.histogram(f"compile.{op}.{shape_class}.ms").observe(ms)
        with _LOCK:
            n = _COMPILE_COUNTS[(op, shape_class, kernel)] = (
                _COMPILE_COUNTS.get((op, shape_class, kernel), 0) + 1)
        if n > 1:
            metrics.counter("compile.retraces").inc()
            record_event("compile-retrace", op=op,
                         shape_class=shape_class, kernel=kernel, count=n)
    elif name.endswith(".run"):
        op = name[: -len(".run")]
        metrics.histogram(f"run.{op}.{shape_class}.ms").observe(ms)


def synchronize(tensors) -> None:
    """Wait for the CUDA devices that hold ``tensors`` (each device once);
    CPU tensors and other values need no wait."""
    import torch

    seen = set()
    for t in tensors:
        if torch.is_tensor(t) and t.is_cuda and t.device not in seen:
            seen.add(t.device)
            torch.cuda.synchronize(t.device)


@contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU and, where
    there is a card, CUDA activity) and write a Chrome trace into
    ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
