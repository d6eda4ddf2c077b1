"""The serving core: bounded queue, shape-class batcher, deadline-aware
scheduler — built to stay up and degrade predictably when traffic
exceeds capacity.

Counterpart of ``cme213_tpu/serve/server.py``, with one addition: the
server owns a ``device`` (``cuda`` unless the caller asks for the CPU;
with no card the constructor raises ``FrameworkError``) and hands it to
every adapter call, so the batches run on the card and their results come
back to the host as numpy, copied once a batch.

Control flow is synchronous and deterministic (the property every test
leans on): ``submit`` either enqueues and returns a
request id, or refuses immediately with a structured shed result;
``step`` forms ONE batch from the queue head's (op, shape-class) bucket
and executes it through the resilience stack.  Every robustness decision
is observable:

- **backpressure**: the queue is bounded; an arrival past capacity is
  shed with a ``queue-shed`` event + ``serve.shed.queue-full`` counter
  and a 429-style result — bounded queueing delay for everyone admitted,
  an honest refusal for everyone else.
- **deadlines**: a request that cannot *start* before its deadline is
  rejected before execution (``deadline-shed`` + ``serve.shed.deadline``)
  — device minutes are never spent on an answer nobody is waiting for.
  Deadlines bound queue wait, not execution: a batch that *starts* in
  time serves even if it finishes past the mark (latency says so).
- **circuit breaking**: rung failures feed a per-(op, rung)
  ``core.resilience.CircuitBreaker``; an open circuit routes requests to
  the fallback rung without burning a failure per request, and a
  half-open probe restores the rung when it heals.
- **graceful degradation**: when the SLO monitor burns (``serve/slo.py``
  — the primary trigger when one is attached) or queue depth / latency
  p99 crosses its threshold (the backstops), the scheduler switches to
  the degraded rung ladder and coarser (power-of-two-padded) shape
  buckets, and wraps batch execution in a ``degraded-mode`` span — the
  trade shows up in ``trace summary``, not just in the latency
  distribution.  Exit has hysteresis (half the entry depth; the SLO
  monitor's own recovery hysteresis) so the mode doesn't flap.
- **request-lifecycle tracing**: every request is phase-stamped on the
  server clock (submit → dequeue → admit → execute → complete); results
  carry the ``timing`` breakdown, a ``request-served`` event links each
  rid to the ``serve.batch`` span that executed it, and the phases feed
  ``serve.request.<phase>_ms`` histograms plus per-tenant
  ``serve.tenant.<t>.*`` counters.
- **admission**: with a memory budget set (``CME213_MEMORY_BUDGET``),
  batch sizes are preflighted (``core.admission.admit_batch``, over each
  adapter's count of a batch's device bytes) and shrink before dispatch;
  overflow requests stay queued, and a shape
  class whose single-request program cannot fit is shed with reason
  ``admission``.

All timing runs on an injectable ``core.resilience.Clock``; with a
``VirtualClock`` the entire deadline/breaker/straggler machinery is
testable without a single wall-clock sleep (``slow:`` fault clauses
advance the same clock).
"""

from __future__ import annotations

import itertools
from contextlib import nullcontext

from ..core import admission, metrics, numerics
from ..core.errors import FrameworkError
from ..core.faults import maybe_drift, maybe_slow
from ..core.resilience import CircuitBreaker, Clock, with_fallback
from ..core.trace import (begin_span, current_span_id, record_event, span,
                          tail_decide, tail_keep_reason,
                          trace_id as current_trace_id)
from .request import (
    ADMISSION,
    DEADLINE,
    FAILED,
    OK,
    QUEUE_FULL,
    SHED,
    SolveRequest,
    SolveResult,
)
from .workloads import ADAPTERS, serving_device


def tuned_batch_cap(op: str, shape_class: str, default: int,
                    device=None) -> int:
    """Batch width for one (op, shape-class) bucket on ``device``: the
    measured winner from the tuning cache (``core/tune.py``, op
    ``serve.<op>``) when one is cached, else ``default`` (the server's
    ``max_batch``).  Never *raises* the cap past ``default`` — the
    queue/SLO sizing assumed it."""
    from ..core import tune

    resolved = tune.resolve(f"serve.{op}", shape_class, "float32",
                            device=device, max_batch=default)
    try:
        cap = int(resolved["max_batch"])
    except (KeyError, TypeError, ValueError):
        return default
    return max(1, min(cap, default))


class BoundedQueue:
    """FIFO with a hard capacity: ``push`` refuses (returns False) at
    capacity instead of growing — the arrival being refused is the
    *newest* one, so admitted requests keep their bounded wait."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._items: list[SolveRequest] = []

    def __len__(self) -> int:
        return len(self._items)

    def push(self, req: SolveRequest) -> bool:
        if len(self._items) >= self.capacity:
            return False
        self._items.append(req)
        return True

    def peek(self) -> SolveRequest | None:
        return self._items[0] if self._items else None

    def take(self, reqs: list[SolveRequest]) -> None:
        """Remove the given requests (batch formation / deadline sweep)."""
        drop = {id(r) for r in reqs}
        self._items = [r for r in self._items if id(r) not in drop]

    def items(self) -> list[SolveRequest]:
        return list(self._items)


class Server:
    """The multi-tenant front end; see the module docstring for the
    semantics of each knob."""

    def __init__(self, capacity: int = 64, max_batch: int = 8,
                 clock: Clock | None = None,
                 breaker: CircuitBreaker | None = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 degrade_depth: int | None = None,
                 degrade_p99_ms: float | None = None,
                 adapters: dict | None = None,
                 slo=None, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        #: where every batch runs (``cuda`` unless asked for the CPU)
        self.device = serving_device(device)
        self.clock = clock if clock is not None else Clock()
        self.queue = BoundedQueue(capacity)
        self.max_batch = max_batch
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s,
            clock=self.clock)
        self.degrade_depth = degrade_depth
        self.degrade_p99_ms = degrade_p99_ms
        self.degraded = False
        self._degrade_reason: str | None = None
        self.adapters = adapters if adapters is not None else dict(ADAPTERS)
        self.slo = slo                  # serve.slo.SLOMonitor | None
        self._rids = itertools.count()
        self._admit_cache: dict[tuple, int] = {}
        self._tuned_caps: dict[tuple, int] = {}
        # drive-mode hook: the caller-driven step() loop is the default
        # drive; a transport front end (serve/transport.py) attaches a
        # waker so its background batcher thread wakes on arrival instead
        # of polling.  Called after every successful enqueue.
        self.on_submit = None
        # the long-job lane (serve/jobs.py JobExecutor | None): driven by
        # job_tick() strictly in the gaps between interactive batches
        self.jobs = None

    # ------------------------------------------------------------ submit

    def submit(self, op: str, payload, deadline_ms: float | None = None,
               tenant: str = "default", trace_id: str | None = None,
               parent_span: str | None = None):
        """Accept (returns the request id) or refuse (returns a SHED
        :class:`SolveResult`) — never blocks, never queues unboundedly.

        ``trace_id`` joins the request to an existing cross-process trace
        (a remote caller forwarding its own id); by default the request
        rides this process's trace, so loadgen → queue → batch →
        execution → result share one process-spanning id.  ``parent_span``
        is the wire-carried upstream hop span id: the accepted request's
        ``serve.hop.replica`` span parents under it, so the request's
        replica-side residency joins the caller's waterfall."""
        if op not in self.adapters:
            raise ValueError(f"unknown op {op!r} "
                             f"(serving: {sorted(self.adapters)})")
        tid = trace_id or current_trace_id()
        metrics.counter("serve.requests").inc()
        metrics.counter(f"serve.tenant.{tenant}.requests").inc()
        now = self.clock.now()
        rid = next(self._rids)
        if deadline_ms is not None and deadline_ms <= 0:
            return self._shed_deadline(
                SolveRequest(rid, op, payload, now, now, tenant=tenant,
                             trace_id=tid),
                late_ms=-deadline_ms, now=now)
        req = SolveRequest(
            rid, op, payload, submitted_s=now,
            deadline_s=None if deadline_ms is None else now + deadline_ms / 1e3,
            tenant=tenant, trace_id=tid)
        if not self.queue.push(req):
            metrics.counter(f"serve.shed.{QUEUE_FULL}").inc()
            metrics.counter(f"serve.tenant.{tenant}.shed").inc()
            record_event("queue-shed", op=op, reason=QUEUE_FULL,
                         depth=len(self.queue), age_ms=0.0, tenant=tenant,
                         trace=req.trace_id)
            res = SolveResult(rid, op, SHED, reason=QUEUE_FULL, tenant=tenant,
                              timing=req.timing(), trace_id=req.trace_id)
            self._observe_slo(res)
            return res
        req.parent_span_id = parent_span
        req.hop = begin_span("serve.hop.replica", parent=parent_span,
                             tail_key=f"r{rid}", head_key=rid,
                             rid=rid, op=op, tenant=tenant, trace=tid)
        if self.on_submit is not None:
            self.on_submit()
        return rid

    def _shed_deadline(self, req: SolveRequest, late_ms: float,
                       now: float | None = None) -> SolveResult:
        now = self.clock.now() if now is None else now
        metrics.counter(f"serve.shed.{DEADLINE}").inc()
        metrics.counter(f"serve.tenant.{req.tenant}.shed").inc()
        record_event("deadline-shed", op=req.op, rid=req.rid,
                     late_ms=round(late_ms, 3), depth=len(self.queue),
                     age_ms=round((now - req.submitted_s) * 1e3, 3),
                     tenant=req.tenant, trace=req.trace_id)
        res = SolveResult(req.rid, req.op, SHED, reason=DEADLINE,
                          tenant=req.tenant, timing=req.timing(),
                          trace_id=req.trace_id)
        if req.hop is not None:
            req.hop.end(status=SHED, reason=DEADLINE)
            tail_decide(req.hop.tail_key, keep=True, reason="shed")
        self._observe_slo(res)
        return res

    def _observe_slo(self, result: SolveResult) -> None:
        if self.slo is not None:
            self.slo.observe_result(result)

    # -------------------------------------------------------------- step

    def step(self) -> list[SolveResult]:
        """Sweep expired deadlines, then form and execute ONE batch from
        the queue head's (op, shape-class) bucket.  Returns every result
        produced this step (shed and served)."""
        results: list[SolveResult] = []
        now = self.clock.now()

        expired = [r for r in self.queue.items()
                   if r.deadline_s is not None and now >= r.deadline_s]
        if expired:
            self.queue.take(expired)
            results.extend(
                self._shed_deadline(r, late_ms=(now - r.deadline_s) * 1e3,
                                    now=now)
                for r in expired)

        self._update_degraded()
        head = self.queue.peek()
        if head is None:
            return results

        adapter = self.adapters[head.op]
        coarse = self.degraded
        key = adapter.shape_class(head.payload, coarse=coarse)
        batch = [r for r in self.queue.items()
                 if r.op == head.op
                 and adapter.shape_class(r.payload, coarse=coarse) == key]
        cap = self._tuned_caps.get((head.op, key))
        if cap is None:
            cap = tuned_batch_cap(head.op, key, self.max_batch,
                                  device=self.device)
            self._tuned_caps[(head.op, key)] = cap
        batch = batch[:cap]

        dequeued = self.clock.now()
        for r in batch:
            r.dequeued_s = dequeued
        batch, admission_shed = self._admit(adapter, key, batch, coarse)
        results.extend(admission_shed)
        if not batch:
            return results
        admitted = self.clock.now()
        for r in batch:
            r.admitted_s = admitted
        self.queue.take(batch)
        results.extend(self._execute(adapter, key, batch, coarse))
        return results

    def drain(self) -> list[SolveResult]:
        """Step until the queue is empty."""
        results: list[SolveResult] = []
        while len(self.queue):
            results.extend(self.step())
        return results

    def job_tick(self) -> bool:
        """Run at most one long-job epoch through the attached executor
        (``serve/jobs.py``).  Interactive traffic strictly wins: the
        executor re-checks queue depth and SLO burn before every epoch
        and preempts at the boundary, so the caller may tick whenever a
        ``step()`` left the queue empty.  Returns True when durable job
        progress was made (more work may remain)."""
        if self.jobs is None:
            return False
        return self.jobs.tick()

    # ---------------------------------------------------------- internals

    def _admit(self, adapter, key: str, batch, coarse):
        """Memory-budget preflight: shrink the batch to the admitted
        size (overflow stays queued), or shed the whole bucket when even
        one request cannot fit."""
        if not batch or admission.memory_budget(self.device) is None:
            return batch, []
        rung = adapter.rungs(self.degraded)[0]
        builder = adapter.preflight_builder(
            [r.payload for r in batch], rung, coarse=coarse,
            device=self.device)
        if builder is None:
            return batch, []
        cache_key = (adapter.op, key, rung, len(batch))
        admitted = self._admit_cache.get(cache_key)
        if admitted is None:
            try:
                admitted = admission.admit_batch(
                    f"serve.{adapter.op}", len(batch), builder)
            except admission.AdmissionError:
                self.queue.take(batch)
                now = self.clock.now()
                shed = []
                for r in batch:
                    metrics.counter(f"serve.shed.{ADMISSION}").inc()
                    metrics.counter(f"serve.tenant.{r.tenant}.shed").inc()
                    record_event("queue-shed", op=r.op, reason=ADMISSION,
                                 depth=len(self.queue),
                                 age_ms=round((now - r.submitted_s) * 1e3, 3),
                                 tenant=r.tenant, trace=r.trace_id)
                    res = SolveResult(r.rid, r.op, SHED, reason=ADMISSION,
                                      tenant=r.tenant, timing=r.timing(),
                                      trace_id=r.trace_id)
                    if r.hop is not None:
                        r.hop.end(status=SHED, reason=ADMISSION)
                        tail_decide(r.hop.tail_key, keep=True, reason="shed")
                    self._observe_slo(res)
                    shed.append(res)
                return [], shed
            self._admit_cache[cache_key] = admitted
        return batch[:admitted], []

    def _execute(self, adapter, key: str, batch, coarse) -> list[SolveResult]:
        op = adapter.op
        payloads = [r.payload for r in batch]
        rungs = adapter.rungs(self.degraded)
        # ``drift:serve.<op>.<rung>`` clauses perturb the served outputs
        # *inside* the ladder, so the shadow sampler's reference
        # re-execution (a direct run_batch below) stays clean — exactly
        # the silent-divergence topology shadow sampling exists to catch
        ladder = [(rung,
                   (lambda rg: lambda: maybe_drift(
                       f"serve.{op}.{rg}", adapter.run_batch(
                           payloads, rg, coarse=coarse,
                           device=self.device)))(rung))
                  for rung in rungs]
        ctx = (span("degraded-mode", op=op,
                    reason=self._degrade_reason or "pressure")
               if self.degraded else nullcontext())
        # the run phase starts here: injected straggler latency rides the
        # server clock, so it shows up in run_ms, latencies, and
        # subsequent deadline decisions exactly like a real slow device
        executed = self.clock.now()
        for r in batch:
            r.executed_s = executed
            if r.hop is not None:
                r.run_hop = begin_span("serve.hop.run", parent=r.hop.id,
                                       tail_key=r.hop.tail_key,
                                       head_key=r.rid, rid=r.rid, op=op,
                                       trace=r.trace_id)
        try:
            # the adapters copy each batch's results to the host before
            # they return, so the span's ms is the batch's device time
            with ctx, span("serve.batch", op=op, shape_class=key,
                           size=len(batch)):
                batch_span = current_span_id()
                maybe_slow(f"serve.{op}", sleep=self.clock.sleep)
                # the gate is the drift budget's demotion hook: a rung
                # whose shadow-sample budget burned is routed around with
                # FailureKind.WRONG_ANSWER, exactly like a failed
                # conformance probe (core/numerics.py)
                res = with_fallback(
                    f"serve.{op}", ladder, breaker=self.breaker,
                    gate=lambda rg: not numerics.demoted(f"serve.{op}", rg))
        except FrameworkError as e:
            end = self.clock.now()
            metrics.counter("serve.failed").inc(len(batch))
            out = []
            for r in batch:
                r.completed_s = end
                metrics.counter(f"serve.tenant.{r.tenant}.failed").inc()
                timing = r.timing()
                record_event("request-served", rid=r.rid, op=op,
                             tenant=r.tenant, batch=batch_span,
                             status=FAILED, total_ms=timing["total_ms"],
                             trace=r.trace_id,
                             **{k: v for k, v in timing.items()
                                if k != "total_ms"})
                res_f = SolveResult(
                    r.rid, op, FAILED, reason=str(e)[:200], shape_class=key,
                    batch_size=len(batch), degraded=self.degraded,
                    tenant=r.tenant, timing=timing, trace_id=r.trace_id)
                if r.run_hop is not None:
                    r.run_hop.end(error="FrameworkError")
                if r.hop is not None:
                    r.hop.end(status=FAILED)
                    tail_decide(r.hop.tail_key, keep=True, reason="failed")
                self._observe_slo(res_f)
                out.append(res_f)
            return out
        end = self.clock.now()
        occupancy = len(batch) / self.max_batch
        metrics.counter("serve.batches").inc()
        metrics.histogram("serve.batch.size").observe(len(batch))
        record_event("batch-executed", op=op, shape_class=key,
                     size=len(batch), occupancy=round(occupancy, 4))
        # output sentinel: one vectorized non-finite reduction over the
        # served batch; a trip is recorded and fed to the breaker as
        # FailureKind.NUMERIC but the batch still serves (observability,
        # not a result change — the breaker decides about the *next* one)
        lo, hi = getattr(adapter, "sentinel_range", (None, None))
        numerics.sentinel(f"serve.{op}", res.rung, res.value, lo=lo, hi=hi,
                          breaker=self.breaker)
        out = []
        for r, value in zip(batch, res.value):
            r.completed_s = end
            latency_ms = (end - r.submitted_s) * 1e3
            metrics.histogram("serve.latency.ms").observe(latency_ms)
            metrics.histogram(f"serve.latency.{op}.ms").observe(latency_ms)
            metrics.counter(f"serve.tenant.{r.tenant}.served").inc()
            timing = r.timing()
            for phase in ("queue", "admit", "batch_wait", "run", "total"):
                v = timing[f"{phase}_ms"]
                if v is not None:
                    metrics.histogram(f"serve.request.{phase}_ms").observe(v)
            record_event("request-served", rid=r.rid, op=op, tenant=r.tenant,
                         batch=batch_span, status=OK,
                         total_ms=timing["total_ms"], trace=r.trace_id,
                         **{k: v for k, v in timing.items()
                            if k != "total_ms"})
            res_ok = SolveResult(
                r.rid, op, OK, value=value, rung=res.rung, shape_class=key,
                latency_ms=latency_ms, batch_size=len(batch),
                degraded=self.degraded, tenant=r.tenant, timing=timing,
                trace_id=r.trace_id)
            if r.run_hop is not None:
                r.run_hop.end(rung=res.rung)
            if r.hop is not None:
                r.hop.end(status=OK)
            self._observe_slo(res_ok)
            out.append(res_ok)
        # shadow conformance sampling runs LAST: every latency above was
        # already stamped on the clock, so the reference re-execution is
        # off the measured hot path by construction
        drifted = self._shadow(adapter, key, batch, payloads, res, coarse)
        # tail keep-decision at response time, after the drift verdict:
        # slow/drift-flagged requests keep their buffered hops, the
        # happy path drops them
        for r, res_r in zip(batch, out):
            if r.hop is not None and r.hop.tail_key is not None:
                reason = tail_keep_reason(status=res_r.status,
                                          latency_ms=res_r.latency_ms,
                                          drift=r.rid in drifted)
                tail_decide(r.hop.tail_key, keep=reason is not None,
                            reason=reason or "ok")
        metrics.write_exposition()   # no-op unless CME213_METRICS_FILE set
        return out

    def _shadow(self, adapter, key: str, batch, payloads, res,
                coarse) -> set:
        """Re-execute a deterministic 1-in-N sample of this batch's
        requests on the reference rung and fold the measured drift into
        the numeric-health observatory (``core/numerics.py``).  Never
        raises into the serving path; skipped entirely when the serving
        rung *is* the reference (drift against itself is zero).  Returns
        the sampled rids when the comparison went over budget (the
        drift-flagged keep rule for tail sampling), else an empty set."""
        rate = numerics.shadow_rate()
        if not rate:
            return set()
        op = adapter.op
        ref_rung = adapter.rungs(False)[-1]
        if res.rung == ref_rung:
            return set()
        picked = [i for i, r in enumerate(batch)
                  if numerics.should_sample(str(r.rid), rate=rate,
                                            trace=r.trace_id)]
        if not picked:
            return set()
        try:
            with span("serve.shadow", op=op, shape_class=key,
                      size=len(picked)):
                refs = adapter.run_batch([payloads[i] for i in picked],
                                         ref_rung, coarse=coarse,
                                         device=self.device)
            summary = numerics.shadow_compare(
                f"serve.{op}", res.rung, key,
                [res.value[i] for i in picked], refs)
        except Exception:  # noqa: BLE001 — the shadow path must never
            # take down serving; a crashed reference re-execution only
            # costs this sample
            metrics.counter("numerics.shadow.errors").inc()
            return set()
        if self.slo is not None:
            self.slo.observe(drift=summary["over_budget"])
        if summary.get("over_budget"):
            return {batch[i].rid for i in picked}
        return set()

    def _update_degraded(self) -> None:
        if self.slo is not None:
            self.slo.evaluate()
        depth = len(self.queue)
        p99 = metrics.histogram("serve.latency.ms").percentile(0.99)
        reason = None
        # objective violation is the primary trigger; raw queue depth and
        # the latency ring are the backstops for servers without an SLO
        if self.slo is not None and self.slo.burning:
            reason = "slo-burn"
        elif self.degrade_depth is not None and depth >= self.degrade_depth:
            reason = "queue-depth"
        elif (self.degrade_p99_ms is not None and p99 is not None
              and p99 >= self.degrade_p99_ms):
            reason = "latency-p99"
        if not self.degraded:
            if reason is not None:
                self.degraded = True
                self._degrade_reason = reason
                metrics.gauge("serve.degraded").set(1)
            return
        # hysteresis: leave only once depth has fallen to half the entry
        # threshold (and p99, if it triggered, has come back under) — the
        # latency ring decays slowly, so depth is the primary exit signal
        depth_ok = (self.degrade_depth is None
                    or depth <= self.degrade_depth // 2)
        p99_ok = (self.degrade_p99_ms is None or p99 is None
                  or p99 < self.degrade_p99_ms
                  or self._degrade_reason != "latency-p99")
        if depth_ok and p99_ok and reason is None:
            self.degraded = False
            self._degrade_reason = None
            metrics.gauge("serve.degraded").set(0)
