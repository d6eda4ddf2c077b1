"""Request/result types for the serving front end.

Counterpart of ``cme213_tpu/serve/request.py``, the same types, kept as
the port's own copy (the port imports nothing of the JAX package).

A request names a workload op (``spmv_scan`` / ``heat`` / ``cipher``),
carries an op-specific payload, and optionally a relative deadline.  A
result is either served (``ok``), refused with a structured reason
(``shed`` — the 429 analog: the caller can retry, back off, or route
elsewhere, instead of hanging on unbounded latency), or failed (every
rung of the op's ladder raised).  Shed reasons:

- ``queue-full``  — bounded-queue backpressure: the queue was at
  capacity when the request arrived;
- ``deadline``    — the request could not *start* before its deadline
  (rejected before execution — never executed late and discarded);
- ``admission``   — even a single-request program for this shape class
  exceeds the memory budget (``core/admission.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: result statuses
OK = "ok"
SHED = "shed"
FAILED = "failed"

#: shed reasons (the ``serve.shed.<reason>`` counter suffixes)
QUEUE_FULL = "queue-full"
DEADLINE = "deadline"
ADMISSION = "admission"


#: lifecycle phase names, in stamp order (the ``timing`` dict keys are
#: ``<phase>_ms`` plus ``total_ms``)
PHASES = ("queue", "admit", "batch_wait", "run")


@dataclass
class SolveRequest:
    rid: int                      # server-assigned, unique per server
    op: str                       # workload adapter name
    payload: object               # op-specific problem description
    submitted_s: float            # server-clock time of acceptance
    deadline_s: float | None = None   # absolute server-clock deadline
    tenant: str = "default"       # billing/attribution principal
    # lifecycle phase stamps, all on the server clock (monotonic within a
    # request by construction: stamped in submit/step/execute order)
    dequeued_s: float | None = None   # pulled into a candidate batch
    admitted_s: float | None = None   # cleared the admission preflight
    executed_s: float | None = None   # handed to the kernel ladder
    completed_s: float | None = None  # ladder returned
    # process-spanning trace id (core/trace): stamped at submit, carried
    # through queue -> batch -> execution -> result, so one id follows
    # the request across the loadgen/server process boundary
    trace_id: str | None = None
    # wire-carried span context: the upstream hop span id (client root
    # or front-tier route hop) this request's replica-side hops parent
    # under, so the merged trace renders as one cross-process tree
    parent_span_id: str | None = None
    # open request-hop spans (core.trace.OpenSpan), server-managed:
    # ``hop`` covers submit -> completion, ``run_hop`` execute ->
    # completion; both end with the result (or the shed/fail path)
    hop: object = None
    run_hop: object = None

    def timing(self) -> dict:
        """Phase breakdown in ms (``queue``/``admit``/``batch_wait``/
        ``run`` + ``total``); phases not reached are None.  Sums of the
        reached phases equal ``total_ms`` up to rounding — every stamp
        comes from the same clock."""
        def ms(a, b):
            return None if (a is None or b is None) else round((b - a) * 1e3, 3)
        return {
            "queue_ms": ms(self.submitted_s, self.dequeued_s),
            "admit_ms": ms(self.dequeued_s, self.admitted_s),
            "batch_wait_ms": ms(self.admitted_s, self.executed_s),
            "run_ms": ms(self.executed_s, self.completed_s),
            "total_ms": ms(self.submitted_s, self.completed_s),
        }


@dataclass
class SolveResult:
    rid: int
    op: str
    status: str                   # OK | SHED | FAILED
    reason: str | None = None     # shed reason / failure summary
    value: object = None          # op-specific result (OK only)
    rung: str | None = None       # kernel rung that served (OK only)
    shape_class: str | None = None
    latency_ms: float | None = None   # submit -> completion (server clock)
    batch_size: int | None = None     # lanes in the serving program
    degraded: bool = False            # served under degraded mode
    tenant: str = "default"           # principal the request ran under
    timing: dict | None = None        # phase breakdown (SolveRequest.timing)
    trace_id: str | None = None       # trace the request belonged to

    @property
    def ok(self) -> bool:
        return self.status == OK


@dataclass
class RequestSpec:
    """A loadgen-side request description: what to submit, before the
    server assigns it an id."""

    op: str
    payload: object
    deadline_ms: float | None = None
    tags: dict = field(default_factory=dict)
    tenant: str = "default"
