"""Front-tier request routing: tenant-fair dispatch, replica health,
SLO-burn autoscaling.

Counterpart of ``cme213_tpu/serve/router.py``, line for line: the same
policy over the port's ``core.metrics``, ``core.resilience`` and
``core.trace``.  It imports no torch (nor sockets), so the policy loads
and is tested without a device.

The router is the policy half of the replicated fleet
(``serve/fleet.py`` is the mechanism half: processes, sockets,
threads).  Everything here is **pure and synchronous** — no threads, no
sockets, all timing on the injectable ``core.resilience.Clock`` — so
the scheduling and scaling decisions are unit-testable exactly like the
batching server's.  The fleet front end serializes access with one
lock and feeds the router events (submissions, completions, transport
failures, replica deaths); the router answers with assignments.

- **Tenant-weighted fair dispatch**: one backlog queue per tenant and a
  deficit-round-robin scan (Shreedhar & Varghese) — each visit grants a
  tenant ``quantum x weight`` credit, a dispatch costs 1.  A noisy
  tenant with a thousand queued requests cannot starve a quiet one: the
  scan interleaves tenants every round, so the quiet tenant's p99 is
  bounded by the fleet's batch time, not the noisy backlog.  This is
  the serving analog of the reference's Torque/qsub queue: submission
  order does not equal dispatch order; the scheduler owns placement.
- **Replica selection**: among replicas that are up, have spare
  dispatch capacity, and whose per-replica circuit breaker
  (``core.resilience.CircuitBreaker``, op ``fleet.route``, rung
  ``r<rank>``) admits traffic, pick the least-loaded.  A replica that
  fails transport repeatedly trips its breaker and is routed around
  until the cooldown's half-open probe readmits it.
- **Zero-loss ledger**: every assignment is tracked in an in-flight
  table until completion.  A dead replica's in-flight tickets are
  requeued at the *front* of their tenant queues (``request-requeued``
  events) — an accepted request is never lost, merely re-dispatched
  (solves are pure, so a double execution is harmless and the first
  response wins).
- **Autoscaling** (:class:`Autoscaler`): consumes the SLO monitor's
  two-window burn signal (``serve/slo.py``).  Sustained burn spawns a
  replica (``scale-up``); sustained health at low occupancy retires one
  (``scale-down``).  Both directions have a sustain window *and* a
  shared action cooldown — hysteresis on the injectable clock, so the
  fleet cannot flap.
"""

from __future__ import annotations

import itertools
from collections import Counter, deque
from dataclasses import dataclass, field

from ..core import metrics
from ..core.resilience import CircuitBreaker, Clock
from ..core.trace import begin_span, record_event

#: breaker identity for replica routing failures
ROUTE_OP = "fleet.route"


def _rung(rank: int) -> str:
    return f"r{rank}"


@dataclass
class Ticket:
    """One accepted front-tier request, from submit to response."""

    seq: int
    op: str
    tenant: str
    doc: dict                      # opaque wire doc, forwarded verbatim
    replica: int | None = None     # current assignment (None = queued)
    attempts: int = 0
    requeues: int = 0
    done: object = None            # threading.Event, set by the fleet
    result: dict | None = None
    # v2 transport extras: binary payload sections ride beside the doc
    # (forwarded to the replica untouched), and a pipelined client's
    # reply handle (connection, wire request id) replaces the Event
    sections: list = field(default_factory=list)
    reply: object = None
    # request-hop spans (core.trace.OpenSpan): ``hop`` covers the whole
    # front-tier residency (parented under the client's wire-carried
    # span), ``dispatch_hop`` one assignment attempt, ``wait_hop`` a
    # requeue detour; ``hop_ms`` collects closed-hop durations for the
    # response's waterfall breakdown
    hop: object = None
    dispatch_hop: object = None
    wait_hop: object = None
    hop_ms: dict = field(default_factory=dict)


@dataclass
class ReplicaState:
    rank: int
    capacity: int
    incarnation: int = 0
    up: bool = False
    retiring: bool = False
    inflight: int = 0
    routed: int = 0


@dataclass
class Autoscaler:
    """SLO-burn-driven fleet sizing with hysteresis; see module doc."""

    clock: Clock = field(default_factory=Clock)
    min_replicas: int = 1
    max_replicas: int = 4
    burn_sustain_s: float = 3.0    # burn must persist this long to grow
    ok_sustain_s: float = 6.0      # health+idle must persist to shrink
    low_occupancy: float = 0.5     # shrink only below this utilization
    cooldown_s: float = 10.0       # min spacing between actions

    _burn_since: float | None = field(default=None, repr=False)
    _ok_since: float | None = field(default=None, repr=False)
    _last_action: float | None = field(default=None, repr=False)

    def _cooled(self, now: float) -> bool:
        return (self._last_action is None
                or now - self._last_action >= self.cooldown_s)

    def evaluate(self, burning: bool, occupancy: float,
                 replicas: int) -> str | None:
        """One policy tick: ``"up"``, ``"down"``, or None.  Emits the
        ``scale-up`` / ``scale-down`` event at decision time; the fleet
        acts on the return value."""
        now = self.clock.now()
        if burning:
            self._ok_since = None
            if self._burn_since is None:
                self._burn_since = now
            if (now - self._burn_since >= self.burn_sustain_s
                    and self._cooled(now)
                    and replicas < self.max_replicas):
                self._burn_since = None
                self._last_action = now
                metrics.counter("fleet.scale_up").inc()
                record_event("scale-up", replicas=replicas + 1,
                             reason="slo-burn")
                return "up"
            return None
        self._burn_since = None
        if occupancy > self.low_occupancy:
            self._ok_since = None
            return None
        if self._ok_since is None:
            self._ok_since = now
        if (now - self._ok_since >= self.ok_sustain_s
                and self._cooled(now)
                and replicas > self.min_replicas):
            self._ok_since = None
            self._last_action = now
            metrics.counter("fleet.scale_down").inc()
            record_event("scale-down", replicas=replicas - 1,
                         reason="slo-ok")
            return "down"
        return None


class Router:
    """Tenant-fair, breaker-guarded dispatch over a replica set.

    Not thread-safe by design — the fleet front end owns one lock (a
    condition variable) around every call, which keeps this class
    deterministic enough to unit-test without processes or sockets.
    """

    def __init__(self, clock: Clock | None = None, quantum: float = 1.0,
                 weights: dict[str, float] | None = None,
                 capacity: int = 256, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 5.0):
        self.clock = clock if clock is not None else Clock()
        self.quantum = quantum
        self.weights = dict(weights or {})
        self.capacity = capacity
        self.breaker = CircuitBreaker(threshold=breaker_threshold,
                                      cooldown_s=breaker_cooldown_s,
                                      clock=self.clock)
        self.replicas: dict[int, ReplicaState] = {}
        self._backlogs: dict[str, deque[Ticket]] = {}
        self._deficit: dict[str, float] = {}
        self._tenant_order: list[str] = []
        self._scan = 0                     # DRR rotation cursor
        self._seq = itertools.count()
        self._inflight: dict[int, Ticket] = {}
        self.requeues = Counter()          # per source replica
        self.total_requeues = 0

    # -------------------------------------------------------- replicas

    def register_replica(self, rank: int, capacity: int,
                         incarnation: int = 0) -> ReplicaState:
        rep = self.replicas.get(rank)
        if rep is None:
            rep = ReplicaState(rank, capacity)
            self.replicas[rank] = rep
        rep.capacity = capacity
        rep.incarnation = incarnation
        rep.up = True
        rep.retiring = False
        rep.inflight = 0
        return rep

    def mark_down(self, rank: int, reason: str = "exit") -> list[Ticket]:
        """Replica death: requeue every in-flight ticket it held (at the
        front of its tenant's backlog — it has already waited) and
        return them for observability."""
        rep = self.replicas.get(rank)
        if rep is not None:
            rep.up = False
            rep.inflight = 0
        lost = [t for t in self._inflight.values() if t.replica == rank]
        for t in lost:
            del self._inflight[t.seq]
            self._requeue(t, from_replica=rank)
        return lost

    def mark_retiring(self, rank: int) -> None:
        rep = self.replicas.get(rank)
        if rep is not None:
            rep.retiring = True

    def up_replicas(self) -> list[ReplicaState]:
        return [r for r in self.replicas.values() if r.up]

    def occupancy(self) -> float:
        cap = sum(r.capacity for r in self.up_replicas())
        if not cap:
            return 0.0
        return sum(r.inflight for r in self.up_replicas()) / cap

    # ---------------------------------------------------------- submit

    def submit(self, doc: dict) -> Ticket | None:
        """Accept into the tenant backlog, or refuse (None) when the
        front-tier backlog is at capacity — the same honest-refusal
        contract as the server's bounded queue."""
        backlog = sum(len(q) for q in self._backlogs.values())
        if backlog >= self.capacity:
            metrics.counter("fleet.shed.queue-full").inc()
            return None
        tenant = doc.get("tenant", "default")
        t = Ticket(seq=next(self._seq), op=doc.get("op", "?"),
                   tenant=tenant, doc=doc)
        # open the front-tier residency hop under the client's
        # wire-carried span, then rewrite the forwarded context so the
        # replica's hops parent under this one — the Dapper chain
        t.hop = begin_span("serve.hop.route",
                           parent=doc.get("parent_span"),
                           tail_key=f"t{t.seq}", head_key=t.seq,
                           **self._hop_tags(t))
        doc["parent_span"] = t.hop.id
        if tenant not in self._backlogs:
            self._backlogs[tenant] = deque()
            self._deficit[tenant] = 0.0
            self._tenant_order.append(tenant)
        self._backlogs[tenant].append(t)
        return t

    def _hop_tags(self, ticket: Ticket, **extra) -> dict:
        """Common tags for a ticket's hop spans; the request's own trace
        id (carried in the doc) overrides this process's, so every hop
        of one request lands on one trace id across the fleet."""
        tags = {"rid": ticket.seq, "op": ticket.op,
                "tenant": ticket.tenant, **extra}
        tid = ticket.doc.get("trace_id")
        if tid:
            tags["trace"] = tid
        return tags

    # -------------------------------------------------------- dispatch

    def _pick_replica(self) -> ReplicaState | None:
        ready = [r for r in self.up_replicas()
                 if not r.retiring and r.inflight < r.capacity
                 and self.breaker.allow(ROUTE_OP, _rung(r.rank))]
        if not ready:
            return None
        return min(ready, key=lambda r: (r.inflight, r.rank))

    def next_assignment(self) -> tuple[Ticket, int] | None:
        """Deficit-round-robin pick: the next (ticket, rank) to send, or
        None when the backlog is empty or no replica can take work."""
        if not any(self._backlogs.values()):
            return None
        rep = self._pick_replica()
        if rep is None:
            return None
        n = len(self._tenant_order)
        for i in range(n):
            tenant = self._tenant_order[(self._scan + i) % n]
            q = self._backlogs[tenant]
            if not q:
                self._deficit[tenant] = 0.0   # idle tenants bank nothing
                continue
            self._deficit[tenant] += self.quantum * self.weights.get(
                tenant, 1.0)
            if self._deficit[tenant] < 1.0:
                continue
            self._deficit[tenant] -= 1.0
            self._scan = (self._scan + i + 1) % n
            ticket = q.popleft()
            ticket.replica = rep.rank
            ticket.attempts += 1
            rep.inflight += 1
            rep.routed += 1
            self._inflight[ticket.seq] = ticket
            metrics.counter("fleet.routed").inc()
            if ticket.wait_hop is not None:    # the requeue detour ends
                ms = ticket.wait_hop.end(replica=rep.rank)
                if ms is not None:
                    ticket.hop_ms["requeue_ms"] = round(
                        ticket.hop_ms.get("requeue_ms", 0.0) + ms, 3)
                ticket.wait_hop = None
            if ticket.hop is not None:
                ticket.dispatch_hop = begin_span(
                    "serve.hop.dispatch", parent=ticket.hop.id,
                    tail_key=f"t{ticket.seq}", head_key=ticket.seq,
                    **self._hop_tags(ticket, replica=rep.rank))
            record_event("request-routed", rid=ticket.seq, op=ticket.op,
                         tenant=ticket.tenant, replica=rep.rank)
            return ticket, rep.rank
        return None

    # ------------------------------------------------------ completion

    def complete(self, ticket: Ticket, rank: int, ok: bool = True) -> bool:
        """A send finished (response received).  Returns False when the
        ticket had already been requeued elsewhere (stale completion
        after a mark_down race) — the caller should still deliver the
        response if the ticket is not done (first response wins)."""
        cur = self._inflight.get(ticket.seq)
        live = cur is not None and cur.replica == rank
        if live:
            del self._inflight[ticket.seq]
            rep = self.replicas.get(rank)
            if rep is not None and rep.inflight > 0:
                rep.inflight -= 1
            if ticket.dispatch_hop is not None:
                ms = ticket.dispatch_hop.end()
                if ms is not None:
                    ticket.hop_ms["dispatch_ms"] = ms
                ticket.dispatch_hop = None
        if ok:
            self.breaker.record_success(ROUTE_OP, _rung(rank))
        return live

    def fail_transport(self, ticket: Ticket, rank: int,
                       kind=None) -> None:
        """A send failed at the socket (replica dead or dying): trip the
        breaker a notch and requeue, unless mark_down beat us to it."""
        from ..core.resilience import FailureKind

        self.breaker.record_failure(ROUTE_OP, _rung(rank),
                                    kind or FailureKind.RUNTIME)
        cur = self._inflight.get(ticket.seq)
        if cur is None or cur.replica != rank:
            return
        del self._inflight[ticket.seq]
        rep = self.replicas.get(rank)
        if rep is not None and rep.inflight > 0:
            rep.inflight -= 1
        self._requeue(ticket, from_replica=rank)

    def _requeue(self, ticket: Ticket, from_replica: int) -> None:
        ticket.replica = None
        ticket.requeues += 1
        self.requeues[from_replica] += 1
        self.total_requeues += 1
        metrics.counter("fleet.requeued").inc()
        if ticket.dispatch_hop is not None:    # the attempt died partway
            ticket.dispatch_hop.end(requeued=True)
            ticket.dispatch_hop = None
        if ticket.hop is not None:
            ticket.wait_hop = begin_span(
                "serve.hop.requeue", parent=ticket.hop.id,
                tail_key=f"t{ticket.seq}", head_key=ticket.seq,
                **self._hop_tags(ticket, from_replica=from_replica))
        record_event("request-requeued", rid=ticket.seq, op=ticket.op,
                     tenant=ticket.tenant, from_replica=from_replica)
        q = self._backlogs.setdefault(ticket.tenant, deque())
        if ticket.tenant not in self._deficit:
            self._deficit[ticket.tenant] = 0.0
            self._tenant_order.append(ticket.tenant)
        q.appendleft(ticket)   # it already waited its turn

    # ----------------------------------------------------------- state

    def backlog(self) -> int:
        return sum(len(q) for q in self._backlogs.values())

    def inflight(self) -> int:
        return len(self._inflight)

    def state(self) -> dict:
        return {
            "backlog": self.backlog(),
            "inflight": self.inflight(),
            "occupancy": round(self.occupancy(), 4),
            "requeues": self.total_requeues,
            "replicas": {
                _rung(r.rank): {
                    "up": r.up,
                    "retiring": r.retiring,
                    "incarnation": r.incarnation,
                    "inflight": r.inflight,
                    "routed": r.routed,
                    "requeues": self.requeues.get(r.rank, 0),
                    "breaker": self.breaker.state(ROUTE_OP, _rung(r.rank)),
                }
                for r in self.replicas.values()
            },
        }
