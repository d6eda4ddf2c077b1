"""The replicated serving fleet: N server replicas as supervised worker
processes behind one tenant-fair front tier.

Counterpart of ``cme213_tpu/serve/fleet.py``, with three deviations:

- the fleet owns a ``device`` (``cuda`` unless the caller asks for the
  CPU), resolved once in the front process before any replica is spawned
  (with no card and no ``device``, ``FrameworkError`` at construction,
  not a ready timeout), and handed to every replica as ``--device``;
- a replica's rank is the ``RANK`` variable (torchrun's, which the port's
  launcher, heartbeats and ``faults.maybe_kill_replica`` read) where the
  JAX package exports ``JAX_PROCESS_ID``;
- replicas are spawned as ``python -m cme213_tpu_torch fleet worker``.

Replicas on one card each hold their own CUDA context and caching
allocator; ``CME213_MEMORY_BUDGET`` in the fleet's environment (which
every replica inherits) bounds each one's admission.

This is the serving analog of the reference's hw5 unit — a gang of MPI
ranks cooperating on one workload under supervised relaunch — rebuilt
for request traffic.  It reuses the gang machinery wholesale
(``dist/launch.py`` env conventions: ``RANK`` as the replica
rank, ``CME213_INCARNATION`` bumped per relaunch, ``{rank}``-templated
trace/metrics sinks, heartbeat files from ``dist/supervisor.py``, one
cross-process trace id via ``propagation_env``) but differs in the
failure unit: MPI ranks are a collective, so one death condemns the
gang; replicas are independent, so one death relaunches **that
replica** while the rest keep serving.

Topology::

    clients ── v2 binary frames (or legacy JSON) ──> FleetFrontEnd (this proc)
                                                │  Router (tenant-fair DRR,
                                                │   per-replica breakers,
                                                │   in-flight ledger)
                                     dispatcher │ + one pipelined channel
                                                │   per replica (shm lane
                                                │   when negotiable)
                 ┌──────────────────────────────┼──────────────┐
            replica 0 (proc)               replica 1       ... replica N-1
            Server + TransportServer       (each: warmed program cache,
            (drive="thread", kill_guard)    heartbeats, per-rank sinks)

Dispatch is **pipelined**: each replica is fed over ONE persistent v2
connection carrying up to ``dispatch_width`` requests in flight, keyed
by request id (``serve/wire.py``); payload sections pass through the
front end without re-encoding, and — being same-host — the channel
negotiates the shared-memory lane (``serve/shm.py``) so large payloads
skip the loopback socket entirely.

**Zero accepted-request loss.**  The front end owns every accepted
request until a response exists: a ticket is held in the router's
in-flight ledger while a channel forwards it, and a replica death — seen
as a connection error by the channel (which fails *all* of its in-flight
tickets at once, however deep the pipeline) *and* as a process exit by
the supervisor — requeues the ticket (``request-requeued``) for a healthy
replica.  The dead replica's flight-recorder dump (it dumps before the
injected SIGKILL; see ``faults.maybe_kill_replica``) is read back for
the post-mortem, confirming which requests were mid-batch.  Solves are
pure, so the rare double execution after a mid-response kill is
harmless: the first response wins.

**Autoscaling.**  The front tier runs an ``serve/slo.py`` monitor over
completed responses and a :class:`~.router.Autoscaler` policy tick in
the supervisor loop: sustained ``slo-burn`` spawns the next rank
(``scale-up``), sustained health at low occupancy retires the highest
rank after draining it (``scale-down``), with sustain windows and an
action cooldown for hysteresis — all on the injectable clock.
"""

from __future__ import annotations

import glob
import json
import os
import queue as queue_mod
import subprocess
import sys
import threading
import time

from ..core import flight, metrics
from ..core.faults import KILL_EXIT
from ..core.resilience import Clock
from ..core.trace import (
    propagation_env,
    record_event,
    tail_decide,
    tail_keep_reason,
)
from ..dist.launch import (
    _pump,
    _template_metrics_file,
    _template_trace_file,
    free_port,
)
from ..dist.supervisor import HEARTBEAT_DIR_ENV, HEARTBEAT_INTERVAL_ENV
from . import jobs as jobs_mod
from . import wire
from .request import FAILED, QUEUE_FULL, SHED
from .router import Autoscaler, Router, Ticket
from .transport import (
    RESPONSE_TIMEOUT_S,
    FrameServer,
    TransportClient,
    TransportServer,
)

#: sentinel queued to a sender thread to shut it down
_SENDER_STOP = object()


def _finish_ticket(ticket: Ticket, meta: dict) -> None:
    """Close the front tier's ``serve.hop.route`` span, attach the
    per-hop breakdown to the response meta (``hops`` rides the result
    doc to the client as an extra field: wait/dispatch/requeue residency
    plus the requeue count), and make the front tier's tail-sampling
    keep/drop call — requeues are only visible here, so "kept because
    requeued" is this hop's verdict."""
    hop = ticket.hop
    if hop is None:
        return
    route_ms = hop.end(status=meta.get("status"),
                       requeues=ticket.requeues)
    if route_ms is None:
        return
    hops = dict(ticket.hop_ms)
    hops["route_ms"] = route_ms
    hops["requeues"] = ticket.requeues
    meta["hops"] = hops
    if hop.tail_key is not None:
        reason = tail_keep_reason(status=meta.get("status"),
                                  latency_ms=route_ms,
                                  requeues=ticket.requeues)
        tail_decide(hop.tail_key, keep=reason is not None,
                    reason=reason or "ok")


# ------------------------------------------------------------ replica proc

class ReplicaProc:
    """One supervised replica worker process."""

    def __init__(self, rank: int, incarnation: int, port: int,
                 proc: subprocess.Popen):
        self.rank = rank
        self.incarnation = incarnation
        self.port = port
        self.proc = proc
        self.state = "starting"        # starting | up | down | retired

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"


class ReplicaChannel:
    """One pipelined v2 connection from the front tier to a replica.

    Tickets go out with :meth:`send` (non-blocking past the socket
    write) and complete on the transport client's receiver thread via
    ``_on_response`` — many in flight at once, matched by request id.
    When the connection dies, ``_on_error`` fails **every** in-flight
    ticket back to the router in one sweep: a SIGKILL with a full
    pipeline requeues the whole window through the ledger, losing
    nothing.  Being same-host, the channel asks for the shared-memory
    lane and falls back to the socket when the server declines.
    """

    def __init__(self, fleet: "Fleet", rank: int, addr: str,
                 shm: bool = True, connect_timeout_s: float = 2.0):
        self.fleet = fleet
        self.rank = rank
        self._mu = threading.Lock()
        self._inflight: dict[int, Ticket] = {}
        self._closing = False
        self.dead = False
        self.client = TransportClient(
            addr, connect_timeout_s=connect_timeout_s, shm=shm,
            on_response=self._on_response, on_error=self._on_error)
        # per-peer clock alignment for the request waterfalls: a few
        # ping round trips bound this replica's wall-clock offset
        self.client.sync_clock(samples=3)

    def send(self, ticket: Ticket) -> None:
        """Pipeline one ticket; raises on a dead connection (the caller
        requeues via the router)."""
        rid = self.client.next_rid()
        with self._mu:
            if self.dead:
                raise ConnectionError(f"channel to replica {self.rank} down")
            self._inflight[rid] = ticket
        try:
            self.client.submit_doc(ticket.doc, ticket.sections, rid=rid)
        except Exception:
            with self._mu:
                self._inflight.pop(rid, None)
            raise

    def inflight(self) -> int:
        with self._mu:
            return len(self._inflight)

    # -- receiver-thread callbacks

    def _on_response(self, rid: int, meta: dict, sections: list) -> None:
        with self._mu:
            ticket = self._inflight.pop(rid, None)
        if ticket is None:
            return
        meta.setdefault("replica", self.rank)
        fleet = self.fleet
        with fleet._cv:
            fleet.router.complete(ticket, self.rank)
            fleet._cv.notify_all()
        _finish_ticket(ticket, meta)
        fleet._observe(meta)
        fleet._deliver(ticket, meta, sections)

    def _on_error(self, exc: Exception) -> None:
        with self._mu:
            if self._closing:
                return
            self.dead = True
            pending = list(self._inflight.values())
            self._inflight.clear()
        fleet = self.fleet
        with fleet._cv:
            for ticket in pending:
                fleet.router.fail_transport(ticket, self.rank)
            fleet._cv.notify_all()

    def close(self) -> None:
        with self._mu:
            self._closing = True
            self.dead = True
        self.client.close()


class Fleet:
    """Spawn, supervise, scale, and route over N replica processes."""

    def __init__(self, replicas: int = 2, capacity: int = 64,
                 max_batch: int = 8, mix: str = "spmv,heat,cipher",
                 warm_requests: int = 6, dispatch_width: int | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 ready_timeout_s: float = 180.0,
                 max_restarts: int = 4,
                 slo=None, autoscaler: Autoscaler | None = None,
                 clock: Clock | None = None,
                 router: Router | None = None, shm: bool = True,
                 jobs_dir: str | None = None, device=None):
        from .workloads import serving_device

        #: where every replica serves, resolved here so a fleet with no
        #: card and no ``device`` fails before it spawns anything
        self.device = serving_device(device)
        self.initial_replicas = replicas
        self.capacity = capacity
        self.max_batch = max_batch
        self.mix = mix
        self.warm_requests = warm_requests
        # pipeline depth: max requests in flight on a replica's channel
        # (the router's per-replica capacity on ONE connection)
        self.dispatch_width = dispatch_width or max_batch
        self.shm = shm
        self.ready_timeout_s = ready_timeout_s
        self.max_restarts = max_restarts
        self.slo = slo
        self.autoscaler = autoscaler
        self.clock = clock if clock is not None else Clock()
        self.router = router if router is not None else Router(
            clock=self.clock, capacity=max(capacity * max(replicas, 1), 64))
        self.front = _FleetFrontEnd(self, host, port)
        self._cv = threading.Condition()   # guards the router + fleet maps
        self._procs: dict[int, ReplicaProc] = {}
        self._send_queues: dict[int, queue_mod.Queue] = {}
        self._sender_threads: dict[int, list[threading.Thread]] = {}
        self._restarts = 0
        self._next_rank = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.flight_confirmed = 0      # requests confirmed mid-batch in dumps
        # durable long-job lane: a shared job directory every replica
        # mounts (serve/jobs.py).  The front end serves job-* controls
        # against it directly; replicas claim and execute the records.
        self.jobs_dir = (jobs_dir if jobs_dir is not None
                         else os.environ.get(jobs_mod.JOBS_DIR_ENV))
        self.jobs_store = (jobs_mod.JobStore(self.jobs_dir)
                           if self.jobs_dir else None)

    # ------------------------------------------------------------ start

    def start(self) -> "Fleet":
        flight.install_from_env()
        for _ in range(self.initial_replicas):
            self._spawn(incarnation=0)
        deadline = time.monotonic() + self.ready_timeout_s
        while time.monotonic() < deadline:
            with self._cv:
                states = [p.state for p in self._procs.values()]
            if states and all(s == "up" for s in states):
                break
            self._poll_starting()
            time.sleep(0.1)
        else:
            self.close()
            raise TimeoutError(
                f"fleet: replicas not ready in {self.ready_timeout_s}s")
        self._adopt_orphan_jobs()
        self.front.start()
        for name, fn in (("fleet-dispatch", self._dispatch_loop),
                         ("fleet-supervise", self._supervise_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    @property
    def addr(self) -> str:
        return self.front.addr

    # ------------------------------------------------------- spawn/ready

    def _spawn(self, incarnation: int, rank: int | None = None) -> None:
        if rank is None:
            rank = self._next_rank
            self._next_rank += 1
        port = free_port()
        env = dict(os.environ)
        env["RANK"] = str(rank)
        env["CME213_INCARNATION"] = str(incarnation)
        if self.jobs_dir:
            env[jobs_mod.JOBS_DIR_ENV] = self.jobs_dir
        env.setdefault(HEARTBEAT_INTERVAL_ENV, "0.5")
        env.update(propagation_env())
        _template_trace_file(env, rank)
        _template_metrics_file(env, rank)
        cmd = [sys.executable, "-m", "cme213_tpu_torch", "fleet", "worker",
               "--port", str(port),
               "--device", str(self.device),
               "--capacity", str(self.capacity),
               "--max-batch", str(self.max_batch),
               "--mix", self.mix,
               "--warm-requests", str(self.warm_requests)]
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=_pump, args=(rank, proc.stdout, sys.stderr),
                         daemon=True).start()
        rep = ReplicaProc(rank, incarnation, port, proc)
        with self._cv:
            self._procs[rank] = rep
            if rank not in self._send_queues:
                self._send_queues[rank] = queue_mod.Queue()
                t = threading.Thread(
                    target=self._sender_loop, args=(rank,),
                    name=f"fleet-send-r{rank}", daemon=True)
                t.start()
                self._sender_threads[rank] = [t]

    def _poll_starting(self) -> None:
        """Probe starting replicas; register the ones that answer ping."""
        with self._cv:
            starting = [p for p in self._procs.values()
                        if p.state == "starting"]
        for rep in starting:
            if rep.proc.poll() is not None:
                with self._cv:
                    rep.state = "down"
                continue
            try:
                with TransportClient(rep.addr, timeout_s=2.0,
                                     connect_timeout_s=0.5) as c:
                    pong = c.control("ping")
            except (OSError, ConnectionError, ValueError):
                continue
            if not pong.get("ok"):
                continue
            with self._cv:
                rep.state = "up"
                self.router.register_replica(
                    rep.rank, capacity=self.dispatch_width,
                    incarnation=rep.incarnation)
                self._cv.notify_all()
            metrics.counter("fleet.replica_up").inc()

    # -------------------------------------------------------- dispatch

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                a = self.router.next_assignment()
                if a is None:
                    self._cv.wait(0.05)
                    continue
            ticket, rank = a
            self._send_queues[rank].put(ticket)

    def _sender_loop(self, rank: int) -> None:
        """Feed one replica over one pipelined channel.  The loop only
        *sends*; completions (and connection-death requeues) arrive on
        the channel's receiver thread."""
        channel: ReplicaChannel | None = None
        connected_port = None
        q = self._send_queues[rank]
        while not self._stop.is_set():
            try:
                ticket = q.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            if ticket is _SENDER_STOP:
                break
            with self._cv:
                rep = self._procs.get(rank)
                addr = rep.addr if rep is not None else None
                port = rep.port if rep is not None else None
            try:
                if addr is None:
                    raise ConnectionError(f"replica {rank} gone")
                if channel is None or channel.dead or connected_port != port:
                    if channel is not None:
                        channel.close()
                    channel = ReplicaChannel(self, rank, addr,
                                             shm=self.shm)
                    connected_port = port
                channel.send(ticket)
            except (OSError, ConnectionError, ValueError):
                if channel is not None:
                    channel.close()
                channel = None
                with self._cv:
                    self.router.fail_transport(ticket, rank)
                    self._cv.notify_all()
        if channel is not None:
            channel.close()

    def _deliver(self, ticket: Ticket, meta: dict,
                 sections: list = ()) -> None:
        """Answer the client that owns the ticket: v2 clients get the
        sections forwarded as-is on their pipelined connection; v1
        clients get a self-describing JSON doc (sections inlined to
        base64) and their parked connection thread woken."""
        reply = ticket.reply
        if reply is not None:
            conn, wire_rid = reply
            try:
                conn.send_v2(wire.FT_RESPONSE, wire_rid, meta, sections)
            except (ConnectionError, OSError):
                pass                 # client went away; result dropped
            return
        if ticket.done is not None and not ticket.done.is_set():
            ticket.result = (wire.inline_sections(meta, list(sections))
                             if sections else meta)
            ticket.done.set()

    def _observe(self, resp: dict) -> None:
        if self.slo is None:
            return
        status = resp.get("status")
        self.slo.observe(latency_ms=resp.get("latency_ms"),
                         shed=status == SHED, failed=status == FAILED)

    # ------------------------------------------------------ supervision

    def _supervise_loop(self) -> None:
        while not self._stop.is_set():
            self._poll_starting()
            with self._cv:
                reps = list(self._procs.values())
            for rep in reps:
                rc = rep.proc.poll()
                if rc is not None and rep.state in ("up", "starting"):
                    self._handle_death(rep, rc)
                elif rc is not None and rep.state == "retired":
                    pass
            self._autoscale_tick()
            self._stop.wait(0.05)

    def _handle_death(self, rep: ReplicaProc, rc: int) -> None:
        reason = "replica-kill" if rc == -9 or rc == KILL_EXIT else f"exit:{rc}"
        record_event("replica-down", replica=rep.rank,
                     incarnation=rep.incarnation, reason=reason)
        metrics.counter("fleet.replica_down").inc()
        self.flight_confirmed += self._read_flight_dump(rep)
        with self._cv:
            rep.state = "down"
            self.router.mark_down(rep.rank, reason=reason)
            # tickets already handed to this replica's sender queue but
            # not yet sent will fail at the socket and requeue there;
            # nothing is lost either way.
            relaunch = (not self._stop.is_set()
                        and self._restarts < self.max_restarts)
            if relaunch:
                self._restarts += 1
            self._cv.notify_all()
        if relaunch:
            self._spawn(incarnation=rep.incarnation + 1,
                               rank=rep.rank)
        elif self.jobs_store is not None:
            # the dead replica is NOT coming back: move its claimed jobs
            # to a live rank so they resume from their durable epoch
            # rather than sitting orphaned until the next fleet restart.
            with self._cv:
                live = sorted(p.rank for p in self._procs.values()
                              if p.state == "up" and p.rank != rep.rank)
            if live:
                moved = self.jobs_store.reassign_from(
                    str(rep.rank), str(live[0]))
                for jid in moved:
                    record_event("job-reassigned", job=jid,
                                 source=str(rep.rank), target=str(live[0]))
                    metrics.counter("jobs.reassigned").inc()

    def _adopt_orphan_jobs(self) -> None:
        """Fleet restart: job records whose owner rank no longer exists
        (the previous fleet's replicas are all gone) are reassigned to
        the lowest live rank so they resume from their last durable
        epoch."""
        if self.jobs_store is None:
            return
        with self._cv:
            ranks = {str(p.rank) for p in self._procs.values()
                     if p.state == "up"}
        if not ranks:
            return
        target = min(ranks, key=int)
        for rec in self.jobs_store.list_jobs():
            if rec["state"] in jobs_mod.TERMINAL:
                continue
            owner = self.jobs_store.owner(rec["job"])
            if owner is not None and owner not in ranks:
                self.jobs_store.reassign(rec["job"], target)
                record_event("job-reassigned", job=rec["job"],
                             source=owner, target=target)
                metrics.counter("jobs.reassigned").inc()

    def _read_flight_dump(self, rep: ReplicaProc) -> int:
        """Post-mortem: from the dead replica's flight-recorder dump
        (written before the injected SIGKILL), count the requests it had
        accepted but not yet served — the set the ledger requeues.  The
        dump is the *proof*; the in-flight ledger is the mechanism."""
        fdir = os.environ.get(flight.FLIGHT_DIR_ENV)
        if not fdir:
            return 0
        confirmed = 0
        for path in sorted(glob.glob(
                os.path.join(fdir, f"flight-{rep.proc.pid}-*.json"))):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if doc.get("reason") not in ("replica-kill", "rankkill"):
                continue
            counters = (doc.get("metrics") or {}).get("counters", {})
            accepted = counters.get("serve.requests", 0) - sum(
                v for k, v in counters.items()
                if k.startswith("serve.shed."))
            served = sum(1 for e in (doc.get("events") or [])
                         if e.get("event") == "request-served")
            confirmed += max(0, int(accepted) - served)
            print(f"fleet: replica {rep.rank} flight dump {path}: "
                  f"{max(0, int(accepted) - served)} request(s) in flight",
                  file=sys.stderr, flush=True)
        return confirmed

    # ------------------------------------------------------ autoscaling

    def _autoscale_tick(self) -> None:
        if self.autoscaler is None:
            return
        with self._cv:
            if self.slo is not None:
                # burning only transitions inside evaluate(): the fleet
                # is the monitor's driver, there is no Server.step here
                self.slo.evaluate()
            burning = bool(self.slo is not None and self.slo.burning)
            occupancy = self.router.occupancy()
            n = len([p for p in self._procs.values()
                     if p.state in ("up", "starting")])
        decision = self.autoscaler.evaluate(burning, occupancy, n)
        if decision == "up":
            self.scale_ups += 1
            self._spawn(incarnation=0)
        elif decision == "down":
            self.scale_downs += 1
            self._retire_one()

    def _retire_one(self) -> None:
        with self._cv:
            up = [p for p in self._procs.values() if p.state == "up"]
            if len(up) <= 1:
                return
            rep = max(up, key=lambda p: p.rank)
            rep.state = "retired"
            self.router.mark_retiring(rep.rank)
        # drain: wait (bounded) for its in-flight work, then stop it
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with self._cv:
                st = self.router.replicas.get(rep.rank)
                if st is None or st.inflight == 0:
                    break
            time.sleep(0.05)
        with self._cv:
            st = self.router.replicas.get(rep.rank)
            if st is not None:
                st.up = False
        record_event("replica-down", replica=rep.rank,
                     incarnation=rep.incarnation, reason="retired")
        metrics.counter("fleet.replica_down").inc()
        rep.proc.terminate()

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._cv:
            routing = self.router.state()
            states = {f"r{p.rank}": p.state for p in self._procs.values()}
        routing["replica_states"] = states
        routing["replicas_up"] = sum(1 for s in states.values() if s == "up")
        routing["scale_ups"] = self.scale_ups
        routing["scale_downs"] = self.scale_downs
        routing["flight_confirmed"] = self.flight_confirmed
        return routing

    # ----------------------------------------------------------- close

    def close(self) -> None:
        self._stop.set()
        self.front.close()
        with self._cv:
            self._cv.notify_all()
            reps = list(self._procs.values())
            queues = list(self._send_queues.values())
        for q in queues:
            q.put(_SENDER_STOP)
        for rep in reps:
            if rep.proc.poll() is None:
                rep.proc.terminate()
        for rep in reps:
            try:
                rep.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                rep.proc.kill()


class _FleetFrontEnd(FrameServer):
    """The fleet's client-facing socket.  v2 connections pipeline:
    each accepted frame becomes a ticket carrying its binary sections
    and its reply handle, and the reader moves straight to the next
    frame — responses flow back whenever a replica answers.  v1
    connections keep the legacy contract: the connection thread parks
    on its ticket until the response arrives (possibly after a
    requeue)."""

    def __init__(self, fleet: Fleet, host: str, port: int):
        super().__init__(host, port)
        self.fleet = fleet

    def handle_v2(self, conn, rid: int, meta: dict, sections: list,
                  read_s: float = 0.0) -> None:
        fleet = self.fleet
        with fleet._cv:
            ticket = fleet.router.submit(meta)
            if ticket is not None:
                ticket.sections = sections    # pass through, no re-encode
                ticket.reply = (conn, rid)
                fleet._cv.notify_all()
        if ticket is None:
            conn.send_v2(wire.FT_RESPONSE, rid,
                         {"rid": -1, "op": meta.get("op"), "status": SHED,
                          "reason": QUEUE_FULL,
                          "tenant": meta.get("tenant", "default")})

    def handle(self, doc: dict) -> dict:
        with self.fleet._cv:
            ticket = self.fleet.router.submit(doc)
            if ticket is not None:
                ticket.done = threading.Event()
                self.fleet._cv.notify_all()
        if ticket is None:
            return {"rid": -1, "op": doc.get("op"), "status": SHED,
                    "reason": QUEUE_FULL,
                    "tenant": doc.get("tenant", "default")}
        if not ticket.done.wait(RESPONSE_TIMEOUT_S):
            return {"rid": ticket.seq, "op": ticket.op, "status": FAILED,
                    "reason": "transport-timeout", "tenant": ticket.tenant}
        return ticket.result

    def control(self, doc: dict) -> dict:
        kind = doc.get("control")
        if isinstance(kind, str) and kind.startswith("job-"):
            store = self.fleet.jobs_store
            if store is None:
                return {"ok": False,
                        "error": "fleet has no --jobs-dir; job lane is off"}
            return jobs_mod.handle_control(store, doc)
        return super().control(doc)

    def stats(self) -> dict:
        out = self.fleet.stats()
        if self.fleet.jobs_store is not None:
            states: dict[str, int] = {}
            for rec in self.fleet.jobs_store.list_jobs():
                states[rec["state"]] = states.get(rec["state"], 0) + 1
            out["jobs"] = states
        return out


# ------------------------------------------------------------ worker

def worker_main(argv: list[str]) -> int:
    """Entry point of one replica process (``fleet worker``): build a
    server, warm its program cache, bind the socket transport in
    background-batcher drive, heartbeat until terminated."""
    import argparse

    ap = argparse.ArgumentParser(prog="fleet worker")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--mix", default="spmv,heat,cipher")
    ap.add_argument("--warm-requests", type=int, default=6)
    ap.add_argument("--max-seconds", type=float, default=600.0)
    ap.add_argument("--device", default=None,
                    help="where this replica serves (default cuda; the "
                    "fleet passes its own)")
    args = ap.parse_args(argv)

    from ..core.faults import incarnation
    from ..dist.supervisor import heartbeat_from_env
    from .server import Server
    from .warmup import warm_buckets

    flight.install_from_env()
    rank = os.environ.get("RANK", "0")
    server = Server(capacity=args.capacity, max_batch=args.max_batch,
                    device=args.device)
    if args.warm_requests > 0:
        warmed = warm_buckets(args.mix, requests=args.warm_requests,
                              max_batch=args.max_batch,
                              device=server.device)
        print(f"fleet worker r{rank}: warmed {len(warmed)} buckets",
              flush=True)
    ts = TransportServer(server, port=args.port, drive="thread",
                         kill_guard=True)
    jobs_dir = os.environ.get(jobs_mod.JOBS_DIR_ENV)
    if jobs_dir:
        store = jobs_mod.JobStore(jobs_dir)
        ts.attach_jobs(jobs_mod.JobExecutor(store, server=server, rank=rank))
        print(f"fleet worker r{rank}: job lane on {jobs_dir}", flush=True)
    ts.start()
    record_event("replica-up", replica=int(rank),
                 incarnation=incarnation(), addr=ts.addr)
    metrics.counter("fleet.replica_up").inc()
    print(f"fleet worker r{rank}: serving on {ts.addr} "
          f"(incarnation {incarnation()})", flush=True)
    # the supervisor retires/tears down replicas with SIGTERM
    # (``proc.terminate()``); route it into KeyboardInterrupt so the
    # transport closes and buffered trace spans reach the sink instead
    # of dying with the process
    import signal

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
    except ValueError:
        pass
    hb = heartbeat_from_env()
    deadline = time.monotonic() + args.max_seconds
    try:
        while time.monotonic() < deadline:
            if hb is not None:
                hb.beat(ts.batches)
            time.sleep(0.25)
    except KeyboardInterrupt:
        pass
    finally:
        ts.close()
    return 0
