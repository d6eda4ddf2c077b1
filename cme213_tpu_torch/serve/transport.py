"""Concurrent socket transport for the serving front end.

Counterpart of ``cme213_tpu/serve/transport.py``: the same frames (v1 and
v2), controls and drive modes, so a client of either package is served by
a server of the other.  The batcher thread drives the port's
``Server``, whose batches run on its device; results reach the codec as
numpy.  A replica's rank is the ``RANK`` variable (torchrun's, which the
port's launcher sets) where the JAX package reads ``JAX_PROCESS_ID``.
The replicated fleet in front of these servers (the JAX package's
``serve/router.py`` and ``serve/fleet.py``) is not in the port yet
(ROADMAP.md, queue A, item 7b).

The batching server (``serve/server.py``) is deliberately synchronous:
``submit`` / ``step`` on one thread, deterministic under a virtual
clock.  This module puts sockets in front of it without giving up that
core: a threaded accept loop funnels many client connections into the
one server under a lock, and a background **batcher thread** drains the
queue — the caller-driven ``step()`` loop becomes one of two drive
modes:

- ``drive="caller"`` — nothing runs in the background; the owner calls
  :meth:`TransportServer.pump` to step the server and deliver results.
  Deterministic (virtual-clock friendly): every existing test pattern
  still works with sockets in front.
- ``drive="thread"`` — a daemon batcher thread wakes on every accepted
  request (the ``Server.on_submit`` waker) and steps until the queue is
  empty.  This is the live-serving mode the fleet replicas run.

**Two wire protocols share every port**, distinguished per-frame by the
first four bytes:

- **v2 (binary, default)** — ``serve/wire.py``'s zero-copy framing:
  fixed header (magic / version / frame type / request id / section
  count), JSON only for small metadata, arrays as raw sections written
  with ``sendmsg`` and read with ``recv_into``.  Requests are
  **pipelined**: many in flight per connection, responses matched by
  request id in whatever order batches complete.  Same-host clients can
  negotiate a shared-memory lane (``serve/shm.py``) via a control
  frame, with transparent socket fallback.
- **v1 (legacy)** — ``[4-byte big-endian length][UTF-8 JSON]`` with
  numpy as base64 ``{"__nd__": [dtype, shape, data]}`` triples, one
  request in flight per connection.  A v2 server still speaks it frame
  by frame (the ``transport.proto_v1`` counter exposes how much legacy
  traffic remains), so old clients and mixed fleets keep working.

Clients negotiate with a ``{"control": "hello", "proto": 2}`` frame;
a client whose hello dies mid-handshake reconnects in v1 mode.  Either
way :meth:`TransportClient.solve` returns a
:class:`~.request.SolveResult` that compares bitwise-equal to a serial
solve; v2 adds :meth:`~TransportClient.submit` /
:meth:`~TransportClient.result` pairs for pipelining from one thread.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import struct
import threading
import time

import numpy as np

from . import wire
from ..core import metrics, trace
from ..core.faults import incarnation, maybe_kill_replica
from .request import FAILED, OK, SolveResult
from .server import Server

#: response safety net: a transport request that produces no result in
#: this many wall seconds fails with reason "transport-timeout" instead
#: of hanging its client connection forever
RESPONSE_TIMEOUT_S = 120.0

_LEN = struct.Struct(">I")


# ------------------------------------------------------------ v1 framing

def send_frame(sock: socket.socket, doc: dict) -> None:
    body = json.dumps(doc).encode("utf-8")
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(sock: socket.socket) -> dict | None:
    """One v1 frame, or None on a clean EOF at a frame boundary."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    body = _recv_exact(sock, length)
    if body is None:
        raise ConnectionError("EOF mid-frame")
    return json.loads(body.decode("utf-8"))


# ------------------------------------------------------------ wire codec
#
# The document codecs live in serve/wire.py, shared between protocols
# via a pluggable array encoder; these v1-shaped wrappers keep the
# first protocol's surface (and its base64 self-describing docs) intact.

def _nd_encode(arr: np.ndarray) -> dict:
    return wire.nd_b64(arr)


def _nd_decode(doc: dict) -> np.ndarray:
    return wire.nd_b64_decode(doc)


def encode_value(value):
    """JSON-encode a result value: numpy arrays become bitwise
    base64 triples; containers recurse; scalars pass through."""
    return wire.encode_value(value, wire.nd_b64)


def decode_value(doc):
    return wire.decode_value(doc)


def encode_payload(op: str, payload) -> dict:
    """Per-op payload serialization (the inverse of
    :func:`decode_payload`); ops are the ``serve.workloads.ADAPTERS``
    keys."""
    return wire.encode_payload(op, payload, wire.nd_b64)


def decode_payload(op: str, doc: dict):
    return wire.decode_payload(op, doc)


_RESULT_FIELDS = wire.RESULT_FIELDS


def encode_result(res: SolveResult, **extra) -> dict:
    return wire.encode_result(res, wire.nd_b64, **extra)


def decode_result(doc: dict) -> SolveResult:
    return wire.decode_result(doc)


def parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _observe_codec(direction: str, rid, op, ms: float, nbytes: int) -> None:
    """One encode/decode observation: histogram + span tag event (the
    loadgen ``transport`` subsection and ``trace summary`` both read
    these).  The histogram sees every request; the trace event is
    **sampled** past the first 64 rids of a connection (1 in 16 after
    that) — at wire speed the event record itself would be a measurable
    share of the request, and rids restart per connection so short runs
    always trace fully."""
    metrics.histogram(f"serve.request.{direction}_ms").observe(ms)
    if isinstance(rid, int) and rid > 64 and rid % 16:
        return
    if direction == "encode":
        trace.record_event("request-serialized", rid=rid, op=op,
                           ms=round(ms, 4), nbytes=int(nbytes))
    else:
        trace.record_event("request-deserialized", rid=rid, op=op,
                           ms=round(ms, 4), nbytes=int(nbytes))


# ------------------------------------------------------------ connections

class _Conn:
    """One accepted (or dialed) socket: a write lock so pipelined
    responses interleave whole frames only, plus the optionally
    negotiated shared-memory lane."""

    __slots__ = ("sock", "wlock", "lane", "alive")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.wlock = threading.Lock()
        self.lane = None          # shm.ShmLane once negotiated
        self.alive = True

    def send_v1(self, doc: dict) -> None:
        with self.wlock:
            send_frame(self.sock, doc)

    def send_v2(self, ftype: int, rid: int, meta: dict,
                sections=()) -> None:
        self.send_packed(wire.pack_frame(ftype, rid, meta, sections), rid)

    def send_packed(self, bufs: list, rid: int = 0) -> None:
        """Send a packed frame — through the shm lane when negotiated
        and a slot credit is free, else the socket."""
        with self.wlock:
            if self.lane is not None:
                bell = self.lane.tx.try_send(bufs)
                if bell is not None:
                    wire.send_frame_v2(self.sock, wire.FT_SHM, rid, bell)
                    return
            wire.send_buffers(self.sock, bufs)

    def close(self) -> None:
        self.alive = False
        try:
            # shutdown first: close() alone does not send the FIN while
            # a reader thread is blocked in recv on this fd (the
            # in-flight syscall keeps the kernel socket alive), so the
            # peer would never see the EOF
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self.lane is not None:
            try:
                self.lane.close()
            except Exception:
                pass
            self.lane = None


# ------------------------------------------------------------ servers

class FrameServer:
    """Threaded accept loop speaking both wire protocols (sniffed per
    frame); subclasses implement :meth:`handle` (v1: one request doc ->
    one response doc, may block) and :meth:`handle_v2` (pipelined: must
    not block the reader), and optionally extend :meth:`control`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._sock: socket.socket | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[_Conn] = set()
        self._conns_mu = threading.Lock()

    # -- lifecycle

    def start(self) -> "FrameServer":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self._host, self._port))
        self._port = self._sock.getsockname()[1]
        self._sock.listen(128)
        self._sock.settimeout(0.2)
        t = threading.Thread(target=self._accept_loop,
                             name="transport-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    @property
    def addr(self) -> str:
        return f"{self._host}:{self._port}"

    def close(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # sever live connections too: their reader threads exit and
        # pipelined clients see the EOF immediately (the same signal a
        # SIGKILLed replica's clients get)
        with self._conns_mu:
            conns = list(self._conns)
        for c in conns:
            c.close()

    # -- plumbing

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="transport-conn", daemon=True)
            t.start()

    def _serve_conn(self, sock: socket.socket) -> None:
        conn = _Conn(sock)
        with self._conns_mu:
            self._conns.add(conn)
        try:
            with sock:
                rd = wire.BufReader(sock)
                while not self._stop.is_set():
                    try:
                        if not rd.pending():
                            self._flush(conn)   # before we block reading
                        first4 = rd.first4()
                        if first4 is None:
                            return
                        if first4[:1] == wire.MAGIC[:1]:
                            self._serve_v2_frame(conn, rd, first4)
                        else:
                            self._serve_v1_frame(conn, rd, first4)
                    except (ConnectionError, OSError, ValueError):
                        return
        finally:
            with self._conns_mu:
                self._conns.discard(conn)
            conn.close()

    def _serve_v1_frame(self, conn: _Conn, rd: "wire.BufReader",
                        head: bytes) -> None:
        (length,) = _LEN.unpack(head)
        doc = json.loads(rd.recv_exact(length).decode("utf-8"))
        metrics.counter("transport.proto_v1").inc()
        try:
            if "control" in doc:
                resp = self.control(doc)
            else:
                resp = self.handle(doc)
        except Exception as e:       # noqa: BLE001 - wire boundary
            resp = {"status": FAILED, "reason": "transport",
                    "error": f"{type(e).__name__}: {e}"}
        conn.send_v1(resp)

    def _serve_v2_frame(self, conn: _Conn, rd: "wire.BufReader",
                        first4: bytes) -> None:
        t0 = time.perf_counter()
        ftype, rid, meta, sections = wire.read_frame_rest(rd, first4)
        if ftype == wire.FT_SHM:
            if conn.lane is None:
                raise wire.WireError("shm doorbell without a lane")
            slot = int(meta["slot"])
            ftype, rid, meta, sections = conn.lane.read(slot,
                                                        int(meta["len"]))
            # the slot is parsed out; return the writer's credit
            conn.send_v2(wire.FT_CONTROL, 0,
                         {"control": "shm-ack", "slot": slot})
        read_s = time.perf_counter() - t0
        if ftype == wire.FT_CONTROL:
            self._control_v2(conn, rid, meta)
        elif ftype == wire.FT_REQUEST:
            try:
                self.handle_v2(conn, rid, meta, sections, read_s)
            except Exception as e:   # noqa: BLE001 - wire boundary
                conn.send_v2(wire.FT_RESPONSE, rid,
                             {"status": FAILED, "reason": "transport",
                              "error": f"{type(e).__name__}: {e}"})
        else:
            raise wire.WireError(f"unexpected frame type {ftype}")

    def _control_v2(self, conn: _Conn, rid: int, meta: dict) -> None:
        kind = meta.get("control")
        if kind == "shm-ack":
            if conn.lane is not None:
                conn.lane.tx.ack(int(meta["slot"]))
            return                   # credit return: no reply
        if kind == "shm-setup":
            from . import shm as shm_mod
            try:
                lane = shm_mod.attach_server_lane(meta)
                resp = {"ok": True, "slots": lane.tx.ring.slots}
            except Exception as e:   # noqa: BLE001 - stay on sockets
                lane = None
                resp = {"ok": False,
                        "error": f"{type(e).__name__}: {e}"}
            # reply over the socket FIRST: the lane goes live only after
            # the client has heard the answer (it is not reading slots yet)
            conn.send_v2(wire.FT_CONTROL_REPLY, rid, resp)
            conn.lane = lane
            return
        resp = self.control(meta)
        conn.send_v2(wire.FT_CONTROL_REPLY, rid, resp)

    # -- overridables

    def _flush(self, conn: _Conn) -> None:
        """Called by the connection loop whenever its read buffer runs
        dry (i.e. just before it might block): subclasses that batch
        their replies write them out here."""

    def handle(self, doc: dict) -> dict:
        raise NotImplementedError

    def handle_v2(self, conn: _Conn, rid: int, meta: dict,
                  sections: list, read_s: float = 0.0) -> None:
        raise NotImplementedError

    def control(self, doc: dict) -> dict:
        kind = doc.get("control")
        if kind == "ping":
            # "t" is this process's wall clock at reply time: the
            # client's ClockSync turns ping round trips into a per-peer
            # offset ± error bound for waterfall clock alignment
            return {"ok": True, "pid": os.getpid(), "t": time.time(),
                    "rank": os.environ.get("RANK", "main"),
                    "incarnation": incarnation()}
        if kind == "hello":
            # protocol negotiation: we always speak v2; echo it so the
            # client pipelines, and ping fields ride along for free
            return {"ok": True, "proto": wire.VERSION, "pid": os.getpid(),
                    "t": time.time(),
                    "rank": os.environ.get("RANK", "main"),
                    "incarnation": incarnation()}
        if kind == "stats":
            return {"ok": True, "stats": self.stats()}
        return {"ok": False, "error": f"unknown control {kind!r}"}

    def stats(self) -> dict:
        return {}


class TransportServer(FrameServer):
    """The socket front end over one local :class:`~.server.Server`.

    ``drive="thread"`` starts a background batcher that wakes on every
    accepted request and steps the server until its queue is empty
    (calling the ``replica-kill`` fault guard once per non-empty sweep
    when ``kill_guard`` is set — the fleet replica's deterministic
    mid-batch death point).  ``drive="caller"`` leaves stepping to the
    owner via :meth:`pump`.

    v1 connections block their reader thread per request (one in
    flight); v2 connections register ``(conn, wire rid)`` with the
    request and the batcher writes responses back in completion order —
    arbitrarily many in flight per connection.
    """

    def __init__(self, server: Server, host: str = "127.0.0.1",
                 port: int = 0, drive: str = "thread",
                 poll_interval_s: float = 0.05, kill_guard: bool = False):
        if drive not in ("thread", "caller"):
            raise ValueError(f"drive must be thread|caller, got {drive!r}")
        super().__init__(host, port)
        self.server = server
        self.drive = drive
        self.kill_guard = kill_guard
        self._poll_interval_s = poll_interval_s
        self._mu = threading.Lock()          # guards the synchronous core
        self._wake = threading.Event()
        # rid -> [Event, result] (v1 blocking) | (_Conn, wire_rid) (v2)
        self._pending: dict[int, object] = {}
        self.batches = 0                     # batcher sweeps that executed
        server.on_submit = self._wake.set

    def attach_jobs(self, executor) -> "TransportServer":
        """Wire a ``serve.jobs.JobExecutor`` into this transport: the
        batcher (or :meth:`pump`) ticks one job epoch per idle gap, and
        ``job-*`` control frames are served against its store."""
        executor.server = self.server
        self.server.jobs = executor
        return self

    def start(self) -> "TransportServer":
        super().start()
        if self.drive == "thread":
            t = threading.Thread(target=self._batch_loop,
                                 name="transport-batcher", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    # -- request paths

    def handle(self, doc: dict) -> dict:
        """v1: decode, submit, block this connection thread on delivery."""
        op = doc["op"]
        t0 = time.perf_counter()
        payload = decode_payload(op, doc["payload"])
        dec_ms = (time.perf_counter() - t0) * 1e3
        waiter = None
        with self._mu:
            out = self.server.submit(
                op, payload, deadline_ms=doc.get("deadline_ms"),
                tenant=doc.get("tenant", "default"),
                trace_id=doc.get("trace_id"),
                parent_span=doc.get("parent_span"))
            if isinstance(out, SolveResult):         # shed at the door
                return encode_result(out)
            waiter = [threading.Event(), None]
            self._pending[out] = waiter
        _observe_codec("decode", out, op, dec_ms, 0)
        if not waiter[0].wait(RESPONSE_TIMEOUT_S):
            with self._mu:
                self._pending.pop(out, None)
            return {"rid": out, "op": op, "status": FAILED,
                    "reason": "transport-timeout", "tenant":
                    doc.get("tenant", "default")}
        t0 = time.perf_counter()
        resp = encode_result(waiter[1])
        _observe_codec("encode", out, op,
                       (time.perf_counter() - t0) * 1e3, 0)
        return resp

    def handle_v2(self, conn: _Conn, rid: int, meta: dict,
                  sections: list, read_s: float = 0.0) -> None:
        """v2: decode, submit, register — never blocks the reader."""
        op = meta["op"]
        t0 = time.perf_counter()
        payload = wire.decode_payload(op, meta["payload"], sections)
        dec_ms = (time.perf_counter() - t0 + read_s) * 1e3
        nbytes = sum(s.nbytes for s in sections)
        shed = None
        with self._mu:
            out = self.server.submit(
                op, payload, deadline_ms=meta.get("deadline_ms"),
                tenant=meta.get("tenant", "default"),
                trace_id=meta.get("trace_id"),
                parent_span=meta.get("parent_span"))
            if isinstance(out, SolveResult):
                shed = out
            else:
                self._pending[out] = (conn, rid)
        _observe_codec("decode", rid if shed else out, op, dec_ms, nbytes)
        if shed is not None:
            self._reply_v2(conn, rid, shed)

    def _encode_reply(self, wire_rid: int, res: SolveResult) -> list:
        t0 = time.perf_counter()
        sw = wire.SectionWriter()
        meta = wire.encode_result(res, sw)
        bufs = wire.pack_frame(wire.FT_RESPONSE, wire_rid, meta, sw.arrays)
        _observe_codec("encode", res.rid, res.op,
                       (time.perf_counter() - t0) * 1e3,
                       sum(np.asarray(a).nbytes for a in sw.arrays))
        return bufs

    def _reply_v2(self, conn: _Conn, wire_rid: int,
                  res: SolveResult) -> None:
        try:
            conn.send_packed(self._encode_reply(wire_rid, res), wire_rid)
        except (ConnectionError, OSError):
            pass                     # client went away; result is dropped

    # -- drive modes

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self._poll_interval_s)
            self._wake.clear()
            self._sweep()
            self._job_tick()

    def _job_tick(self) -> None:
        """One long-job epoch in this idle gap (outside ``_mu``: the
        epoch runs while interactive submits keep landing, and the next
        ``_sweep`` drains them the moment the epoch yields — epoch
        boundaries ARE the preemption points).  Re-arms the wake event
        while job work remains so back-to-back idle gaps keep the job
        moving instead of waiting out the poll interval."""
        if self.server.jobs is None or self._stop.is_set():
            return
        try:
            if self.server.job_tick():
                self._wake.set()
        except Exception:             # noqa: BLE001 — never take down
            # the batcher thread; the executor already FAILed the job
            metrics.counter("jobs.tick_errors").inc()

    def _sweep(self) -> None:
        """Step until the queue is empty, delivering results."""
        while True:
            with self._mu:
                if not len(self.server.queue):
                    return
                if self.kill_guard:
                    maybe_kill_replica()
                results = self.server.step()
                self.batches += 1
                v2_out = self._deliver_locked(results)
            self._send_v2(v2_out)

    def pump(self) -> list[SolveResult]:
        """Caller-driven drive mode: one server step + delivery, then
        (with a job lane attached) one job epoch if the gap is idle."""
        with self._mu:
            results = self.server.step()
            v2_out = self._deliver_locked(results)
        self._send_v2(v2_out)
        self._job_tick()
        return results

    def _deliver_locked(self, results) -> list:
        """Match results to waiters; v2 sends happen outside the lock."""
        v2_out = []
        for res in results:
            waiter = self._pending.pop(res.rid, None)
            if waiter is None:
                continue
            if isinstance(waiter, list):      # v1: wake the conn thread
                waiter[1] = res
                waiter[0].set()
            else:                             # v2: write when unlocked
                v2_out.append((waiter, res))
        return v2_out

    def _send_v2(self, v2_out: list) -> None:
        """Deliver a sweep's responses: per connection, the whole
        batch's frames go out as ONE vectored write (a per-response
        ``sendmsg`` costs a syscall + a GIL bounce each — at batch 64
        that was most of the batcher's time).  Connections with a shm
        lane keep per-frame sends: each frame targets its own slot."""
        by_conn: dict = {}
        for (conn, wire_rid), res in v2_out:
            by_conn.setdefault(conn, []).append((wire_rid, res))
        for conn, items in by_conn.items():
            if conn.lane is not None or len(items) == 1:
                for wire_rid, res in items:
                    self._reply_v2(conn, wire_rid, res)
                continue
            bufs: list = []
            for wire_rid, res in items:
                bufs += self._encode_reply(wire_rid, res)
            try:
                with conn.wlock:
                    wire.send_buffers(conn.sock, bufs)
            except (ConnectionError, OSError):
                pass                 # client went away; results dropped

    def control(self, doc: dict) -> dict:
        kind = doc.get("control")
        if isinstance(kind, str) and kind.startswith("job-"):
            from . import jobs as jobs_mod

            if self.server.jobs is None:
                return {"ok": False,
                        "error": "no job lane on this server"}
            return jobs_mod.handle_control(self.server.jobs.store, doc)
        return super().control(doc)

    def stats(self) -> dict:
        with self._mu:
            out = {"queue_depth": len(self.server.queue),
                   "pending": len(self._pending),
                   "batches": self.batches,
                   "degraded": self.server.degraded}
        if self.server.jobs is not None:
            out["jobs"] = self.server.jobs.stats()
        return out


class StubSolveServer(FrameServer):
    """The rate gate's front end: the solve is a stub.  Every request is
    decoded, echoed, and re-encoded inline on its connection thread — no
    queue, no batcher, no device — so a closed-loop run against this
    server measures the transport alone: framing, codec, socket, and
    nothing else.  ``serve loadgen --transport self --stub-solve`` drives
    it as the transport's rate gate (``--min-rps``).  Replies for pipelined requests are
    batched per connection and flushed as one vectored write whenever
    the read buffer runs dry (:meth:`FrameServer._flush`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(host, port)
        self.served = 0
        # conn -> pending reply buffers; only ever touched by that
        # connection's own reader thread, so no lock
        self._replies: dict = {}

    def handle(self, doc: dict) -> dict:
        op = doc["op"]
        payload = decode_payload(op, doc["payload"])
        self.served += 1
        return encode_result(SolveResult(
            -1, op, OK, value=payload, rung="stub-solve",
            tenant=doc.get("tenant", "default")))

    def handle_v2(self, conn: _Conn, rid: int, meta: dict,
                  sections: list, read_s: float = 0.0) -> None:
        op = meta["op"]
        t0 = time.perf_counter()
        payload = wire.decode_payload(op, meta["payload"], sections)
        _observe_codec("decode", rid, op,
                       (time.perf_counter() - t0 + read_s) * 1e3,
                       sum(s.nbytes for s in sections))
        t0 = time.perf_counter()
        sw = wire.SectionWriter()
        out = wire.encode_result(
            SolveResult(rid, op, OK, value=payload, rung="stub-solve",
                        tenant=meta.get("tenant", "default")), sw)
        bufs = wire.pack_frame(wire.FT_RESPONSE, rid, out, sw.arrays)
        _observe_codec("encode", rid, op,
                       (time.perf_counter() - t0) * 1e3,
                       sum(np.asarray(a).nbytes for a in sw.arrays))
        self.served += 1
        self._replies.setdefault(conn, []).extend(bufs)

    def _flush(self, conn: _Conn) -> None:
        bufs = self._replies.pop(conn, None)
        if bufs:
            with conn.wlock:
                wire.send_buffers(conn.sock, bufs)

    def stats(self) -> dict:
        return {"served": self.served}


# ------------------------------------------------------------ client

#: process-wide connection sequence: rids restart at 1 per connection,
#: so the client-hop tail-sampling keys need a connection discriminator
#: to stay unique within the process
_CONN_SEQ = itertools.count(1)


class TransportClient:
    """Transport client; v2 (default) pipelines many requests over one
    connection and supports a same-host shared-memory lane, v1 is the
    first, blocking protocol (one request in flight, concurrency across
    connections).

    v2 surface: :meth:`submit` returns a request id immediately,
    :meth:`result` blocks for that id; :meth:`solve` is the pair.
    Constructed with ``on_response=`` the client runs in **callback
    mode** — responses are delivered to the callback on the receiver
    thread instead of parked for :meth:`result` (how a fleet sender
    pipelines to its replica), and ``on_error`` fires once when the
    connection dies with requests outstanding.
    """

    def __init__(self, addr: str, timeout_s: float = RESPONSE_TIMEOUT_S,
                 connect_timeout_s: float = 10.0, proto: int = 2,
                 shm: bool = False, shm_slots: int = 8,
                 shm_slot_bytes: int = 1 << 20,
                 on_response=None, on_error=None,
                 recv_thread: bool = True):
        host, port = parse_addr(addr)
        self.addr = addr
        self.timeout_s = timeout_s
        self._connect_timeout_s = connect_timeout_s
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout_s)
        self._mu = threading.Lock()
        self._rid = itertools.count(1)
        self._pending: dict[int, list] = {}   # rid -> [Event, payload]
        self._ctl: dict[int, list] = {}       # control rid -> [Event, doc]
        self._outbox: list = []               # corked (bufs, rid) pairs
        self._on_response = on_response
        self._on_error = on_error
        self._closing = False
        self._conn: _Conn | None = None
        self._sync = False
        self._conn_seq = next(_CONN_SEQ)
        self.clock_sync: trace.ClockSync | None = None
        self.proto = 1
        if proto >= 2:
            self._negotiate(host, port)
        if self.proto == 2:
            if shm:
                self._setup_shm(shm_slots, shm_slot_bytes)
            if recv_thread or on_response is not None or self.shm_active:
                self._sock.settimeout(None)
                t = threading.Thread(target=self._recv_loop,
                                     name="transport-client-recv",
                                     daemon=True)
                t.start()
                self._recv_thread = t
            else:
                # sync pipelined mode (``recv_thread=False``): the
                # calling thread parses response frames itself — no
                # receiver thread, no per-request Event/lock handoff.
                # Single-caller clients only (the closed-loop loadgen
                # hot path); shm lanes keep the threaded receiver for
                # doorbell handling.
                self._sync = True
                self._rd = wire.BufReader(self._sock)
                self._inflight: dict[int, dict] = {}
                self._parked: dict[int, tuple] = {}
                self._sock.settimeout(timeout_s)
        else:
            self._sock.settimeout(timeout_s)

    # -- handshake (synchronous, before the receiver thread exists)

    def _sync_control(self, doc: dict) -> dict:
        rid = next(self._rid)
        self._conn.send_v2(wire.FT_CONTROL, rid, doc)
        while True:
            first4 = wire.recv_exact(self._sock, 4)
            ftype, frid, meta, _ = wire.read_frame_rest(self._sock, first4)
            if ftype == wire.FT_CONTROL_REPLY and frid == rid:
                return meta

    def _negotiate(self, host: str, port: int) -> None:
        self._conn = _Conn(self._sock)
        try:
            hello = self._sync_control({"control": "hello",
                                        "proto": wire.VERSION})
            if hello.get("proto", 1) >= 2:
                self.proto = 2
                return
        except (ConnectionError, OSError, socket.timeout, ValueError):
            pass
        # a pre-v2 server choked on the binary hello: reconnect legacy
        self._conn = None
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = socket.create_connection(
            (host, port), timeout=self._connect_timeout_s)
        self.proto = 1

    def _setup_shm(self, slots: int, slot_bytes: int) -> None:
        from . import shm as shm_mod
        try:
            lane = shm_mod.create_client_lane(slots, slot_bytes)
        except Exception:
            return                    # no shm on this platform: sockets
        try:
            resp = self._sync_control({"control": "shm-setup",
                                       **shm_mod.setup_doc(lane)})
        except (ConnectionError, OSError, socket.timeout):
            lane.close()
            raise
        if resp.get("ok"):
            self._conn.lane = lane
        else:
            lane.close()

    # -- receiver (v2)

    def _recv_loop(self) -> None:
        err: Exception | None = None
        rd = wire.BufReader(self._sock)
        try:
            while True:
                first4 = rd.first4()
                if first4 is None:
                    break
                ftype, rid, meta, sections = wire.read_frame_rest(
                    rd, first4)
                if ftype == wire.FT_SHM:
                    lane = self._conn.lane
                    if lane is None:
                        raise wire.WireError("shm doorbell without a lane")
                    slot = int(meta["slot"])
                    ftype, rid, meta, sections = lane.read(
                        slot, int(meta["len"]))
                    self._conn.send_v2(wire.FT_CONTROL, 0,
                                       {"control": "shm-ack",
                                        "slot": slot})
                if ftype == wire.FT_CONTROL:
                    if meta.get("control") == "shm-ack" and self._conn.lane:
                        self._conn.lane.tx.ack(int(meta["slot"]))
                    continue
                if ftype == wire.FT_CONTROL_REPLY:
                    with self._mu:
                        waiter = self._ctl.pop(rid, None)
                    if waiter is not None:
                        waiter[1] = meta
                        waiter[0].set()
                    continue
                if ftype == wire.FT_RESPONSE:
                    self._dispatch_response(rid, meta, sections)
        except Exception as e:        # noqa: BLE001 - connection fate
            err = e
        finally:
            self._fail_all(err or
                           ConnectionError("server closed connection"))

    def _dispatch_response(self, rid: int, meta: dict,
                           sections: list) -> None:
        if self._on_response is not None:
            self._on_response(rid, meta, sections)
            return
        with self._mu:
            # left registered until result() consumes it — popping here
            # would race a result() call that hasn't looked yet
            waiter = self._pending.get(rid)
        if waiter is not None:
            waiter[1] = ("ok", meta, sections, time.perf_counter())
            waiter[0].set()

    def _fail_all(self, exc: Exception) -> None:
        with self._mu:
            dead = list(self._pending.values()) + list(self._ctl.values())
            self._pending.clear()
            self._ctl.clear()
            closing = self._closing
        for waiter in dead:
            waiter[1] = ("err", exc)
            waiter[0].set()
        if self._on_error is not None and not closing:
            self._on_error(exc)

    # -- sync pipelined mode (no receiver thread)

    def _read_sync(self) -> tuple[int, int, dict, list]:
        first4 = self._rd.first4()
        if first4 is None:
            raise ConnectionError("server closed connection")
        return wire.read_frame_rest(self._rd, first4)

    def _result_sync(self, rid: int) -> SolveResult:
        if self._outbox:
            self.flush()
        info = self._inflight.pop(rid, None)
        if info is None:
            raise KeyError(f"no outstanding request {rid}")
        hit = self._parked.pop(rid, None)
        while hit is None:
            ftype, frid, meta, sections = self._read_sync()
            if ftype != wire.FT_RESPONSE:
                continue              # control replies have their own loop
            if frid == rid:
                hit = (meta, sections, time.perf_counter())
            else:
                self._parked[frid] = (meta, sections,
                                      time.perf_counter())
        meta, sections, recv_s = hit
        t0 = time.perf_counter()
        res = wire.decode_result(meta, sections)
        hop = info.pop("_hop", None)
        info["decode_ms"] = (time.perf_counter() - t0) * 1e3
        if "sent_s" in info:
            info["rtt_ms"] = (recv_s - info.pop("sent_s")) * 1e3
        res.client = info
        self._finish_hop(hop, res=res)
        return res

    # -- request surface

    def next_rid(self) -> int:
        """Reserve a request id (callback-mode senders register their
        bookkeeping under it *before* the wire can answer)."""
        return next(self._rid)

    def submit_doc(self, doc: dict, sections=(),
                   rid: int | None = None) -> int:
        """Pipeline a pre-encoded request document (fleet forwarding:
        the payload's section refs pass through untouched)."""
        if self.proto != 2:
            raise RuntimeError("submit_doc requires a v2 connection")
        rid = next(self._rid) if rid is None else rid
        bufs = wire.pack_frame(wire.FT_REQUEST, rid, doc, sections)
        if self._sync:
            self._inflight[rid] = {}
        elif self._on_response is None:
            waiter = [threading.Event(), None, {}]
            with self._mu:
                self._pending[rid] = waiter
        self._conn.send_packed(bufs, rid)
        return rid

    def submit(self, op: str, payload, deadline_ms: float | None = None,
               tenant: str = "default",
               trace_id: str | None = None, flush: bool = True) -> int:
        """Encode and send one request; returns its id immediately.
        Many submits may be outstanding on this one connection.

        ``flush=False`` corks the frame instead of writing it: a burst
        of corked submits goes out as ONE vectored write on the next
        :meth:`flush` (or implicitly when :meth:`result` would block),
        which is how the closed-loop loadgen refills a deep pipeline
        window without paying one sendmsg per request."""
        if self.proto != 2:
            raise RuntimeError("submit/result pipelining requires v2; "
                               "use solve() on a v1 connection")
        t0 = time.perf_counter()
        rid = next(self._rid)
        tid = trace_id or trace.trace_id()
        # the client hop is the waterfall root: its id rides the wire as
        # ``parent_span`` so every downstream hop (route/dispatch/
        # replica/run) parents under it across process boundaries
        hop = trace.begin_span("serve.hop.client",
                               tail_key=f"c{self._conn_seq}.{rid}",
                               head_key=rid, rid=rid, op=op,
                               tenant=tenant, trace=tid)
        sw = wire.SectionWriter()
        doc = {"op": op, "payload": wire.encode_payload(op, payload, sw),
               "tenant": tenant, "trace_id": tid,
               "parent_span": hop.id}
        if deadline_ms is not None:
            doc["deadline_ms"] = deadline_ms
        bufs = wire.pack_frame(wire.FT_REQUEST, rid, doc, sw.arrays)
        enc_ms = (time.perf_counter() - t0) * 1e3
        info = {"encode_ms": enc_ms, "sent_s": time.perf_counter(),
                "_hop": hop}
        if self._sync:
            self._inflight[rid] = info
        else:
            waiter = [threading.Event(), None, info]
            with self._mu:
                self._pending[rid] = waiter
        if not flush:
            self._outbox.append((bufs, rid))
            return rid
        try:
            self._conn.send_packed(bufs, rid)
        except (ConnectionError, OSError):
            if self._sync:
                self._inflight.pop(rid, None)
            else:
                with self._mu:
                    self._pending.pop(rid, None)
            self._finish_hop(hop, error="ConnectionError")
            raise ConnectionError("server closed connection")
        return rid

    def flush(self) -> None:
        """Write every corked submit.  Socket path: all frames in one
        vectored send under one lock hold.  A negotiated shm lane keeps
        its per-frame slot/doorbell accounting instead."""
        if not self._outbox:
            return
        out, self._outbox = self._outbox, []
        try:
            if self._conn.lane is not None:
                for bufs, rid in out:
                    self._conn.send_packed(bufs, rid)
                return
            flat = [b for bufs, _ in out for b in bufs]
            if self._sync:
                self._flush_sync(flat)
                return
            with self._conn.wlock:
                wire.send_buffers(self._conn.sock, flat)
        except (ConnectionError, OSError):
            raise ConnectionError("server closed connection")

    def _flush_sync(self, bufs: list) -> None:
        """Deadlock-proof corked write for sync mode: with no receiver
        thread, a blocking send of a deep window can stall against the
        peer's own blocked response writes (both socket buffers full,
        neither side reading).  Send non-blocking and *drain* response
        frames into the parked set whenever the send buffer is full —
        consuming the response stream is what lets the peer resume
        reading our requests."""
        import select

        sock = self._conn.sock
        views = [v if isinstance(v, memoryview) else memoryview(v)
                 for v in bufs]
        views = [v for v in views if len(v)]
        sock.settimeout(0)            # non-blocking while flushing
        try:
            while views:
                readable, writable, _ = select.select(
                    [sock], [sock], [], self.timeout_s)
                if not readable and not writable:
                    raise TimeoutError("flush stalled")
                if readable and not writable:
                    sock.settimeout(self.timeout_s)
                    try:
                        ftype, frid, meta, sections = self._read_sync()
                    finally:
                        sock.settimeout(0)
                    if ftype == wire.FT_RESPONSE:
                        self._parked[frid] = (meta, sections,
                                              time.perf_counter())
                    continue
                try:
                    sent = sock.sendmsg(views[:512])
                except (BlockingIOError, InterruptedError):
                    continue
                while sent:
                    if sent >= len(views[0]):
                        sent -= len(views[0])
                        views.pop(0)
                    else:
                        views[0] = views[0][sent:]
                        sent = 0
        finally:
            sock.settimeout(self.timeout_s)

    def result(self, rid: int,
               timeout_s: float | None = None) -> SolveResult:
        """Block for one submitted request's result (any order)."""
        if self._sync:
            return self._result_sync(rid)
        if self._outbox:
            self.flush()     # corked submits must hit the wire first
        with self._mu:
            waiter = self._pending.get(rid)
        if waiter is None:
            raise KeyError(f"no outstanding request {rid}")
        ok = waiter[0].wait(self.timeout_s if timeout_s is None
                            else timeout_s)
        with self._mu:
            self._pending.pop(rid, None)
        if not ok:
            self._finish_hop(waiter[2].pop("_hop", None),
                             error="TimeoutError")
            raise TimeoutError(f"no response for request {rid}")
        kind = waiter[1][0]
        if kind == "err":
            self._finish_hop(waiter[2].pop("_hop", None),
                             error=type(waiter[1][1]).__name__)
            raise waiter[1][1]
        _, meta, sections, recv_s = waiter[1]
        t0 = time.perf_counter()
        res = wire.decode_result(meta, sections)
        info = dict(waiter[2])
        hop = info.pop("_hop", None)
        info["decode_ms"] = (time.perf_counter() - t0) * 1e3
        if "sent_s" in info:
            info["rtt_ms"] = (recv_s - info.pop("sent_s")) * 1e3
        res.client = info            # transport-side attribution
        self._finish_hop(hop, res=res)
        return res

    def _finish_hop(self, hop, res: SolveResult | None = None,
                    error: str | None = None) -> None:
        """End a ``serve.hop.client`` span and make its tail-sampling
        call: the client is the last hop to see the request, so the
        end-to-end keep/drop verdict (slow / shed / failed / requeued)
        lands here."""
        if hop is None:
            return
        if error is not None:
            ms, status, requeues = hop.end(error=error), FAILED, 0
        else:
            requeues = int((getattr(res, "hops", None) or {})
                           .get("requeues", 0) or 0)
            ms, status = hop.end(status=res.status), res.status
        if ms is None or hop.tail_key is None:
            return
        reason = trace.tail_keep_reason(status=status, latency_ms=ms,
                                        requeues=requeues)
        trace.tail_decide(hop.tail_key, keep=reason is not None,
                          reason=reason or "ok")

    def sync_clock(self, samples: int = 5) -> trace.ClockSync | None:
        """Estimate the server's wall-clock offset from ``samples`` ping
        round trips (midpoint-of-RTT, EWMA-smoothed) and record it as a
        ``clock-offset`` event — the edge ``trace waterfall`` uses to
        shift this peer's hops onto one timeline.  Returns the
        :class:`~..core.trace.ClockSync` (also kept on ``clock_sync``),
        or None when the peer predates the ``"t"`` ping field or the
        connection died mid-sync."""
        cs = trace.ClockSync()
        peer_pid = None
        for _ in range(max(1, int(samples))):
            t0 = time.time()
            try:
                resp = self.control("ping")
            except (ConnectionError, OSError, TimeoutError):
                return None
            t1 = time.time()
            if not resp.get("ok") or resp.get("t") is None:
                return None
            peer_pid = resp.get("pid")
            cs.update(t0, float(resp["t"]), t1)
        self.clock_sync = cs
        trace.record_event("clock-offset", peer_pid=peer_pid,
                           offset_ms=round(cs.offset_ms, 3),
                           err_ms=round(cs.err_ms, 3),
                           rtt_ms=round(cs.rtt_ms, 3),
                           samples=cs.samples)
        return cs

    def solve(self, op: str, payload, deadline_ms: float | None = None,
              tenant: str = "default",
              trace_id: str | None = None) -> SolveResult:
        if self.proto == 2:
            return self.result(self.submit(op, payload,
                                           deadline_ms=deadline_ms,
                                           tenant=tenant,
                                           trace_id=trace_id))
        rid = next(self._rid)
        tid = trace_id or trace.trace_id()
        hop = trace.begin_span("serve.hop.client",
                               tail_key=f"c{self._conn_seq}.{rid}",
                               head_key=rid, rid=rid, op=op,
                               tenant=tenant, trace=tid)
        doc = {"op": op, "payload": encode_payload(op, payload),
               "tenant": tenant, "trace_id": tid,
               "parent_span": hop.id}
        if deadline_ms is not None:
            doc["deadline_ms"] = deadline_ms
        try:
            res = decode_result(self.request(doc))
        except Exception as e:
            self._finish_hop(hop, error=type(e).__name__)
            raise
        self._finish_hop(hop, res=res)
        return res

    def request(self, doc: dict) -> dict:
        """One request doc -> one response doc.  v1: the blocking wire
        call.  v2: pipelined under the hood; section refs in the reply
        are inlined so the document is self-describing like v1's."""
        if self.proto == 2:
            if "control" in doc:
                return self.control(doc["control"],
                                    **{k: v for k, v in doc.items()
                                       if k != "control"})
            rid = self.submit_doc(doc)
            if self._sync:
                self._inflight.pop(rid, None)
                while True:
                    ftype, frid, meta, sections = self._read_sync()
                    if ftype == wire.FT_RESPONSE and frid == rid:
                        return wire.inline_sections(meta, sections)
                    if ftype == wire.FT_RESPONSE:
                        self._parked[frid] = (meta, sections,
                                              time.perf_counter())
            with self._mu:
                waiter = self._pending.get(rid)
            ok = waiter is not None and waiter[0].wait(self.timeout_s)
            with self._mu:
                self._pending.pop(rid, None)
            if not ok:
                raise TimeoutError(f"no response for request {rid}")
            if waiter[1][0] == "err":
                raise waiter[1][1]
            _, meta, sections, _ = waiter[1]
            return wire.inline_sections(meta, sections)
        with self._mu:
            send_frame(self._sock, doc)
            resp = recv_frame(self._sock)
        if resp is None:
            raise ConnectionError("server closed connection")
        return resp

    def control(self, kind: str, **fields) -> dict:
        if self.proto != 2:
            return self.request({"control": kind, **fields})
        if self._sync:
            if self._outbox:
                self.flush()
            rid = next(self._rid)
            self._conn.send_v2(wire.FT_CONTROL, rid,
                               {"control": kind, **fields})
            while True:
                ftype, frid, meta, sections = self._read_sync()
                if ftype == wire.FT_CONTROL_REPLY and frid == rid:
                    return meta
                if ftype == wire.FT_RESPONSE:
                    self._parked[frid] = (meta, sections,
                                          time.perf_counter())
        rid = next(self._rid)
        waiter = [threading.Event(), None]
        with self._mu:
            self._ctl[rid] = waiter
        self._conn.send_v2(wire.FT_CONTROL, rid,
                           {"control": kind, **fields})
        if not waiter[0].wait(self.timeout_s):
            with self._mu:
                self._ctl.pop(rid, None)
            raise TimeoutError(f"no reply to control {kind!r}")
        if isinstance(waiter[1], tuple) and waiter[1][0] == "err":
            raise waiter[1][1]
        return waiter[1]

    @property
    def shm_active(self) -> bool:
        return bool(self._conn is not None and self._conn.lane)

    def close(self) -> None:
        self._closing = True
        if self._conn is not None:
            self._conn.close()
        else:
            try:
                self._sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
