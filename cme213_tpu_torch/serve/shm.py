"""Shared-memory frame lane for same-host transport clients.

Counterpart of ``cme213_tpu/serve/shm.py``; it moves bytes only and
imports no torch.

When client and server share a host — the fleet's own front-end →
replica dispatch is the canonical case — pushing megabyte payloads
through the loopback socket costs two kernel copies and a wakeup per
frame.  This lane moves the *bytes* through a ``multiprocessing.
shared_memory`` ring instead and keeps the socket for what it is good
at: ordering and readiness.  Each v2 frame that fits a slot is packed
into shared memory and announced by a tiny ``FT_SHM`` doorbell frame
over the existing connection; frames that don't fit (or when no slot
credit is free) fall back to plain socket frames transparently —
correctness never depends on the lane.

**Negotiation** (one control round-trip, client-initiated): the client
creates two segments — ``c2s`` (client writes) and ``s2c`` (server
writes) — and sends ``{"control": "shm-setup", "c2s": name, "s2c":
name, "slots": N, "slot_bytes": B}``.  A server that can attach both
replies ``{"ok": true}`` and the lane is live in both directions; any
failure leaves the connection on pure sockets.  The client owns the
segments' lifetime (creates and unlinks); the server only attaches.

**Credit scheme**: the writer holds one credit per slot.  A send takes
a credit, copies the packed frame in, and doorbells ``{"slot": i,
"len": n}``.  The receiver parses the frame *out* of the slot (arrays
are copied on parse — ``wire.parse_frame``) and returns the credit
with ``{"control": "shm-ack", "slot": i}`` riding the same socket.
Doorbells and ordinary frames share one ordered byte stream, so
mixed-lane traffic on a connection stays in submission order.
"""

from __future__ import annotations

import threading

from . import wire

#: lane defaults: 8 slots x 1 MiB covers the serving mix's payloads
#: (spmv 1k-float problems ~ tens of KiB) with room for pipelining
DEFAULT_SLOTS = 8
DEFAULT_SLOT_BYTES = 1 << 20


def _shared_memory():
    # imported lazily so platforms without it degrade to sockets
    from multiprocessing import shared_memory
    return shared_memory


def _unregister(name: str) -> None:
    """Detach a segment from this process's resource tracker: only the
    creating side owns cleanup, attachers must not unlink at exit."""
    try:    # pragma: no cover - tracker internals vary by version
        from multiprocessing import resource_tracker
        resource_tracker.unregister(f"/{name}", "shared_memory")
    except Exception:
        pass


def _register(name: str) -> None:
    """Re-register before an explicit unlink — ``unlink()`` always
    unregisters, and an attach in the *same* process (tests) would have
    already removed the tracker entry via :func:`_unregister`."""
    try:    # pragma: no cover - tracker internals vary by version
        from multiprocessing import resource_tracker
        resource_tracker.register(f"/{name}", "shared_memory")
    except Exception:
        pass


class ShmRing:
    """One direction of the lane: a slotted shared-memory segment.
    Purely memory — credits live with the writer (:class:`ShmTx`)."""

    def __init__(self, name: str | None = None,
                 slots: int = DEFAULT_SLOTS,
                 slot_bytes: int = DEFAULT_SLOT_BYTES,
                 create: bool = False):
        sm = _shared_memory()
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self.created = create
        if create:
            self.shm = sm.SharedMemory(create=True,
                                       size=self.slots * self.slot_bytes)
        else:
            self.shm = sm.SharedMemory(name=name)
            _unregister(self.shm.name)
        self.name = self.shm.name

    def slot_view(self, slot: int, length: int | None = None) -> memoryview:
        off = slot * self.slot_bytes
        end = off + (self.slot_bytes if length is None else length)
        return self.shm.buf[off:end]

    def close(self) -> None:
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass
        if self.created:
            try:
                _register(self.name)
                self.shm.unlink()
            except (OSError, FileNotFoundError):
                pass


class ShmTx:
    """Writer half: slot credits + frame copy-in.  ``try_send`` returns
    doorbell meta on success or None (no credit / frame too big), in
    which case the caller sends the frame over the socket instead."""

    def __init__(self, ring: ShmRing):
        self.ring = ring
        self._mu = threading.Lock()
        self._free = list(range(ring.slots))
        self.sent = 0          # frames through the lane
        self.fallbacks = 0     # frames that went to the socket instead

    def try_send(self, bufs: list) -> dict | None:
        total = wire.frame_nbytes(bufs)
        if total > self.ring.slot_bytes:
            with self._mu:
                self.fallbacks += 1
            return None
        with self._mu:
            if not self._free:
                self.fallbacks += 1
                return None
            slot = self._free.pop()
        view = self.ring.slot_view(slot)
        o = 0
        for b in bufs:
            mv = b if isinstance(b, memoryview) else memoryview(b)
            n = len(mv)
            view[o:o + n] = mv
            o += n
        with self._mu:
            self.sent += 1
        return {"slot": slot, "len": total}

    def ack(self, slot: int) -> None:
        with self._mu:
            if slot not in self._free:
                self._free.append(slot)

    def stats(self) -> dict:
        with self._mu:
            return {"sent": self.sent, "fallbacks": self.fallbacks,
                    "free": len(self._free), "slots": self.ring.slots}


class ShmLane:
    """Both directions of a negotiated lane, from either endpoint's
    point of view: ``tx`` is the ring this side writes (plus credits),
    ``rx`` the ring it parses doorbelled frames out of."""

    def __init__(self, tx_ring: ShmRing, rx_ring: ShmRing):
        self.tx = ShmTx(tx_ring)
        self.rx = rx_ring

    def read(self, slot: int, length: int):
        """Parse the frame a doorbell announced; the slot is free for
        the writer again the moment this returns (arrays were copied)."""
        view = self.rx.slot_view(slot, length)
        try:
            return wire.parse_frame(view)
        finally:
            view.release()

    def close(self) -> None:
        self.tx.ring.close()
        self.rx.close()


def create_client_lane(slots: int = DEFAULT_SLOTS,
                       slot_bytes: int = DEFAULT_SLOT_BYTES) -> ShmLane:
    """Client side: create both segments (the client owns unlink)."""
    c2s = ShmRing(slots=slots, slot_bytes=slot_bytes, create=True)
    try:
        s2c = ShmRing(slots=slots, slot_bytes=slot_bytes, create=True)
    except Exception:
        c2s.close()
        raise
    return ShmLane(tx_ring=c2s, rx_ring=s2c)


def attach_server_lane(setup: dict) -> ShmLane:
    """Server side: attach to the client's segments from an
    ``shm-setup`` control document.  Raises on any failure — the caller
    replies not-ok and the connection stays on sockets."""
    slots = int(setup["slots"])
    slot_bytes = int(setup["slot_bytes"])
    rx = ShmRing(name=setup["c2s"], slots=slots, slot_bytes=slot_bytes)
    try:
        tx = ShmRing(name=setup["s2c"], slots=slots,
                     slot_bytes=slot_bytes)
    except Exception:
        rx.close()
        raise
    return ShmLane(tx_ring=tx, rx_ring=rx)


def setup_doc(lane: ShmLane) -> dict:
    """The client's ``shm-setup`` control fields for ``lane``."""
    return {"c2s": lane.tx.ring.name, "s2c": lane.rx.name,
            "slots": lane.tx.ring.slots,
            "slot_bytes": lane.tx.ring.slot_bytes}
