"""v2 binary wire format: zero-copy frames for the serving transport.

Counterpart of ``cme213_tpu/serve/wire.py``, byte for byte the same
frames, so a client of either package talks to a server of the other.
Only numpy crosses the codec: the adapters copy a batch's results off the
card before they reach it, and a tensor that still lies on the card is
refused (:func:`encode_value`).

The first wire protocol shipped every request as 4-byte-length JSON with
numpy payloads as **base64** strings — three full copies of every array
(tobytes, b64encode, json.dumps) on each side of the wire.  At serving
rates the router burns more CPU en/decoding than the device spends
solving, which is the same disease the paper's kernels treat on-chip
(hw4's transpose staging through shared memory instead of strided
global loads; hw5's derived datatypes handing MPI the halo *in place*
instead of packing it).  This module is the transport-layer analog:
arrays travel as raw bytes straight off ``ndarray.data``, never through
an intermediate string.

**Frame layout** (all integers big-endian)::

    header   ">4sBBQII"   magic  version  ftype  rid  nsections  meta_len
    meta     meta_len bytes of UTF-8 JSON (control fields, op, tenant,
             timings — everything *small*; arrays never ride here)
    section  x nsections:
      desc   ">BBHQ"      dtype_len  ndim  flags  nbytes
      dtype  dtype_len ascii bytes (numpy ``dtype.str``: '<f8', '>i4',
             '|u1' — byte order always explicit, unlike ``str(dtype)``)
      shape  ndim x ">q"  (signed 8-byte dims: >2 GiB-safe, 0-d = no dims)
      bytes  nbytes raw C-contiguous array bytes

The first header byte (0xC3) can never begin a v1 frame — a v1 length
prefix of 0xC3xxxxxx would announce a >3 GiB JSON body — so a server
can peek 4 bytes and dispatch either protocol on the same port.  Arrays
inside a meta document are ``{"__sec__": i}`` references into the
frame's section table; the v1 ``{"__nd__": [dtype, shape, b64]}``
triple is still decoded for compatibility, so a v2 server accepts v1
payload documents unchanged.

**Span context on the wire.**  Request metas (v2) and request docs (v1)
carry two optional tracing fields: ``trace_id`` — the cross-process
trace the request belongs to — and ``parent_span`` — the sender's open
``serve.hop.*`` span id, which the receiving tier parents its own hop
under, so one request renders as one tree across client, front tier,
and replica (``trace waterfall``).  Response metas carry the
symmetrical extra ``hops`` — the front tier's per-hop residency
breakdown (wait/dispatch/requeue ms + requeue count) — which rides the
extras path below and lands on the client's result as ``res.hops``.

Write side: :func:`pack_frame` returns a *buffer list* (header bytes,
meta bytes, then alternating descriptors and live ``memoryview``s of
the arrays) pushed through ``socket.sendmsg`` by :func:`send_buffers` —
vectored I/O, no join, no copy.  Read side: :func:`read_frame_rest`
allocates each destination with ``np.empty(shape, dtype)`` and
``recv_into``s the payload directly into it.  :func:`parse_frame`
decodes the same layout from an in-memory buffer (the shared-memory
lane's slots, codec benches).
"""

from __future__ import annotations

import base64
import functools
import json
import socket
import struct

import numpy as np

#: first byte 0xC3 is unreachable as a v1 length prefix (see module doc)
MAGIC = b"\xc3WR2"
VERSION = 2

#: frame types
FT_REQUEST = 1        # op request; payload doc in meta, arrays in sections
FT_RESPONSE = 2       # SolveResult doc in meta, value arrays in sections
FT_CONTROL = 3        # ping / stats / hello / shm-setup / shm-ack
FT_CONTROL_REPLY = 4
FT_SHM = 5            # doorbell: the real frame lives in a shm ring slot

_HEAD = struct.Struct(">4sBBQII")   # magic, version, ftype, rid, nsec, meta_len
_SECT = struct.Struct(">BBHQ")      # dtype_len, ndim, flags, nbytes
_DIM = struct.Struct(">q")

HEAD_SIZE = _HEAD.size

#: sanity bounds a frame reader enforces before allocating anything
MAX_META_BYTES = 64 << 20
MAX_SECTIONS = 4096
MAX_NDIM = 32


class WireError(ConnectionError):
    """A malformed v2 frame (bad magic/version/bounds)."""


# ------------------------------------------------------------ raw I/O

def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Exactly ``n`` bytes or raise — EOF here is always mid-frame."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("EOF mid-frame")
        buf += chunk
    return buf


def recv_into_exact(sock: socket.socket, mv: memoryview) -> None:
    """Fill a writable byte view straight off the socket (no staging
    buffer — this is the zero-copy read half)."""
    got, n = 0, len(mv)
    while got < n:
        r = sock.recv_into(mv[got:], n - got)
        if r == 0:
            raise ConnectionError("EOF mid-frame")
        got += r


class BufReader:
    """Buffered frame reader over a socket: one ``recv`` pulls up to
    ``bufsize`` bytes and the many small exact reads a frame header
    needs (magic, head, meta, section descriptors) are served from the
    buffer — at serving rates the unbuffered path costs ~6 syscalls per
    frame, which is most of a pipelined request's CPU.  Large payload
    reads drain the buffer first, then ``recv_into`` the remainder
    straight into the destination array, so the zero-copy section path
    is preserved."""

    __slots__ = ("sock", "bufsize", "_buf", "_view", "_pos", "_end")

    def __init__(self, sock: socket.socket, bufsize: int = 1 << 16):
        self.sock = sock
        self.bufsize = bufsize
        self._buf = bytearray(bufsize)
        self._view = memoryview(self._buf)
        self._pos = 0
        self._end = 0

    def _fill(self) -> int:
        """One recv into the (empty) buffer; returns bytes read."""
        n = self.sock.recv_into(self._buf, self.bufsize)
        self._pos, self._end = 0, n
        return n

    def pending(self) -> int:
        """Bytes already buffered (0 means the next read may block —
        the moment to flush any batched writes)."""
        return self._end - self._pos

    def first4(self) -> bytes | None:
        """The 4 protocol-sniff bytes, or None on a clean EOF at a
        frame boundary."""
        if self._pos == self._end and self._fill() == 0:
            return None
        try:
            return self.recv_exact(4)
        except ConnectionError:
            return None

    def recv_exact(self, n: int) -> bytes:
        """Exactly ``n`` bytes or raise — EOF here is always mid-frame."""
        pos, end = self._pos, self._end
        if end - pos >= n:              # the hot path: already buffered
            self._pos = pos + n
            return bytes(self._buf[pos:pos + n])
        out = bytearray(self._buf[pos:end])
        self._pos = self._end = 0
        while len(out) < n:
            if n - len(out) >= self.bufsize:
                chunk = self.sock.recv(n - len(out))
                if not chunk:
                    raise ConnectionError("EOF mid-frame")
                out += chunk
            else:
                if self._fill() == 0:
                    raise ConnectionError("EOF mid-frame")
                take = min(n - len(out), self._end)
                out += self._buf[:take]
                self._pos = take
        return bytes(out)

    def recv_view(self, n: int):
        """A zero-copy view of the next ``n`` bytes when they are
        already buffered (valid until the next read), else the bytes
        from :meth:`recv_exact` — either way something ``struct`` can
        unpack without a staging copy on the hot path."""
        pos = self._pos
        if self._end - pos >= n:
            self._pos = pos + n
            return self._view[pos:pos + n]
        return self.recv_exact(n)

    def recv_into(self, mv: memoryview) -> None:
        """Fill a writable byte view: buffered bytes first, then
        ``recv_into`` the remainder directly (no staging copy)."""
        n = len(mv)
        have = min(n, self._end - self._pos)
        if have:
            mv[:have] = self._buf[self._pos:self._pos + have]
            self._pos += have
        got = have
        while got < n:
            r = self.sock.recv_into(mv[got:], n - got)
            if r == 0:
                raise ConnectionError("EOF mid-frame")
            got += r


def _src_exact(src, n: int) -> bytes:
    """Exact read off either a plain socket or a :class:`BufReader`."""
    return src.recv_exact(n) if isinstance(src, BufReader) \
        else recv_exact(src, n)


def send_buffers(sock: socket.socket, bufs: list) -> int:
    """Vectored write of a buffer list (``sendmsg``), looping on partial
    sends; falls back to one join+sendall where sendmsg is missing.
    Returns total bytes written."""
    total = 0
    if not hasattr(sock, "sendmsg"):    # pragma: no cover - non-POSIX
        blob = b"".join(bytes(b) for b in bufs)
        sock.sendall(blob)
        return len(blob)
    views = [b if isinstance(b, memoryview) else memoryview(b)
             for b in bufs]
    views = [v for v in views if len(v)]
    while views:
        sent = sock.sendmsg(views[:512])    # stay under IOV_MAX
        total += sent
        while sent:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0
    return total


# ------------------------------------------------------------ sections

def section_view(arr) -> tuple[str, tuple, np.ndarray]:
    """(dtype.str, caller shape, C-contiguous array) for one payload
    array.  The shape is captured *before* ``ascontiguousarray``, which
    promotes 0-d to (1,); ``dtype.str`` keeps byte order explicit."""
    a = np.asarray(arr)
    shape = a.shape
    a = np.ascontiguousarray(a)
    return a.dtype.str, shape, a


def _byte_view(a: np.ndarray) -> memoryview:
    # reshape(-1) is a free view on a C-contiguous array and turns 0-d
    # into (1,), which memoryview.cast('B') requires
    return memoryview(a.reshape(-1)).cast("B")


def pack_frame(ftype: int, rid: int, meta: dict,
               sections: list | tuple = ()) -> list:
    """Encode one frame as a buffer list for :func:`send_buffers`.
    ``sections`` are arrays (or anything ``np.asarray`` takes); their
    bytes ride as live memoryviews — nothing is copied here."""
    meta_b = json.dumps(meta).encode("utf-8")
    bufs = [None, meta_b]
    for arr in sections:
        dt, shape, a = section_view(arr)
        d = dt.encode("ascii")
        desc = (_SECT.pack(len(d), len(shape), 0, a.nbytes) + d
                + b"".join(_DIM.pack(s) for s in shape))
        bufs.append(desc)
        if a.nbytes:
            bufs.append(_byte_view(a))
    bufs[0] = _HEAD.pack(MAGIC, VERSION, ftype, rid, len(sections),
                         len(meta_b))
    return bufs


def frame_nbytes(bufs: list) -> int:
    return sum(len(b) if isinstance(b, (bytes, memoryview)) else
               memoryview(b).nbytes for b in bufs)


def frame_bytes(ftype: int, rid: int, meta: dict,
                sections: list | tuple = ()) -> bytes:
    """One contiguous blob of the frame (shm slots, codec benches)."""
    return b"".join(bytes(b) for b in
                    pack_frame(ftype, rid, meta, sections))


def send_frame_v2(sock: socket.socket, ftype: int, rid: int, meta: dict,
                  sections: list | tuple = ()) -> int:
    return send_buffers(sock, pack_frame(ftype, rid, meta, sections))


def _check_head(head: bytes) -> tuple[int, int, int, int]:
    magic, ver, ftype, rid, nsec, meta_len = _HEAD.unpack(head)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise WireError(f"unsupported wire version {ver}")
    if meta_len > MAX_META_BYTES or nsec > MAX_SECTIONS:
        raise WireError(f"frame bounds exceeded (meta={meta_len}, "
                        f"sections={nsec})")
    return ftype, rid, nsec, meta_len


def _check_sect(desc: bytes) -> tuple[int, int, int]:
    dlen, ndim, _flags, nbytes = _SECT.unpack(desc)
    if ndim > MAX_NDIM:
        raise WireError(f"section ndim {ndim} exceeds {MAX_NDIM}")
    return dlen, ndim, nbytes


def read_frame_rest(src, first4: bytes) -> tuple[int, int, dict, list]:
    """Finish reading a v2 frame whose first 4 bytes (the magic) were
    already consumed by protocol sniffing.  ``src`` is a socket or a
    :class:`BufReader`.  Returns ``(ftype, rid, meta, sections)`` with
    each section read straight into a freshly allocated array — one
    copy total, off the kernel buffer."""
    buffered = isinstance(src, BufReader)
    if buffered:
        # struct pieces come as zero-copy views into the read buffer;
        # only the json meta needs materialized bytes
        exact, view = src.recv_exact, src.recv_view
    else:
        exact = view = functools.partial(recv_exact, src)
    ftype, rid, nsec, meta_len = _check_head(first4
                                             + exact(HEAD_SIZE - 4))
    meta = json.loads(exact(meta_len)) if meta_len else {}
    sections = []
    for _ in range(nsec):
        dlen, ndim, nbytes = _check_sect(view(_SECT.size))
        dt = bytes(view(dlen)).decode("ascii")
        shape = struct.unpack(f">{ndim}q", view(ndim * 8))
        out = np.empty(shape, dtype=np.dtype(dt))
        if out.nbytes != nbytes:
            raise WireError(f"section length {nbytes} != "
                            f"{out.nbytes} for {dt}{shape}")
        if nbytes:
            if buffered:
                src.recv_into(_byte_view(out))
            else:
                recv_into_exact(src, _byte_view(out))
        sections.append(out)
    return ftype, rid, meta, sections


def parse_frame(buf) -> tuple[int, int, dict, list]:
    """Decode one frame from an in-memory buffer (a shm slot or a
    joined blob).  Arrays are **copied** out — the buffer is reusable
    the moment this returns."""
    mv = memoryview(buf)
    ftype, rid, nsec, meta_len = _check_head(bytes(mv[:HEAD_SIZE]))
    o = HEAD_SIZE
    meta = json.loads(bytes(mv[o:o + meta_len])) if meta_len else {}
    o += meta_len
    sections = []
    for _ in range(nsec):
        dlen, ndim, nbytes = _check_sect(bytes(mv[o:o + _SECT.size]))
        o += _SECT.size
        dt = bytes(mv[o:o + dlen]).decode("ascii")
        o += dlen
        shape = tuple(_DIM.unpack(bytes(mv[o + i * 8:o + i * 8 + 8]))[0]
                      for i in range(ndim))
        o += ndim * 8
        arr = np.frombuffer(mv[o:o + nbytes],
                            dtype=np.dtype(dt)).reshape(shape).copy()
        o += nbytes
        sections.append(arr)
    return ftype, rid, meta, sections


# ------------------------------------------------------ document codecs
#
# The value/payload/result codecs are shared between protocols via a
# pluggable array encoder ``nd(arr) -> doc``: v1 passes the base64
# triple encoder, v2 passes a SectionWriter that appends the array to
# the frame's section table and returns a {"__sec__": i} reference.
# Decoding accepts *both* spellings regardless of which protocol
# carried the document — that is the whole v1-compat story.

def nd_b64(arr) -> dict:
    """v1 array encoding: base64 triple (kept for legacy clients)."""
    dt, shape, a = section_view(arr)
    return {"__nd__": [dt, list(shape),
                       base64.b64encode(a.tobytes()).decode("ascii")]}


def nd_b64_decode(doc: dict) -> np.ndarray:
    dtype, shape, data = doc["__nd__"]
    return np.frombuffer(base64.b64decode(data),
                         dtype=np.dtype(dtype)).reshape(shape).copy()


class SectionWriter:
    """v2 array encoder: collects arrays into a frame section table."""

    def __init__(self):
        self.arrays: list = []

    def __call__(self, arr) -> dict:
        self.arrays.append(np.asarray(arr))
        return {"__sec__": len(self.arrays) - 1}


def encode_value(value, nd):
    """Wire-encode a result value: arrays via ``nd``, containers
    recurse, scalars pass through."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.ndarray):
        return nd(value)
    if isinstance(value, (np.generic,)):
        return nd(np.asarray(value))
    if isinstance(value, (list, tuple)):
        return {"__seq__": [encode_value(v, nd) for v in value]}
    if isinstance(value, dict):
        return {"__map__": {str(k): encode_value(v, nd)
                            for k, v in value.items()}}
    if getattr(value, "is_cuda", False):
        raise TypeError("a tensor on the card reaches the wire codec: "
                        "copy it to numpy first")
    if hasattr(value, "__array__"):     # a CPU tensor et al.
        return nd(np.asarray(value))
    return {"__repr__": repr(value)}


def decode_value(doc, sections=None):
    """Inverse of :func:`encode_value`; understands both the v1
    ``__nd__`` base64 triple and the v2 ``__sec__`` section ref."""
    if isinstance(doc, dict):
        if "__sec__" in doc:
            if sections is None:
                raise WireError("__sec__ ref outside a sectioned frame")
            return sections[doc["__sec__"]]
        if "__nd__" in doc:
            return nd_b64_decode(doc)
        if "__seq__" in doc:
            return [decode_value(v, sections) for v in doc["__seq__"]]
        if "__map__" in doc:
            return {k: decode_value(v, sections)
                    for k, v in doc["__map__"].items()}
        if "__repr__" in doc:
            return doc["__repr__"]
    return doc


def encode_payload(op: str, payload, nd) -> dict:
    """Per-op payload serialization; ops are the
    ``serve.workloads.ADAPTERS`` keys."""
    if op == "spmv_scan":
        return {"a": nd(payload.a), "s": nd(payload.s),
                "k": nd(payload.k), "x": nd(payload.x),
                "iters": int(payload.iters)}
    if op == "heat":
        return {k: getattr(payload, k)
                for k in ("nx", "ny", "lx", "ly", "alpha", "iters",
                          "order", "ic", "bc_top", "bc_left",
                          "bc_bottom", "bc_right")}
    if op == "cipher":
        return {"text": nd(payload.text), "shift": int(payload.shift)}
    if op == "sort":
        return {"keys": nd(payload)}
    if op == "stub":
        return {"x": nd(payload)}
    raise ValueError(f"no wire codec for op {op!r}")


def decode_payload(op: str, doc: dict, sections=None):
    if op == "spmv_scan":
        from ..apps.spmv_scan import Problem

        return Problem(a=decode_value(doc["a"], sections),
                       s=decode_value(doc["s"], sections),
                       k=decode_value(doc["k"], sections),
                       x=decode_value(doc["x"], sections),
                       iters=int(doc["iters"]))
    if op == "heat":
        from ..config import SimParams

        return SimParams(**{k: doc[k] for k in doc})
    if op == "cipher":
        from .workloads import CipherRequest

        return CipherRequest(text=decode_value(doc["text"], sections),
                             shift=int(doc["shift"]))
    if op == "sort":
        return decode_value(doc["keys"], sections)
    if op == "stub":
        return decode_value(doc["x"], sections)
    raise ValueError(f"no wire codec for op {op!r}")


RESULT_FIELDS = ("rid", "op", "status", "reason", "rung", "shape_class",
                 "latency_ms", "batch_size", "degraded", "tenant",
                 "timing", "trace_id")


def encode_result(res, nd, **extra) -> dict:
    doc = {f: getattr(res, f) for f in RESULT_FIELDS}
    doc["value"] = encode_value(res.value, nd)
    doc.update(extra)
    return doc


_RESULT_SKIP = frozenset(RESULT_FIELDS) | {"value"}


def decode_result(doc: dict, sections=None):
    from .request import SolveResult

    res = SolveResult(
        **{f: doc.get(f) for f in RESULT_FIELDS},
        value=decode_value(doc.get("value"), sections))
    # transport-level extras (e.g. which fleet replica served it) ride
    # as plain attributes; consumers use getattr(res, "replica", None)
    for k, v in doc.items():
        if k not in _RESULT_SKIP:
            setattr(res, k, v)
    return res


def inline_sections(doc, sections):
    """Rewrite a v2 document's ``__sec__`` refs as v1 ``__nd__``
    triples — the downgrade path at a mixed-protocol edge (a v2 replica
    answering a v1 client through the fleet front end)."""
    if isinstance(doc, dict):
        if "__sec__" in doc:
            return nd_b64(sections[doc["__sec__"]])
        return {k: inline_sections(v, sections) for k, v in doc.items()}
    if isinstance(doc, list):
        return [inline_sections(v, sections) for v in doc]
    return doc
