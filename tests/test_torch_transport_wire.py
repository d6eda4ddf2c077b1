"""The port's v2 binary wire format and socket transport
(``cme213_tpu_torch/serve/{wire,shm,transport}.py``) on the CPU: the JAX
package's ``tests/test_transport_wire.py`` cases ported one for one, then
the cross-package checks: the same document and sections pack to the same
bytes in both packages, and a client of either package is served by a
server of the other over loopback (``stub`` and ``cipher``), every socket
with its own timeout.

v2 binary wire format: codec property tests and transport behavior.

The contract for the zero-copy framing (``serve/wire.py``):
every (dtype x shape) combination — 0-d scalars, empty arrays,
F-contiguous and strided views, explicit big-endian dtypes — must
round-trip **bitwise** through the binary sections, length fields must
be 8-byte (>2 GiB-safe), and the document codecs must accept both the
v2 ``__sec__`` refs and the legacy v1 ``__nd__`` base64 triples.  On
top of the codec: pipelining (many in-flight per connection, responses
out of order), protocol negotiation (v1 clients against a v2 server,
counted by ``transport.proto_v1``), and the shared-memory lane with
its socket fallback.
"""

import socket
import threading

import numpy as np
import pytest

from cme213_tpu_torch.core import metrics, trace
from cme213_tpu_torch.core.resilience import VirtualClock
from cme213_tpu_torch.serve import OK, Server
from cme213_tpu_torch.serve import wire
from cme213_tpu_torch.serve.loadgen import build_mix
from cme213_tpu_torch.serve.transport import (
    TransportClient,
    TransportServer,
    send_frame,
    recv_frame,
)
from cme213_tpu_torch.serve.workloads import ADAPTERS


@pytest.fixture(autouse=True)
def _clean_slate():
    trace.clear_events()
    metrics.reset()
    yield
    metrics.reset()


def _roundtrip_socket(arrays, meta=None):
    a, b = socket.socketpair()
    try:
        wire.send_buffers(a, wire.pack_frame(
            wire.FT_REQUEST, 42, meta or {}, arrays))
        first4 = wire.recv_exact(b, 4)
        return wire.read_frame_rest(b, first4)
    finally:
        a.close()
        b.close()


# ------------------------------------------------------------ sections

#: the fuzz matrix of the 0-d and endianness cases: every dtype
#: crossed with every shape, bitwise both ways
DTYPES = ("<f8", ">f8", "<f4", ">f4", "<i8", ">i4", "<u2", "|u1", "|b1",
          "<c16")
SHAPES = ((), (0,), (1,), (7,), (5, 3), (2, 0, 3), (2, 3, 4))


def _make(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape)) if shape else 1
    base = rng.integers(0, 100, size=max(n, 1))
    arr = base.astype(np.dtype(dtype))[:n].reshape(shape)
    return arr


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_section_roundtrip_bitwise_every_dtype_shape(dtype, shape):
    arr = _make(dtype, shape, seed=hash((dtype, shape)) % 2**16)
    ftype, rid, meta, sections = _roundtrip_socket([arr])
    assert (ftype, rid) == (wire.FT_REQUEST, 42)
    (back,) = sections
    assert back.dtype == arr.dtype          # byte order preserved
    assert back.shape == arr.shape          # incl. 0-d and empty dims
    assert back.tobytes() == arr.tobytes()


def test_section_roundtrip_noncontiguous_views():
    base = np.arange(48, dtype="<f8").reshape(6, 8)
    cases = [np.asfortranarray(base),        # F-contiguous
             base[::2, 1::3],                # strided view
             base.T]                         # transposed view
    ftype, _, _, sections = _roundtrip_socket(cases)
    for src, back in zip(cases, sections):
        assert back.shape == src.shape
        assert np.ascontiguousarray(src).tobytes() == back.tobytes()


def test_section_roundtrip_0d_keeps_0d():
    # the first protocol's edge: ascontiguousarray promotes () to (1,);
    # the binary layer must hand back a true 0-d
    for val in (np.float64(2.5), np.array(7, dtype=">i8")):
        _, _, _, (back,) = _roundtrip_socket([val])
        assert back.shape == ()
        assert back.tobytes() == np.asarray(val).tobytes()


def test_section_length_fields_are_2gib_safe():
    # descriptors carry nbytes as an unsigned 8-byte field and dims as
    # signed 8-byte ints: sizes past 2**31 survive the pack/unpack
    big = 5 * 2**31 + 13
    desc = wire._SECT.pack(3, 1, 0, big)
    dlen, ndim, flags, nbytes = wire._SECT.unpack(desc)
    assert nbytes == big
    assert wire._DIM.unpack(wire._DIM.pack(2**40))[0] == 2**40


def test_parse_frame_matches_socket_read():
    arrays = [np.arange(12, dtype="<i4").reshape(3, 4),
              np.array(1.5, dtype=">f8"), np.empty((0, 2), "<f4")]
    meta = {"op": "stub", "tenant": "t0", "nested": {"k": [1, 2.5]}}
    blob = wire.frame_bytes(wire.FT_RESPONSE, 7, meta, arrays)
    ftype, rid, m2, secs = wire.parse_frame(blob)
    assert (ftype, rid, m2) == (wire.FT_RESPONSE, 7, meta)
    for src, back in zip(arrays, secs):
        assert back.dtype == src.dtype and back.shape == src.shape
        assert back.tobytes() == src.tobytes()


def test_malformed_frames_raise_wire_error():
    good = bytearray(wire.frame_bytes(wire.FT_REQUEST, 1, {"op": "x"}))
    bad_magic = bytes([0xC3, 0x00]) + bytes(good[2:])
    with pytest.raises(wire.WireError, match="magic"):
        wire.parse_frame(bad_magic)
    bad_ver = bytearray(good)
    bad_ver[4] = 99
    with pytest.raises(wire.WireError, match="version"):
        wire.parse_frame(bytes(bad_ver))


# ------------------------------------------------------ document codecs

def test_decode_value_accepts_both_nd_and_sec():
    arr = np.arange(5, dtype="<f4")
    v1_doc = wire.encode_value(arr, wire.nd_b64)
    assert wire.decode_value(v1_doc).tobytes() == arr.tobytes()
    sw = wire.SectionWriter()
    v2_doc = wire.encode_value({"xs": [arr, 3]}, sw)
    got = wire.decode_value(v2_doc, sw.arrays)
    assert got["xs"][0].tobytes() == arr.tobytes() and got["xs"][1] == 3
    with pytest.raises(wire.WireError, match="__sec__"):
        wire.decode_value({"__sec__": 0})    # sectionless context


def test_v2_payload_roundtrip_every_op_bitwise():
    specs = build_mix("spmv,heat,cipher", 6, seed=3)
    for spec in specs:
        sw = wire.SectionWriter()
        doc = wire.encode_payload(spec.op, spec.payload, sw)
        back = wire.decode_payload(spec.op, doc, sw.arrays)
        if spec.op == "spmv_scan":
            for f in ("a", "s", "k", "x"):
                assert np.asarray(getattr(back, f)).tobytes() == \
                    np.ascontiguousarray(getattr(spec.payload, f)).tobytes()
        elif spec.op == "cipher":
            assert back.text.tobytes() == spec.payload.text.tobytes()
            assert back.shift == spec.payload.shift


def test_inline_sections_downgrades_sec_refs():
    arr = np.arange(4, dtype="<u2")
    sw = wire.SectionWriter()
    doc = {"value": wire.encode_value([arr], sw), "status": "ok"}
    flat = wire.inline_sections(doc, sw.arrays)
    assert "__nd__" in flat["value"]["__seq__"][0]
    assert wire.decode_value(flat["value"])[0].tobytes() == arr.tobytes()


# ------------------------------------------------------------ transport

def _cipher_server(**kw):
    server = Server(adapters=ADAPTERS, clock=VirtualClock(), max_batch=8,
                    device="cpu")
    kw.setdefault("poll_interval_s", 0.01)
    return TransportServer(server, drive="thread", **kw).start()


def test_pipelined_submits_resolve_out_of_order():
    ts = _cipher_server()
    try:
        specs = build_mix("cipher", 6, seed=9)
        with TransportClient(ts.addr, timeout_s=30.0) as c:
            assert c.proto == 2
            rids = [c.submit(s.op, s.payload) for s in specs]
            # resolve in reverse submission order on one connection
            results = {rid: c.result(rid) for rid in reversed(rids)}
        assert all(results[r].status == OK for r in rids)
        assert [results[r].rid for r in rids] == sorted(
            results[r].rid for r in rids)
        # client-side attribution rode along
        info = results[rids[0]].client
        assert info["encode_ms"] >= 0 and info["rtt_ms"] > 0
    finally:
        ts.close()


def test_v1_client_still_served_and_counted():
    ts = _cipher_server()
    try:
        spec = build_mix("cipher", 1, seed=4)[0]
        before = metrics.counter("transport.proto_v1").value
        with TransportClient(ts.addr, proto=1, timeout_s=30.0) as c:
            assert c.proto == 1
            res = c.solve(spec.op, spec.payload)
        assert res.status == OK
        assert metrics.counter("transport.proto_v1").value > before
        after_v1 = metrics.counter("transport.proto_v1").value
        # v2 clients leave the legacy counter alone
        with TransportClient(ts.addr, timeout_s=30.0) as c:
            assert c.solve(spec.op, spec.payload).status == OK
        assert metrics.counter("transport.proto_v1").value == after_v1
    finally:
        ts.close()


def test_hello_negotiation_reports_v2():
    ts = _cipher_server()
    try:
        with TransportClient(ts.addr, timeout_s=30.0) as c:
            pong = c.control("hello", proto=2)
            assert pong["ok"] and pong["proto"] == wire.VERSION
    finally:
        ts.close()


def test_codec_histograms_and_span_tags_populate():
    ts = _cipher_server()
    try:
        spec = build_mix("cipher", 1, seed=2)[0]
        with TransportClient(ts.addr, timeout_s=30.0) as c:
            assert c.solve(spec.op, spec.payload).status == OK
        snap = metrics.snapshot()["histograms"]
        assert snap["serve.request.decode_ms"]["count"] >= 1
        assert snap["serve.request.encode_ms"]["count"] >= 1
        names = {e["event"] for e in trace.events()}
        assert {"request-serialized", "request-deserialized"} <= names
    finally:
        ts.close()


def test_shm_lane_negotiates_and_serves_bitwise():
    ts = _cipher_server()
    try:
        specs = build_mix("cipher", 4, seed=13)
        with TransportClient(ts.addr, shm=True, timeout_s=30.0) as c:
            if not c.shm_active:
                pytest.skip("shared memory unavailable on this host")
            results = [c.solve(s.op, s.payload) for s in specs]
        assert all(r.status == OK for r in results)
        # same requests over plain sockets: bitwise-equal values
        with TransportClient(ts.addr, timeout_s=30.0) as c:
            refs = [c.solve(s.op, s.payload) for s in specs]
        for res, ref in zip(results, refs):
            assert np.asarray(res.value).tobytes() == \
                np.asarray(ref.value).tobytes()
    finally:
        ts.close()


def test_shm_oversized_frames_fall_back_to_socket():
    ts = _cipher_server()
    try:
        spec = build_mix("cipher", 1, seed=8)[0]
        with TransportClient(ts.addr, shm=True, shm_slots=2,
                             shm_slot_bytes=256, timeout_s=30.0) as c:
            if not c.shm_active:
                pytest.skip("shared memory unavailable on this host")
            res = c.solve(spec.op, spec.payload)   # payload > slot
            assert res.status == OK
            assert c._conn.lane.tx.fallbacks >= 1
    finally:
        ts.close()


def test_raw_v1_socket_frames_against_v2_server():
    # a hand-rolled legacy client: length-prefixed JSON, one in flight
    ts = _cipher_server()
    try:
        from cme213_tpu_torch.serve.transport import encode_payload
        spec = build_mix("cipher", 1, seed=5)[0]
        host, port = ts.addr.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=10) as s:
            send_frame(s, {"control": "ping"})
            assert recv_frame(s)["ok"] is True
            send_frame(s, {"op": spec.op,
                           "payload": encode_payload(spec.op, spec.payload),
                           "tenant": "legacy"})
            resp = recv_frame(s)
        assert resp["status"] == OK and resp["tenant"] == "legacy"
    finally:
        ts.close()


# -------------------------------------------------- across the packages

def _jwire():
    from cme213_tpu.serve import wire as jwire

    return jwire


@pytest.mark.parametrize("ftype", [1, 2, 3, 4, 5])
def test_frames_are_byte_identical_across_packages(ftype):
    """``pack_frame`` / ``frame_bytes`` of the same document and sections
    give the same bytes in both packages, and each parses the other's."""
    jwire = _jwire()
    arrays = [np.arange(12, dtype="<i4").reshape(3, 4),
              np.array(1.5, dtype=">f8"), np.empty((0, 2), "<f4"),
              np.asfortranarray(np.arange(6, dtype="<u2").reshape(2, 3)),
              np.arange(5, dtype="|u1")]
    meta = {"op": "stub", "tenant": "t0", "nested": {"k": [1, 2.5, None]},
            "trace_id": "abc", "parent_span": "s1"}
    ours = wire.frame_bytes(ftype, 99, meta, arrays)
    assert ours == jwire.frame_bytes(ftype, 99, meta, arrays)
    assert b"".join(bytes(b) for b in wire.pack_frame(
        ftype, 99, meta, arrays)) == ours
    for parse in (wire.parse_frame, jwire.parse_frame):
        t, rid, m, secs = parse(ours)
        assert (t, rid, m) == (ftype, 99, meta)
        assert [s.tobytes() for s in secs] == \
            [np.ascontiguousarray(a).tobytes() for a in arrays]


def test_documents_and_v1_frames_match_across_packages():
    """Payload and result documents (v1 base64 and v2 section refs) are
    the same JSON in both packages for every op of the mix."""
    import json

    from cme213_tpu.serve import loadgen as jloadgen
    from cme213_tpu.serve import transport as jtransport
    from cme213_tpu.serve.request import SolveResult as JResult
    from cme213_tpu_torch.serve import SolveResult
    from cme213_tpu_torch.serve import transport

    jwire = _jwire()
    mix = "spmv,heat,cipher,sort,stub"
    for spec, jspec in zip(build_mix(mix, 5, seed=6),
                           jloadgen.build_mix(mix, 5, seed=6)):
        v1 = transport.encode_payload(spec.op, spec.payload)
        assert json.dumps(v1, sort_keys=True) == json.dumps(
            jtransport.encode_payload(jspec.op, jspec.payload),
            sort_keys=True)
        sw, jsw = wire.SectionWriter(), jwire.SectionWriter()
        doc = wire.encode_payload(spec.op, spec.payload, sw)
        assert doc == jwire.encode_payload(jspec.op, jspec.payload, jsw)
        assert wire.frame_bytes(wire.FT_REQUEST, 3, {"op": spec.op,
                                                     "payload": doc},
                                sw.arrays) == \
            jwire.frame_bytes(wire.FT_REQUEST, 3, {"op": jspec.op,
                                                   "payload": doc},
                              jsw.arrays)
    value = np.arange(6, dtype=np.float32)
    kw = dict(rid=4, op="stub", status="ok", value=value, rung="echo",
              shape_class="n6", latency_ms=1.5, batch_size=2,
              tenant="t1", timing={"total_ms": 1.5}, trace_id="tr")
    sw, jsw = wire.SectionWriter(), jwire.SectionWriter()
    assert wire.encode_result(SolveResult(**kw), sw, replica=1) == \
        jwire.encode_result(JResult(**kw), jsw, replica=1)
    assert transport.encode_result(SolveResult(**kw)) == \
        jtransport.encode_result(JResult(**kw))


def test_codec_refuses_a_tensor_on_the_card():
    class CardTensor:
        is_cuda = True

        def __array__(self, dtype=None):
            raise AssertionError("never converted")

    with pytest.raises(TypeError, match="copy it to numpy"):
        wire.encode_value(CardTensor(), wire.nd_b64)
    torch = pytest.importorskip("torch")
    sw = wire.SectionWriter()
    doc = wire.encode_value(torch.arange(3), sw)
    assert wire.decode_value(doc, sw.arrays).tolist() == [0, 1, 2]


def _interop(server_addr, client_cls):
    """stub and cipher over one v2 connection and one v1 connection."""
    from cme213_tpu_torch.ops.elementwise import shift_cipher

    torch = pytest.importorskip("torch")
    specs = build_mix("stub,cipher", 6, seed=21)
    for proto in (2, 1):
        with client_cls(server_addr, proto=proto, timeout_s=30.0) as c:
            assert c.proto == proto
            for spec in specs:
                res = c.solve(spec.op, spec.payload, tenant="x")
                assert res.status == OK and res.tenant == "x"
                if spec.op == "stub":
                    assert np.asarray(res.value).tobytes() == \
                        spec.payload.tobytes()
                else:
                    ref = shift_cipher(torch.from_numpy(spec.payload.text),
                                       spec.payload.shift).numpy()
                    np.testing.assert_array_equal(res.value, ref)


def test_port_client_against_jax_server():
    from cme213_tpu.serve import Server as JServer
    from cme213_tpu.serve.transport import TransportServer as JTransport

    jts = JTransport(JServer(max_batch=8), drive="thread",
                     poll_interval_s=0.01).start()
    try:
        _interop(jts.addr, TransportClient)
        with TransportClient(jts.addr, timeout_s=30.0) as c:
            assert c.control("hello", proto=2)["proto"] == wire.VERSION
    finally:
        jts.close()


def test_jax_client_against_port_server():
    from cme213_tpu.serve.transport import TransportClient as JClient

    ts = _cipher_server()
    try:
        _interop(ts.addr, JClient)
        with JClient(ts.addr, timeout_s=30.0) as c:
            st = c.control("stats")["stats"]
        assert st["batches"] >= 1 and st["queue_depth"] == 0
    finally:
        ts.close()


def test_transport_server_runs_its_server_s_device_only(monkeypatch):
    """The batcher drives the card-backed ``Server``; a server built
    without a device and with no card refuses before any socket opens."""
    import torch

    from cme213_tpu_torch.core.errors import FrameworkError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FrameworkError):
        TransportServer(Server())
