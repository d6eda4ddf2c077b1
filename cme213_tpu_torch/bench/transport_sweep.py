"""Transport bench: codec + wire throughput over msg size × lane × depth.

``python -m cme213_tpu_torch.bench.transport_sweep [--quick] [--out CSV]
[--assert-speedup F]``

Counterpart of ``cme213_tpu/bench/transport_sweep.py`` over the port's
``serve/wire.py`` and ``serve/transport.py`` (host code: no device is
touched).  Two sweeps, one CSV (``bench_results_torch/transport_sweep.csv``,
never the JAX package's ``bench_results/``; regression-gated like every
other sweep via ``bench/regress.py``):

- **codec** — pure in-memory encode+decode of one stub request at each
  message size, v1 spelling (JSON document with the array as a base64
  triple) vs v2 (binary frame, array bytes straight off
  ``ndarray.data``).  ``mbs`` here is the codec's own number: payload
  MB through one encode+decode round trip per second of CPU.
  ``--assert-speedup F`` exits 1 unless v2/v1 >= F at the largest size
  (``tests/test_torch_transport_sweep.py`` holds 5x at 1 MiB, as the
  JAX package's gate does).
- **wire** — closed-loop echo against an in-process
  :class:`~cme213_tpu_torch.serve.transport.StubSolveServer` over a loopback
  socket: v1 stop-and-wait, v2 at pipeline depths 1/8/32, and the
  shared-memory lane when the platform has one.  ``req_s`` is the
  request rate; ``mbs`` counts payload bytes both directions (the echo
  moves each byte twice).

Identity columns are ``sweep, lane, msg_bytes, depth``; metric columns
``ms, mbs, req_s`` (`regress.py` knows ``mbs``/``req_s`` are
higher-better).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np

from ..serve import wire
from . import RESULTS_DIR

#: where the CSV goes unless ``--out`` says otherwise
DEFAULT_OUT = f"{RESULTS_DIR}/transport_sweep.csv"

#: message sizes swept (bytes); the last one anchors the speedup gate
SIZES = (1 << 10, 1 << 16, 1 << 20)
QUICK_SIZES = (1 << 10, 1 << 20)


def _payload(n: int) -> np.ndarray:
    return np.random.default_rng(n).integers(
        0, 255, size=n).astype(np.uint8)


def _codec_v1_ms(arr: np.ndarray, iters: int) -> float:
    """One v1 encode+decode round trip: base64 triple inside a JSON
    document, the first protocol's spelling."""
    from ..serve.transport import decode_payload, encode_payload

    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        blob = json.dumps({"op": "stub",
                           "payload": encode_payload("stub", arr)})
        doc = json.loads(blob)
        out = decode_payload("stub", doc["payload"])
        best = min(best, time.perf_counter() - t0)
    assert out.tobytes() == arr.tobytes()
    return best * 1e3


def _codec_v2_ms(arr: np.ndarray, iters: int) -> float:
    """One v2 encode+decode round trip through the binary frame codec
    (pack to a contiguous blob, parse back, materialize the payload)."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        sw = wire.SectionWriter()
        doc = {"op": "stub", "payload": wire.encode_payload(
            "stub", arr, sw)}
        blob = wire.frame_bytes(wire.FT_REQUEST, 1, doc, sw.arrays)
        ftype, rid, meta, sections = wire.parse_frame(blob)
        out = wire.decode_payload("stub", meta["payload"], sections)
        best = min(best, time.perf_counter() - t0)
    assert out.tobytes() == arr.tobytes()
    return best * 1e3


def codec_sweep(sizes=SIZES, iters: int = 20) -> list[dict]:
    rows = []
    for n in sizes:
        arr = _payload(n)
        for lane, fn in (("v1json", _codec_v1_ms),
                         ("v2bin", _codec_v2_ms)):
            ms = fn(arr, iters)
            rows.append({"sweep": "codec", "lane": lane,
                         "msg_bytes": n, "depth": 1,
                         "ms": round(ms, 4),
                         "mbs": round(n / 1e6 / (ms / 1e3), 2),
                         "req_s": round(1e3 / ms, 1)})
    return rows


def _drive(addr: str, arr: np.ndarray, requests: int, depth: int,
           proto: int = 2, shm: bool = False) -> float:
    """Closed-loop echo of ``requests`` payloads; returns elapsed s."""
    from ..serve.transport import TransportClient

    client = TransportClient(addr, proto=proto, shm=shm,
                             recv_thread=bool(shm))
    try:
        gc.collect()
        gc.disable()
        t0 = time.perf_counter()
        if client.proto != 2 or depth <= 1:
            for _ in range(requests):
                res = client.solve("stub", arr)
                assert res.status == "ok", res.reason
        else:
            window: list[int] = []
            sent = 0
            while sent < requests or window:
                while sent < requests and len(window) < depth:
                    window.append(client.submit("stub", arr,
                                                flush=False))
                    sent += 1
                client.flush()
                for _ in range(min(len(window), max(1, depth // 2))):
                    res = client.result(window.pop(0))
                    assert res.status == "ok", res.reason
        return time.perf_counter() - t0
    finally:
        gc.enable()
        client.close()


def wire_sweep(sizes=SIZES, quick: bool = False) -> list[dict]:
    from ..serve.transport import StubSolveServer

    depths = (1, 32) if quick else (1, 8, 32)
    server = StubSolveServer().start()
    rows = []
    try:
        for n in sizes:
            arr = _payload(n)
            # enough requests to swamp connection setup, capped so the
            # 1 MiB x 32-deep cell stays CI-sized
            requests = max(50, min(2000, (8 << 20) // n))
            lanes = [("v1json", 1, False), ("v2bin", 2, False)]
            if sys.platform.startswith("linux"):
                lanes.append(("v2shm", 2, True))
            for lane, proto, shm in lanes:
                for depth in (1,) if proto == 1 else depths:
                    el = _drive(server.addr, arr, requests, depth,
                                proto=proto, shm=shm)
                    rows.append({
                        "sweep": "wire", "lane": lane, "msg_bytes": n,
                        "depth": depth,
                        "ms": round(el * 1e3 / requests, 4),
                        "mbs": round(2 * n * requests / 1e6 / el, 2),
                        "req_s": round(requests / el, 1)})
    finally:
        server.close()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--quick", action="store_true",
                    help="2 sizes, 2 depths — the CI shape")
    ap.add_argument("--codec-only", action="store_true",
                    help="skip the socket sweep (codec rows only)")
    ap.add_argument("--assert-speedup", type=float, default=None,
                    metavar="F",
                    help="exit 1 unless v2/v1 codec MB/s >= F at the "
                    "largest swept size")
    args = ap.parse_args(argv)

    sizes = QUICK_SIZES if args.quick else SIZES
    rows = codec_sweep(sizes, iters=5 if args.quick else 20)
    if not args.codec_only:
        rows += wire_sweep(sizes, quick=args.quick)

    for r in rows:
        print(f"{r['sweep']:>5} {r['lane']:>6} {r['msg_bytes']:>8} B "
              f"depth {r['depth']:>2}: {r['ms']:>9.3f} ms  "
              f"{r['mbs']:>9.2f} MB/s  {r['req_s']:>9.1f} req/s")

    if args.out:
        from .sweeps import write_csv

        write_csv(rows, args.out)
        print(f"wrote {args.out} ({len(rows)} rows)")

    if args.assert_speedup is not None:
        top = max(sizes)
        by_lane = {r["lane"]: r["mbs"] for r in rows
                   if r["sweep"] == "codec" and r["msg_bytes"] == top}
        ratio = by_lane["v2bin"] / by_lane["v1json"]
        ok = ratio >= args.assert_speedup
        print(f"codec speedup @ {top} B: {ratio:.1f}x "
              f"(gate {args.assert_speedup:.1f}x) "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
