"""Deterministic load generator + SLO report for the serving front end.

Counterpart of ``cme213_tpu/serve/loadgen.py``: the same request
population (``build_mix``'s shapes unchanged), flags and report layout,
plus ``--device`` (the in-process server runs on ``cuda`` unless given
``--device=cpu``; with no card it raises ``FrameworkError``).  The
``fleet`` section reads any transport's ``stats`` control document, so it
works against a single ``TransportServer`` too.

``python -m cme213_tpu_torch serve loadgen`` drives a :class:`~.server.Server`
with a synthetic request population drawn from the hw workload mix and
reports what the paper's operator would ask of a serving tier: p50/p99
latency, throughput, shed rate, breaker transitions, batching occupancy.

Two arrival disciplines:

- **closed** (default): a fixed concurrency window — submit until the
  window is full, step, repeat.  Offered load adapts to service rate, so
  the run is CPU-deterministic (same seed → same batches) and measures
  steady-state behaviour: batching efficiency, latency distribution.
- **open**: arrivals ignore completions — requests land in bursts of
  ``--burst`` regardless of queue state.  Offered load over capacity is
  *guaranteed* to shed, which is the point: this is the overload smoke
  that proves backpressure refuses the excess instead of melting.

Fault clauses compose naturally: run under ``CME213_FAULTS=
"fail:serve.cipher.packed:1:4"`` and the report's ``breaker`` section
shows the open/half-open/close transitions; ``slow:serve.heat:50``
stretches the latency tail.  ``--baseline`` replays the same request
sequence through a ``max_batch=1`` server and reports the batched/serial
throughput ratio — the serving tier's reason to exist, measured.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..core import flight, metrics, numerics, trace
from ..core.metrics import _nearest_rank
from ..core.resilience import Clock
from . import slo as slo_mod
from .request import OK, SHED, FAILED, PHASES, RequestSpec
from .server import Server

#: ops the ``--mix`` flag accepts, comma-separated.  ``stub`` is the
#: transport-measurement op: the adapter echoes the payload with no torch
#: on the path, so a closed-loop run over it measures the wire + queue
#: cost alone (``--min-rps`` gates that rate).
MIX_OPS = ("spmv", "heat", "cipher", "sort", "stub")


def build_mix(mix: str, requests: int, seed: int = 0,
              deadline_ms: float | None = None,
              tenants: int = 1, stub_bytes: int = 1024) -> list[RequestSpec]:
    """The synthetic request population: ``requests`` specs cycling
    through the ops named in ``mix``, shapes chosen so that same-op
    requests recur in a handful of shape classes (batching has something
    to coalesce) without being identical payloads.  ``tenants`` > 1
    round-robins the specs over tenants ``t0..t{n-1}`` so per-tenant
    attribution has something to attribute."""
    ops = [o.strip() for o in mix.split(",") if o.strip()]
    unknown = [o for o in ops if o not in MIX_OPS]
    if unknown:
        raise ValueError(f"unknown mix op(s) {unknown} (choose from {MIX_OPS})")
    rng = np.random.default_rng(seed)
    specs: list[RequestSpec] = []
    for i in range(requests):
        op = ops[i % len(ops)]
        tenant = f"t{i % tenants}" if tenants > 1 else "default"
        if op == "spmv":
            from ..apps.spmv_scan import generate_problem

            n = (512, 1024)[(i // len(ops)) % 2]  # two shape classes
            prob = generate_problem(n, p=max(2, n // 64), q=n // 2,
                                    iters=6, seed=seed + i)
            specs.append(RequestSpec("spmv_scan", prob,
                                     deadline_ms=deadline_ms, tenant=tenant))
        elif op == "stub":
            # one shape class on purpose: every request batches with its
            # neighbours and the measured cost is pure transport + queue
            specs.append(RequestSpec(
                "stub", rng.integers(0, 255, size=stub_bytes)
                .astype(np.uint8),
                deadline_ms=deadline_ms, tenant=tenant))
        elif op == "sort":
            # two shape classes, like spmv: same-sized requests batch,
            # uint32 keys so every rung (lax/radix/bitonic) is eligible
            n = (512, 1024)[(i // len(ops)) % 2]
            specs.append(RequestSpec(
                "sort", rng.integers(0, 2**32, size=n, dtype=np.uint32),
                deadline_ms=deadline_ms, tenant=tenant))
        elif op == "heat":
            from ..config import SimParams

            params = SimParams(nx=24, ny=24, order=2, iters=4,
                               alpha=float(rng.uniform(0.5, 2.0)))
            specs.append(RequestSpec("heat", params,
                                     deadline_ms=deadline_ms, tenant=tenant))
        else:
            from .workloads import CipherRequest

            text = rng.integers(0, 200, size=4096).astype(np.uint8)
            specs.append(RequestSpec(
                "cipher", CipherRequest(text, int(rng.integers(0, 56))),
                deadline_ms=deadline_ms, tenant=tenant))
    return specs


def run_load(server: Server, specs: list[RequestSpec],
             mode: str = "closed", concurrency: int = 8,
             burst: int = 16, clock: Clock | None = None) -> dict:
    """Drive ``server`` with ``specs`` under the chosen arrival
    discipline; returns ``{"results": [...], "elapsed_s": float}``."""
    clock = clock if clock is not None else server.clock
    results = []
    t0 = clock.now()
    if mode == "closed":
        pending = list(specs)
        inflight = 0
        while pending or inflight:
            while pending and inflight < concurrency:
                spec = pending.pop(0)
                out = server.submit(spec.op, spec.payload,
                                    deadline_ms=spec.deadline_ms,
                                    tenant=spec.tenant)
                if isinstance(out, int):
                    inflight += 1
                else:
                    results.append(out)  # shed at submit
            stepped = server.step()
            inflight -= len(stepped)
            results.extend(stepped)
    elif mode == "open":
        pending = list(specs)
        while pending:
            for spec in pending[:burst]:
                out = server.submit(spec.op, spec.payload,
                                    deadline_ms=spec.deadline_ms,
                                    tenant=spec.tenant)
                if not isinstance(out, int):
                    results.append(out)
            pending = pending[burst:]
            results.extend(server.step())  # one service slot per burst
        results.extend(server.drain())
    else:
        raise ValueError(f"unknown mode {mode!r} (closed | open)")
    return {"results": results, "elapsed_s": clock.now() - t0}


def run_load_transport(addr: str, specs: list[RequestSpec],
                       mode: str = "closed", concurrency: int = 8,
                       burst: int = 16,
                       burst_interval_s: float = 0.005,
                       pipeline: int = 1) -> dict:
    """Drive a socket front end (``serve/transport.py`` — one server or
    a whole fleet) with **real concurrent client threads**, which the
    in-process :func:`run_load` cannot do.  Closed keeps ``concurrency``
    connections each with ``pipeline`` requests in flight (the v2
    submit/result window — ``pipeline=1`` degenerates to the blocking
    solve loop, which also covers v1 servers); open fires every
    request in its own thread, ``burst`` at a time, arrivals ignoring
    completions — genuine concurrent pressure on the accept path."""
    import threading
    import time as time_mod

    from .request import SolveResult
    from .transport import TransportClient

    results: list = []
    mu = threading.Lock()

    def _failed(spec: RequestSpec, err: Exception) -> SolveResult:
        return SolveResult(-1, spec.op, FAILED, reason="transport",
                           tenant=spec.tenant)

    t0 = time_mod.monotonic()
    if mode == "closed":
        remaining = list(specs)

        def _take(k: int) -> list[RequestSpec]:
            with mu:
                out, remaining[:k] = remaining[:k], []
                return out

        def worker() -> None:
            client = None
            window: list[tuple[int, RequestSpec]] = []  # (rid, spec) FIFO
            batch: list[RequestSpec] = []               # taken, not sent

            def settle_many(rs: list) -> None:
                with mu:
                    results.extend(rs)

            while True:
                try:
                    if not batch and not window:
                        batch = _take(max(1, pipeline))
                        if not batch:
                            break
                    if client is None:
                        # sync pipelined mode: this worker is the only
                        # caller, so it parses responses itself instead
                        # of paying a receiver-thread handoff per request
                        client = TransportClient(addr, recv_thread=False)
                    if client.proto != 2 or pipeline <= 1:
                        # stop-and-wait (the only v1 option)
                        spec = batch.pop(0)
                        settle_many([client.solve(
                            spec.op, spec.payload,
                            deadline_ms=spec.deadline_ms,
                            tenant=spec.tenant)])
                        continue
                    # sliding window: fill to depth (submits corked,
                    # one vectored write for the whole refill), then
                    # retire the oldest half — ``pipeline`` requests
                    # ride one connection and the syscall + lock count
                    # is ~2/chunk, not 2/request
                    while len(window) < pipeline:
                        if not batch:
                            batch = _take(pipeline - len(window))
                            if not batch:
                                break
                        spec = batch.pop(0)
                        window.append((client.submit(
                            spec.op, spec.payload,
                            deadline_ms=spec.deadline_ms,
                            tenant=spec.tenant, flush=False), spec))
                    client.flush()
                    done = []
                    for _ in range(min(len(window),
                                       max(1, pipeline // 2))):
                        rid, _ = window[0]
                        done.append(client.result(rid))
                        window.pop(0)
                    settle_many(done)
                except (OSError, ConnectionError, ValueError,
                        TimeoutError, KeyError) as e:
                    if client is not None:
                        client.close()
                        client = None
                    # everything on the dead connection fails, plus one
                    # unsent spec so a dead server can't spin this loop;
                    # the rest of the unsent batch goes back in the pool
                    dead = [_failed(lost, e) for _, lost in window]
                    window = []
                    if batch:
                        dead.append(_failed(batch.pop(0), e))
                        if batch:
                            with mu:
                                remaining[:0] = batch
                            batch = []
                    settle_many(dead)
            if client is not None:
                client.close()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, min(concurrency, len(specs))))]
    elif mode == "open":
        def fire(spec: RequestSpec) -> None:
            try:
                with TransportClient(addr) as client:
                    res = client.solve(spec.op, spec.payload,
                                       deadline_ms=spec.deadline_ms,
                                       tenant=spec.tenant)
            except (OSError, ConnectionError, ValueError) as e:
                res = _failed(spec, e)
            with mu:
                results.append(res)

        threads = [threading.Thread(target=fire, args=(spec,), daemon=True)
                   for spec in specs]
    else:
        raise ValueError(f"unknown mode {mode!r} (closed | open)")

    # gc pauses inside the drive window read as multi-ms latency spikes
    # that have nothing to do with the transport under test; collect
    # once up front, then hold gc off until the window closes
    import gc
    gc.collect()
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        if mode == "open":
            # arrivals ignore completions: launch in bursts, never wait
            for i, t in enumerate(threads):
                t.start()
                if burst and (i + 1) % burst == 0:
                    time_mod.sleep(burst_interval_s)
        else:
            for t in threads:
                t.start()
        for t in threads:
            t.join()
    finally:
        if gc_was_on:
            gc.enable()
    return {"results": results, "elapsed_s": time_mod.monotonic() - t0}


def fleet_section(run: dict, addr: str) -> dict:
    """The SLO report's ``fleet`` section for a ``--transport`` run:
    which replicas served (stamped on each wire response), plus the
    front tier's own routing stats via a ``stats`` control frame."""
    from .transport import TransportClient

    seen = sorted({r.replica for r in run["results"]
                   if getattr(r, "replica", None) is not None})
    section: dict = {"replicas_seen": [f"r{n}" for n in seen]}
    try:
        with TransportClient(addr, timeout_s=5.0) as client:
            stats = client.control("stats").get("stats") or {}
    except (OSError, ConnectionError, ValueError):
        stats = {}
    for key in ("replicas_up", "requeues", "scale_ups", "scale_downs",
                "occupancy", "backlog", "replicas", "flight_confirmed"):
        if key in stats:
            section[key] = stats[key]
    return section


def transport_section(run: dict, before: dict, after: dict) -> dict:
    """The SLO report's ``transport`` subsection: where a wire request's
    milliseconds actually went.  Client-side attribution rides each
    result (``res.client`` — encode/decode ms and the submit→response
    RTT measured at the socket); server-side codec cost comes from the
    ``serve.request.encode_ms``/``decode_ms`` histograms the transport
    layer feeds (the same numbers ``trace summary`` renders).  The
    honest-measurement gate reads ``codec_share``: the p99 of per-request
    client encode+decode as a fraction of the p99 RTT — transport framing
    is an overhead and must price like one."""
    infos = [r.client for r in run["results"]
             if getattr(r, "client", None)]
    enc = [i["encode_ms"] for i in infos if "encode_ms" in i]
    dec = [i["decode_ms"] for i in infos if "decode_ms" in i]
    rtt = [i["rtt_ms"] for i in infos if "rtt_ms" in i]
    codec = [i.get("encode_ms", 0.0) + i.get("decode_ms", 0.0)
             for i in infos]
    # wire + queue time: RTT minus the server's own request clock (the
    # timing breakdown every served result carries)
    overhead = [r.client["rtt_ms"] - r.timing["total_ms"]
                for r in run["results"]
                if getattr(r, "client", None)
                and "rtt_ms" in r.client
                and r.timing and r.timing.get("total_ms") is not None]

    d = metrics.delta(before, after)
    bh, ah = before.get("histograms", {}), after.get("histograms", {})

    def hist_delta(name: str) -> dict | None:
        h, p = ah.get(name), bh.get(name) or {}
        if not h:
            return None
        n = int(h.get("count", 0)) - int(p.get("count", 0))
        if n <= 0:
            return None
        s = float(h.get("sum") or 0.0) - float(p.get("sum") or 0.0)
        return {"count": n, "mean": round(s / n, 4)}

    section = {
        "client": {"encode_ms": _pcts(enc), "decode_ms": _pcts(dec),
                   "rtt_ms": _pcts(rtt)},
        "server": {"encode_ms": hist_delta("serve.request.encode_ms"),
                   "decode_ms": hist_delta("serve.request.decode_ms")},
        "transport_ms": _pcts(overhead),
        "proto_v1_frames": d["counters"].get("transport.proto_v1", 0),
    }
    codec_p = _pcts(codec)
    rtt_p = _pcts(rtt)
    if codec_p and rtt_p and rtt_p["p99"]:
        section["codec_share"] = round(codec_p["p99"] / rtt_p["p99"], 4)
    return section


def _waterfall_segments(rtt_ms: float, hops: dict, timing: dict) -> dict:
    """Decompose one wire request's RTT into disjoint hop segments:
    client wire+codec, front-tier residency (DRR wait + requeue detours),
    replica-side waiting (queue/admit/batch-wait), and the kernel run.
    Segments a layer didn't report (e.g. no front tier on a single
    TransportServer) are None, not zero."""
    total = timing.get("total_ms")
    route = hops.get("route_ms")
    dispatch = hops.get("dispatch_ms")
    inner = route if route is not None else total
    wire = round(max(0.0, rtt_ms - inner), 3) if inner is not None else None
    front = (round(max(0.0, route - dispatch), 3)
             if route is not None and dispatch is not None else None)
    waits = [timing.get(k) for k in ("queue_ms", "admit_ms",
                                     "batch_wait_ms")]
    replica_wait = (round(sum(w for w in waits if w is not None), 3)
                    if any(w is not None for w in waits) else None)
    return {"wire_ms": wire, "front_ms": front,
            "replica_wait_ms": replica_wait,
            "run_ms": timing.get("run_ms")}


def waterfall_section(run: dict, before: dict, after: dict) -> dict:
    """The SLO report's ``waterfall`` section for a ``--transport`` run:
    per-segment latency percentiles from the hop breakdown each response
    carries (``res.hops`` — the front tier's route/dispatch/requeue
    residency — joined with the replica's phase timing), a decomposition
    of the p99-RTT request naming its **dominant** hop, and the
    tail-sampling counters that prove the post-hoc drop rate."""
    rows = []
    for r in run["results"]:
        info = getattr(r, "client", None) or {}
        rtt = info.get("rtt_ms")
        if rtt is None:
            continue
        rows.append((rtt, _waterfall_segments(
            rtt, getattr(r, "hops", None) or {}, r.timing or {})))
    section: dict = {}
    if rows:
        hops_p: dict[str, dict] = {}
        for key in ("wire_ms", "front_ms", "replica_wait_ms", "run_ms"):
            p = _pcts(seg.get(key) for _, seg in rows)
            if p is not None:
                hops_p[key] = p
        if hops_p:
            section["hops"] = hops_p
        rows.sort(key=lambda x: x[0])
        # nearest-rank p99 row: sorted[ceil(0.99 * n) - 1]
        rtt, seg = rows[min(len(rows) - 1,
                            max(0, -(-99 * len(rows)) // 100 - 1))]
        present = {k: v for k, v in seg.items() if v is not None}
        section["p99"] = {
            "rtt_ms": round(rtt, 3),
            "segments": present,
            "dominant": (max(present, key=present.get)
                         if present else None),
        }
    d = metrics.delta(before, after)["counters"]
    kept = d.get("trace.sampling.kept", 0)
    dropped = d.get("trace.sampling.dropped", 0)
    if d.get("trace.sampling.buffered", 0) or kept or dropped:
        section["sampling"] = {
            "buffered": d.get("trace.sampling.buffered", 0),
            "kept": kept,
            "dropped": dropped,
            "keep_rate": (round(kept / (kept + dropped), 4)
                          if kept + dropped else None),
            "kept_by_reason": {
                k[len("trace.sampling.kept."):]: v for k, v in d.items()
                if k.startswith("trace.sampling.kept.")},
        }
    return section


def compile_attribution(before: dict, after: dict) -> dict:
    """Per-shape-class compile-vs-run attribution from the metrics delta:
    how much of the pass went to (re)tracing (``compile.<op>.<class>.ms``)
    vs executing (``run.<op>.<class>.ms``), plus the retrace count and the
    program cache's hit/miss counts.  ``compile_share`` near zero is the
    warmed steady state the program cache exists to reach."""
    bh, ah = before.get("histograms", {}), after.get("histograms", {})
    bc, ac = before.get("counters", {}), after.get("counters", {})

    def counter_delta(name: str) -> int:
        return int(ac.get(name, 0)) - int(bc.get(name, 0))

    per_class: dict[str, dict] = {}
    totals = {"compile": 0.0, "run": 0.0}
    for name, h in ah.items():
        for kind, ms_key, n_key in (("compile", "compile_ms", "compiles"),
                                    ("run", "run_ms", "runs")):
            if not (name.startswith(kind + ".") and name.endswith(".ms")):
                continue
            key = name[len(kind) + 1:-3]
            prev = bh.get(name) or {}
            d_ms = float(h.get("sum") or 0.0) - float(prev.get("sum") or 0.0)
            d_n = int(h.get("count", 0)) - int(prev.get("count", 0))
            if d_n <= 0:
                continue
            row = per_class.setdefault(
                key, {"compile_ms": 0.0, "compiles": 0,
                      "run_ms": 0.0, "runs": 0})
            row[ms_key] = round(row[ms_key] + d_ms, 3)
            row[n_key] += d_n
            totals[kind] += d_ms
    total = totals["compile"] + totals["run"]
    return {
        "per_class": per_class,
        "compile_ms": round(totals["compile"], 3),
        "run_ms": round(totals["run"], 3),
        "compile_share": round(totals["compile"] / total, 4) if total else 0.0,
        "retraces": counter_delta("compile.retraces"),
        "cache_hits": counter_delta("programs.hits"),
        "cache_misses": counter_delta("programs.misses"),
    }


def submit_job_over(addr: str, args) -> dict:
    """Submit the ``--job`` long job over the transport's control
    channel before the interactive load starts (idempotent: a duplicate
    submit adopts the existing record)."""
    from .transport import TransportClient

    params = {"nodes": args.job_nodes, "iters": args.job_iters,
              "epoch": args.job_epoch}
    with TransportClient(addr, timeout_s=10.0) as client:
        reply = client.control("job-submit", job=args.job, op=args.job_op,
                               params=params)
    if not reply.get("ok"):
        return {"submitted": False, "error": reply.get("error")}
    return {"submitted": True, "created": reply.get("created"),
            "job": reply.get("job")}


def wait_job_over(addr: str, args, section: dict) -> dict:
    """After the load pass: poll ``--job`` until it is terminal (or the
    ``--job-wait-s`` budget runs out) and return the report section —
    the durable record's final public view plus how it got there."""
    import time as time_mod

    from .transport import TransportClient

    out = {"job": args.job, "op": args.job_op,
           "submitted": section.get("submitted", False),
           "created": section.get("created")}
    if not section.get("submitted"):
        out["state"] = None
        out["error"] = section.get("error", "submit failed")
        return out
    deadline = time_mod.monotonic() + args.job_wait_s
    rec = None
    while time_mod.monotonic() < deadline:
        try:
            with TransportClient(addr, timeout_s=10.0) as client:
                reply = client.control("job-status", job=args.job)
        except (OSError, ConnectionError, ValueError):
            time_mod.sleep(0.25)
            continue
        rec = reply.get("job") if reply.get("ok") else None
        if rec and rec["state"] in ("DONE", "FAILED", "STALLED"):
            break
        time_mod.sleep(0.25)
    if rec is None:
        out["state"] = None
        out["error"] = "status unavailable"
        return out
    out.update({k: rec.get(k) for k in
                ("state", "epoch", "total_epochs", "iters", "total_iters",
                 "residual", "resumes", "preemptions", "reason")})
    if rec["state"] not in ("DONE", "FAILED", "STALLED"):
        out["error"] = f"not terminal after {args.job_wait_s}s"
    return out


def _pcts(values) -> dict | None:
    """{p50, p99} by nearest rank, or None with no samples."""
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    return {"p50": round(_nearest_rank(vals, 0.50), 3),
            "p99": round(_nearest_rank(vals, 0.99), 3)}


def phase_attribution(served) -> dict:
    """Per-op (plus ``overall``) p50/p99 for each lifecycle phase, from
    the served results' ``timing`` breakdowns."""
    by_op: dict[str, list] = {}
    for r in served:
        if r.timing:
            by_op.setdefault(r.op, []).append(r.timing)
    out: dict[str, dict] = {}
    groups = {"overall": [t for ts in by_op.values() for t in ts], **by_op}
    for group, timings in groups.items():
        row = {}
        for phase in PHASES + ("total",):
            p = _pcts(t.get(f"{phase}_ms") for t in timings)
            if p is not None:
                row[phase] = p
        if row:
            out[group] = row
    return out


def tenant_attribution(results) -> dict:
    """Per-tenant request accounting + served-latency percentiles."""
    out: dict[str, dict] = {}
    for r in results:
        row = out.setdefault(r.tenant, {"requests": 0, "served": 0,
                                        "shed": 0, "failed": 0,
                                        "_lat": []})
        row["requests"] += 1
        if r.status == OK:
            row["served"] += 1
            if r.latency_ms is not None:
                row["_lat"].append(r.latency_ms)
        elif r.status == SHED:
            row["shed"] += 1
        else:
            row["failed"] += 1
    for row in out.values():
        row["latency_ms"] = _pcts(row.pop("_lat"))
    return out


def slo_report(run: dict, before: dict, after: dict, slo=None) -> dict:
    """The SLO view of a :func:`run_load` run: latency percentiles over
    served requests, throughput, shed accounting, breaker transitions,
    per-phase and per-tenant attribution — computed from the results plus
    the metrics-registry delta (the same numbers ``trace summary`` reads
    from the trace file)."""
    results = run["results"]
    served = [r for r in results if r.status == OK]
    shed = [r for r in results if r.status == SHED]
    failed = [r for r in results if r.status == FAILED]
    lat = sorted(r.latency_ms for r in served if r.latency_ms is not None)

    def pct(q):
        v = _nearest_rank(lat, q)
        return None if v is None else round(v, 3)

    d = metrics.delta(before, after)
    counters = d["counters"]
    shed_by_reason: dict[str, int] = {}
    for r in shed:
        shed_by_reason[r.reason] = shed_by_reason.get(r.reason, 0) + 1
    elapsed = run["elapsed_s"]
    sizes = [r.batch_size for r in served if r.batch_size]
    return {
        # the process-spanning trace id this session's records carry —
        # inherited from a launcher when run under one, so the report is
        # joinable against the merged gang trace
        "trace_id": trace.trace_id(),
        "requests": len(results),
        "served": len(served),
        "shed": len(shed),
        "failed": len(failed),
        "shed_rate": round(len(shed) / len(results), 4) if results else 0.0,
        "shed_by_reason": shed_by_reason,
        "latency_ms": {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
                       "max": round(lat[-1], 3) if lat else None},
        "elapsed_s": round(elapsed, 4),
        "throughput_rps": (round(len(served) / elapsed, 2)
                           if elapsed > 0 else None),
        "batches": counters.get("serve.batches", 0),
        "batch_mean_size": (round(sum(sizes) / len(sizes), 2)
                            if sizes else None),
        "degraded_served": sum(1 for r in served if r.degraded),
        "breaker": {
            "opened": counters.get("breaker.open", 0),
            "half_open": counters.get("breaker.half_open", 0),
            "closed": counters.get("breaker.close", 0),
            "skipped": counters.get("breaker.skipped", 0),
        },
        "demotions": counters.get("fallback.demotions", 0),
        "compile": compile_attribution(before, after),
        "phases": phase_attribution(served),
        "tenants": tenant_attribution(results),
        "slo": {
            "objectives": slo.state() if slo is not None else {},
            "burn_events": len(trace.events("slo-burn")),
            "ok_events": len(trace.events("slo-ok")),
        },
        # numeric health (core/numerics.py): shadow-sample drift counts
        # from the metrics delta + the drift budget's live snapshot
        "numerics": {
            "shadow_samples": counters.get("numerics.shadow.samples", 0),
            "shadow_over_budget":
                counters.get("numerics.shadow.over_budget", 0),
            "shadow_errors": counters.get("numerics.shadow.errors", 0),
            "sentinel_trips": counters.get("numerics.sentinel.tripped", 0),
            "budget_burns": counters.get("numerics.budget.burns", 0),
            "demoted": (numerics.last_drift() or {}).get("demoted", []),
        },
    }


def format_report(report: dict) -> str:
    lines = [
        f"requests {report['requests']}: {report['served']} served, "
        f"{report['shed']} shed ({report['shed_rate']:.1%}), "
        f"{report['failed']} failed",
    ]
    for reason, n in sorted(report["shed_by_reason"].items()):
        lines.append(f"  shed {reason}: {n}")
    lt = report["latency_ms"]
    if lt["p50"] is not None:
        lines.append(f"latency ms: p50 {lt['p50']}  p90 {lt['p90']}  "
                     f"p99 {lt['p99']}  max {lt['max']}")
    if report["throughput_rps"] is not None:
        lines.append(f"throughput: {report['throughput_rps']} req/s over "
                     f"{report['elapsed_s']} s")
    if report["batches"]:
        lines.append(f"batches: {report['batches']} "
                     f"(mean size {report['batch_mean_size']})")
    if report["degraded_served"]:
        lines.append(f"degraded-mode served: {report['degraded_served']}")
    br = report["breaker"]
    if any(br.values()):
        lines.append(f"breaker: {br['opened']} opened, {br['half_open']} "
                     f"half-open probes, {br['closed']} closed, "
                     f"{br['skipped']} requests routed around")
    comp = report.get("compile")
    if comp:
        lines.append(
            f"compile: {comp['compile_ms']} ms vs run {comp['run_ms']} ms "
            f"(share {comp['compile_share']:.1%}), "
            f"{comp['retraces']} retrace(s), program cache "
            f"{comp['cache_hits']} hit / {comp['cache_misses']} miss")
        for key in sorted(comp["per_class"]):
            row = comp["per_class"][key]
            lines.append(
                f"  {key}: compile {row['compile_ms']} ms "
                f"x{row['compiles']}, run {row['run_ms']} ms x{row['runs']}")
    phases = report.get("phases") or {}
    if "overall" in phases:
        lines.append("phase attribution (p50/p99 ms):")
        for group in sorted(phases, key=lambda g: (g != "overall", g)):
            row = phases[group]
            cells = "  ".join(
                f"{ph} {row[ph]['p50']}/{row[ph]['p99']}"
                for ph in PHASES + ("total",) if ph in row)
            lines.append(f"  {group}: {cells}")
    tenants = report.get("tenants") or {}
    if len(tenants) > 1 or (tenants and "default" not in tenants):
        lines.append("tenants:")
        for t in sorted(tenants):
            row = tenants[t]
            lm = row["latency_ms"]
            tail = (f", p50 {lm['p50']} p99 {lm['p99']} ms" if lm else "")
            lines.append(f"  {t}: {row['served']}/{row['requests']} served, "
                         f"{row['shed']} shed, {row['failed']} failed{tail}")
    slo_sec = report.get("slo") or {}
    if slo_sec.get("objectives") or slo_sec.get("burn_events"):
        lines.append(f"slo: {slo_sec.get('burn_events', 0)} burn / "
                     f"{slo_sec.get('ok_events', 0)} ok transitions")
        for name, st in sorted((slo_sec.get("objectives") or {}).items()):
            lines.append(
                f"  {name} ({st['kind']} target {st['target']}): "
                f"burn short {st['burn_short']} long {st['burn_long']}"
                f"{'  BURNING' if st['burning'] else ''}")
    num = report.get("numerics") or {}
    if num.get("shadow_samples") or num.get("sentinel_trips") \
            or num.get("demoted"):
        lines.append(
            f"numerics: {num['shadow_samples']} shadow sample(s), "
            f"{num['shadow_over_budget']} over budget, "
            f"{num['budget_burns']} budget burn(s), "
            f"{num['sentinel_trips']} sentinel trip(s)")
        for key in num.get("demoted") or []:
            lines.append(f"  DEMOTED {key}")
    tp = report.get("transport")
    if tp:
        lines.append("transport (p50/p99 ms):")
        cl = tp.get("client") or {}
        cells = "  ".join(
            f"{k.replace('_ms', '')} {cl[k]['p50']}/{cl[k]['p99']}"
            for k in ("encode_ms", "decode_ms", "rtt_ms") if cl.get(k))
        if cells:
            lines.append(f"  client: {cells}")
        sv = tp.get("server") or {}
        cells = "  ".join(
            f"{k.replace('_ms', '')} mean {sv[k]['mean']} x{sv[k]['count']}"
            for k in ("encode_ms", "decode_ms") if sv.get(k))
        if cells:
            lines.append(f"  server: {cells}")
        if tp.get("transport_ms"):
            t = tp["transport_ms"]
            lines.append(f"  wire+queue: {t['p50']}/{t['p99']}")
        if tp.get("codec_share") is not None:
            lines.append(f"  codec share of p99 rtt: "
                         f"{tp['codec_share']:.2%}")
        if tp.get("proto_v1_frames"):
            lines.append(f"  legacy v1 frames: {tp['proto_v1_frames']}")
    wf = report.get("waterfall")
    if wf:
        hops = wf.get("hops") or {}
        if hops:
            cells = "  ".join(
                f"{k.replace('_ms', '')} {v['p50']}/{v['p99']}"
                for k, v in hops.items())
            lines.append(f"waterfall (p50/p99 ms): {cells}")
        p99 = wf.get("p99")
        if p99 and p99.get("segments"):
            cells = "  ".join(f"{k.replace('_ms', '')} {v}"
                              for k, v in p99["segments"].items())
            lines.append(f"  p99 request ({p99['rtt_ms']} ms rtt): {cells}"
                         f"  -> dominant hop: "
                         f"{(p99['dominant'] or '?').replace('_ms', '')}")
        samp = wf.get("sampling")
        if samp:
            decided = samp["kept"] + samp["dropped"]
            rate = (f"{samp['keep_rate']:.1%}"
                    if samp.get("keep_rate") is not None else "-")
            reasons = ", ".join(
                f"{k} {v}" for k, v in
                sorted((samp.get("kept_by_reason") or {}).items())) or "-"
            lines.append(
                f"  tail sampling: kept {samp['kept']}/{decided} "
                f"decided ({rate}), {samp['buffered']} buffered; "
                f"kept by reason: {reasons}")
    fleet = report.get("fleet")
    if fleet:
        seen = ", ".join(fleet.get("replicas_seen") or []) or "-"
        lines.append(
            f"fleet: replicas seen {seen}; "
            f"{fleet.get('requeues', 0)} requeue(s); "
            f"scale +{fleet.get('scale_ups', 0)}/-"
            f"{fleet.get('scale_downs', 0)}")
        for label in sorted(fleet.get("replicas") or {}):
            row = fleet["replicas"][label]
            lines.append(
                f"  {label}: routed {row.get('routed', 0)}, "
                f"requeues {row.get('requeues', 0)}, "
                f"breaker {row.get('breaker', '?')}"
                f"{'' if row.get('up') else '  DOWN'}")
    job = report.get("job")
    if job:
        lines.append(
            f"job {job.get('job')}: {job.get('state')} "
            f"(epoch {job.get('epoch')}/{job.get('total_epochs')}, "
            f"{job.get('resumes', 0)} resume(s), "
            f"{job.get('preemptions', 0)} preemption(s))")
    if "baseline" in report:
        b = report["baseline"]
        lines.append(f"baseline (max_batch=1): {b['throughput_rps']} req/s "
                     f"-> batched speedup {b['speedup']}x")
    return "\n".join(lines)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="serve loadgen",
        description="drive the serving front end with synthetic load and "
                    "print an SLO report")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--mode", choices=("closed", "open"), default="closed")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop in-flight window")
    ap.add_argument("--burst", type=int, default=16,
                    help="open-loop arrivals per service step")
    ap.add_argument("--capacity", type=int, default=64,
                    help="server queue capacity")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--mix", default="spmv,heat,cipher",
                    help=f"comma-separated ops from {MIX_OPS}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=1,
                    help="round-robin requests over this many tenants "
                    "(t0..tN-1) for per-tenant attribution")
    ap.add_argument("--degrade-depth", type=int, default=None)
    ap.add_argument("--degrade-p99-ms", type=float, default=None)
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="p99 latency objective (ms); arms the SLO "
                    "burn-rate monitor as a degraded-mode trigger")
    ap.add_argument("--slo-shed-rate", type=float, default=None,
                    help="shed-rate budget objective (fraction)")
    ap.add_argument("--slo-error-rate", type=float, default=None,
                    help="error-rate budget objective (fraction)")
    ap.add_argument("--slo-drift-rate", type=float, default=None,
                    help="numeric-drift budget objective: fraction of "
                    "shadow-sampled requests allowed over the drift "
                    "tolerance (needs CME213_SHADOW_RATE)")
    ap.add_argument("--slo-short-s", type=float, default=5.0)
    ap.add_argument("--slo-long-s", type=float, default=60.0)
    ap.add_argument("--slo-burn-threshold", type=float, default=2.0)
    ap.add_argument("--slo-min-samples", type=int, default=10)
    ap.add_argument("--breaker-threshold", type=int, default=3)
    ap.add_argument("--breaker-cooldown-s", type=float, default=30.0)
    ap.add_argument("--baseline", action="store_true",
                    help="also replay through max_batch=1 and report the "
                    "batched/serial throughput ratio")
    ap.add_argument("--warm", action="store_true",
                    help="run one untimed pass first so the measured pass "
                    "reflects the warmed steady state (every program a "
                    "cache hit; compile share ~ 0)")
    ap.add_argument("--max-retraces", type=int, default=None,
                    help="exit nonzero when the pass records more than this "
                    "many compile retraces (the steady-state gate: with the "
                    "program cache every shape class compiles at most once, "
                    "so 0 is the expected value)")
    ap.add_argument("--transport", default=None, metavar="HOST:PORT",
                    help="drive a socket front end (serve/transport.py or "
                    "a fleet) with real concurrent client threads instead "
                    "of an in-process server; the report gains fleet and "
                    "transport sections.  'self' spins up an in-process "
                    "TransportServer for the run (the CI rate gate)")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="requests in flight per connection in closed "
                    "--transport mode (v2 submit/result window; 1 = "
                    "blocking solve per request)")
    ap.add_argument("--stub-bytes", type=int, default=1024,
                    help="payload size for the 'stub' mix op")
    ap.add_argument("--stub-solve", action="store_true",
                    help="with --transport self: serve from a "
                    "StubSolveServer (decode-echo-encode inline, no "
                    "queue/batcher) so the run measures the transport "
                    "alone")
    ap.add_argument("--min-rps", type=float, default=None,
                    help="exit nonzero when served throughput falls below "
                    "this (the transport rate gate: --transport self "
                    "--mix stub measures the wire+queue path alone)")
    ap.add_argument("--max-codec-share", type=float, default=None,
                    help="exit nonzero when client encode+decode p99 "
                    "exceeds this fraction of the p99 rtt (the framing-"
                    "overhead gate; needs --transport)")
    ap.add_argument("--max-trace-keep-rate", type=float, default=None,
                    help="exit nonzero when tail sampling kept more than "
                    "this fraction of trace-buffered requests (the "
                    "sampling drop-rate gate; needs --transport and "
                    "CME213_TRACE_TAIL=1)")
    ap.add_argument("--job", default=None, metavar="JOB_ID",
                    help="with --transport: submit a durable long job "
                    "before the interactive load and report its fate "
                    "alongside the SLO report (needs a job lane — fleet "
                    "up --jobs-dir)")
    ap.add_argument("--job-op", default="pagerank",
                    help="job kind for --job (serve/workloads.JOB_KINDS)")
    ap.add_argument("--job-nodes", type=int, default=4096)
    ap.add_argument("--job-iters", type=int, default=48)
    ap.add_argument("--job-epoch", type=int, default=8,
                    help="iterations per durable epoch for --job")
    ap.add_argument("--job-wait-s", type=float, default=120.0,
                    help="after the load pass, wait this long for --job "
                    "to reach DONE (exit nonzero otherwise)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: where the in-process "
                    "server's batches run")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    flight.install()   # a crashing load run leaves its black box behind
    specs = build_mix(args.mix, args.requests, seed=args.seed,
                      deadline_ms=args.deadline_ms, tenants=args.tenants,
                      stub_bytes=args.stub_bytes)

    if args.transport:
        from .transport import (
            StubSolveServer,
            TransportClient,
            TransportServer,
        )

        own_server = None
        addr = args.transport
        if addr == "self":
            own_server = (StubSolveServer() if args.stub_solve
                          else TransportServer(
                              Server(capacity=args.capacity,
                                     max_batch=args.max_batch,
                                     clock=Clock(), device=args.device),
                              drive="thread",
                              poll_interval_s=0.001)).start()
            addr = own_server.addr
        try:
            # clock alignment for the request waterfalls: bound the
            # front end's wall-clock offset before any spans are cut
            try:
                with TransportClient(addr, timeout_s=5.0) as sync_client:
                    sync_client.sync_clock(samples=5)
            except (OSError, ConnectionError, ValueError, TimeoutError):
                pass
            if args.job:
                job_section = submit_job_over(addr, args)
            if args.warm:
                run_load_transport(addr, specs, mode=args.mode,
                                   concurrency=args.concurrency,
                                   burst=args.burst,
                                   pipeline=args.pipeline)
            before = metrics.snapshot()
            run = run_load_transport(addr, specs, mode=args.mode,
                                     concurrency=args.concurrency,
                                     burst=args.burst,
                                     pipeline=args.pipeline)
            after = metrics.snapshot()
            report = slo_report(run, before, after)
            report["transport"] = transport_section(run, before, after)
            report["waterfall"] = waterfall_section(run, before, after)
            report["fleet"] = fleet_section(run, addr)
            if args.job:
                report["job"] = wait_job_over(addr, args, job_section)
        finally:
            if own_server is not None:
                own_server.close()
        print(json.dumps(report, indent=2) if args.as_json
              else format_report(report))
        rc = 0
        if args.job and report["job"].get("state") != "DONE":
            print(f"FAIL: job {args.job} is "
                  f"{report['job'].get('state')!r}, not DONE "
                  f"({report['job'].get('error')})", file=sys.stderr)
            rc = 1
        rps = report["throughput_rps"]
        if args.min_rps is not None and (rps or 0) < args.min_rps:
            print(f"FAIL: {rps} req/s below --min-rps={args.min_rps}",
                  file=sys.stderr)
            rc = 1
        share = report["transport"].get("codec_share")
        if args.max_codec_share is not None:
            if share is None or share > args.max_codec_share:
                print(f"FAIL: codec share {share} exceeds "
                      f"--max-codec-share={args.max_codec_share}",
                      file=sys.stderr)
                rc = 1
        if args.max_trace_keep_rate is not None:
            samp = report["waterfall"].get("sampling") or {}
            rate = samp.get("keep_rate")
            if rate is None or rate > args.max_trace_keep_rate:
                print(f"FAIL: trace keep rate {rate} exceeds "
                      f"--max-trace-keep-rate={args.max_trace_keep_rate} "
                      f"(tail sampling must drop the happy path)",
                      file=sys.stderr)
                rc = 1
        return rc

    last_slo = None

    def make_server(max_batch: int) -> Server:
        nonlocal last_slo
        clock = Clock()
        last_slo = slo_mod.from_flags(
            clock, p99_ms=args.slo_p99_ms, shed_rate=args.slo_shed_rate,
            error_rate=args.slo_error_rate,
            drift_rate=args.slo_drift_rate, short_s=args.slo_short_s,
            long_s=args.slo_long_s, burn_threshold=args.slo_burn_threshold,
            min_samples=args.slo_min_samples)
        return Server(capacity=args.capacity, max_batch=max_batch,
                      clock=clock,
                      breaker_threshold=args.breaker_threshold,
                      breaker_cooldown_s=args.breaker_cooldown_s,
                      degrade_depth=args.degrade_depth,
                      degrade_p99_ms=args.degrade_p99_ms,
                      slo=last_slo, device=args.device)

    def run_pass(max_batch: int) -> dict:
        return run_load(make_server(max_batch), specs, mode=args.mode,
                        concurrency=args.concurrency, burst=args.burst)

    baseline = None
    if args.baseline:
        # the ratio measures SERVING throughput, not compile time: warm
        # both paths first (every batch size is its own program), then
        # compare the warmed passes — the repo's bench discipline
        run_pass(args.max_batch)
        run_pass(1)
        b_run = run_pass(1)
        b_served = [r for r in b_run["results"] if r.status == OK]
        baseline = {"served": len(b_served),
                    "elapsed_s": round(b_run["elapsed_s"], 4),
                    "throughput_rps":
                        round(len(b_served) / b_run["elapsed_s"], 2)
                        if b_run["elapsed_s"] > 0 else None}

    if args.warm:
        # same seed + closed-loop discipline → the warm pass forms the
        # same batches, so the measured pass serves every shape class
        # (and batch width) from the program cache
        run_pass(args.max_batch)
    before = metrics.snapshot()
    run = run_pass(args.max_batch)
    report = slo_report(run, before, metrics.snapshot(), slo=last_slo)
    if baseline is not None:
        speedup = None
        if baseline["throughput_rps"] and report["throughput_rps"]:
            speedup = round(report["throughput_rps"]
                            / baseline["throughput_rps"], 2)
        report["baseline"] = {**baseline, "speedup": speedup}

    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        print(format_report(report))
    retraces = report["compile"]["retraces"]
    if args.max_retraces is not None and retraces > args.max_retraces:
        print(f"FAIL: {retraces} compile retrace(s) exceed "
              f"--max-retraces={args.max_retraces}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
