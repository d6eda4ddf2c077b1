"""Offline trace analysis: ``python -m cme213_tpu_torch trace <cmd> files...``.

Counterpart of ``cme213_tpu/trace_cli.py``: the same analysis over the
JSON-lines files ``core/trace.py`` sinks (``CME213_TRACE_FILE``, one file
per rank via ``{rank}`` templating).  The port's records follow the JAX
package's schema, so each package's CLI reads the other's sinks, and on
the same records both print the same text and the same JSON documents,
but for two lines: a flight dump's platform line names torch and CUDA
(the port's dump header), and the attribution-mismatch header names the
staged plan the port compares against (``core/diag.check_attribution``).
Subcommands:

- ``summary``  — per-phase and per-kernel span time, compile-vs-run split
  and retrace counts, roofline attribution (``pct_peak`` against
  ``core/roofline.peaks()``, which ``CME213_DEVICE_PEAKS`` overrides),
  served-rung and demotion counts, checkpoint-commit latency percentiles,
  fault, retry and rollback tallies, gang verdicts.  ``--require a,b``
  fails (exit 1) when a named span never completed or a named event never
  occurred — the CI gate — and ``--single-trace`` fails unless the
  records carry exactly one cross-process trace id.  ``--json`` prints
  the same aggregates as one JSON document.
- ``timeline`` — one chronological line per event with relative
  timestamps and rank labels (span-begin records are folded into their
  span-end line; ``--all`` shows everything).  Both summary and timeline
  window long traces with ``--since <ms|ISO>`` and ``--last N``.
- ``merge``    — interleave many per-rank files into one time-sorted
  JSON-lines stream (stdout or ``--out``); ``--timeline`` renders the
  merged view instead; ``--follow`` tails the files live through
  ``core/collector.py`` instead of one post-mortem pass.
- ``export``   — Chrome trace-event JSON loadable in Perfetto or
  ``chrome://tracing``: rank → pid, span nesting depth → tid, spans as
  B/E pairs, everything else as instant events, and each request's
  ``serve.hop.*`` chain stitched with flow arrows (s/t/f).
- ``waterfall`` — one request's hops (matched by rid tag or trace id)
  reassembled into a cross-process tree on one clock via the
  ``clock-offset`` peer graph, with the accumulated ± error bound;
  ``--json`` for the CI gate.
- ``regress``  — the bench regression gate (``bench/regress.py``).
- ``metrics``  — a metrics snapshot in the Prometheus text format
  (``core/metrics.render_prometheus``), from a trace JSONL file (its last
  ``metrics-snapshot`` event), a snapshot JSON document or a flight dump.
- ``flight``   — a crash flight dump (``core/flight.py``): header,
  traceback, open spans, and the timeline before the crash.

Any unparseable line is a hard error (exit 2): a trace that cannot be
trusted end to end must fail the gate, not be skipped.  Records missing
fields their :data:`~cme213_tpu_torch.core.trace.EVENT_SCHEMA` entry
requires are counted and reported (they do not fail the parse).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter, defaultdict

from .core.metrics import _nearest_rank
from .core.trace import validate_record


class TraceParseError(ValueError):
    """A sink file line that is not a JSON event record."""


#: tags every record carries; hidden from per-event detail rendering
_BASE_FIELDS = {"event", "t", "pid", "rank", "incarnation", "trace", "_file"}


def load_events(paths: list[str], *,
                tolerate_torn: bool = False) -> list[dict]:
    """Parse + time-sort the records of one or many sink files.  Raises
    TraceParseError on any malformed line (parse errors are fatal — see
    module docstring) unless ``tolerate_torn`` is set, in which case bad
    lines are skipped — the ``waterfall`` subcommand uses this because
    its whole job is reading the sink of a process that may have been
    SIGKILLed mid-write, leaving a torn final line."""
    events = []
    for path in paths:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    if tolerate_torn:
                        continue
                    raise TraceParseError(f"{path}:{lineno}: {e}") from e
                if not isinstance(rec, dict) or "event" not in rec:
                    if tolerate_torn:
                        continue
                    raise TraceParseError(
                        f"{path}:{lineno}: not an event record")
                rec["_file"] = os.path.basename(path)
                events.append(rec)
    # stable sort: equal timestamps keep file order (begin before end)
    events.sort(key=lambda r: r.get("t") or 0.0)
    return events


def _rank_label(rec: dict) -> str:
    r = rec.get("rank")
    return f"r{r}" if isinstance(r, int) else "main"


def window_events(events: list[dict], since=None,
                  last: int | None = None) -> list[dict]:
    """Windowing for long-horizon (collector-era) traces.  ``since``
    keeps records newer than a bound — a bare number is milliseconds
    back from the NEWEST record, an ISO-8601 timestamp is absolute;
    ``last`` keeps the N newest records (after ``since``).  Raises
    ValueError on an unparseable ``since``."""
    if since is not None:
        try:
            ms = float(since)
        except (TypeError, ValueError):
            from datetime import datetime

            try:
                cutoff = datetime.fromisoformat(str(since)).timestamp()
            except ValueError as e:
                raise ValueError(
                    f"--since {since!r} is neither a millisecond count "
                    f"nor an ISO-8601 timestamp") from e
        else:
            ts = [e["t"] for e in events
                  if isinstance(e.get("t"), (int, float))]
            cutoff = (max(ts) - ms / 1e3) if ts else None
        if cutoff is not None:
            events = [e for e in events
                      if isinstance(e.get("t"), (int, float))
                      and e["t"] >= cutoff]
    if last is not None:
        events = events[-last:] if last > 0 else []
    return events


def _error_class(error) -> str:
    """Forensics bucket for a kernel-failure ``error`` field: the
    exception type name when the field looks like ``Type: message``,
    else the (truncated) text itself — dispatch records type names,
    bench rows record free text."""
    s = str(error or "?").strip()
    head = s.split(":", 1)[0].strip()
    if head and " " not in head and len(head) <= 40:
        return head
    return s[:40]


def _percentiles(vals: list[float]) -> dict:
    vals = sorted(vals)

    def pct(q):
        return _nearest_rank(vals, q)

    return {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
            "max": vals[-1]}


# ------------------------------------------------------------------ summary

def summarize(events: list[dict], out=None) -> dict:
    """Print the aggregate report; returns the aggregates (tests use the
    dict, humans read the text)."""
    w = (out or sys.stdout).write
    ranks = sorted({_rank_label(e) for e in events})
    incarnations = sorted({e.get("incarnation", 0) for e in events})
    ts = [e["t"] for e in events if isinstance(e.get("t"), (int, float))]
    span_s = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    w(f"{len(events)} events over {span_s:.3f}s, ranks: "
      f"{', '.join(ranks) or '-'}, incarnations: "
      f"{', '.join(str(i) for i in incarnations)}\n")

    # cross-process causality: the trace ids and pids the records span —
    # a launched gang shows ONE id across every pid it touched
    trace_ids = sorted({str(e["trace"]) for e in events if e.get("trace")})
    pids = sorted({e["pid"] for e in events
                   if isinstance(e.get("pid"), int)})
    if trace_ids:
        w(f"trace ids: {', '.join(trace_ids)} "
          f"(across {len(pids)} pid(s))\n")

    invalid = Counter()
    for e in events:
        for missing in validate_record(e):
            invalid[(e["event"], missing)] += 1
    if invalid:
        w("schema violations:\n")
        for (ev, field), n in sorted(invalid.items()):
            w(f"  {ev}: missing {field} x{n}\n")

    # spans: per-phase/per-kernel time (the reference's timer table)
    by_span = defaultdict(list)
    begun = {}
    for e in events:
        if e["event"] == "span-begin":
            begun[e.get("id")] = e
        elif e["event"] == "span-end":
            begun.pop(e.get("id"), None)
            if isinstance(e.get("ms"), (int, float)):
                by_span[e["span"]].append(e["ms"])
    if by_span:
        w("spans (ms):\n")
        w(f"  {'name':<38} {'count':>5} {'total':>10} {'mean':>9} "
          f"{'max':>9}\n")
        for name in sorted(by_span):
            vals = by_span[name]
            w(f"  {name:<38} {len(vals):>5} {sum(vals):>10.2f} "
              f"{sum(vals) / len(vals):>9.2f} {max(vals):>9.2f}\n")
    if begun:
        w(f"open spans (begun, never ended — killed mid-flight?): "
          f"{', '.join(sorted(b['span'] for b in begun.values()))}\n")

    # compile vs run split per (op, shape class) + the retrace detector
    # (ROADMAP item 5's measurement half): spans named <op>.compile /
    # <op>.run carrying a shape_class tag
    split = defaultdict(lambda: {"compiles": 0, "compile_ms": 0.0,
                                 "runs": 0, "run_ms": 0.0,
                                 "cache_hits": 0, "cache_misses": 0})
    for e in events:
        if e["event"] in ("program-cache-hit", "program-cache-miss"):
            # the program cache (core/programs.py): a hit is a dispatch
            # that skipped compile entirely, a miss is the one build+warm
            # that produced the row's compile span
            d = split[(e.get("op"), e.get("shape_class"))]
            d["cache_hits" if e["event"] == "program-cache-hit"
              else "cache_misses"] += 1
            continue
        if e["event"] != "span-end" or "shape_class" not in e:
            continue
        nm, ms = e.get("span", ""), e.get("ms")
        if not isinstance(ms, (int, float)):
            continue
        if nm.endswith(".compile"):
            d = split[(nm[:-len(".compile")], e["shape_class"])]
            d["compiles"] += 1
            d["compile_ms"] += ms
        elif nm.endswith(".run"):
            d = split[(nm[:-len(".run")], e["shape_class"])]
            d["runs"] += 1
            d["run_ms"] += ms
    retraces = Counter((e.get("op"), e.get("shape_class")) for e in events
                       if e["event"] == "compile-retrace")
    if split:
        w("compile vs run (ms):\n")
        w(f"  {'op [shape class]':<38} {'compiles':>8} {'ms':>9} "
          f"{'runs':>5} {'ms':>9} {'hit/miss':>9}\n")
        for (op, sc), d in sorted(split.items()):
            hit_miss = f"{d['cache_hits']}/{d['cache_misses']}"
            w(f"  {f'{op} [{sc}]':<38} {d['compiles']:>8} "
              f"{d['compile_ms']:>9.2f} {d['runs']:>5} {d['run_ms']:>9.2f} "
              f"{hit_miss:>9}\n")
    if retraces:
        w(f"compile retraces: {sum(retraces.values())} ("
          + ", ".join(f"{op} [{sc}] x{n}"
                      for (op, sc), n in sorted(retraces.items())) + ")\n")

    # roofline attribution: span-ends that declared their cost model
    # (sp.roofline(...)) carry achieved_gbs / pct_peak / bound
    att = defaultdict(list)
    for e in events:
        if e["event"] == "span-end" and "achieved_gbs" in e:
            att[(e.get("span", "?"), str(e.get("kernel", "-")))].append(e)
    if att:
        w("roofline attribution:\n")
        for (nm, kernel), recs in sorted(att.items()):
            best = max(recs, key=lambda r: r.get("achieved_gbs") or 0)
            line = (f"  {nm} [{kernel}]: best "
                    f"{best.get('achieved_gbs')} GB/s")
            if best.get("pct_peak") is not None:
                line += (f" ({best['pct_peak']}% of peak, "
                         f"{best.get('bound')}-bound)")
            w(line + f" x{len(recs)}\n")

    served = Counter((e["op"], e["rung"]) for e in events
                     if e["event"] == "served")
    demoted_serves = sum(1 for e in events
                         if e["event"] == "served" and e.get("demoted"))
    if served:
        w("served rungs:\n")
        for (op, rung), n in sorted(served.items()):
            w(f"  {op}: {rung} x{n}\n")
        w(f"  (demoted serves: {demoted_serves})\n")
    rung_failed = Counter((e["op"], e["rung"]) for e in events
                          if e["event"] == "rung-failed")
    if rung_failed:
        w("demotions (rung-failed):\n")
        for (op, rung), n in sorted(rung_failed.items()):
            w(f"  {op}.{rung} x{n}\n")

    # conformance verdicts (core/conformance.py): probes run and how
    # many diverged — the served/demoted counts above show the effect
    conf = Counter((e.get("op"), e.get("rung"), bool(e.get("ok")))
                   for e in events if e["event"] == "conformance-probe")
    conf_failed = [e for e in events if e["event"] == "conformance-failed"]
    if conf or conf_failed:
        n_pass = sum(n for (_, _, ok), n in conf.items() if ok)
        n_fail = sum(n for (_, _, ok), n in conf.items() if not ok)
        w(f"conformance: {n_pass + n_fail} probe(s), {n_pass} passed, "
          f"{n_fail} failed\n")
        for (op, rung, ok), n in sorted(conf.items(), key=lambda kv: (
                str(kv[0][0]), str(kv[0][1]))):
            w(f"  {op}.{rung}: {'pass' if ok else 'FAIL'} x{n}\n")
        for e in conf_failed:
            w(f"  failed: {e.get('op')}.{e.get('rung')} "
              f"[{e.get('shape_class')}] {e.get('detail')}\n")

    # staged kernel forensics (core/diag.py): every kernel-failure from
    # dispatch/bench/serve carries a stage tag; group by (op, kernel,
    # stage, error class), with conformance REFUSALS (the gate said no)
    # rendered apart from the lower/compile/execute CRASHES — "diverged
    # from reference" and "Mosaic blew up" are different diagnoses
    kfail = [e for e in events if e["event"] == "kernel-failure"]
    forensics = Counter(
        (str(e.get("op")), str(e.get("kernel")), str(e.get("stage") or "?"),
         _error_class(e.get("error"))) for e in kfail)
    if kfail:
        crashes = sorted((k, n) for k, n in forensics.items()
                         if k[2] != "conformance")
        refusals = sorted((k, n) for k, n in forensics.items()
                          if k[2] == "conformance")
        w(f"kernel forensics: {len(kfail)} failure(s), "
          f"{sum(n for _, n in crashes)} crash(es), "
          f"{sum(n for _, n in refusals)} conformance refusal(s)\n")
        if crashes:
            w(f"  {'op.kernel':<30} {'stage':<12} {'error class':<24} "
              f"{'count':>5}\n")
            for (op, kern, stage, err), n in crashes:
                w(f"  {f'{op}.{kern}':<30} {stage:<12} {err:<24} {n:>5}\n")
        for (op, kern, _, err), n in refusals:
            w(f"  refused: {op}.{kern} ({err}) x{n}\n")

    # device health (core/diag.py doctor ladder)
    health_evs = [e for e in events if e["event"] == "device-health"]
    health = None
    if health_evs:
        last = health_evs[-1]
        health = {"probes": len(health_evs),
                  "last_healthy": bool(last.get("healthy")),
                  "platform": last.get("platform"),
                  "devices": last.get("devices"),
                  "probe_ms": last.get("probe_ms")}
        w(f"device health: {len(health_evs)} probe(s); last "
          f"{'HEALTHY' if health['last_healthy'] else 'UNHEALTHY'} "
          f"({health['platform']}, {health['devices']} device(s), "
          f"probe {health['probe_ms']} ms)\n")

    # predicted-vs-measured attribution mismatches (core/diag.py): the
    # roofline cost model disagreed with what the rung's plan stages
    mismatches = [e for e in events if e["event"] == "attribution-mismatch"]
    if mismatches:
        w(f"attribution mismatches: {len(mismatches)} "
          f"(cost model vs staged plan)\n")
        for e in mismatches:
            w(f"  {e.get('op')}.{e.get('rung')} [{e.get('shape_class')}] "
              f"{e.get('metric')}: predicted {e.get('predicted')} "
              f"measured {e.get('measured')} (x{e.get('ratio')})\n")

    # admission decisions (core/admission.py): rejections and the
    # chunk/tile shrink responses
    rejected = [e for e in events if e["event"] == "admission-rejected"]
    shrunk = [e for e in events if e["event"] == "chunk-shrunk"]
    if rejected or shrunk:
        w(f"admission: {len(rejected)} rejected, {len(shrunk)} "
          f"chunk(s)/tile(s) shrunk\n")
        for e in rejected:
            w(f"  rejected: {e.get('op')} needs {e.get('requested_bytes')}"
              f" B > budget {e.get('budget_bytes')} B\n")
        for e in shrunk:
            w(f"  shrunk: {e.get('op')} {e.get('from_size')} -> "
              f"{e.get('to_size')} ({e.get('reason')})\n")

    commits = [e for e in events if e["event"] == "epoch-commit"]
    commit_stats = None
    if commits:
        last = max(commits, key=lambda e: e.get("epoch", 0))
        line = (f"epoch commits: {len(commits)} "
                f"(latest epoch {last.get('epoch')}, step {last.get('step')})")
        ms = [e["ms"] for e in commits if isinstance(e.get("ms"), (int, float))]
        if ms:
            commit_stats = _percentiles(ms)
            line += ("  latency ms: " + " ".join(
                f"{k}={v:.2f}" for k, v in commit_stats.items()))
        w(line + "\n")
    loads = [e for e in events if e["event"] == "commit-loaded"]
    for e in loads:
        w(f"resume: epoch {e.get('epoch')}, step {e.get('step')} "
          f"from {e.get('candidate')} ({_rank_label(e)}, "
          f"incarnation {e.get('incarnation')})\n")
    bad = Counter(e.get("candidate") for e in events
                  if e["event"] == "commit-invalid")
    if bad:
        w("invalid commits skipped: "
          + ", ".join(f"{c} x{n}" for c, n in sorted(bad.items())) + "\n")

    verdicts = [e for e in events if e["event"] == "rank-failed"]
    restarts = [e for e in events if e["event"] == "gang-restart"]
    launches = [e for e in events if e["event"] == "gang-launch"]
    exits = [e for e in events if e["event"] == "gang-exit"]
    if launches or verdicts or restarts:
        w(f"gang: {len(launches)} launch(es), {len(verdicts)} verdict(s) "
          f"[{', '.join(v.get('reason', '?') for v in verdicts) or '-'}], "
          f"{len(restarts)} restart(s)"
          + (f", final rc {exits[-1].get('rc')}" if exits else "") + "\n")
    beats = defaultdict(list)
    for e in events:
        if e["event"] == "heartbeat":
            beats[e.get("rank")].append(e.get("step"))
    for rank in sorted(beats, key=str):
        w(f"heartbeats r{rank}: {len(beats[rank])} "
          f"(last step {beats[rank][-1]})\n")

    # serving front end (serve/): load shedding, breaker transitions,
    # batch occupancy — the stays-up-under-overload evidence
    shed = Counter()
    for e in events:
        if e["event"] == "queue-shed":
            shed[(e.get("op"), e.get("reason"))] += 1
        elif e["event"] == "deadline-shed":
            shed[(e.get("op"), "deadline")] += 1
    breaker = {"open": [], "half_open": [], "close": []}
    for e in events:
        if e["event"] == "breaker-open":
            breaker["open"].append((e.get("op"), e.get("rung")))
        elif e["event"] == "breaker-half-open":
            breaker["half_open"].append((e.get("op"), e.get("rung")))
        elif e["event"] == "breaker-close":
            breaker["close"].append((e.get("op"), e.get("rung")))
    batches = [e for e in events if e["event"] == "batch-executed"]
    degraded = sum(1 for e in events if e["event"] == "span-end"
                   and e.get("span") == "degraded-mode")
    reqs = [e for e in events if e["event"] == "request-served"]
    # transport codec span tags (serve/transport.py samples these past
    # the first 64 rids of a connection — counts here are of *traced*
    # codec operations; the full population lives in the
    # serve.request.{encode,decode}_ms histograms)
    codec = {"encode": [e for e in events
                        if e["event"] == "request-serialized"],
             "decode": [e for e in events
                        if e["event"] == "request-deserialized"]}
    serving = None
    if shed or any(breaker.values()) or batches or reqs or any(
            codec.values()):
        occ = [e["occupancy"] for e in batches
               if isinstance(e.get("occupancy"), (int, float))]
        sizes = [e["size"] for e in batches
                 if isinstance(e.get("size"), (int, float))]
        # stable shed keys: every serving op appears with every shed
        # reason, zero-filled, so downstream diffs never see keys
        # flicker in and out with the traffic
        serve_ops = sorted({str(e.get("op")) for e in
                            (batches + reqs)} |
                           {str(op) for op, _ in shed})
        shed_keys = {f"{op}:{reason}": 0 for op in serve_ops
                     for reason in ("queue-full", "deadline", "admission")}
        for (op, reason), n in shed.items():
            shed_keys[f"{op}:{reason}"] = n
        serving = {
            "shed": dict(sorted(shed_keys.items())),
            "breaker": {k: [f"{op}.{rung}" for op, rung in v]
                        for k, v in breaker.items()},
            "batches": len(batches),
            "batch_mean_size": (sum(sizes) / len(sizes)) if sizes else None,
            "batch_occupancy": (sum(occ) / len(occ)) if occ else None,
            "degraded_batches": degraded,
        }
        for d, evs in codec.items():
            ms = [e["ms"] for e in evs
                  if isinstance(e.get("ms"), (int, float))]
            nb = [e["nbytes"] for e in evs
                  if isinstance(e.get("nbytes"), (int, float))]
            serving[f"{d}_traced"] = len(evs)
            serving[f"{d}_ms_mean"] = (sum(ms) / len(ms)) if ms else None
            serving[f"{d}_bytes"] = sum(nb)
        w(f"serving: {len(batches)} batch(es)")
        if sizes:
            w(f", mean size {serving['batch_mean_size']:.2f}"
              f", occupancy {serving['batch_occupancy']:.2f}")
        if degraded:
            w(f", {degraded} degraded")
        w("\n")
        for d in ("encode", "decode"):
            if serving[f"{d}_traced"]:
                w(f"  wire {d}: {serving[f'{d}_traced']} traced, "
                  f"mean {serving[f'{d}_ms_mean']:.4f} ms, "
                  f"{serving[f'{d}_bytes']} B\n")
        for key, n in serving["shed"].items():
            if n:
                w(f"  shed {key} x{n}\n")
        for transition in ("open", "half_open", "close"):
            for target in breaker[transition]:
                w(f"  breaker {transition.replace('_', '-')}: "
                  f"{target[0]}.{target[1]}\n")

    # replicated fleet (serve/fleet.py + serve/router.py): per-replica
    # routing stats from the front tier's lifecycle + routing events —
    # the zero-accepted-request-loss evidence lives here (requeues)
    fleet_sec = None
    routed = [e for e in events if e["event"] == "request-routed"]
    requeued = [e for e in events if e["event"] == "request-requeued"]
    rep_ups = [e for e in events if e["event"] == "replica-up"]
    rep_downs = [e for e in events if e["event"] == "replica-down"]
    if routed or requeued or rep_ups or rep_downs:
        per_rep: dict[str, dict] = {}

        def _rep(label) -> dict:
            return per_rep.setdefault(str(label), {
                "routed": 0, "requeued": 0, "ups": 0, "downs": 0,
                "breaker": "closed"})

        for e in rep_ups:
            _rep(f"r{e.get('replica')}")["ups"] += 1
        for e in rep_downs:
            _rep(f"r{e.get('replica')}")["downs"] += 1
        for e in routed:
            _rep(f"r{e.get('replica')}")["routed"] += 1
        for e in requeued:
            _rep(f"r{e.get('from_replica')}")["requeued"] += 1
        # per-replica breaker state: the router keys its breaker
        # (op="fleet.route") by rung "r<rank>" — last transition wins
        for e in events:
            if (e.get("op") == "fleet.route"
                    and e["event"] in ("breaker-open", "breaker-half-open",
                                       "breaker-close")):
                _rep(e.get("rung"))["breaker"] = \
                    e["event"].removeprefix("breaker-")
        fleet_sec = {
            "replicas": {k: per_rep[k] for k in sorted(per_rep)},
            "routed": len(routed),
            "requeues": len(requeued),
            "replica_ups": len(rep_ups),
            "replica_downs": len(rep_downs),
            "scale_ups": sum(1 for e in events
                             if e["event"] == "scale-up"),
            "scale_downs": sum(1 for e in events
                               if e["event"] == "scale-down"),
        }
        w(f"fleet: {len(per_rep)} replica(s), {len(routed)} routed, "
          f"{len(requeued)} requeue(s), scale +{fleet_sec['scale_ups']}"
          f"/-{fleet_sec['scale_downs']}\n")
        for label, row in fleet_sec["replicas"].items():
            w(f"  {label}: {row['routed']} routed, "
              f"{row['requeued']} requeued, breaker {row['breaker']}"
              + (f" [DOWN x{row['downs']}]" if row["downs"] else "")
              + "\n")

    # request-lifecycle phase attribution: request-served events carry
    # the per-phase timing breakdown stamped by the server clock
    phases = None
    if reqs:
        per_op: dict[str, dict[str, list]] = defaultdict(
            lambda: defaultdict(list))
        for e in reqs:
            op = str(e.get("op"))
            for ph in ("queue_ms", "admit_ms", "batch_wait_ms", "run_ms",
                       "total_ms"):
                v = e.get(ph)
                if isinstance(v, (int, float)):
                    per_op[op][ph].append(v)
                    per_op["overall"][ph].append(v)
        phases = {}
        for op, cols in per_op.items():
            phases[op] = {ph: {"p50": round(_nearest_rank(sorted(vs), 0.5), 3),
                               "p99": round(_nearest_rank(sorted(vs), 0.99), 3)}
                          for ph, vs in cols.items() if vs}
        w(f"request phases (p50/p99 ms over {len(reqs)} request(s)):\n")
        for op in sorted(phases, key=lambda o: (o != "overall", o)):
            cells = "  ".join(
                f"{ph[:-3]} {d['p50']}/{d['p99']}"
                for ph, d in sorted(phases[op].items(), key=lambda kv: (
                    ("queue_ms", "admit_ms", "batch_wait_ms", "run_ms",
                     "total_ms").index(kv[0]))))
            w(f"  {op}: {cells}\n")

    # per-tenant accounting: request-served carries tenant; shed events
    # carry it as an optional tag
    tenants = None
    tenant_rows: dict[str, dict] = defaultdict(
        lambda: {"served": 0, "failed": 0, "shed": 0, "_lat": []})
    for e in reqs:
        row = tenant_rows[str(e.get("tenant"))]
        if e.get("status") == "ok":
            row["served"] += 1
            if isinstance(e.get("total_ms"), (int, float)):
                row["_lat"].append(e["total_ms"])
        else:
            row["failed"] += 1
    for e in events:
        if e["event"] in ("queue-shed", "deadline-shed") and "tenant" in e:
            tenant_rows[str(e.get("tenant"))]["shed"] += 1
    if tenant_rows:
        tenants = {}
        for t, row in sorted(tenant_rows.items()):
            lat = sorted(row.pop("_lat"))
            tenants[t] = {**row,
                          "p50_ms": (round(_nearest_rank(lat, 0.5), 3)
                                     if lat else None),
                          "p99_ms": (round(_nearest_rank(lat, 0.99), 3)
                                     if lat else None)}
        w("tenants:\n")
        for t, row in tenants.items():
            tail = (f", p50 {row['p50_ms']} p99 {row['p99_ms']} ms"
                    if row["p50_ms"] is not None else "")
            w(f"  {t}: {row['served']} served, {row['shed']} shed, "
              f"{row['failed']} failed{tail}\n")

    # SLO burn/recovery transitions (serve/slo.py)
    slo = None
    burns = [e for e in events if e["event"] == "slo-burn"]
    oks = [e for e in events if e["event"] == "slo-ok"]
    if burns or oks:
        slo = {
            "burns": len(burns),
            "oks": len(oks),
            "objectives": sorted({str(e.get("objective"))
                                  for e in burns + oks}),
            "last_burn": (
                {"objective": burns[-1].get("objective"),
                 "burn_short": burns[-1].get("burn_short"),
                 "burn_long": burns[-1].get("burn_long"),
                 "threshold": burns[-1].get("threshold")}
                if burns else None),
        }
        w(f"slo: {len(burns)} burn(s), {len(oks)} recover(ies) "
          f"[{', '.join(slo['objectives'])}]\n")
        for e in burns:
            w(f"  burn {e.get('objective')}: short {e.get('burn_short')} "
              f"long {e.get('burn_long')} >= {e.get('threshold')}\n")
        for e in oks:
            w(f"  ok {e.get('objective')}: short {e.get('burn_short')}\n")

    # numeric health (core/numerics.py): shadow conformance drift,
    # budget demotions, and output sentinels — the continuous form of
    # the conformance section's one-shot probes above
    numeric = None
    drifts = [e for e in events if e["event"] == "numeric-drift"]
    d_burns = [e for e in events if e["event"] == "drift-budget-burn"]
    d_oks = [e for e in events if e["event"] == "drift-budget-ok"]
    sentinels = [e for e in events if e["event"] == "numeric-sentinel"]
    if drifts or d_burns or sentinels:
        per_rung: dict = {}
        for e in drifts:
            key = f"{e.get('op')}.{e.get('rung')}"
            row = per_rung.setdefault(
                key, {"samples": 0, "over_budget": 0, "worst_rel_l2": 0.0,
                      "worst_ulps": 0})
            row["samples"] += 1
            row["over_budget"] += bool(e.get("over_budget"))
            rel = e.get("rel_l2")
            if isinstance(rel, (int, float)):
                row["worst_rel_l2"] = max(row["worst_rel_l2"], rel)
            else:  # "inf" marker: shape/dtype mismatch or non-finite
                row["worst_rel_l2"] = "inf"
            ulps = e.get("max_ulps")
            if isinstance(ulps, int) and isinstance(row["worst_ulps"], int):
                row["worst_ulps"] = (max(row["worst_ulps"], ulps)
                                     if ulps >= 0 else ulps)
        numeric = {
            "drift": per_rung,
            "samples": len(drifts),
            "over_budget": sum(1 for e in drifts if e.get("over_budget")),
            "demotions": [f"{e.get('op')}.{e.get('rung')}"
                          for e in d_burns],
            "recoveries": len(d_oks),
            "sentinels": {
                "trips": len(sentinels),
                "bad_elems": sum(e.get("count") or 0 for e in sentinels)},
        }
        w(f"numeric health: {numeric['samples']} shadow sample(s), "
          f"{numeric['over_budget']} over budget, "
          f"{len(d_burns)} budget burn(s), "
          f"{len(sentinels)} sentinel trip(s)\n")
        for key, row in sorted(per_rung.items()):
            w(f"  {key}: {row['samples']} sample(s), "
              f"{row['over_budget']} over, "
              f"worst rel_l2 {row['worst_rel_l2']}"
              + (f", worst ulps {row['worst_ulps']}"
                 if row["worst_ulps"] else "") + "\n")
        for e in d_burns:
            w(f"  DEMOTED {e.get('op')}.{e.get('rung')}: burn short "
              f"{e.get('burn_short')} long {e.get('burn_long')} "
              f">= {e.get('threshold')}\n")
        for e in sentinels:
            w(f"  sentinel {e.get('op')}.{e.get('rung')}: "
              f"{e.get('kind')} x{e.get('count')} "
              f"(of {e.get('size')} elems)\n")

    # convergence (core/numerics.ConvergenceTracker feeders): per-op
    # solver-progress rollup with the same stall policy `top` renders.
    # Keyed by (op, job) — two jobs iterating the same op must not fold
    # into one row, or a fresh job's high residual masks a stall.
    convergence = None
    progress = [e for e in events if e["event"] == "solver-progress"]
    if progress:
        convergence = {}
        for e in progress:
            op = str(e.get("op") or "solver")
            if e.get("job"):
                op = f"{op}[{e['job']}]"
            row = convergence.setdefault(
                op, {"epochs": 0, "first_residual": e.get("residual"),
                     "last_residual": None, "last_step": None,
                     "iters_per_s": None, "_best": None, "_since": 0,
                     "stalled": False})
            row["epochs"] += 1
            res = e.get("residual")
            row["last_residual"] = res
            row["last_step"] = e.get("step")
            row["iters_per_s"] = e.get("iters_per_s")
            if isinstance(res, (int, float)):
                if row["_best"] is None or res < row["_best"] * (1 - 1e-3):
                    row["_best"], row["_since"] = res, 0
                else:
                    row["_since"] += 1
                row["stalled"] = row["_since"] >= 5
        for op, row in convergence.items():
            row.pop("_best"), row.pop("_since")
        w(f"convergence: {len(convergence)} solver(s), "
          f"{len(progress)} progress event(s)\n")
        for op, row in sorted(convergence.items()):
            w(f"  {op}: {row['epochs']} epoch(s), residual "
              f"{row['first_residual']} -> {row['last_residual']} "
              f"@step {row['last_step']}, {row['iters_per_s']} iters/s "
              f"{'STALLED' if row['stalled'] else ''}".rstrip() + "\n")

    # durable long-job lane (serve/jobs.py): per-job lifecycle rollup.
    # job-epoch is emitted only after the durable publish, so duplicate
    # epoch numbers here mean a committed epoch was re-executed — the
    # invariant the lane exists to uphold.
    jobs_sec = None
    job_evs = [e for e in events if str(e["event"]).startswith("job-")]
    if job_evs:
        jobs_sec = {}
        for e in job_evs:
            jid = str(e.get("job") or "?")
            row = jobs_sec.setdefault(
                jid, {"op": None, "state": None, "epoch": None,
                      "total_epochs": None, "residual": None, "epochs": 0,
                      "dup_epochs": 0, "resumes": 0, "preemptions": 0,
                      "reassignments": 0, "_seen": set()})
            if e.get("op"):
                row["op"] = e.get("op")
            ev = e["event"]
            if ev == "job-submitted":
                row["state"] = "PENDING"
                row["total_epochs"] = e.get("total_epochs")
            elif ev == "job-epoch":
                row["state"] = "RUNNING"
                row["epoch"] = e.get("epoch")
                row["residual"] = e.get("residual")
                row["epochs"] += 1
                if e.get("epoch") in row["_seen"]:
                    row["dup_epochs"] += 1
                row["_seen"].add(e.get("epoch"))
            elif ev == "job-preempted":
                row["state"] = "PREEMPTED"
                row["preemptions"] += 1
            elif ev == "job-resumed":
                row["state"] = "RUNNING"
                row["resumes"] += 1
            elif ev == "job-reassigned":
                row["reassignments"] += 1
            elif ev == "job-done":
                row["state"] = e.get("state")
        for row in jobs_sec.values():
            row.pop("_seen")
        w(f"jobs: {len(jobs_sec)} job(s), {len(job_evs)} event(s)\n")
        for jid, row in sorted(jobs_sec.items()):
            w(f"  {jid} [{row['op']}]: {row['state']} "
              f"epoch {row['epoch']}/{row['total_epochs']}, "
              f"residual {row['residual']}, "
              f"{row['resumes']} resume(s), "
              f"{row['preemptions']} preemption(s)"
              + (f", {row['reassignments']} reassignment(s)"
                 if row["reassignments"] else "")
              + (f" [REEXECUTED x{row['dup_epochs']}]"
                 if row["dup_epochs"] else "") + "\n")

    # autotuning (core/tune.py): search activity + the tuned-vs-default
    # split at dispatch — the "is the cache actually consulted" signal
    tuning = None
    t_trials = [e for e in events if e["event"] == "tune-trial"]
    t_winners = [e for e in events if e["event"] == "tune-winner"]
    t_hits = sum(1 for e in events if e["event"] == "tune-hit")
    t_defaults = sum(1 for e in events if e["event"] == "tune-default")
    if t_trials or t_winners or t_hits or t_defaults:
        tuning = {
            "trials": len(t_trials),
            "rejected": sum(1 for e in t_trials if not e.get("ok")),
            "winners": {
                f"{e.get('op')} [{e.get('shape_class')}]": {
                    "candidate": e.get("candidate"),
                    "statics": e.get("statics"),
                    "gbs": e.get("gbs"),
                } for e in t_winners},
            "hits": t_hits,
            "defaults": t_defaults,
        }
        w(f"tuning: {len(t_trials)} trial(s) "
          f"({tuning['rejected']} rejected), {len(t_winners)} winner(s); "
          f"dispatch {t_hits} tuned / {t_defaults} default\n")
        for key, rec in sorted(tuning["winners"].items()):
            w(f"  {key}: {rec['candidate']} {rec['statics']} "
              f"{rec['gbs']} GB/s\n")

    counts = Counter(e["event"] for e in events)
    for label, ev in (("op failures", "op-failure"),
                      ("retries", "retry"),
                      ("numeric aborts", "numeric-abort"),
                      ("checkpoint rollbacks", "checkpoint-rollback"),
                      ("checkpoint quarantines", "checkpoint-quarantine")):
        if counts[ev]:
            w(f"{label}: {counts[ev]}\n")
    faults = Counter(e.get("kind") for e in events
                     if e["event"] == "fault-injected")
    if faults:
        w("faults injected: "
          + ", ".join(f"{k} x{n}" for k, n in sorted(faults.items())) + "\n")

    # all keys are strings so the dict doubles as the --json document
    return {"events": len(events), "ranks": ranks,
            "trace_ids": trace_ids, "pids": pids, "spans": dict(by_span),
            "served": {f"{op}.{rung}": n for (op, rung), n in served.items()},
            "rung_failed": {f"{op}.{rung}": n
                            for (op, rung), n in rung_failed.items()},
            "compile_run": {f"{op} [{sc}]": d
                            for (op, sc), d in split.items()},
            "retraces": {f"{op} [{sc}]": n
                         for (op, sc), n in retraces.items()},
            "attribution": {
                f"{nm} [{kernel}]": {
                    "count": len(recs),
                    "best_gbs": max(r.get("achieved_gbs") or 0
                                    for r in recs),
                    "pct_peak": max((r.get("pct_peak") or 0 for r in recs),
                                    default=0) or None,
                    "bound": recs[-1].get("bound"),
                } for (nm, kernel), recs in att.items()},
            "commits": len(commits), "commit_ms": commit_stats,
            "resumes": len(loads), "verdicts": len(verdicts),
            "restarts": len(restarts),
            "invalid": {f"{ev}:{field}": n
                        for (ev, field), n in invalid.items()},
            "conformance": {f"{op}.{rung}": {"ok": ok, "count": n}
                            for (op, rung, ok), n in conf.items()},
            "forensics": {f"{op}.{kern}:{stage}:{err}": n
                          for (op, kern, stage, err), n
                          in sorted(forensics.items())},
            "health": health,
            "attribution_mismatches": len(mismatches),
            "admission": {"rejected": len(rejected), "shrunk": len(shrunk)},
            "serving": serving,
            "fleet": fleet_sec,
            "phases": phases,
            "tenants": tenants,
            "slo": slo,
            "numerics": numeric,
            "convergence": convergence,
            "jobs": jobs_sec,
            "tuning": tuning,
            "counts": dict(counts)}


# ----------------------------------------------------------------- timeline

def _detail(rec: dict) -> str:
    ev = rec["event"]
    if ev in ("span-begin", "span-end"):
        parts = [str(rec.get("span", "?"))]
        if "ms" in rec:
            parts.append(f"ms={rec['ms']}")
        if "error" in rec:
            parts.append(f"error={rec['error']}")
        parts += [f"{k}={rec[k]}" for k in sorted(rec)
                  if k not in _BASE_FIELDS
                  and k not in ("span", "id", "parent", "ms", "error")]
        return " ".join(parts)
    if ev == "metrics-snapshot":
        m = rec.get("metrics", {})
        return (f"{len(m.get('counters', {}))} counters, "
                f"{len(m.get('gauges', {}))} gauges, "
                f"{len(m.get('histograms', {}))} histograms")
    parts = []
    for k in sorted(rec):
        if k in _BASE_FIELDS:
            continue
        v = rec[k]
        if isinstance(v, str) and len(v) > 60:
            v = v[:57] + "..."
        parts.append(f"{k}={v}")
    return " ".join(parts)


def _timeline_line(e: dict, t0: float) -> str:
    t = e.get("t")
    rel = f"+{t - t0:9.3f}s" if isinstance(t, (int, float)) else " " * 11
    inc = e.get("incarnation", 0)
    return (f"{rel} {_rank_label(e):>5} i{inc} "
            f"{e['event']:<22} {_detail(e)}\n")


def render_timeline(events: list[dict], out=None,
                    show_all: bool = False) -> None:
    """One line per event, chronological, relative to the first record —
    the merged gang view when fed every rank's file."""
    out = out or sys.stdout
    ts = [e["t"] for e in events if isinstance(e.get("t"), (int, float))]
    t0 = min(ts) if ts else 0.0
    for e in events:
        if not show_all and e["event"] == "span-begin":
            continue  # folded into the span-end line (which carries ms)
        out.write(_timeline_line(e, t0))


# ------------------------------------------------------------------ export

def _chrome_pid(rec: dict) -> int:
    """rank → Chrome pid: rank r → r+1, non-rank (launcher/main) → 0."""
    r = rec.get("rank")
    return r + 1 if isinstance(r, int) else 0


def to_chrome_trace(events: list[dict]) -> dict:
    """Convert trace records to the Chrome trace-event format (Perfetto /
    ``chrome://tracing``).

    Mapping: rank → pid (with ``process_name`` metadata naming each),
    span nesting depth → tid (a span's depth comes from its parent
    chain, so causal trees render as stacked tracks), span begin/end
    pairs → ``B``/``E`` duration events, a ``span-end`` whose begin is
    missing (ring-buffer truncation) → a self-contained ``X`` complete
    event reconstructed from its ``ms``, and every non-span record → an
    instant (``i``) event.  Open spans (begun, never ended — a killed
    rank) are dropped so begin/end pairing stays valid for the viewer.
    Timestamps are microseconds relative to the first record.

    Request waterfalls additionally get Chrome *flow* events: the
    ``serve.hop.*`` spans of one request (grouped by walking parent
    links to their shared root) are stitched with ``s``/``t``/``f``
    arrows so Perfetto draws the request's path across the pid lanes it
    crossed — client to front tier to replica and back.
    """
    ts = [e["t"] for e in events if isinstance(e.get("t"), (int, float))]
    t0 = min(ts) if ts else 0.0

    def us(t) -> float:
        return round((t - t0) * 1e6, 3)

    begins = {e.get("id"): e for e in events if e["event"] == "span-begin"}
    ends = {e.get("id"): e for e in events if e["event"] == "span-end"}

    depth_memo: dict = {}

    def depth(sid) -> int:
        d, chain = 0, sid
        seen = set()
        while chain is not None and chain not in seen:
            if chain in depth_memo:
                d += depth_memo[chain]
                break
            seen.add(chain)
            rec = begins.get(chain) or ends.get(chain)
            parent = rec.get("parent") if rec else None
            if parent is None:
                break
            d += 1
            chain = parent
        depth_memo[sid] = d
        return d

    out, pids = [], {}
    for e in events:
        pid = _chrome_pid(e)
        if pid not in pids:
            pids[pid] = ("main" if pid == 0
                         else f"rank {e.get('rank')}")
        args = {k: v for k, v in e.items()
                if k not in _BASE_FIELDS and k not in ("span", "id",
                                                       "parent")}
        t = e.get("t")
        if not isinstance(t, (int, float)):
            continue
        if e["event"] == "span-begin":
            if e.get("id") not in ends:
                continue  # open span: dropped to keep pairing valid
            out.append({"name": e.get("span", "?"), "cat": "span",
                        "ph": "B", "ts": us(t), "pid": pid,
                        "tid": depth(e.get("id")), "args": args})
        elif e["event"] == "span-end":
            sid = e.get("id")
            ms = e.get("ms") if isinstance(e.get("ms"), (int, float)) else 0.0
            if sid in begins:
                out.append({"name": e.get("span", "?"), "cat": "span",
                            "ph": "E", "ts": us(t), "pid": pid,
                            "tid": depth(sid), "args": args})
            else:  # begin lost (ring buffer): reconstruct from ms
                out.append({"name": e.get("span", "?"), "cat": "span",
                            "ph": "X", "ts": us(t - ms / 1e3),
                            "dur": round(ms * 1e3, 3), "pid": pid,
                            "tid": depth(sid), "args": args})
        else:
            out.append({"name": e["event"], "cat": "event", "ph": "i",
                        "s": "p", "ts": us(t), "pid": pid, "tid": 0,
                        "args": args})

    # request flow arrows: group closed serve.hop.* spans by the root of
    # their parent chain (one root = one request), then stitch the group
    # in begin-time order as s → t → ... → f steps.  Each step sits at
    # its hop's begin inside that hop's pid/tid lane, so the viewer
    # draws the request hopping across process lanes.
    def _flow_root(sid):
        seen = set()
        while sid not in seen:
            seen.add(sid)
            rec = begins.get(sid) or ends.get(sid)
            parent = rec.get("parent") if rec else None
            if parent is None or (parent not in begins
                                  and parent not in ends):
                return sid
            sid = parent
        return sid

    flows = defaultdict(list)
    for sid, b in begins.items():
        if (str(b.get("span", "")).startswith("serve.hop.")
                and sid in ends
                and isinstance(b.get("t"), (int, float))):
            flows[_flow_root(sid)].append(b)
    for flow_id, (root, hops) in enumerate(sorted(flows.items(),
                                                  key=lambda kv: str(kv[0])),
                                           start=1):
        if len(hops) < 2:
            continue  # a single-hop request has no arrow to draw
        hops.sort(key=lambda b: b["t"])
        for i, b in enumerate(hops):
            ph = "s" if i == 0 else ("f" if i == len(hops) - 1 else "t")
            ev = {"name": "request", "cat": "flow", "ph": ph,
                  "id": flow_id, "ts": us(b["t"]),
                  "pid": _chrome_pid(b), "tid": depth(b.get("id"))}
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice, not the next
            out.append(ev)
    out.sort(key=lambda ev: ev["ts"])
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": label}} for pid, label in sorted(pids.items())]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


# --------------------------------------------------------------- waterfall

def clock_shifts(events: list[dict]) -> dict:
    """Per-pid clock edges from the ``clock-offset`` events.

    Each event was recorded by ``pid`` after pinging ``peer_pid`` and
    says: at one instant, the peer's clock read ``offset_ms`` more than
    ours, give or take ``err_ms`` (half the round trip — the classic
    Cristian bound).  Returns ``{(recorder, peer): (offset_ms, err_ms)}``
    keeping the last (most-converged EWMA) sample per pair.
    """
    edges: dict = {}
    for e in events:
        if e["event"] != "clock-offset":
            continue
        a, b = e.get("pid"), e.get("peer_pid")
        off = e.get("offset_ms")
        if not isinstance(a, int) or not isinstance(b, int) or \
                not isinstance(off, (int, float)):
            continue
        err = e.get("err_ms")
        edges[(a, b)] = (float(off),
                         float(err) if isinstance(err, (int, float)) else 0.0)
    return edges


def resolve_shifts(edges: dict, ref_pid: int) -> dict:
    """BFS the pid graph: ``{pid: (shift_ms, err_ms)}`` where adding
    ``shift_ms`` to a timestamp taken on ``pid``'s clock expresses it on
    ``ref_pid``'s timeline, with ``err_ms`` the accumulated uncertainty
    along the path (errors add — each synced link contributes its own
    half-RTT bound).  Unreachable pids are absent: the caller renders
    them unshifted and flags the missing alignment."""
    adj = defaultdict(list)
    for (a, b), (off, err) in edges.items():
        # recorded: t_peer = t_rec + off.  Walking rec→peer converts a
        # peer timestamp back by -off; peer→rec converts forward by +off.
        adj[a].append((b, -off, err))
        adj[b].append((a, +off, err))
    shifts = {ref_pid: (0.0, 0.0)}
    frontier = [ref_pid]
    while frontier:
        nxt = []
        for u in frontier:
            s, se = shifts[u]
            for v, d, err in adj[u]:
                if v not in shifts:
                    shifts[v] = (s + d, se + err)
                    nxt.append(v)
        frontier = nxt
    return shifts


def build_waterfalls(events: list[dict], key: str,
                     ref_pid: int | None = None) -> dict:
    """Reassemble per-request waterfalls from the ``serve.hop.*`` spans.

    ``key`` matches a hop's ``rid`` tag or a trace id.  Each matching
    hop's parent chain is walked to its root (the client hop when the
    client's sink file is included); every hop sharing that root is one
    request, rendered as one tree.  Rids restart per process — the same
    number can name different requests in the client, front-tier, and
    replica domains — so distinct roots become distinct trees and the
    caller picks by trace id.

    Timestamps are shifted onto ``ref_pid``'s clock (default: the pid
    that recorded the front tier's ``serve.hop.route``, else the root's
    recorder) via the ``clock-offset`` peer graph, carrying the
    accumulated ± error bound so hop ordering claims are honest about
    alignment uncertainty.
    """
    begins = {e["id"]: e for e in events
              if e["event"] == "span-begin" and e.get("id") is not None}
    ends = {e["id"]: e for e in events
            if e["event"] == "span-end" and e.get("id") is not None}

    def rec(sid):
        return begins.get(sid) or ends.get(sid)

    hop_ids = [sid for sid in {**begins, **ends}
               if str(rec(sid).get("span", "")).startswith("serve.hop.")]

    def root_of(sid):
        seen = set()
        while sid not in seen:
            seen.add(sid)
            parent = (rec(sid) or {}).get("parent")
            if parent is None or rec(parent) is None:
                return sid
            sid = parent
        return sid

    seeds = [sid for sid in hop_ids
             if str(rec(sid).get("rid")) == key
             or str(rec(sid).get("trace")) == key]
    roots = sorted({root_of(s) for s in seeds}, key=str)
    by_root = defaultdict(list)
    for sid in hop_ids:
        by_root[root_of(sid)].append(sid)

    trees = []
    for root in roots:
        members = by_root[root]
        pids = sorted({rec(s).get("pid") for s in members
                       if isinstance(rec(s).get("pid"), int)})
        traces = sorted({str(rec(s).get("trace")) for s in members
                         if rec(s).get("trace")})
        route = [s for s in members
                 if rec(s).get("span") == "serve.hop.route"]
        ref = ref_pid if ref_pid is not None else \
            rec((route or [root])[0]).get("pid")
        shifts = resolve_shifts(clock_shifts(events), ref) \
            if isinstance(ref, int) else {}

        hops = {}
        for sid in members:
            b, e = begins.get(sid), ends.get(sid)
            r = b or e
            pid = r.get("pid")
            shift, err = shifts.get(pid, (0.0, 0.0))
            ms = e.get("ms") if e and isinstance(e.get("ms"),
                                                 (int, float)) else None
            # an end without its begin (ring truncation) still has a
            # start: rewind its local ms from the end stamp
            t = b.get("t") if b else (
                e["t"] - (ms or 0.0) / 1e3
                if isinstance(e.get("t"), (int, float)) else None)
            hops[sid] = {
                "span": r.get("span"), "id": sid,
                "parent": r.get("parent"), "pid": pid,
                "rank": r.get("rank"), "rid": r.get("rid"),
                "start_s": (t + shift / 1e3
                            if isinstance(t, (int, float)) else None),
                "dur_ms": ms,
                "err_ms": round(err, 3),
                "aligned": pid in shifts,
                "open": e is None,
                "requeued": bool((e or {}).get("requeued")),
            }
        t0 = min((h["start_s"] for h in hops.values()
                  if h["start_s"] is not None), default=0.0)
        for h in hops.values():
            h["start_ms"] = (round((h.pop("start_s") - t0) * 1e3, 3)
                             if h["start_s"] is not None
                             else h.pop("start_s"))
        children = defaultdict(list)
        for sid, h in hops.items():
            if sid != root:
                children[h["parent"]].append(sid)
        for kids in children.values():
            kids.sort(key=lambda s: (hops[s]["start_ms"]
                                     if hops[s]["start_ms"] is not None
                                     else float("inf"), str(s)))

        ordered = []

        def _walk(sid, depth):
            h = dict(hops[sid])
            h["depth"] = depth
            ordered.append(h)
            for kid in children.get(sid, []):
                _walk(kid, depth + 1)

        _walk(root, 0)
        trees.append({"root": root, "ref_pid": ref, "pids": pids,
                      "trace_ids": traces, "hops": ordered})
    return {"key": key, "trees": trees}


def render_waterfall(doc: dict, out=None) -> None:
    """Text tree, one per matched request: indented hops with their
    start on the reference timeline (± the clock-alignment bound when
    the hop lives on a synced remote pid), duration, and the markers
    that matter for the zero-loss story (``REQUEUED``, ``[open]``)."""
    w = (out or sys.stdout).write
    if not doc["trees"]:
        w(f"no serve.hop.* spans match rid/trace {doc['key']!r}\n")
        return
    for tree in doc["trees"]:
        w(f"request {doc['key']} trace={','.join(tree['trace_ids']) or '-'} "
          f"({len(tree['hops'])} hop(s) across {len(tree['pids'])} pid(s), "
          f"timeline of pid {tree['ref_pid']})\n")
        for h in tree["hops"]:
            start = (f"+{h['start_ms']:.3f}" if h["start_ms"] is not None
                     else "?")
            err = ""
            if h["err_ms"] and h["aligned"]:
                err = f" ±{h['err_ms']:.3f}"
            elif not h["aligned"]:
                err = " ±?"  # pid never clock-synced against the ref
            dur = (f" {h['dur_ms']:.3f}ms" if h["dur_ms"] is not None
                   else " [open]")
            tags = f" rid={h['rid']}" if h.get("rid") is not None else ""
            if h["requeued"]:
                tags += " REQUEUED"
            w(f"  {'  ' * h['depth']}{h['span']:<{max(2, 24 - 2 * h['depth'])}}"
              f" pid {h['pid']} {start}{err}ms{dur}{tags}\n")


# ------------------------------------------------------------------ flight

def load_metrics_snapshot(path: str) -> dict:
    """A metrics snapshot from any of the formats that carry one: a
    snapshot JSON document, a flight dump (its ``metrics`` key), or a
    trace JSONL file (the last ``metrics-snapshot`` event).  Raises
    TraceParseError when none is found."""
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            try:
                doc = json.load(f)
            except ValueError:
                doc = None
            if isinstance(doc, dict):
                if "counters" in doc or "histograms" in doc:
                    return doc
                if isinstance(doc.get("metrics"), dict):
                    return doc["metrics"]
    snaps = [e for e in load_events([path]) if e["event"] == "metrics-snapshot"]
    if not snaps:
        raise TraceParseError(f"{path}: no metrics snapshot found")
    return snaps[-1].get("metrics", {})


def load_flight(path: str) -> dict:
    """Parse a flight dump; TraceParseError when it isn't one."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except ValueError as e:
        raise TraceParseError(f"{path}: {e}") from e
    if not isinstance(doc, dict) or "reason" not in doc or \
            not isinstance(doc.get("events"), list):
        raise TraceParseError(f"{path}: not a flight dump")
    return doc


def render_flight(doc: dict, out=None) -> None:
    """Human rendering of a flight dump: header, traceback, open spans,
    the pre-crash timeline, and a metrics digest."""
    out = out or sys.stdout
    w = out.write
    plat = doc.get("platform") or {}
    w(f"flight dump: reason {doc.get('reason')!r}, pid {doc.get('pid')}, "
      f"rank {doc.get('rank')}, incarnation {doc.get('incarnation')}\n")
    w(f"  platform: python {plat.get('python')}, torch {plat.get('torch')}, "
      f"CUDA {plat.get('cuda')}"
      + (f", {plat['card']}" if plat.get("card") else "")
      + f", {plat.get('platform')}\n")
    if plat.get("argv"):
        w(f"  argv: {' '.join(str(a) for a in plat['argv'])}\n")
    if doc.get("traceback"):
        w("traceback:\n")
        for line in str(doc["traceback"]).rstrip().split("\n"):
            w(f"  {line}\n")
    open_spans = doc.get("open_spans") or []
    if open_spans:
        w(f"open spans at death ({len(open_spans)}):\n")
        for s in open_spans:
            w(f"  {s.get('span')} (id {s.get('id')}, "
              f"parent {s.get('parent')})\n")
    health = doc.get("health")
    if health:
        w(f"last device health: "
          f"{'HEALTHY' if health.get('healthy') else 'UNHEALTHY'} "
          f"({health.get('platform')}, {health.get('device_count')} "
          f"device(s), probe {health.get('probe_ms')} ms)\n")
        for st in health.get("stages") or []:
            if not st.get("ok"):
                w(f"  failed stage {st.get('stage')}: "
                  f"{st.get('detail')}\n")
    forensics = doc.get("forensics") or {}
    for label, frame in (("open forensics stage", forensics.get("open")),
                         ("last failed stage",
                          forensics.get("last_failed"))):
        if frame:
            tail = (f" ({frame['error']})" if frame.get("error") else "")
            w(f"{label}: {frame.get('op')} @ {frame.get('stage')}{tail}\n")
    numeric = doc.get("numerics") or {}
    if numeric.get("budget") or numeric.get("demoted"):
        demoted = numeric.get("demoted") or []
        w(f"last numeric drift: {len(numeric.get('budget') or {})} "
          f"budgeted rung(s), {len(demoted)} demoted"
          + (f" ({', '.join(demoted)})" if demoted else "") + "\n")
        for key, st in sorted((numeric.get("budget") or {}).items()):
            w(f"  {key}: {st.get('samples')} sample(s), "
              f"{st.get('over')} over, last rel_l2 "
              f"{st.get('last_rel_l2')}"
              + (" BURNING" if st.get("burning") else "") + "\n")
    events = doc.get("events") or []
    w(f"last {len(events)} event(s) before death:\n")
    render_timeline(events, out=out)
    m = doc.get("metrics") or {}
    w(f"metrics at death: {len(m.get('counters', {}))} counters, "
      f"{len(m.get('gauges', {}))} gauges, "
      f"{len(m.get('histograms', {}))} histograms\n")


# -------------------------------------------------------------------- main

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cme213_tpu_torch trace",
        description="analyze CME213_TRACE_FILE JSON-lines traces")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_sum = sub.add_parser("summary", help="aggregate report over traces")
    p_sum.add_argument("files", nargs="+")
    p_sum.add_argument("--require", default="",
                       help="comma-separated span OR event names that must "
                            "appear (a span must have completed; an event "
                            "name — e.g. conformance-failed — must occur "
                            "at least once); exit 1 otherwise — the CI "
                            "gate")
    p_sum.add_argument("--json", action="store_true",
                       help="print the aggregates as one JSON document "
                            "instead of the text report (what CI and the "
                            "regression gate consume)")
    p_sum.add_argument("--single-trace", action="store_true",
                       help="exit 1 unless the records carry exactly one "
                            "trace id — the cross-process propagation gate")

    p_tl = sub.add_parser("timeline", help="chronological event listing")
    p_tl.add_argument("files", nargs="+")
    p_tl.add_argument("--all", action="store_true",
                      help="include span-begin records")

    for p in (p_sum, p_tl):
        p.add_argument("--since", default=None,
                       help="only records newer than this: a number is "
                            "milliseconds back from the newest record, "
                            "else an ISO-8601 timestamp")
        p.add_argument("--last", type=int, default=None,
                       help="only the N newest records (after --since)")

    p_mg = sub.add_parser("merge", help="interleave per-rank files")
    p_mg.add_argument("files", nargs="+")
    p_mg.add_argument("--timeline", action="store_true",
                      help="render the merged gang timeline instead of "
                           "JSON lines")
    p_mg.add_argument("--out", default=None,
                      help="write merged JSON lines here (default stdout)")
    p_mg.add_argument("--follow", action="store_true",
                      help="keep tailing the files (live collector) "
                           "instead of one post-mortem pass; globs are "
                           "re-expanded as ranks appear")
    p_mg.add_argument("--interval", type=float, default=0.5,
                      help="seconds between polls in --follow mode")
    p_mg.add_argument("--max-seconds", type=float, default=None,
                      help="stop following after this many seconds")

    p_ex = sub.add_parser("export", help="Chrome trace-event JSON "
                                         "(Perfetto / chrome://tracing)")
    p_ex.add_argument("files", nargs="+")
    p_ex.add_argument("--out", default=None,
                      help="write the Chrome trace here (default stdout)")

    p_wf = sub.add_parser("waterfall",
                          help="one request's hops as a clock-aligned "
                               "cross-process tree")
    p_wf.add_argument("rid", help="request id (any hop's rid tag) or a "
                                  "trace id")
    p_wf.add_argument("files", nargs="+")
    p_wf.add_argument("--json", action="store_true",
                      help="print the waterfall document instead of the "
                           "text tree (what the CI gate consumes)")
    p_wf.add_argument("--ref-pid", type=int, default=None,
                      help="pid whose clock anchors the timeline "
                           "(default: the front tier's — the pid that "
                           "recorded serve.hop.route)")

    p_rg = sub.add_parser("regress", help="bench regression gate "
                                          "(bench/regress.py)")
    p_rg.add_argument("args", nargs=argparse.REMAINDER,
                      help="arguments forwarded to bench.regress")

    p_mt = sub.add_parser("metrics", help="Prometheus text exposition of "
                                          "a metrics snapshot")
    p_mt.add_argument("file",
                      help="trace JSONL (last metrics-snapshot event), "
                           "snapshot JSON, or flight dump")

    p_fl = sub.add_parser("flight", help="render a crash flight dump")
    p_fl.add_argument("file", help="flight-<pid>-<ts>.json dump")

    # intercepted before argparse: REMAINDER won't swallow leading flags
    # (``trace regress --fresh ...``), and regress owns its own CLI
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "regress":
        from .bench.regress import main as regress_main

        return regress_main(list(argv[1:]))

    args = ap.parse_args(argv)
    if args.cmd == "metrics":
        from .core.metrics import render_prometheus
        try:
            snap = load_metrics_snapshot(args.file)
        except (TraceParseError, OSError) as e:
            print(f"trace: {e}", file=sys.stderr)
            return 2
        sys.stdout.write(render_prometheus(snap))
        return 0
    if args.cmd == "flight":
        try:
            doc = load_flight(args.file)
        except (TraceParseError, OSError) as e:
            print(f"trace: {e}", file=sys.stderr)
            return 2
        render_flight(doc)
        return 0
    if args.cmd == "merge" and args.follow:
        # live mode rides the collector's tailer (rotation/truncation-
        # safe, partial-line tolerant) instead of the strict parser: a
        # torn tail line is pending input here, not a corrupt trace
        from .core.collector import Collector

        coll = Collector(args.files)
        deadline = (time.monotonic() + args.max_seconds
                    if args.max_seconds else None)
        out = open(args.out, "w") if args.out else sys.stdout
        t0: float | None = None
        try:
            while True:
                for e in coll.poll():
                    t = e.get("t")
                    if t0 is None and isinstance(t, (int, float)):
                        t0 = t
                    if args.timeline:
                        out.write(_timeline_line(e, t0 or 0.0))
                    else:
                        rec = {k: v for k, v in e.items() if k != "_file"}
                        out.write(json.dumps(rec, default=str) + "\n")
                    out.flush()
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(args.interval)
        except KeyboardInterrupt:
            pass
        finally:
            if args.out:
                out.close()
        return 0
    try:
        events = load_events(args.files,
                             tolerate_torn=(args.cmd == "waterfall"))
    except (TraceParseError, OSError) as e:
        print(f"trace: {e}", file=sys.stderr)
        return 2
    if args.cmd in ("summary", "timeline"):
        try:
            events = window_events(events, since=args.since, last=args.last)
        except ValueError as e:
            print(f"trace: {e}", file=sys.stderr)
            return 2

    if args.cmd == "waterfall":
        doc = build_waterfalls(events, args.rid, ref_pid=args.ref_pid)
        if args.json:
            print(json.dumps(doc, indent=2, default=str))
        else:
            render_waterfall(doc)
        return 0 if doc["trees"] else 1
    if args.cmd == "export":
        doc = to_chrome_trace(events)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(doc, f, default=str)
        else:
            json.dump(doc, sys.stdout, default=str)
            sys.stdout.write("\n")
        return 0
    if args.cmd == "summary":
        import io

        text = io.StringIO() if args.json else None
        agg = summarize(events, out=text)
        if args.json:
            print(json.dumps(agg, indent=2, default=str))
        required = [s.strip() for s in args.require.split(",") if s.strip()]
        missing = [s for s in required
                   if s not in agg["spans"] and not agg["counts"].get(s)]
        if missing:
            print(f"trace: required span(s)/event(s) never appeared: "
                  f"{', '.join(missing)}", file=sys.stderr)
            return 1
        if args.single_trace and len(agg["trace_ids"]) != 1:
            print(f"trace: expected exactly one trace id, saw "
                  f"{len(agg['trace_ids'])} "
                  f"({', '.join(agg['trace_ids']) or '-'})",
                  file=sys.stderr)
            return 1
        return 0
    if args.cmd == "timeline":
        render_timeline(events, show_all=args.all)
        return 0
    # merge
    if args.timeline:
        render_timeline(events)
        return 0
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        for e in events:
            rec = {k: v for k, v in e.items() if k != "_file"}
            out.write(json.dumps(rec, default=str) + "\n")
    finally:
        if args.out:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
