"""Live gang collector: tail N per-rank trace sinks into one fleet view.

Counterpart of ``cme213_tpu/core/collector.py``, the same code over the
port's sinks (whose records are the JAX package's, ``core/trace.py``), so
the two packages' collectors give one state for the same files.  It tails
every rank's JSON-lines sink (polling, so it works on any filesystem),
merges the records into one stream ordered by time and keyed by the
process-spanning trace id, and keeps the rolling aggregates the consoles
read: per-rank heartbeat freshness, epoch-commit lag, shed, breaker and
SLO-burn counters, span totals, solver convergence.

Consumers:

- ``python -m cme213_tpu_torch collect`` (this module's CLI): the merged
  state once (``--once``/``--json``) or the merged record stream as JSON
  lines (``--follow``).
- ``python -m cme213_tpu_torch top`` (``top_cli.py``): the live console.
- ``trace merge --follow`` (``trace_cli.py``): the same tailer, as a
  timeline or JSON lines.
- :func:`write_fleet_exposition` folds every rank's final
  ``metrics-snapshot`` into one Prometheus file (``CME213_METRICS_FILE``).

Tailing is rotation- and truncation-safe (an inode change or a shrinking
file resets the cursor) and tolerates partial lines (a torn tail line is
buffered until its newline arrives): a rank killed mid-write must never
corrupt the merged view, only delay it.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time

#: events that condemn/describe gang lifecycle vs. per-request flow
_SHED_EVENTS = {"queue-shed", "deadline-shed", "admission-rejected"}


class SinkTailer:
    """Incremental reader for one JSON-lines sink file.

    ``poll()`` returns the complete records appended since the last call.
    The file may not exist yet (a rank that hasn't opened its sink), may
    be rotated (inode change) or truncated (size below the cursor) — both
    reset the cursor to 0 so the replacement file is read from its start.
    A partial trailing line is buffered, not parsed; malformed complete
    lines are counted (``malformed``) and skipped.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.malformed = 0
        self._offset = 0
        self._sig: tuple | None = None
        self._buf = b""

    def poll(self) -> list[dict]:
        try:
            st = os.stat(self.path)
        except OSError:
            return []
        sig = (st.st_ino, st.st_dev)
        if sig != self._sig or st.st_size < self._offset:
            # rotated (new inode) or truncated: restart from the top
            self._offset, self._buf, self._sig = 0, b"", sig
        if st.st_size <= self._offset:
            return []
        try:
            # binary mode: offsets are byte-exact (text-mode tell() lies)
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
                self._offset = f.tell()
        except OSError:
            return []
        lines = (self._buf + chunk).split(b"\n")
        self._buf = lines.pop()  # b"" when the chunk ended on a newline
        records = []
        for raw in lines:
            raw = raw.strip()
            if not raw:
                continue
            try:
                doc = json.loads(raw.decode("utf-8", errors="replace"))
            except ValueError:
                self.malformed += 1
                continue
            if not isinstance(doc, dict) or "event" not in doc:
                self.malformed += 1
                continue
            doc["_file"] = self.path
            records.append(doc)
        return records


def _rank_key(rec: dict) -> str:
    rank = rec.get("rank")
    return f"r{rank}" if rank is not None else "main"


def _rank_sort_key(label: str):
    if label.startswith("r") and label[1:].isdigit():
        return (0, int(label[1:]), label)
    return (1, 0, label)


def _new_row() -> dict:
    return {"pid": None, "incarnation": 0, "state": "unknown", "step": None,
            "heartbeat_t": None, "last_span": None, "last_event": None,
            "last_t": None, "breakers_open": 0, "degraded": False,
            "events": 0, "metrics": None, "role": None, "occupancy": None}


class Collector:
    """Merge N tailed sinks into rolling fleet aggregates.

    ``patterns`` may mix literal paths and globs; globs are re-expanded
    on every ``poll()`` so ranks that open their sink late (or replicas
    that join) are picked up without a restart.  Each ``poll()`` returns
    the new batch, time-ordered across files — the causally-ordered
    merged stream — and folds it into ``state()``.
    """

    def __init__(self, patterns):
        self.patterns = [str(p) for p in patterns]
        self._tailers: dict[str, SinkTailer] = {}
        self.trace_ids: set = set()
        self.ranks: dict[str, dict] = {}
        self.fleet: collections.Counter = collections.Counter()
        self.spans: dict[str, dict] = {}
        self.verdicts: list[dict] = []
        #: per-op convergence rows from solver-progress events (the
        #: STALLED verdict `top` renders; same policy as
        #: core/numerics.ConvergenceTracker's default)
        self.solvers: dict[str, dict] = {}
        #: durable long-job rows from job-* lifecycle events (serve/jobs.py)
        self.jobs: dict[str, dict] = {}
        self.recent: collections.deque = collections.deque(maxlen=64)
        #: slowest request hops seen (serve.hop.client / serve.hop.route
        #: span-ends), descending ms — the "which requests hurt" ribbon
        self.slowest: list[dict] = []
        self.last_commit: dict | None = None
        self.last_rc = None
        self.events = 0
        self.last_t: float | None = None

    # ------------------------------------------------------------ tailing

    def _expand(self) -> None:
        for pat in self.patterns:
            paths = (sorted(glob.glob(pat))
                     if any(ch in pat for ch in "*?[") else [pat])
            for p in paths:
                if p not in self._tailers:
                    self._tailers[p] = SinkTailer(p)

    def poll(self) -> list[dict]:
        self._expand()
        batch: list[dict] = []
        for tailer in self._tailers.values():
            batch.extend(tailer.poll())
        # time-order across files: each sink is append-ordered already,
        # so a stable sort on t interleaves ranks causally (same-clock
        # single host; cross-host skew is a known Dapper-style caveat)
        batch.sort(key=lambda r: (r.get("t") or 0.0))
        for rec in batch:
            self._ingest(rec)
        return batch

    # ---------------------------------------------------------- ingestion

    def _ingest(self, rec: dict) -> None:
        self.events += 1
        event = rec.get("event")
        t = rec.get("t")
        if isinstance(t, (int, float)):
            self.last_t = t if self.last_t is None else max(self.last_t, t)
        trace = rec.get("trace")
        if trace:
            self.trace_ids.add(str(trace))

        key = _rank_key(rec)
        row = self.ranks.setdefault(key, _new_row())
        row["events"] += 1
        row["last_event"] = event
        row["last_t"] = t
        if event not in ("rank-failed", "replica-down"):
            # rank-failed / replica-down are a supervisor reporting on a
            # condemned worker: the record mixes the emitter's identity
            # with the worker's (launcher pid + worker rank; front-tier
            # rank + replica incarnation) — folding it into either row's
            # pid/incarnation state would cross-contaminate them
            row["pid"] = rec.get("pid", row["pid"])
            inc = rec.get("incarnation", row["incarnation"]) or 0
            if inc != row["incarnation"]:
                # a restarted incarnation starts clean: stale failure
                # state must not shadow the replacement process
                row.update(incarnation=inc, state="unknown",
                           breakers_open=0, degraded=False)

        if event == "heartbeat":
            row["state"] = "running"
            row["step"] = rec.get("step")
            row["heartbeat_t"] = t
        elif event == "rank-failed":
            row["state"] = "failed"
            self.verdicts.append({"rank": rec.get("rank"),
                                  "reason": rec.get("reason"),
                                  "incarnation": rec.get("incarnation"),
                                  "t": t})
            self.fleet["verdicts"] += 1
        elif event == "gang-launch":
            self.fleet["launches"] += 1
        elif event == "gang-restart":
            self.fleet["restarts"] += 1
        elif event == "gang-exit":
            self.fleet["exits"] += 1
            self.last_rc = rec.get("rc")
        elif event == "epoch-commit":
            self.fleet["commits"] += 1
            self.last_commit = {"epoch": rec.get("epoch"),
                                "step": rec.get("step"), "t": t}
        elif event in _SHED_EVENTS:
            self.fleet["sheds"] += 1
        elif event == "slo-burn":
            self.fleet["slo_burns"] += 1
        elif event == "breaker-open":
            self.fleet["breaker_opens"] += 1
            row["breakers_open"] += 1
        elif event == "breaker-close":
            row["breakers_open"] = max(0, row["breakers_open"] - 1)
        elif event == "request-served":
            self.fleet["requests"] += 1
        elif event == "replica-up":
            # emitted by the replica worker itself: its row is `key`
            self.fleet["replica_ups"] += 1
            row.update(role="replica", state="running")
        elif event == "replica-down":
            # emitted by the fleet front tier ABOUT a replica — like
            # rank-failed, the condemned row is the replica's, not the
            # emitter's
            self.fleet["replica_downs"] += 1
            target = self.ranks.get(f"r{rec.get('replica')}")
            if target is not None:
                target["state"] = ("retired"
                                   if rec.get("reason") == "retired"
                                   else "down")
        elif event == "request-routed":
            self.fleet["routed"] += 1
        elif event == "request-requeued":
            self.fleet["requeues"] += 1
        elif event == "scale-up":
            self.fleet["scale_ups"] += 1
        elif event == "scale-down":
            self.fleet["scale_downs"] += 1
        elif event == "batch-executed":
            occ = rec.get("occupancy")
            if isinstance(occ, (int, float)):
                row["occupancy"] = occ
        elif event == "conformance-failed":
            self.fleet["conformance_failures"] += 1
        elif event == "attribution-mismatch":
            self.fleet["attribution_mismatches"] += 1
        elif event == "numeric-drift":
            self.fleet["drift_samples"] += 1
            if rec.get("over_budget"):
                self.fleet["drift_over_budget"] += 1
        elif event == "drift-budget-burn":
            self.fleet["drift_demotions"] += 1
        elif event == "numeric-sentinel":
            self.fleet["sentinel_trips"] += 1
        elif event == "solver-progress":
            self._ingest_progress(rec)
        elif event in ("job-submitted", "job-epoch", "job-preempted",
                       "job-resumed", "job-done", "job-reassigned"):
            self._ingest_job(event, rec)
        elif event == "served" and rec.get("demoted"):
            row["degraded"] = True
        elif event == "flight-dump":
            row["state"] = "crashed"
        elif event == "span-begin":
            row["last_span"] = rec.get("span")
        elif event == "span-end":
            name = rec.get("span")
            ms = rec.get("ms")
            if name and isinstance(ms, (int, float)):
                agg = self.spans.setdefault(
                    name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
                agg["count"] += 1
                agg["total_ms"] = round(agg["total_ms"] + ms, 3)
                agg["max_ms"] = max(agg["max_ms"], round(ms, 3))
                if name in ("serve.hop.client", "serve.hop.route"):
                    self._note_slowest(rec, ms)
        elif event == "metrics-snapshot":
            if isinstance(rec.get("metrics"), dict):
                row["metrics"] = rec["metrics"]

        if event not in ("span-begin", "span-end", "heartbeat",
                         "solver-progress"):
            self.recent.append({"t": t, "rank": key, "event": event})

    #: slowest-traces ribbon depth
    _SLOWEST_N = 8

    def _note_slowest(self, rec: dict, ms: float) -> None:
        """Track the top-N slowest request hops.  The entry carries
        everything `trace waterfall` needs to pull the full tree: the
        rid tag (its argument) and the trace id (the cross-file join
        key).  Client and route hops both feed the ribbon — whichever
        tier's sink the collector can see still surfaces the pain."""
        self.slowest.append({
            "span": rec.get("span"), "ms": round(ms, 3),
            "rid": rec.get("rid"), "trace": rec.get("trace"),
            "rank": _rank_key(rec), "status": rec.get("status"),
            "requeues": rec.get("requeues"), "t": rec.get("t")})
        self.slowest.sort(key=lambda e: -e["ms"])
        del self.slowest[self._SLOWEST_N:]

    #: solver-progress stall policy (matches ConvergenceTracker defaults)
    _STALL_EPOCHS = 5
    _MIN_IMPROVE = 1e-3

    def _ingest_progress(self, rec: dict) -> None:
        # keyed by (op, job): two concurrent jobs running the same op
        # must not fold into one convergence row
        op = str(rec.get("op") or "solver")
        if rec.get("job"):
            op = f"{op}[{rec['job']}]"
        res = rec.get("residual")
        if not isinstance(res, (int, float)):
            return
        row = self.solvers.setdefault(op, {
            "step": None, "residual": None, "iters_per_s": None,
            "best": None, "since_improve": 0, "stalled": False})
        row["step"] = rec.get("step")
        row["residual"] = res
        row["iters_per_s"] = rec.get("iters_per_s")
        best = row["best"]
        if best is None or res < best * (1.0 - self._MIN_IMPROVE):
            row["best"] = res
            row["since_improve"] = 0
        else:
            row["since_improve"] += 1
        row["stalled"] = row["since_improve"] >= self._STALL_EPOCHS

    def _ingest_job(self, event: str, rec: dict) -> None:
        jid = str(rec.get("job") or "?")
        row = self.jobs.setdefault(jid, {
            "op": rec.get("op"), "state": None, "epoch": None,
            "total_epochs": None, "residual": None, "epochs_seen": 0,
            "resumes": 0, "preemptions": 0, "reassigned": 0,
            "owner": None, "last_t": rec.get("t")})
        row["last_t"] = rec.get("t")
        if event == "job-submitted":
            row.update(op=rec.get("op"), state="PENDING",
                       total_epochs=rec.get("total_epochs"))
            self.fleet["jobs_submitted"] += 1
        elif event == "job-epoch":
            row.update(state="RUNNING", epoch=rec.get("epoch"),
                       residual=rec.get("residual"))
            row["epochs_seen"] += 1
            self.fleet["job_epochs"] += 1
        elif event == "job-preempted":
            row.update(state="PREEMPTED", epoch=rec.get("epoch"))
            row["preemptions"] += 1
            self.fleet["job_preemptions"] += 1
        elif event == "job-resumed":
            row.update(state="RUNNING", epoch=rec.get("epoch"))
            row["resumes"] += 1
            self.fleet["job_resumes"] += 1
        elif event == "job-reassigned":
            row["reassigned"] += 1
            row["owner"] = rec.get("target")
            self.fleet["job_reassignments"] += 1
        else:                            # job-done
            row.update(state=rec.get("state"))
            self.fleet["jobs_done"] += 1

    # ------------------------------------------------------------- output

    def state(self) -> dict:
        """The merged fleet view, deterministic for ``--once --json``:
        ages are computed against the newest *observed* event time, not
        the wall clock, so re-rendering an idle capture is stable."""
        now_t = self.last_t
        ranks_out = {}
        for key in sorted(self.ranks, key=_rank_sort_key):
            row = dict(self.ranks[key])
            hb = row.get("heartbeat_t")
            row["heartbeat_age_s"] = (
                round(now_t - hb, 3)
                if hb is not None and now_t is not None else None)
            ranks_out[key] = row
        commit_lag_s = (
            round(now_t - self.last_commit["t"], 3)
            if self.last_commit and self.last_commit.get("t") is not None
            and now_t is not None else None)
        return {
            "files": sorted(self._tailers),
            "events": self.events,
            "malformed": sum(t.malformed for t in self._tailers.values()),
            "trace_ids": sorted(self.trace_ids),
            "ranks": ranks_out,
            "fleet": dict(sorted(self.fleet.items())),
            "verdicts": list(self.verdicts),
            "solvers": {k: dict(v) for k, v in sorted(self.solvers.items())},
            "jobs": {k: dict(v) for k, v in sorted(self.jobs.items())},
            "spans": {k: dict(v) for k, v in sorted(self.spans.items())},
            "slowest_traces": [dict(e) for e in self.slowest],
            "recent": list(self.recent),
            "last_rc": self.last_rc,
            "last_commit": self.last_commit,
            "commit_lag_s": commit_lag_s,
        }

    def fleet_snapshots(self) -> dict[str, dict]:
        """Last seen per-rank metrics snapshot, keyed by rank label —
        the input shape ``metrics.render_prometheus(fleet=...)`` takes."""
        return {key: row["metrics"] for key, row in self.ranks.items()
                if isinstance(row.get("metrics"), dict)}


def write_fleet_exposition(sink_paths, path: str | None = None,
                           extra: dict[str, dict] | None = None) -> str | None:
    """Fold the final ``metrics-snapshot`` of every sink in ``sink_paths``
    (plus ``extra`` — e.g. the launcher's own live registry) into one
    federated Prometheus exposition at ``path`` (default
    ``CME213_METRICS_FILE``).  Atomic tmp + ``os.replace``; the written
    path is pinned against the atexit single-process overwrite.  Returns
    the path written, or None when unconfigured or nothing to expose."""
    from . import metrics

    path = path or os.environ.get(metrics.METRICS_FILE_ENV)
    if not path:
        return None
    coll = Collector(sink_paths)
    coll.poll()
    fleet = coll.fleet_snapshots()
    if extra:
        fleet.update(extra)
    text = metrics.render_prometheus(fleet=fleet) if fleet else ""
    if not text:
        return None
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    metrics.suppress_exit_exposition(path)
    return path


def render_state(state: dict, out) -> None:
    """Compact text rendering of :meth:`Collector.state` (the ``collect``
    one-shot default; ``top`` owns the full console)."""
    ids = state["trace_ids"]
    out.write(f"fleet: {len(state['ranks'])} proc(s), "
              f"{state['events']} event(s), "
              f"{len(ids)} trace id(s)"
              + (f" [{ids[0]}]" if len(ids) == 1 else "") + "\n")
    for key, row in state["ranks"].items():
        hb = row["heartbeat_age_s"]
        out.write(f"  {key:<6} {row['state']:<8} pid={row['pid']} "
                  f"inc={row['incarnation']} step={row['step']} "
                  f"hb_age={hb if hb is not None else '-'}s "
                  f"last={row['last_event']}\n")
    if state["fleet"]:
        out.write("  fleet counters: "
                  + " ".join(f"{k}={v}"
                             for k, v in state["fleet"].items()) + "\n")
    if state["verdicts"]:
        for v in state["verdicts"]:
            out.write(f"  verdict: rank {v['rank']} {v['reason']} "
                      f"(incarnation {v['incarnation']})\n")
    for e in state.get("slowest_traces", [])[:4]:
        out.write(f"  slow: {e['ms']}ms {e['span']} rid={e['rid']} "
                  f"trace={e['trace']} ({e['rank']}"
                  + (f", {e['requeues']} requeue(s)" if e.get("requeues")
                     else "") + ")\n")
    if state["malformed"]:
        out.write(f"  malformed lines skipped: {state['malformed']}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cme213_tpu_torch collect",
        description="tail per-rank trace sinks into one live fleet view")
    ap.add_argument("files", nargs="+",
                    help="sink files or globs (re-expanded every poll)")
    ap.add_argument("--once", action="store_true",
                    help="read what exists now, print the merged state, "
                         "exit (the default unless --follow)")
    ap.add_argument("--json", action="store_true",
                    help="print the merged state as deterministic JSON")
    ap.add_argument("--follow", action="store_true",
                    help="stream the merged record stream as JSONL until "
                         "interrupted (or --max-seconds)")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="seconds between polls in --follow mode")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="stop following after this many seconds")
    args = ap.parse_args(argv)

    coll = Collector(args.files)
    if args.follow and not args.once:
        deadline = (time.monotonic() + args.max_seconds
                    if args.max_seconds else None)
        try:
            while True:
                for rec in coll.poll():
                    out = {k: v for k, v in rec.items() if k != "_file"}
                    print(json.dumps(out, sort_keys=True, default=str),
                          flush=True)
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(args.interval)
        except KeyboardInterrupt:
            pass
        return 0
    coll.poll()
    state = coll.state()
    if args.json:
        print(json.dumps(state, sort_keys=True, default=str))
    else:
        render_state(state, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
