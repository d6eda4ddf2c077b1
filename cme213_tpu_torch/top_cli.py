"""``python -m cme213_tpu_torch top``: a live fleet console over the
collector.

Counterpart of ``cme213_tpu/top_cli.py``.  The reference watches an MPI
job with ``qstat`` plus per-rank timing tables printed at the end (hw5);
this is the interactive equivalent for a gang or serving fleet:
per-rank rows (state, step, heartbeat age, last span, breaker/degraded
flags), fleet gauges (restarts, commits + lag, sheds, SLO burns,
requests), the hottest spans, the slowest request hops (each line names
the rid and trace id ``trace waterfall`` takes), and a recent-events
ribbon — refreshed in place from the per-rank trace sinks that
``core/collector.py`` tails.

Deterministic modes for tests and CI:

- ``--once``: render one frame from whatever the sinks hold and exit.
- ``--json``: emit the collector's merged state as sorted-key JSON
  (ages are relative to the newest observed event, not the wall clock,
  so re-rendering an idle capture is byte-stable).

``--hb-dir`` folds the supervisor's file heartbeats
(``dist/supervisor.read_all_heartbeats``) into the view — useful when a
rank's sink is unconfigured but its heartbeat file is landing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .core.collector import Collector

_CLEAR = "\x1b[2J\x1b[H"


def _fmt(value, width: int) -> str:
    s = "-" if value is None else str(value)
    return s[:width].ljust(width)


def _flags(row: dict) -> str:
    flags = []
    if row.get("breakers_open"):
        flags.append(f"brk:{row['breakers_open']}")
    if row.get("degraded"):
        flags.append("degraded")
    return ",".join(flags) or "-"


def render_top(state: dict, out=None) -> None:
    """One console frame from :meth:`Collector.state` output."""
    out = out or sys.stdout
    ids = state["trace_ids"]
    trace = ids[0] if len(ids) == 1 else f"{len(ids)} ids"
    out.write(f"cme213 fleet · {len(state['ranks'])} proc(s) · "
              f"{state['events']} event(s) · trace {trace or '-'}\n")

    out.write(f"{'PROC':<7}{'ROLE':<9}{'STATE':<9}{'PID':<8}{'INC':<4}"
              f"{'STEP':<7}{'HB AGE':<8}{'OCC':<6}{'LAST SPAN':<22}"
              f"{'FLAGS'}\n")
    for key, row in state["ranks"].items():
        hb = row.get("heartbeat_age_s")
        occ = row.get("occupancy")
        out.write(_fmt(key, 7) + _fmt(row.get("role"), 9)
                  + _fmt(row.get("state"), 9)
                  + _fmt(row.get("pid"), 8)
                  + _fmt(row.get("incarnation"), 4)
                  + _fmt(row.get("step"), 7)
                  + _fmt(f"{hb:.1f}s" if hb is not None else None, 8)
                  + _fmt(f"{occ:.2f}" if occ is not None else None, 6)
                  + _fmt(row.get("last_span"), 22)
                  + _flags(row) + "\n")

    fl = state["fleet"]
    lag = state.get("commit_lag_s")
    commit = state.get("last_commit") or {}
    out.write("fleet: "
              f"launches={fl.get('launches', 0)} "
              f"restarts={fl.get('restarts', 0)} "
              f"verdicts={fl.get('verdicts', 0)} "
              f"commits={fl.get('commits', 0)}"
              + (f"@epoch{commit.get('epoch')}" if commit else "")
              + (f" lag={lag}s" if lag is not None else "")
              + f" sheds={fl.get('sheds', 0)}"
              f" slo_burns={fl.get('slo_burns', 0)}"
              f" breaker_opens={fl.get('breaker_opens', 0)}"
              f" requests={fl.get('requests', 0)}\n")
    if any(fl.get(k) for k in ("replica_ups", "replica_downs", "routed",
                               "requeues", "scale_ups", "scale_downs")):
        out.write("serving: "
                  f"replicas_up={fl.get('replica_ups', 0)} "
                  f"replicas_down={fl.get('replica_downs', 0)} "
                  f"routed={fl.get('routed', 0)} "
                  f"requeues={fl.get('requeues', 0)} "
                  f"scale=+{fl.get('scale_ups', 0)}"
                  f"/-{fl.get('scale_downs', 0)}\n")
    out.write("numerics: "
              f"drift={fl.get('drift_samples', 0)}"
              f"/{fl.get('drift_over_budget', 0)}over "
              f"demotions={fl.get('drift_demotions', 0)} "
              f"sentinels={fl.get('sentinel_trips', 0)} "
              f"conformance_failures={fl.get('conformance_failures', 0)} "
              f"attribution_mismatches="
              f"{fl.get('attribution_mismatches', 0)}\n")

    solvers = state.get("solvers") or {}
    if solvers:
        out.write("solvers:\n")
        for op, row in solvers.items():
            verdict = "STALLED" if row.get("stalled") else "converging"
            res = row.get("residual")
            ips = row.get("iters_per_s")
            out.write(f"  {op:<14} step={row.get('step')} "
                      f"residual={res if res is not None else '-'} "
                      f"iters/s={ips if ips is not None else '-'} "
                      f"{verdict}\n")

    jobs = state.get("jobs") or {}
    if jobs:
        out.write("jobs:\n")
        for jid, row in jobs.items():
            epoch = row.get("epoch")
            total = row.get("total_epochs")
            res = row.get("residual")
            out.write(f"  {jid:<18} {row.get('op') or '?':<10} "
                      f"{row.get('state') or '?':<10} "
                      f"epoch={epoch if epoch is not None else '-'}"
                      f"/{total if total is not None else '-'} "
                      f"residual={res if res is not None else '-'} "
                      f"resumes={row.get('resumes', 0)} "
                      f"preempt={row.get('preemptions', 0)}\n")

    spans = sorted(state["spans"].items(),
                   key=lambda kv: kv[1]["total_ms"], reverse=True)[:5]
    if spans:
        out.write("spans (top by total ms):\n")
        for name, agg in spans:
            out.write(f"  {name:<28} n={agg['count']:<6} "
                      f"total={agg['total_ms']}ms max={agg['max_ms']}ms\n")

    slowest = state.get("slowest_traces") or []
    if slowest:
        out.write("slowest requests (waterfall rid · trace):\n")
        for e in slowest[:5]:
            tail = []
            if e.get("requeues"):
                tail.append(f"{e['requeues']} requeue(s)")
            if e.get("status") not in (None, "ok"):
                tail.append(str(e["status"]))
            out.write(f"  {e['ms']:>9.1f}ms {e['span']:<18} "
                      f"rid={e['rid']} trace={e['trace']}"
                      + (f" [{', '.join(tail)}]" if tail else "") + "\n")

    recent = state["recent"][-8:]
    if recent:
        out.write("recent: "
                  + " · ".join(f"{e['rank']}:{e['event']}" for e in recent)
                  + "\n")
    if state["malformed"]:
        out.write(f"({state['malformed']} malformed line(s) skipped)\n")


def _fold_heartbeats(state: dict, hb_dir: str) -> None:
    from .dist.supervisor import read_all_heartbeats

    beats = read_all_heartbeats(hb_dir)
    state["heartbeats"] = {str(r): b for r, b in sorted(beats.items())}
    for rank, beat in beats.items():
        row = state["ranks"].get(f"r{rank}")
        if row is not None and row.get("step") is None:
            row["step"] = beat.get("step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cme213_tpu_torch top",
        description="live fleet console over per-rank trace sinks")
    ap.add_argument("files", nargs="+",
                    help="sink files or globs (re-expanded every poll)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit the merged state as sorted-key JSON "
                         "(implies one frame per refresh)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between refreshes in live mode")
    ap.add_argument("--iterations", type=int, default=None,
                    help="stop after this many refreshes (live mode)")
    ap.add_argument("--hb-dir", default=None,
                    help="also fold supervisor heartbeat files from this "
                         "directory into the view")
    args = ap.parse_args(argv)

    coll = Collector(args.files)

    def frame(clear: bool) -> None:
        coll.poll()
        state = coll.state()
        if args.hb_dir:
            _fold_heartbeats(state, args.hb_dir)
        if args.json:
            print(json.dumps(state, sort_keys=True, default=str),
                  flush=True)
        else:
            if clear:
                sys.stdout.write(_CLEAR)
            render_top(state, sys.stdout)
            sys.stdout.flush()

    if args.once:
        frame(clear=False)
        return 0
    done = 0
    try:
        while args.iterations is None or done < args.iterations:
            frame(clear=not args.json)
            done += 1
            if args.iterations is not None and done >= args.iterations:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
