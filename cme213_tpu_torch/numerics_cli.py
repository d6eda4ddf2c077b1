"""``python -m cme213_tpu_torch numerics``: the numeric-health report and
gate.

Counterpart of ``cme213_tpu/numerics_cli.py``.  The reference validates
numerics offline: hw2 diffs ``grid_final_*`` files after the run,
hw_final checks a relative error at exit.  ``core/numerics.py`` moves
that check into the run (drift budgets, output sentinels, convergence
tracing: one ``solver-progress`` event a checkpointed chunk), and this CLI
is the offline rollup over the trace sinks those records land in.

Subcommand::

    numerics report <sink.jsonl> [...] [--json]
                    [--max-over-budget N] [--min-samples N]
                    [--forbid-stall]

``report`` reuses the trace summarizer's aggregation (``trace_cli.py``)
and prints only the numeric-health and convergence sections.  Gates:

- ``--max-over-budget N``: exit 1 when more than N shadow samples were
  over the drift tolerance (``--max-over-budget 0`` is the "clean run
  must show zero drift" CI gate).
- ``--min-samples N``: exit 1 unless at least N shadow samples landed —
  guards against a gate that trivially passes because sampling was off.
- ``--forbid-stall``: exit 1 when any solver's convergence trace ends
  STALLED.
"""

from __future__ import annotations

import argparse
import io
import json
import sys

from .trace_cli import TraceParseError, load_events, summarize


def report(files: list[str]) -> dict:
    """Aggregate the numeric-health view of one or many sinks."""
    events = load_events(files)
    agg = summarize(events, out=io.StringIO())  # text discarded; dict kept
    return {
        "events": agg["events"],
        "numerics": agg.get("numerics"),
        "convergence": agg.get("convergence"),
    }


def render(doc: dict, out=None) -> None:
    out = out or sys.stdout
    w = out.write
    numeric = doc.get("numerics")
    if not numeric:
        w("numeric health: no shadow samples, sentinels, or budget "
          "events in these sinks\n")
    else:
        w(f"numeric health: {numeric['samples']} shadow sample(s), "
          f"{numeric['over_budget']} over budget, "
          f"{len(numeric['demotions'])} demotion(s), "
          f"{numeric['sentinels']['trips']} sentinel trip(s)\n")
        for key, row in sorted((numeric.get("drift") or {}).items()):
            w(f"  {key}: {row['samples']} sample(s), "
              f"{row['over_budget']} over, "
              f"worst rel_l2 {row['worst_rel_l2']}\n")
        for key in numeric["demotions"]:
            w(f"  DEMOTED {key}\n")
    convergence = doc.get("convergence")
    if convergence:
        for op, row in sorted(convergence.items()):
            verdict = "STALLED" if row.get("stalled") else "converging"
            w(f"solver {op}: {row['epochs']} epoch(s), residual "
              f"{row['first_residual']} -> {row['last_residual']}, "
              f"{verdict}\n")


def _gate(doc: dict, args) -> list[str]:
    """The CI verdicts; each string is one failed gate."""
    numeric = doc.get("numerics") or {}
    samples = numeric.get("samples", 0)
    over = numeric.get("over_budget", 0)
    failures = []
    if args.min_samples is not None and samples < args.min_samples:
        failures.append(f"only {samples} shadow sample(s), "
                        f"gate needs >= {args.min_samples}")
    if args.max_over_budget is not None and over > args.max_over_budget:
        failures.append(f"{over} shadow sample(s) over the drift budget, "
                        f"gate allows <= {args.max_over_budget}")
    if args.forbid_stall:
        stalled = sorted(op for op, row in
                         (doc.get("convergence") or {}).items()
                         if row.get("stalled"))
        if stalled:
            failures.append("stalled solver(s): " + ", ".join(stalled))
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cme213_tpu_torch numerics",
        description="numeric-health report + CI gate over trace sinks")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="numeric-health rollup over sinks")
    p.add_argument("files", nargs="+")
    p.add_argument("--json", action="store_true",
                   help="emit the rollup as one JSON document")
    p.add_argument("--max-over-budget", type=int, default=None,
                   help="exit 1 when more shadow samples than this were "
                        "over the drift tolerance (0 = clean-run gate)")
    p.add_argument("--min-samples", type=int, default=None,
                   help="exit 1 unless at least this many shadow samples "
                        "landed (guards against sampling being off)")
    p.add_argument("--forbid-stall", action="store_true",
                   help="exit 1 when any solver convergence trace ends "
                        "STALLED")
    args = ap.parse_args(argv)

    try:
        doc = report(args.files)
    except (OSError, TraceParseError) as e:
        print(f"numerics: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(doc, sort_keys=True, default=str))
    else:
        render(doc)
    failures = _gate(doc, args)
    for f in failures:
        print(f"GATE FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
