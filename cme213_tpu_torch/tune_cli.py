"""``python -m cme213_tpu_torch tune``: the autotuner's front end.

Counterpart of ``cme213_tpu/tune_cli.py``.  Three subcommands over
``core/tune.py``:

- ``run``    search one or more ops' registered candidate spaces (gate,
  warm, median-of-k time, every clock read after a device synchronise)
  and persist the winners to the ``CME213_TUNE_CACHE`` JSON cache that
  dispatch consults;
- ``show``   print the cached winners (disk and in-process);
- ``clear``  drop every cached winner, in-process and on disk.

After ``tune run --op heat``, every ``run_heat_resilient`` in any process
pointed at the same cache resolves its ``tile_y`` as tuned-or-default
(``tune-hit`` events), after ``tune run --op sort`` ``ops.sort.sort_auto``
serves the winning sort, and ``CME213_TUNE=0`` restores the built-in
defaults without touching the cache.  The ``spmv_scan`` and ``segmented_scan``
spaces measure and record their winners, which no dispatch reads yet
(``core/tune.py``); after ``tune run --op serve.spmv`` the serve batcher
caps that bucket's batch width at the winner (``serve.server.
tuned_batch_cap``).  ``run`` works on the card unless ``--device=cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import sys


def _run_kwargs(op: str, args: argparse.Namespace) -> dict:
    """Per-op keyword arguments for ``tune.run`` from the shared flags:
    each space function receives only the knobs it declares."""
    kw: dict = {"device": args.device}
    if op.startswith("serve."):
        kw.update(max_batch=args.max_batch, seed=args.seed)
    elif op == "spmv_scan":
        kw.update(n=args.n, iters=args.iters, dtype=args.dtype)
    elif op == "segmented_scan":
        kw.update(dtype=args.dtype)
        if args.crossover_n is not None:
            kw["n"] = args.crossover_n
    elif op == "heat":
        kw.update(gy=args.gy, gx=args.gx, order=args.order, k=args.k,
                  iters=args.heat_iters, dtype=args.dtype)
    elif op == "sort":
        kw.update(n=args.n)
    return kw


def _cmd_run(args: argparse.Namespace) -> int:
    from .core import tune

    ops = [o.strip() for o in args.op.split(",") if o.strip()]
    if not ops:
        print("tune run: --op needs at least one op", file=sys.stderr)
        return 2
    reports = []
    for op in ops:
        try:
            rep = tune.run(op, runs=args.runs, persist=not args.dry_run,
                           **_run_kwargs(op, args))
        except tune.TuneError as e:
            print(f"tune run: {e}", file=sys.stderr)
            return 1
        reports.append(rep)
    if args.as_json:
        print(json.dumps(reports, indent=2))
        return 0
    for rep in reports:
        w = rep["winner"]
        print(f"{rep['op']} [{rep['shape_class']}/{rep['dtype']}] on "
              f"{rep['device']}: winner {w['candidate']} "
              f"({w['ms']} ms, {w['gbs']} GB/s)")
        for t in rep["trials"]:
            mark = "*" if t["candidate"] == w["candidate"] else " "
            if t["ok"]:
                print(f"  {mark} {t['candidate']:<24} {t['ms']:>12} ms  "
                      f"{t['gbs']:>8} GB/s")
            else:
                print(f"  {mark} {t['candidate']:<24} "
                      f"REJECTED ({t.get('error', 'gated out')})")
    if args.dry_run:
        print("(dry run: winners NOT persisted)")
    return 0


def _cmd_show(args: argparse.Namespace) -> int:
    from .core import tune

    recs = tune.entries()
    if args.as_json:
        print(json.dumps(recs, indent=2, sort_keys=True))
        return 0
    if not recs:
        where = tune.cache_path() or f"unset — set {tune.CACHE_ENV}"
        print(f"tune: no cached winners (cache file: {where})")
        return 0
    print(f"{len(recs)} cached winner(s)"
          + (f" [{tune.cache_path()}]" if tune.cache_path() else ""))
    for key in sorted(recs):
        rec = recs[key]
        device, op, shape_class, dtype = key.split("|")
        statics = json.dumps(rec["statics"], sort_keys=True)
        print(f"  {device:<8} {op:<16} {shape_class:<20} {dtype:<8} "
              f"-> {rec['candidate']:<20} {statics} "
              f"({rec['ms']} ms, {rec['gbs']} GB/s)")
    return 0


def _cmd_clear(args: argparse.Namespace) -> int:
    from .core import tune

    print(f"tune: cleared {tune.clear()} winner(s)")
    return 0


def main(argv: list[str]) -> int:
    from .core import tune

    ap = argparse.ArgumentParser(
        prog="python -m cme213_tpu_torch tune",
        description="measured autotuning of dispatch statics: search the "
                    "registered per-op candidate spaces and persist the "
                    "winners (CME213_TUNE_CACHE) for dispatch to consume")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser(
        "run", help="gate, time and persist winners for one or more ops")
    runp.add_argument("--op", default="spmv_scan",
                      help="comma-separated ops: spmv_scan, "
                           "segmented_scan, heat, sort, serve.<mix-op> "
                           "(e.g. serve.spmv)")
    runp.add_argument("--n", type=int, default=1 << 20,
                      help="problem size for spmv_scan / sort")
    runp.add_argument("--iters", type=int, default=8,
                      help="spmv_scan solve iterations")
    runp.add_argument("--crossover-n", type=int, default=None,
                      help="segmented_scan contested size "
                           "(default: the built-in threshold)")
    runp.add_argument("--gy", type=int, default=64,
                      help="heat interior rows")
    runp.add_argument("--gx", type=int, default=64,
                      help="heat interior columns")
    runp.add_argument("--order", type=int, default=2,
                      help="heat stencil order (2|4|8)")
    runp.add_argument("--k", type=int, default=1,
                      help="heat steps fused a launch")
    runp.add_argument("--heat-iters", type=int, default=4,
                      help="heat steps a timed run")
    runp.add_argument("--max-batch", type=int, default=8,
                      help="serve.<op> width ceiling")
    runp.add_argument("--seed", type=int, default=0)
    runp.add_argument("--dtype", default="float32")
    runp.add_argument("--device", default=None,
                      help="cuda (default) or cpu")
    runp.add_argument("--runs", type=int, default=tune.TRIAL_RUNS,
                      help="measured runs a candidate (median taken)")
    runp.add_argument("--dry-run", action="store_true",
                      help="search and report but do not persist winners")
    runp.add_argument("--json", action="store_true", dest="as_json")
    runp.set_defaults(fn=_cmd_run)

    showp = sub.add_parser("show", help="print the cached winners")
    showp.add_argument("--json", action="store_true", dest="as_json")
    showp.set_defaults(fn=_cmd_show)

    clearp = sub.add_parser(
        "clear", help="drop every cached winner (in-process and on disk)")
    clearp.set_defaults(fn=_cmd_clear)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
