"""``python -m cme213_tpu_torch chaos`` — game-day chaos campaigns.

Counterpart of ``cme213_tpu/chaos_cli.py``.  ``run`` and ``replay`` take
``--device`` (default ``cuda``, as ``serve loadgen --device`` does; with no
card and no ``--device=cpu`` they raise ``FrameworkError``); ``draw`` and
``matrix`` run nothing and need no device.

Four subcommands over :mod:`cme213_tpu_torch.core.chaos`:

- ``run``: N seeded campaigns — draw a fault cocktail, arm it against a
  live serving run (in-process server or a real replica fleet), check
  the five global invariants, ddmin-shrink any violation to a minimal
  cocktail and bank it as a replayable fixture.  Exit 0 iff every
  campaign held every invariant.
- ``draw``: print the cocktails N campaigns *would* arm, without
  running anything — the CI determinism gate diffs two draws of the
  same seed.
- ``replay``: re-run banked fixtures; exit 0 iff every fixture's
  observed violations match its recorded expectation.
- ``matrix``: print the clause-compatibility matrix, including why the
  ineligible fault kinds are excluded.

Example (the CI chaos gate)::

    python -m cme213_tpu_torch chaos run --seed 1 --campaigns 8 \\
        --backend fleet --replicas 2 --mix cipher,sort,heat --json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _add_campaign_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--seed", type=int, default=0,
                    help="campaign seed; cocktails are a pure function "
                    "of (seed, campaign index)")
    ap.add_argument("--campaigns", type=int, default=4,
                    help="number of seeded campaigns to run")
    ap.add_argument("--backend", choices=("inproc", "fleet"),
                    default="inproc",
                    help="inproc: in-process server (fast); fleet: live "
                    "replica subprocesses behind the socket front end")
    ap.add_argument("--mix", default="cipher,sort",
                    help="loadgen op mix the cocktail is armed against")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet backend: replica count")
    ap.add_argument("--max-batch", type=int, default=4)


def _run_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="chaos run",
        description="run seeded chaos campaigns against a live serving "
                    "run and check the global invariants")
    _add_campaign_flags(ap)
    ap.add_argument("--no-shrink", action="store_true",
                    help="report violations without ddmin-shrinking them")
    ap.add_argument("--bank-dir", default=None,
                    help="fixture directory (default tests/chaos_fixtures/)")
    ap.add_argument("--disable", action="append", default=[],
                    metavar="FEATURE",
                    help="game-day handicap: switch off one resilience "
                    "behaviour for the drill (know: drift-compensation)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--device", default=None,
                    help="where the campaigns serve (default cuda)")
    args = ap.parse_args(argv)

    from .core import chaos

    try:
        out = chaos.run_campaigns(
            seed=args.seed, campaigns=args.campaigns,
            backend=args.backend, mix=args.mix, requests=args.requests,
            replicas=args.replicas, max_batch=args.max_batch,
            shrink_violations=not args.no_shrink,
            bank_dir=args.bank_dir, handicaps=tuple(args.disable),
            device=args.device)
    except ValueError as e:
        print(f"chaos run: {e}", file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(out, indent=2))
    else:
        for c in out["campaigns"]:
            mark = "ok  " if c["ok"] else "FAIL"
            print(f"campaign {c['campaign']:>2} [{mark}] {c['cocktail']}")
            for v in c["violations"]:
                print(f"    {v['invariant']}: {v['detail']}")
        for path in out["fixtures"]:
            print(f"banked {path}")
        print(f"{len(out['campaigns'])} campaign(s), "
              f"{out['violations_total']} violation(s)")
    return 0 if out["ok"] else 1


def _draw_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="chaos draw",
        description="print the cocktails N campaigns would arm (pure: "
                    "nothing runs; diffable determinism check)")
    _add_campaign_flags(ap)
    args = ap.parse_args(argv)

    import numpy as np

    from .core import chaos

    ops = sorted({chaos.MIX_TO_OP[m.strip()]
                  for m in args.mix.split(",") if m.strip()})
    for i in range(args.campaigns):
        rng = np.random.default_rng([args.seed, i])
        plan = chaos.draw_cocktail(rng, args.backend, ops, args.replicas)
        problems = chaos.validate_cocktail(plan, args.backend)
        if problems:
            print(f"chaos draw: campaign {i} drew a matrix violation: "
                  f"{problems}", file=sys.stderr)
            return 1
        print(f"{i}\t{plan}")
    return 0


def _replay_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="chaos replay",
        description="re-run banked fixtures; pass iff observed "
                    "violations match each fixture's expectation")
    ap.add_argument("fixtures", nargs="*",
                    help="fixture JSON paths (default: every fixture "
                    "under tests/chaos_fixtures/)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--device", default=None,
                    help="where the fixtures replay (default cuda)")
    args = ap.parse_args(argv)

    from .core import chaos

    paths = args.fixtures or sorted(
        glob.glob(os.path.join(chaos.fixtures_dir(), "*.json")))
    if not paths:
        print("chaos replay: no fixtures found", file=sys.stderr)
        return 2
    docs = []
    ok = True
    for path in paths:
        result, expected, observed = chaos.replay_fixture(
            path, device=args.device)
        match = expected == observed
        ok = ok and match
        docs.append({"fixture": os.path.basename(path),
                     "expected": expected, "observed": observed,
                     "match": match,
                     "cocktail": result.cocktail})
        if not args.as_json:
            mark = "ok  " if match else "FAIL"
            print(f"[{mark}] {os.path.basename(path)}: expected "
                  f"{expected or ['<none>']}, observed "
                  f"{observed or ['<none>']}")
    if args.as_json:
        print(json.dumps({"fixtures": docs, "ok": ok}, indent=2))
    return 0 if ok else 1


def _matrix_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="chaos matrix",
        description="print the clause-compatibility matrix")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    from .core import chaos

    if args.as_json:
        print(json.dumps({k: {
            "eligible": r.eligible, "backends": list(r.backends),
            "max_per_cocktail": r.max_per_cocktail,
            "conflicts": list(r.conflicts), "reason": r.reason,
        } for k, r in chaos.MATRIX.items()}, indent=2))
        return 0
    for kind, r in chaos.MATRIX.items():
        if r.eligible:
            extra = f", conflicts {'/'.join(r.conflicts)}" \
                if r.conflicts else ""
            print(f"{kind:<13} drawable on {'/'.join(r.backends)} "
                  f"(max {r.max_per_cocktail}{extra})")
        else:
            print(f"{kind:<13} excluded")
        print(f"{'':<13} {r.reason}")
    return 0


def main(argv: list[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m cme213_tpu_torch chaos "
              "<run|draw|replay|matrix> [args...]\n\n"
              "subcommands:\n"
              "  run     seeded campaigns: arm a drawn fault cocktail "
              "against a live serving\n"
              "          run, check global invariants, shrink + bank "
              "violations\n"
              "  draw    print the cocktails a run would arm "
              "(determinism check; pure)\n"
              "  replay  re-run banked fixtures, compare observed vs "
              "expected violations\n"
              "  matrix  print the clause-compatibility matrix")
        return 0 if argv else 2
    sub = {"run": _run_main, "draw": _draw_main, "replay": _replay_main,
           "matrix": _matrix_main}.get(argv[0])
    if sub is None:
        print(f"chaos: unknown subcommand {argv[0]!r} "
              f"(try run | draw | replay | matrix)", file=sys.stderr)
        return 2
    return sub(argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
