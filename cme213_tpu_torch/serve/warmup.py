"""Pre-build the canonical serving buckets: the warm-start half of the
compile-amortization story.

Counterpart of ``cme213_tpu/serve/warmup.py``.  ``python -m
cme213_tpu_torch serve warmup`` derives the shape classes a serving mix
will hit (the same population ``loadgen`` drives), then runs each (op,
shape class, batch width, rung) combination once through the adapters'
batch paths on the device (``--device``, default ``cuda``).  Every program
lands in the process-wide cache (``core/programs.py``, built and warmed on
a miss) and every bucket's conformance verdict (the spmv pad-and-mask
probe, the sort golden gate) in ``core/conformance``, which persists to
``CME213_CONFORMANCE_CACHE`` when that is set, so a later server process
skips the probes.

**Deviation.**  The JAX package also fills XLA's persistent compilation
cache (``CME213_COMPILE_CACHE``) so a later process loads compiled
programs from disk.  Eager torch compiles nothing ahead of a call, and has
no such cache: the report names the variable as not applicable and gives
the build-and-warm milliseconds this process measured, never a disk cache.

The report is the same compile-attribution section the loadgen SLO report
carries: per-class build ms and program-cache misses (one per warmed
program).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..core import metrics


def warm_buckets(mix: str, requests: int = 12, max_batch: int = 8,
                 seed: int = 0, tuned: bool = False,
                 device=None) -> list[str]:
    """Run one batch per (op, shape class, batch width, rung) of the mix's
    canonical buckets through the adapters on ``device`` (default
    ``cuda``; ``FrameworkError`` with no card), building and warming each
    program into the process cache and running each bucket's probe.
    Batch widths 1 and ``max_batch`` are warmed: the widths a drained tail
    and a full batch window dispatch.  With ``tuned``, the tuning cache's
    per-bucket batch width (``server.tuned_batch_cap``) is warmed too.
    Returns the warmed ``op[class]/bN`` labels."""
    from .loadgen import build_mix
    from .server import tuned_batch_cap
    from .workloads import ADAPTERS, serving_device

    dev = serving_device(device)
    specs = build_mix(mix, requests, seed=seed)
    groups: dict[tuple[str, str], list] = {}
    for spec in specs:
        adapter = ADAPTERS[spec.op]
        key = (spec.op, adapter.shape_class(spec.payload))
        groups.setdefault(key, []).append(spec.payload)

    warmed = []
    for (op, sc), payloads in sorted(groups.items()):
        adapter = ADAPTERS[op]
        widths = {1, max(1, max_batch)}
        if tuned:
            widths.add(tuned_batch_cap(op, sc, max(1, max_batch),
                                       device=dev))
        for b in sorted(widths):
            batch = (payloads * b)[:b]
            ok = True
            for rung in adapter.rungs():
                try:
                    adapter.run_batch(batch, rung, device=dev)
                except Exception as e:  # noqa: BLE001 — warmup is advisory
                    ok = False
                    print(f"warmup: {op}[{sc}] rung {rung!r} failed: {e}",
                          file=sys.stderr)
            if ok:
                warmed.append(f"{op}[{sc}]/b{b}")
    return warmed


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="serve warmup",
        description="pre-build the canonical serving buckets into the "
                    "program cache and the conformance verdicts "
                    "(CME213_CONFORMANCE_CACHE persists the verdicts; "
                    "CME213_COMPILE_CACHE does not apply to eager torch)")
    ap.add_argument("--mix", default="spmv,heat,cipher",
                    help="comma-separated ops, as for loadgen --mix")
    ap.add_argument("--requests", type=int, default=12,
                    help="mix length used to derive the bucket set")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="full batch width to warm (width 1 always is)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tuned", action="store_true",
                    help="also warm each bucket's tuned batch width "
                         "(from the CME213_TUNE_CACHE winners)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    from ..core import conformance, flight, programs

    flight.install()
    from .loadgen import compile_attribution

    verdicts = os.environ.get(conformance.CACHE_ENV)
    before = metrics.snapshot()
    warmed = warm_buckets(args.mix, requests=args.requests,
                          max_batch=args.max_batch, seed=args.seed,
                          tuned=args.tuned, device=args.device)
    report = {
        "warmed": warmed,
        "programs": programs.size(),
        # no disk cache of compiled programs exists for eager torch
        "persistent_cache": None,
        "persistent_entries": None,
        "compile_cache_env": "not applicable (eager torch)",
        "conformance_cache": verdicts,
        "compile": compile_attribution(before, metrics.snapshot()),
    }
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        comp = report["compile"]
        print(f"warmed {len(warmed)} bucket(s), {report['programs']} "
              f"cached program(s), compile {comp['compile_ms']} ms")
        for label in warmed:
            print(f"  {label}")
        print("persistent cache: not applicable (CME213_COMPILE_CACHE: "
              "eager torch keeps no compiled programs on disk)")
        if verdicts:
            print(f"conformance verdicts: {verdicts}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
