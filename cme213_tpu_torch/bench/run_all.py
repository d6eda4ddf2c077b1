"""Run every ported sweep and write CSV artifacts (the harness entry point).

Usage::

    python -m cme213_tpu_torch.bench.run_all [--out DIR] [--quick]
        [--only NAME,...] [--device cuda|cpu]

Counterpart of ``cme213_tpu/bench/run_all.py``: the same job table (CSV
names, ``--quick`` and full sizes), cut to the sweeps whose modules are
ported.  ``--out`` defaults to ``bench_results_torch``, not the JAX
package's ``bench_results``, whose committed CSVs are that package's
evidence.  ``--device`` defaults to ``cuda`` and fails without a card.

Failure handling: a sweep that raises is retried ONCE, and every failure,
recovered or final, lands in ``<out>/failures.json``::

    {"failed":  [{"sweep", "attempt", "error", "message"}, ...],
     "retried": [...]}   # first-attempt failures whose retry succeeded

The exit code is 0 when every sweep produced rows, even after a retry; 1
when a sweep failed both attempts; 2 when ``--only`` names a sweep that is
unknown or not ported yet.  ``<out>/metrics.json`` holds each sweep's row
count, wall-clock ms and the ``core/metrics`` delta over the sweep.

Each attempt first consults the fault plan (``faults.maybe_fail(
"sweep.<name>")``, so ``CME213_FAULTS=fail:sweep.<name>`` exercises the
retry), and each sweep emits a ``sweep-failed`` event per failed attempt
and a ``sweep-complete`` event when it produced rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: CSV basename -> (sweep function in ``sweeps``, quick sizes, full sizes);
#: the JAX package's table (``cme213_tpu/bench/run_all.py``), in its order
JOBS = {
    "heat_bandwidth": (
        "heat_sweep",
        dict(sizes=(64,), orders=(2, 4, 8), iters=3),
        # 5 sizes x 3 orders: the reference table's shape
        # (hw/hw2/programming/data/data.ods measures 5 grid sizes)
        dict(sizes=(250, 500, 1000, 2000, 4000), orders=(2, 4, 8),
             iters=200)),
    "pallas_tile": (
        "pallas_tile_sweep",
        dict(size=32, order=2, iters=2, tiles=(8, 16)),
        dict(size=2000, order=8, iters=100, tiles=(40, 80, 200, 400))),
    "heat_kernels": (
        "heat_kernel_sweep",
        dict(size=64, order=8, iters=8, ks=(2, 4)),
        dict(size=4000, order=8, iters=64, ks=(2, 4, 8))),
    "pipeline_tune": (
        "pipeline_tune_sweep",
        dict(size=64, order=8, iters=4, ks=(1, 2), targets=(16,)),
        dict(size=4000, order=8, iters=64, ks=(1, 2, 4, 8, 16),
             targets=(256, 192, 128, 64))),
    "transfer_bandwidth": (
        "transfer_bandwidth_sweep",
        dict(sizes=(1 << 16,)),
        dict(sizes=(1 << 20, 1 << 24, 1 << 27))),
    "scan_bandwidth": (
        "scan_sweep",
        dict(n=1 << 16, num_segments=1 << 8),
        dict(n=1 << 26, num_segments=1 << 16)),
    "dist_heat_scaling": (
        "dist_heat_sweep",
        dict(size=32, order=2, iters=3, ndevs=(1, 2), pallas=None),
        dict(size=2000, order=8, iters=100, ndevs=(1, 2, 4, 8),
             pallas=None)),
    "dist_heat_compile_coverage": (
        "dist_heat_compile_coverage",
        dict(size=32, order=2, iters=2, ndevs=(1, 2)),
        dict(size=2000, order=8, iters=4, ndevs=(1, 2, 4, 8))),
    "spmv_pallas_coverage": (
        "spmv_pallas_coverage",
        dict(scale=0.002, iters=1),
        dict(scale=1.0, iters=1)),
    "spmv_scan_sweep": (
        "spmv_scan_sweep",
        dict(ns=(1 << 12,), iters=2, kernels=("flat", "blocked")),
        dict(ns=(1 << 16, 1 << 20, 1 << 22), iters=8, kernels=None)),
}

#: the JAX package's sweeps whose modules are not ported yet (ROADMAP A5,
#: A7): cipher, PageRank, the native and device sorts, the suite
NOT_PORTED = ("data_bandwidth_vector_length", "bandwidth_vs_avg_edges",
              "sort_threads", "spmv_suite", "sort_sweep")


def main(argv=None) -> int:
    from ..core import faults, flight, metrics, trace
    from ..core.platform import resolve_device
    from . import sweeps

    flight.install()  # a crashed sweep leaves its black box behind
    ap = argparse.ArgumentParser(prog="python -m cme213_tpu_torch.bench."
                                      "run_all")
    ap.add_argument("--out", default="bench_results_torch")
    ap.add_argument("--quick", action="store_true",
                    help="small sizes (CI/CPU-friendly)")
    ap.add_argument("--only", default=None,
                    help="comma-separated CSV basenames (without .csv) "
                         "to run, e.g. --only heat_kernels,pallas_tile")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    only = (set(t.strip() for t in args.only.split(",") if t.strip())
            if args.only else None)
    if only is not None:
        waiting = only & set(NOT_PORTED)
        unknown = only - set(JOBS) - waiting
        if waiting or unknown:
            if waiting:
                print(f"--only: sweep(s) {sorted(waiting)} are not ported "
                      f"yet", file=sys.stderr)
            if unknown:
                print(f"--only: unknown sweep name(s) {sorted(unknown)}",
                      file=sys.stderr)
            print(f"choose from {sorted(JOBS)}", file=sys.stderr)
            return 2
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    failed, retried = [], []
    sweep_metrics: dict[str, dict] = {}
    for name, (fn_name, quick, full) in JOBS.items():
        if only is not None and name not in only:
            continue
        path = os.path.join(args.out, f"{name}.csv")
        kwargs = quick if args.quick else full
        rows = None
        before = metrics.snapshot()
        t0 = time.perf_counter()
        for attempt in (1, 2):  # one retry: a flake cannot zero the run
            try:
                faults.maybe_fail(f"sweep.{name}")
                rows = getattr(sweeps, fn_name)(**kwargs, device=device)
                break
            except Exception as e:  # noqa: BLE001 — recorded, then retried
                rec = {"sweep": name, "attempt": attempt,
                       "error": type(e).__name__, "message": str(e)[:500]}
                print(f"{name}.csv: FAILED attempt {attempt}/2 "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
                (retried if attempt == 1 else failed).append(rec)
                trace.record_event("sweep-failed", sweep=name,
                                   attempt=attempt, error=type(e).__name__)
        if rows is None:
            continue
        ms = round((time.perf_counter() - t0) * 1e3, 1)
        trace.record_event("sweep-complete", sweep=name, rows=len(rows),
                           ms=ms)
        sweep_metrics[name] = {"rows": len(rows), "ms": ms,
                               "metrics": metrics.delta(before,
                                                        metrics.snapshot())}
        sweeps.write_csv(rows, path)
        print(f"{path}: {len(rows)} rows")
    with open(os.path.join(args.out, "failures.json"), "w") as f:
        json.dump({"failed": failed, "retried": retried}, f, indent=2)
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(sweep_metrics, f, indent=2, default=str)
    # nonzero only on a sweep failing BOTH attempts; retry-recovered flakes
    # exit 0 and stay auditable in failures.json
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
