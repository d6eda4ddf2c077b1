"""Run every ported sweep and write CSV artifacts (the harness entry point).

Usage::

    python -m cme213_tpu_torch.bench.run_all [--out DIR] [--quick]
        [--only NAME,...] [--device cuda|cpu]

Counterpart of ``cme213_tpu/bench/run_all.py``: the same job table (CSV
names, ``--quick`` and full sizes), all fifteen sweeps.  ``--out`` defaults to ``bench_results_torch``, not the JAX
package's ``bench_results``, whose committed CSVs are that package's
evidence.  ``--device`` defaults to ``cuda`` and fails without a card.

Failure handling: a sweep that raises is retried ONCE, and every failure,
recovered or final, lands in ``<out>/failures.json``::

    {"failed":  [{"sweep", "attempt", "error", "message"}, ...],
     "retried": [...]}   # first-attempt failures whose retry succeeded

The exit code is 0 when every sweep produced rows, even after a retry; 1
when a sweep failed both attempts; 2 when ``--only`` names an unknown
sweep.  ``<out>/metrics.json`` holds each sweep's row
count, wall-clock ms and the ``core/metrics`` delta over the sweep.

Each attempt first consults the fault plan (``faults.maybe_fail(
"sweep.<name>")``, so ``CME213_FAULTS=fail:sweep.<name>`` exercises the
retry), and each sweep emits a ``sweep-failed`` event per failed attempt
and a ``sweep-complete`` event when it produced rows.

``CME213_PROFILE_DIR=<dir>`` profiles the sweeps with ``torch.profiler``
(``core/trace.device_trace``: CPU and, on the card, CUDA activity) into a
Chrome trace in ``<dir>``, and after each sweep on the card writes the
allocator's state (``torch.cuda.memory_snapshot()``) to
``<dir>/memory_<sweep>.json`` with a ``device-memory`` event.  Profiling
is best-effort: when it is unavailable a line says so, and it never
changes what the sweeps compute or where they run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: directory for the sweeps' profiler trace and memory snapshots
PROFILE_DIR_ENV = "CME213_PROFILE_DIR"

#: CSV basename -> (sweep function in ``sweeps``, quick sizes, full sizes);
#: the JAX package's table (``cme213_tpu/bench/run_all.py``), in its order
JOBS = {
    "data_bandwidth_vector_length": (
        "cipher_vector_length_sweep",
        dict(steps=3, max_bytes=1 << 16),
        dict(steps=25, max_bytes=1 << 26)),
    "bandwidth_vs_avg_edges": (
        "pagerank_avg_edges_sweep",
        dict(num_nodes=1 << 12, edges_range=range(2, 5), iterations=4),
        dict(num_nodes=1 << 21, edges_range=range(2, 21), iterations=20)),
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
    "sort_threads": (
        "sort_thread_sweep",
        dict(num_elements=20_000, threads=(1, 2)),
        dict(num_elements=16_000_000, threads=(1, 2, 4, 8, 16, 32))),
    "spmv_pallas_coverage": (
        "spmv_pallas_coverage",
        dict(scale=0.002, iters=1),
        dict(scale=1.0, iters=1)),
    "spmv_suite": (
        "spmv_suite_sweep",
        dict(scale=0.002, kernels=("flat",)),
        dict(scale=1.0, kernels=None)),
    "spmv_scan_sweep": (
        "spmv_scan_sweep",
        dict(ns=(1 << 12,), iters=2, kernels=("flat", "blocked")),
        dict(ns=(1 << 16, 1 << 20, 1 << 22), iters=8, kernels=None)),
    "sort_sweep": (
        "sort_sweep",
        dict(ns=(1 << 12,)),
        dict(ns=(1 << 16, 1 << 20))),
}

#: the JAX package's sweeps the port lacks: none (every CSV of its table is
#: in ``JOBS``)
NOT_PORTED: tuple[str, ...] = ()


def main(argv=None) -> int:
    from ..core import faults, flight, metrics, trace
    from ..core.platform import resolve_device
    from . import RESULTS_DIR, sweeps

    flight.install()  # a crashed sweep leaves its black box behind
    ap = argparse.ArgumentParser(prog="python -m cme213_tpu_torch.bench."
                                      "run_all")
    ap.add_argument("--out", default=RESULTS_DIR)
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
    if only is not None and only - set(JOBS):
        print(f"--only: unknown sweep name(s) {sorted(only - set(JOBS))}; "
              f"choose from {sorted(JOBS)}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    profiler = None
    if profile_dir:
        try:
            profiler = trace.device_trace(profile_dir)
            profiler.__enter__()
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            profiler = None
            print(f"{PROFILE_DIR_ENV}: profiler unavailable "
                  f"({type(e).__name__}: {e})", file=sys.stderr)

    failed, retried = [], []
    sweep_metrics: dict[str, dict] = {}
    try:
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
                except Exception as e:  # noqa: BLE001 — recorded, retried
                    rec = {"sweep": name, "attempt": attempt,
                           "error": type(e).__name__,
                           "message": str(e)[:500]}
                    print(f"{name}.csv: FAILED attempt {attempt}/2 "
                          f"({type(e).__name__}: {e})", file=sys.stderr)
                    (retried if attempt == 1 else failed).append(rec)
                    trace.record_event("sweep-failed", sweep=name,
                                       attempt=attempt,
                                       error=type(e).__name__)
            if rows is None:
                continue
            ms = round((time.perf_counter() - t0) * 1e3, 1)
            trace.record_event("sweep-complete", sweep=name, rows=len(rows),
                               ms=ms)
            if profiler is not None:
                _memory_snapshot(profile_dir, name, device)
            sweep_metrics[name] = {
                "rows": len(rows), "ms": ms,
                "metrics": metrics.delta(before, metrics.snapshot())}
            sweeps.write_csv(rows, path)
            print(f"{path}: {len(rows)} rows")
    finally:
        if profiler is not None:
            try:
                profiler.__exit__(None, None, None)
            except Exception as e:  # noqa: BLE001
                print(f"{PROFILE_DIR_ENV}: trace not written "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
    with open(os.path.join(args.out, "failures.json"), "w") as f:
        json.dump({"failed": failed, "retried": retried}, f, indent=2)
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(sweep_metrics, f, indent=2, default=str)
    # nonzero only on a sweep failing BOTH attempts; retry-recovered flakes
    # exit 0 and stay auditable in failures.json
    return 1 if failed else 0


def _memory_snapshot(profile_dir: str, name: str, device) -> None:
    """The allocator's state after sweep ``name`` on the card, as JSON,
    with a ``device-memory`` event; nothing on the CPU."""
    from ..core import trace

    if device.type != "cuda":
        return
    try:
        import torch

        path = os.path.join(profile_dir, f"memory_{name}.json")
        with open(path, "w") as f:
            json.dump(torch.cuda.memory_snapshot(), f, default=str)
        trace.record_event("device-memory", path=path,
                           bytes=os.path.getsize(path))
    except Exception:  # noqa: BLE001 — never fail a sweep over this
        pass


if __name__ == "__main__":
    raise SystemExit(main())
