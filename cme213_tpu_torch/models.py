"""Workload registry of the port: ``python -m cme213_tpu_torch <workload>``.

Counterpart of ``cme213_tpu/models.py``; holds the workloads ported so far.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Workload:
    name: str
    reference_unit: str
    summary: str
    run: Callable[[list[str]], int]


def _heat2d(argv: list[str]) -> int:
    from .apps import heat2d

    return heat2d.main(["heat2d", *argv])


def _spmv_scan(argv: list[str]) -> int:
    from .apps import spmv_scan

    return spmv_scan.main(["spmv_scan", *argv])


def _doctor(argv: list[str]) -> int:
    from . import doctor_cli

    return doctor_cli.main(argv)


def _tune(argv: list[str]) -> int:
    from . import tune_cli

    return tune_cli.main(argv)


def _trace(argv: list[str]) -> int:
    from . import trace_cli

    return trace_cli.main(argv)


def _collect(argv: list[str]) -> int:
    from .core import collector

    return collector.main(argv)


def _top(argv: list[str]) -> int:
    from . import top_cli

    return top_cli.main(argv)


def _numerics(argv: list[str]) -> int:
    from . import numerics_cli

    return numerics_cli.main(argv)


WORKLOADS: dict[str, Workload] = {
    w.name: w
    for w in (
        Workload("heat2d", "hw2/hw5", "2-D heat diffusion: plain PyTorch "
                 "stencil + the hand-written CUDA kernel, golden ULP-10 "
                 "check; --distributed runs the hw5 domain decomposition "
                 "over every card (--local-kernel=xla|pallas; "
                 "--device=cpu runs the plain versions)", _heat2d),
        Workload("spmv_scan", "hw_final", "iterated multiply + segmented "
                 "scan: plain torch scans + the hand-written CUDA kernel "
                 "(--kernel=pallas|pallas-fused), f64 golden check; "
                 "--distributed shards the sequence over every card",
                 _spmv_scan),
        # not a reference workload: the diagnostic layer standing in for
        # the reference's checkCudaErrors/cudaGetLastError discipline
        Workload("doctor", "diagnostics", "staged device-health ladder "
                 "(enumerate, memory, timed liveness; exit 1 when "
                 "unhealthy, --json for the structured report, "
                 "--device=cpu to probe the CPU; calibrate: roofline "
                 "cost models against what each rung stages)", _doctor),
        Workload("tune", "tuning", "measured autotuning of dispatch "
                 "statics: run --op heat,spmv_scan,segmented_scan | show | "
                 "clear (CME213_TUNE_CACHE; CME213_TUNE=0 disables)",
                 _tune),
        # not reference workloads: the telemetry tooling over the
        # CME213_TRACE_FILE sinks every workload above writes (host
        # tooling only; it reads files and touches no device)
        Workload("trace", "telemetry", "summary | timeline | merge | "
                 "export (Perfetto) | waterfall | regress | metrics "
                 "(Prometheus text) | flight (crash dump) over "
                 "CME213_TRACE_FILE JSON-lines traces and bench artifacts",
                 _trace),
        Workload("collect", "telemetry", "tail per-rank trace sinks into "
                 "a live merged fleet view: one-shot state (--once/"
                 "--json) or a followed merged JSONL stream (--follow)",
                 _collect),
        Workload("top", "telemetry", "live fleet console over the "
                 "collector: per-rank state/step/heartbeat-age rows, "
                 "fleet gauges, solver convergence, recent events; "
                 "deterministic --once/--json, --hb-dir folds heartbeat "
                 "files", _top),
        Workload("numerics", "telemetry", "report: numeric-health rollup "
                 "over trace sinks (drift samples, budget burns and rung "
                 "demotions, sentinel trips, solver convergence/stall); "
                 "--json for CI, --max-over-budget/--min-samples/"
                 "--forbid-stall gate with exit 1", _numerics),
    )
}


def usage() -> str:
    lines = ["usage: python -m cme213_tpu_torch <workload> [args...]", "",
             "workloads:"]
    for w in WORKLOADS.values():
        lines.append(f"  {w.name:<10} [{w.reference_unit}] {w.summary}")
    return "\n".join(lines)


def dispatch(argv: list[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(usage())
        return 0
    w = WORKLOADS.get(argv[0])
    if w is None:
        print(f"unknown workload {argv[0]!r}\n\n{usage()}", file=sys.stderr)
        return 2
    return w.run(argv[1:])
