"""Workload registry of the port: ``python -m cme213_tpu_torch <workload>``.

Counterpart of ``cme213_tpu/models.py``, with every workload of the JAX
package.  Each that touches a device runs on ``cuda`` unless given
``--device=cpu``.
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


def _cipher(argv: list[str]) -> int:
    from .apps import cipher

    return cipher.main(["cipher", *argv])


def _pagerank(argv: list[str]) -> int:
    from .apps import pagerank

    known = ("num_nodes", "avg_edges", "iterations", "seed", "device")
    kwargs: dict = {}
    for a in argv:
        if not (a.startswith("--") and "=" in a):
            print(f"pagerank: unknown argument {a!r} "
                  f"(expected --key=value with key in {known})",
                  file=sys.stderr)
            return 2
        key, value = a[2:].split("=", 1)
        key = key.replace("-", "_")
        if key not in known:
            print(f"pagerank: unknown option --{key}", file=sys.stderr)
            return 2
        kwargs[key] = value if key == "device" else int(value)
    return 0 if pagerank.main(**kwargs) else 1


def _vigenere(argv: list[str]) -> int:
    from .apps import vigenere

    return vigenere.main(["vigenere", *argv])


def _sorts(argv: list[str]) -> int:
    from .apps import sorts

    return sorts.main(["sorts", *argv])


def _heat2d(argv: list[str]) -> int:
    from .apps import heat2d

    return heat2d.main(["heat2d", *argv])


def _spmv_scan(argv: list[str]) -> int:
    from .apps import spmv_scan

    return spmv_scan.main(["spmv_scan", *argv])


def _doctor(argv: list[str]) -> int:
    from . import doctor_cli

    return doctor_cli.main(argv)


def _serve(argv: list[str]) -> int:
    from . import serve

    return serve.main(argv)


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


def _fleet(argv: list[str]) -> int:
    from . import fleet_cli

    return fleet_cli.main(argv)


def _chaos(argv: list[str]) -> int:
    from . import chaos_cli

    return chaos_cli.main(argv)


WORKLOADS: dict[str, Workload] = {
    w.name: w
    for w in (
        Workload("cipher", "hw1", "Caesar shift cipher (device bandwidth "
                 "ladder: 1/4/8-byte lanes), byte-exact against the host "
                 "golden", _cipher),
        Workload("pagerank", "hw1", "CSR PageRank iteration vs host golden "
                 "(--num_nodes= --avg_edges= --iterations= --seed= "
                 "--device=)", _pagerank),
        Workload("heat2d", "hw2/hw5", "2-D heat diffusion: plain PyTorch "
                 "stencil + the hand-written CUDA kernel, golden ULP-10 "
                 "check; --distributed runs the hw5 domain decomposition "
                 "over every card (--local-kernel=xla|pallas; "
                 "--device=cpu runs the plain versions)", _heat2d),
        Workload("vigenere", "hw3", "Vigenère create/crack via device "
                 "analytics pipelines", _vigenere),
        Workload("sorts", "hw4", "host OpenMP merge/radix sorts (native "
                 "library built at first use) + the device radix sort",
                 _sorts),
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
        # not a reference workload: the multi-tenant front end serving
        # the workloads above as a request population (bounded queue,
        # shape-class batching, deadlines, breaker, degradation)
        Workload("serve", "serving", "loadgen: drive the bounded-queue "
                 "batching front end with synthetic load, print an SLO "
                 "report; warmup: build and warm the canonical serving "
                 "buckets (--device=cpu on the CPU)", _serve),
        Workload("tune", "tuning", "measured autotuning of dispatch "
                 "statics: run --op heat,spmv_scan,segmented_scan,sort,"
                 "serve.<mix-op> "
                 "| show | clear (CME213_TUNE_CACHE; CME213_TUNE=0 "
                 "disables)",
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
        # not a reference workload: the replicated serving tier — the
        # hw5 gang machinery (supervised relaunch, incarnations,
        # per-rank sinks) repurposed for N independent server replicas
        # behind a tenant-fair, SLO-burn-autoscaling front end
        Workload("fleet", "serving", "up: run a replicated serving fleet "
                 "(socket front end, tenant-fair router, per-replica "
                 "breakers, supervised relaunch with zero accepted-"
                 "request loss, SLO-burn autoscaling; --device=cpu on the "
                 "CPU); worker: one replica process (spawned by up); "
                 "jobs: durable long jobs on a running fleet", _fleet),
        # not a reference workload: the game-day layer composing all of
        # the above — seeded fault cocktails armed against a live
        # serving run, global invariants checked after every campaign,
        # violations ddmin-shrunk to minimal replayable fixtures
        Workload("chaos", "robustness", "run: seeded chaos campaigns "
                 "(randomized fault cocktails from the CME213_FAULTS "
                 "grammar, matrix-filtered, armed against a live "
                 "inproc/fleet serving run; zero-loss + bitwise-"
                 "conformance + SLO-report + one-trace + no-leak "
                 "invariants; violations shrink to banked fixtures; "
                 "--device=cpu on the CPU); draw | replay | matrix",
                 _chaos),
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
