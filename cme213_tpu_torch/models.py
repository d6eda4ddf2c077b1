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
                 "--device=cpu to probe the CPU)", _doctor),
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
