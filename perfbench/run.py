"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; ``checks`` last: each
number compared with its limit), and the last lines of standard error
repeat the checks.  Without as many CUDA cards as the cell asks for, or
with JAX or the JAX package loaded in this process, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import harness  # noqa: E402

#: caches of the program, at fixed paths inside the checkout
CACHE_DIR = harness.HERE / ".cache"


def set_cache_env(cell: str, rank: int | None = None) -> None:
    """Point the program's tuning and verdict caches at fixed files of
    this checkout, one a cell (and a rank), so that no run reads a winner
    or a verdict from outside it."""
    CACHE_DIR.mkdir(exist_ok=True)
    tag = cell if rank is None else f"{cell}.rank{rank}"
    os.environ["CME213_TUNE_CACHE"] = str(CACHE_DIR / f"tune.{tag}.json")
    os.environ["CME213_CONFORMANCE_CACHE"] = str(
        CACHE_DIR / f"conformance.{tag}.json")


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell: harness.Cell, out: dict, kind: str, count: int,
                trace: bool) -> dict:
    """The contract's result object; ``checks`` comes last."""
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        device["busy_s"] = out.get("busy_s", 0.0)
        device["window_s"] = out.get("window_s", 0.0)
    res = {"correct": harness.judge(out["checks"], out["failed"]),
           "attempted": out["attempted"], "failed": out["failed"],
           "metrics": out["metrics"], "device": device}
    if trace and "breakdown" in out:
        res["breakdown"] = out["breakdown"]
    res["checks"] = harness.checks_key(out["checks"])
    return res


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.Cell.load(args.workload)
    set_cache_env(cell.name)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    ctx = harness.Context(cell, args.seed, "cuda")
    trace = bool(args.trace)
    ranks = int(cell.workload.get("ranks", 1))
    if ranks > 1:
        from . import gang

        out, kind = gang.run(ctx, args.seconds, trace, T_START, ranks)
    else:
        out = harness.measure(ctx, args.seconds, trace, T_START)
        kind = torch.cuda.get_device_name(0)
    found = harness.forbidden_loaded() + out.get("forbidden", [])
    if found:
        print(f"perfbench: forbidden modules loaded: {sorted(set(found))}",
              file=sys.stderr)
        return 3
    res = result_line(cell, out, kind, cell.chips, trace)
    harness.print_checks(out["checks"])
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
