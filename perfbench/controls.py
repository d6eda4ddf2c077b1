"""The control of each cell's comparison: the plain reference put in the
program's place and computed one precision lower than the configuration
states (bfloat16 for its float32), read by the same numbers a run
compares.  Each reading has to fail its limit, or the comparison could
not tell a wrong answer.

    python3 -m perfbench.controls --workload <cell> --seeds 1,2,3 \
        [--device cuda] [--size key=value ...]

prints one JSON line a seed with every reading and its limit, at the
cell's own sizes unless ``--size`` shrinks them (the tests do).  With
``--program`` it also reads, in the same process, the program's own
answer on each seed (the lower readings) through the cell's entry and,
for the SpMV-scan, through the program's other scans as witnesses.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness, inputs
from .reference import compare
from .reference import heat as heat_ref
from .reference import spmv as spmv_ref


def heat_readings(ctx: harness.Context) -> list[dict]:
    cfg = ctx.cell.config
    nx, ny = int(ctx.param("nx")), int(ctx.param("ny"))
    iters, order = int(ctx.param("iters")), int(cfg["order"])
    phys = dict(lx=cfg["lx"], ly=cfg["ly"], alpha=cfg["alpha"])
    lo, hi = cfg["value_range"]
    worst = None
    for v in inputs.heat_variants(ctx.seed, int(ctx.param("variants")),
                                  lo, hi):
        expect = heat_ref.solve(nx, ny, order, iters, v["ic"], v["bc"],
                                dtype=torch.float32, device=ctx.device,
                                **phys)
        lowered = heat_ref.solve(nx, ny, order, iters, v["ic"], v["bc"],
                                 dtype=torch.bfloat16, device=ctx.device,
                                 **phys)
        d = compare.max_ulp(expect, lowered)
        worst = d if worst is None else min(worst, d)
    name = "dist.max_ulp" if ctx.cell.workload["driver"] == "hw5_gang" \
        else "heat.max_ulp"
    return [{"name": name, "value": worst, "limit": cfg["max_ulp"]}]


def spmv_readings(ctx: harness.Context) -> list[dict]:
    cfg = ctx.cell.config
    shape = {k: int(ctx.param(k)) for k in ("n", "p", "q", "iters")}
    d = inputs.spmv_problem(seed=ctx.seed, device=ctx.device, **shape)
    args = (d["a"], d["s"], d["k"], d["x"], d["iters"])
    expect = spmv_ref.solve(*args, device=ctx.device)
    lowered = spmv_ref.solve_lowered(*args, dtype=torch.bfloat16,
                                     device=ctx.device)
    l2, linf = compare.relative_errors(expect, lowered)
    return [{"name": "spmv.rel_l2", "value": l2,
             "limit": cfg["rel_l2_limit"]},
            {"name": "spmv.rel_linf", "value": linf,
             "limit": cfg["rel_linf_limit"]}]


def spmv_program_readings(ctx: harness.Context) -> dict:
    """The program's reading on this seed through the cell's kernel, and
    through ``flat`` and ``pallas-fused`` on the same problem."""
    import contextlib
    import os

    from cme213_tpu_torch.apps import spmv_scan

    shape = {k: int(ctx.param(k)) for k in ("n", "p", "q", "iters")}
    d = inputs.spmv_problem(seed=ctx.seed, device=ctx.device, **shape)
    prob = spmv_scan.Problem(d["a"], d["s"], d["k"], d["x"], d["iters"])
    expect = spmv_ref.solve(d["a"], d["s"], d["k"], d["x"], d["iters"],
                            device=ctx.device)
    out = {}
    kernels = [ctx.cell.traffic["kernel"], "flat"]
    if ctx.device != "cpu":
        kernels.append("pallas-fused")
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        for kernel in kernels:
            got = spmv_scan.run_spmv_scan(prob, kernel=kernel,
                                          device=ctx.device)
            out[kernel] = compare.relative_errors(expect, got)
    return out


READINGS = {"heat_single": heat_readings, "hw5_gang": heat_readings,
            "spmv_scan": spmv_readings}


def readings(ctx: harness.Context) -> list[dict]:
    return READINGS[ctx.cell.workload["driver"]](ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", action="append", default=[])
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    sizes = {}
    for item in args.size:
        key, _, value = item.partition("=")
        sizes[key] = json.loads(value)
    cell = harness.Cell.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell, seed, args.device, sizes)
        rows = readings(ctx)
        line = {"workload": cell.name, "seed": seed, "control": rows,
                "fails": any(r["value"] > r["limit"] for r in rows)}
        if args.program and cell.workload["driver"] == "spmv_scan":
            line["program"] = spmv_program_readings(ctx)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
