"""The hw2 heat solve on one card, as ``apps/heat2d.run_single`` serves it:
``ops/stencil_pipeline.run_heat_resilient`` with k = 1 (the kernel ladder
behind its conformance gate).

Traffic: a closed loop of solves of ``iters`` steps on an ``nx`` × ``ny``
grid.  The seed draws ``variants`` sets of the initial and boundary
values; solve i takes set i mod ``variants``.  The answer of a solve is its
final grid, compared after the window with the plain reference in float32
by the largest distance in units in the last place (hw2's check allows
10).
"""

from __future__ import annotations

import torch

from perfbench import inputs
from perfbench.reference import compare
from perfbench.reference import heat as ref


class Driver:
    span_names = ("heat.run",)

    def __init__(self, ctx):
        self.ctx = ctx
        cfg = ctx.cell.config
        self.nx, self.ny = int(ctx.param("nx")), int(ctx.param("ny"))
        self.iters = int(ctx.param("iters"))
        self.order = int(cfg["order"])
        self.phys = dict(lx=cfg["lx"], ly=cfg["ly"], alpha=cfg["alpha"])
        lo, hi = cfg["value_range"]
        self.variants = inputs.heat_variants(ctx.seed,
                                             int(ctx.param("variants")),
                                             lo, hi)

    def setup(self) -> None:
        from cme213_tpu_torch.config import SimParams
        from cme213_tpu_torch.ops import stencil_pipeline

        self.sp = stencil_pipeline
        self.calls = []
        for v in self.variants:
            top, left, bottom, right = v["bc"]
            p = SimParams(nx=self.nx, ny=self.ny, iters=self.iters,
                          order=self.order, ic=v["ic"], bc_top=top,
                          bc_left=left, bc_bottom=bottom, bc_right=right,
                          **self.phys)
            u0 = ref.initial_grid(self.nx, self.ny, self.order, v["ic"],
                                  v["bc"], torch.float32, self.ctx.device)
            self.calls.append((u0, p))
        self.solve(0)  # builds, probes and warms the one shape

    def solve(self, i: int):
        u0, p = self.calls[i % len(self.calls)]
        res = self.sp.run_heat_resilient(u0, p.iters, p.order, p.xcfl,
                                         p.ycfl, p.bc, k=1)
        return p.iters, (i % len(self.calls), res.value)

    def counters(self) -> dict:
        return {"heat.launches": sum(self.sp.LAUNCHES.values())}

    def release(self) -> None:
        self.calls = []

    def check(self, kept) -> list[dict]:
        worst = 0
        refs: dict = {}
        for _, (variant, grid) in kept:
            if variant not in refs:
                v = self.variants[variant]
                refs[variant] = ref.solve(self.nx, self.ny, self.order,
                                          self.iters, v["ic"], v["bc"],
                                          dtype=torch.float32,
                                          device=self.ctx.device, **self.phys)
            worst = max(worst, compare.max_ulp(refs[variant], grid))
        limit = self.ctx.cell.config["max_ulp"]
        return [{"name": "heat.max_ulp", "value": worst, "limit": limit}]
