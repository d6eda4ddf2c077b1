"""One rank of the hw5 distributed solve as a gang, one rank a card:
``dist/heat.run_distributed_heat(params, mesh, local_kernel="pallas")``
on the 2-D mesh of the gang's ranks (NCCL on cards, gloo on the CPU),
called back to back by every rank.

Traffic: as ``heat_single``'s, one solve at a time for the whole gang.
Every rank gets the whole gathered grid; rank 0's answers are compared,
so the exchange between the cards and the kernel on each are both
judged.
"""

from __future__ import annotations

import torch

from perfbench import inputs
from perfbench.reference import compare
from perfbench.reference import heat as ref


class Driver:
    span_names = ()

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
        from cme213_tpu_torch.config import GridMethod, SimParams
        from cme213_tpu_torch.dist import heat, mesh

        self.heat = heat
        self.params = []
        for v in self.variants:
            top, left, bottom, right = v["bc"]
            self.params.append(SimParams(
                nx=self.nx, ny=self.ny, iters=self.iters, order=self.order,
                ic=v["ic"], bc_top=top, bc_left=left, bc_bottom=bottom,
                bc_right=right, grid_method=GridMethod.BLOCKS_2D,
                synchronous=True, **self.phys))
        devices = mesh.default_devices(self.ctx.device)
        self.mesh = mesh.mesh_for_method(GridMethod.BLOCKS_2D,
                                         devices=devices)
        self.solve(0)  # builds, probes and warms the one shape

    def solve(self, i: int):
        p = self.params[i % len(self.params)]
        out = self.heat.run_distributed_heat(p, self.mesh,
                                             local_kernel="pallas")
        return p.iters, (i % len(self.params), out)

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        self.params = []

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
            worst = max(worst, compare.max_ulp(refs[variant],
                                               torch.from_numpy(grid)))
        limit = self.ctx.cell.config["max_ulp"]
        return [{"name": "dist.max_ulp", "value": worst, "limit": limit}]
