"""The hw_final SpMV-scan on one card: ``apps/spmv_scan.run_spmv_scan`` on
a host ``Problem`` with its default kernel (``auto``), every solve with
its validation, upload, iterations and download.

Traffic: a closed loop of solves of the one problem the seed draws
(``n``, ``p``, ``q`` and ``iters`` from the configuration).  The answer of
a solve is its final vector, compared after the window with the float64
reference by relative L2 and L-infinity error.  The solver's timing line
goes to the null device.
"""

from __future__ import annotations

import contextlib
import os

from perfbench import inputs
from perfbench.reference import compare
from perfbench.reference import spmv as ref


class Driver:
    span_names = ("spmv_scan.run",)

    def __init__(self, ctx):
        self.ctx = ctx
        self.shape = {k: int(ctx.param(k))
                      for k in ("n", "p", "q", "iters")}
        self.kernel = ctx.cell.traffic["kernel"]

    def setup(self) -> None:
        from cme213_tpu_torch.apps import spmv_scan

        self.app = spmv_scan
        d = inputs.spmv_problem(seed=self.ctx.seed, device=self.ctx.device,
                                **self.shape)
        self.data = d
        self.prob = spmv_scan.Problem(d["a"], d["s"], d["k"], d["x"],
                                      d["iters"])
        self.null = open(os.devnull, "w")
        self.solve(0)  # builds, probes and warms the one shape

    def solve(self, i: int):
        with contextlib.redirect_stdout(self.null):
            out = self.app.run_spmv_scan(self.prob, kernel=self.kernel,
                                         device=self.ctx.device)
        return self.prob.iters, out

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        self.prob = None
        self.null.close()

    def check(self, kept) -> list[dict]:
        d = self.data
        expect = ref.solve(d["a"], d["s"], d["k"], d["x"], d["iters"],
                           device=self.ctx.device)
        l2 = linf = 0.0
        for _, out in kept:
            e2, einf = compare.relative_errors(expect, out)
            l2, linf = max(l2, e2), max(linf, einf)
        cfg = self.ctx.cell.config
        return [{"name": "spmv.rel_l2", "value": l2,
                 "limit": cfg["rel_l2_limit"]},
                {"name": "spmv.rel_linf", "value": linf,
                 "limit": cfg["rel_linf_limit"]}]
