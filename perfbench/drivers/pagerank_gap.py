"""GAP ``pr`` on its ``kron`` graph on one card: ``apps/pagerank``'s
normal entry, ``build_csr`` then ``solve_to_tolerance`` behind its
admission.

Set-up draws the seeded Kronecker edges on the card (``perfbench/kron``),
builds the squished CSR and runs one solve.  Traffic: a closed loop of
solves of the one graph, each from uniform ``1/n`` until the sweep's L1
change is below the tolerance; a unit is a sweep.  The answer of a solve is
its scores and its count of sweeps.  After the window the program's graph
is freed, the edges drawn again, and the plain reference builds its own
adjacency and sweeps in float64: each sampled answer is held to it after
as many sweeps as the program reported (relative L1 and L-infinity), to
GAP's verifier residual, and its count to the reference's own.
"""

from __future__ import annotations

import torch

from perfbench import kron
from perfbench.reference import pagerank as ref


class Driver:
    span_names = ("pagerank.sweeps",)

    def __init__(self, ctx):
        self.ctx = ctx
        self.scale = int(ctx.param("scale"))
        self.edge_factor = int(ctx.param("edge_factor"))
        self.damping = float(ctx.param("damping"))
        self.tolerance = float(ctx.param("tolerance"))
        self.max_iters = int(ctx.param("max_iters"))

    def edges(self):
        return kron.kron_edges(self.scale, self.edge_factor, self.ctx.seed,
                               self.ctx.device)

    def setup(self) -> None:
        from cme213_tpu_torch.apps import pagerank

        self.app = pagerank
        src, dst = self.edges()
        self.graph = pagerank.build_csr(src, dst, 1 << self.scale)
        del src, dst
        self.entries = 0
        self.solve(0)  # lays the graph out and warms every launch

    def solve(self, i: int):
        score, sweeps = self.app.solve_to_tolerance(
            self.graph, self.damping, self.tolerance, self.max_iters)
        self.entries += sweeps * self.graph.num_edges
        return sweeps, (sweeps, score)

    def counters(self) -> dict:
        """The program's counts of sweeps and solves, and the entries the
        sweeps have read (a sweep reads every directed entry once)."""
        return {"pagerank.sweeps": self.app.SWEEPS["sweeps"],
                "pagerank.solves": self.app.SWEEPS["solves"],
                "pagerank.entries": self.entries}

    def release(self) -> None:
        self.graph = None

    def check(self, kept) -> list[dict]:
        cfg = self.ctx.cell.config
        src, dst = self.edges()
        adj = ref.Adjacency(src, dst, 1 << self.scale)
        del src, dst
        counts = {sweeps for _, (sweeps, _) in kept}
        stop, states = ref.solve(adj, self.damping, self.tolerance,
                                 self.max_iters, keep=counts)
        l1 = linf = res = off = 0.0
        for _, (sweeps, score) in kept:
            e1, einf = ref.relative_errors(states[sweeps], score)
            l1, linf = max(l1, e1), max(linf, einf)
            res = max(res, ref.residual(adj, score, self.damping))
            off = max(off, abs(sweeps - stop))
        del adj, states
        if self.ctx.device != "cpu":
            torch.cuda.empty_cache()
        return [{"name": "pr.rel_l1", "value": l1,
                 "limit": cfg["rel_l1_limit"]},
                {"name": "pr.rel_linf", "value": linf,
                 "limit": cfg["rel_linf_limit"]},
                {"name": "pr.residual", "value": res,
                 "limit": cfg["residual_limit"]},
                {"name": "pr.sweeps_off", "value": off,
                 "limit": cfg["sweeps_slack"]}]
