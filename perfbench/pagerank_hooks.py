"""GAP ``pr``'s planted faults and control, for the harness's tests and
for the control's command line, registered under the driver's name beside
the other cells' (``faults.PLANTERS``, ``controls.READINGS``).  The
benchmark's runs never import this module.

- ``sweep-skipped``: each solve's first update is left out (the scores lag
  a sweep behind the count it reports);
- ``hub-dropped``: the edges of the vertex most edges touch are left out
  of the graph the program builds.

    python3 -m perfbench.pagerank_hooks --workload pr-kron26 \
        --seeds 1,2,3 [--device cuda] [--size key=value ...]

is ``python3 -m perfbench.controls`` with this cell's control: the plain
reference's own count of float64 sweeps run again with bfloat16 scores
and contributions and float32 row sums, read by the cell's numbers.
"""

from __future__ import annotations

import sys

import torch

from . import controls, faults, harness, kron
from .reference import pagerank as ref

DRIVER = "pagerank_gap"
FAULTS = ("sweep-skipped", "hub-dropped")


def plant(fault: str) -> None:
    from cme213_tpu_torch.apps import pagerank

    if fault == "sweep-skipped":
        real_solve, real_update = pagerank.solve_to_tolerance, \
            pagerank.pull_update
        first = []

        def update(plan, sums, deg, score, contrib, base, damping):
            if first:
                first.pop()
                return torch.ones((), dtype=torch.float64)
            return real_update(plan, sums, deg, score, contrib, base,
                               damping)

        def solve(*args, **kwargs):
            first[:] = [True]
            return real_solve(*args, **kwargs)

        pagerank.pull_update = update
        pagerank.solve_to_tolerance = solve
        return
    real_build = pagerank.build_csr

    def build(src, dst, num_nodes, *args, **kwargs):
        hub = int(torch.bincount(torch.cat([src, dst]).to(torch.int64),
                                 minlength=num_nodes).argmax())
        keep = (src != hub) & (dst != hub)
        return real_build(src[keep], dst[keep], num_nodes, *args, **kwargs)

    pagerank.build_csr = build


def control_readings(ctx: harness.Context) -> list[dict]:
    cfg = ctx.cell.config
    scale = int(ctx.param("scale"))
    damping = float(ctx.param("damping"))
    src, dst = kron.kron_edges(scale, int(ctx.param("edge_factor")),
                               ctx.seed, ctx.device)
    adj = ref.Adjacency(src, dst, 1 << scale)
    del src, dst
    stop, states = ref.solve(adj, damping, float(ctx.param("tolerance")),
                             int(ctx.param("max_iters")), keep=())
    _, states = ref.solve(adj, damping, 0.0, stop, keep=(stop,))
    lowered = ref.solve_lowered(adj, damping, stop)
    l1, linf = ref.relative_errors(states[stop], lowered)
    return [{"name": "pr.rel_l1", "value": l1, "limit": cfg["rel_l1_limit"]},
            {"name": "pr.rel_linf", "value": linf,
             "limit": cfg["rel_linf_limit"]},
            {"name": "pr.residual", "value": ref.residual(adj, lowered,
                                                          damping),
             "limit": cfg["residual_limit"]}]


def register() -> None:
    """Add the driver's planter and control.  ``faults.FAULTS`` gets the
    driver with no faults: the generic fault test plants in a child that
    does not import this module, so this cell's faults are planted by
    ``tests/test_perfbench_pagerank.py``, whose children do."""
    faults.PLANTERS.setdefault(DRIVER, plant)
    faults.FAULTS.setdefault(DRIVER, ())
    controls.READINGS.setdefault(DRIVER, control_readings)


register()

if __name__ == "__main__":
    sys.exit(controls.main())
