"""``dist.kernel_roofline_pct``: the least time rank 0's card could take
for its heat kernel launches (B3, ``heat_ksteps``) inside the program's
``dist.steps`` ranges, over their device time there, from the profiler's
trace.

The launches are counted from the trace's kernel entries.  Each reads its
shard's padded block once and writes the block once (``heat_bytes`` of
each shape halved: one pass is a read and a write), and computes one
step over the block (the cell's solves run one step a launch).  The
block is the cell's grid cut over its mesh as the program cuts it: the
near-square ``py x px`` of the ranks for 2-D blocks (``ranks x 1`` for
stripes), each side rounded up to a whole block, with one stencil border
of halo on every side.  At order 8 the bytes bound it.

That split is derived here, not read: the program tags each ``dist.steps``
span with its block, but the trace's host ranges carry no tags, so a
program that cut the grid otherwise, or ran more than one step a launch,
would be misread."""

import bisect
import math

from perfbench.reference import costs
from perfbench.reference.heat import BORDER
from perfbench.spans import ranges

KERNEL = "heat_ksteps"
ELEM = {"float32": 4, "float64": 8}


def mesh_shape(ranks: int, grid_method: int) -> tuple[int, int]:
    if grid_method == 1:
        return ranks, 1
    py = math.isqrt(ranks)
    while ranks % py:
        py -= 1
    return py, ranks // py


def read(run):
    tr = run.trace
    steps = ranges(run, "dist.steps")
    if tr is None or not steps:
        return None
    starts = [lo for lo, _ in steps]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < steps[i][1]

    launches = sum(1 for name, s, _ in tr.ops if KERNEL in name
                   and inside(s))
    device_s = tr.time_in(steps, match=lambda name: KERNEL in name)
    if not launches or device_s <= 0:
        return None
    p = run.params
    py, px = mesh_shape(int(p["ranks"]), int(p["grid_method"]))
    ny, nx = -(-int(p["ny"]) // py), -(-int(p["nx"]) // px)
    order, elem = int(p["order"]), ELEM[p["dtype"]]
    pad = 2 * BORDER[order]
    nbytes = launches * (costs.heat_bytes(ny + pad, nx + pad, elem)
                         + costs.heat_bytes(ny, nx, elem)) / 2
    least, _ = costs.least_seconds(
        nbytes, costs.heat_flops(ny, nx, order, launches))
    return 100.0 * least / device_s
