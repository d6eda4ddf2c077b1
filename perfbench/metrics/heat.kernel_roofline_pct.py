"""``heat.kernel_roofline_pct``: the least time the card could take for
the window's heat kernels over their device time inside the program's
``heat.run`` spans.

The least time is the larger of two bounds: bytes (each launch reads its
input grid once and writes its output once, the frozen ``heat_bytes`` a
launch) over the HBM peak, and operations (the stencil's per-point count
a step) over the float32 peak.  At order 8 the bytes bound it."""

from perfbench.readers import device_s_in_spans
from perfbench.reference import costs


def read(run):
    device_s = device_s_in_spans(run, "heat.run")
    launches = run.counters.get("heat.launches")
    if device_s is None or not launches:
        return None
    nx, ny = int(run.params["nx"]), int(run.params["ny"])
    least, _ = costs.least_seconds(
        launches * costs.heat_bytes(ny, nx),
        costs.heat_flops(ny, nx, int(run.params["order"]), int(run.units)))
    return 100.0 * least / device_s
