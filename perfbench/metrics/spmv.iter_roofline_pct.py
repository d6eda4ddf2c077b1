"""``spmv.iter_roofline_pct``: the least time of the window's solves over
the device time of every kernel inside the program's ``spmv_scan.run``
spans.  The least time is the larger of two bounds: the frozen
``spmv_scan_bytes`` of a solve over the HBM peak, and a multiply and an
add an element an iteration over the float32 peak.  The count is the same
whatever implements the scan."""

from perfbench.readers import device_s_in_spans
from perfbench.reference import costs


def read(run):
    device_s = device_s_in_spans(run, "spmv_scan.run")
    if device_s is None or run.units <= 0:
        return None
    n, p, q = (int(run.params[k]) for k in ("n", "p", "q"))
    solves = run.units / int(run.params["iters"])
    least, _ = costs.least_seconds(
        solves * costs.spmv_scan_bytes(n, p, q),
        costs.spmv_scan_flops(n, int(run.units)))
    return 100.0 * least / device_s
