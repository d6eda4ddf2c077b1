"""``pr.kernel_roofline_pct``: the least time the card could take for the
window's PageRank sweeps over the device time of every kernel inside the
program's ``pagerank.sweeps`` spans.

The least time is the larger of two bounds: the frozen
``pagerank_sweep_bytes`` a sweep (neighbour ids, offsets and four
per-vertex streams, each once) over the HBM peak, and one add an entry
over the float32 peak.  ``n`` is the cell's ``2^scale``; the entries
swept (a solve's sweeps times its graph's directed entries) are the
driver's count.  The count is the same whatever implements the pull."""

from perfbench.readers import device_s_in_spans
from perfbench.reference import costs
from perfbench.reference import pagerank_costs as pc


def read(run):
    device_s = device_s_in_spans(run, "pagerank.sweeps")
    entries = run.counters.get("pagerank.entries")
    if device_s is None or run.units <= 0 or not entries:
        return None
    n = 1 << int(run.params["scale"])
    edges = entries // int(run.units)  # every solve sweeps the one graph
    least, _ = costs.least_seconds(
        run.units * pc.pagerank_sweep_bytes(n, edges),
        run.units * pc.pagerank_sweep_flops(edges))
    return 100.0 * least / device_s
