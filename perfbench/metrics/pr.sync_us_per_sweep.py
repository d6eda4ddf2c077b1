"""``pr.sync_us_per_sweep``: the host's read of the sweep's L1 change
alone, in microseconds a sweep.

Each ``pagerank.converged`` host range waits for the sweep's kernels and
then copies the change down.  Only its tail counts: from the later of the
range's start and the end of the last kernel the card finished before the
range closed, to the range's end (the copy down and the host's return).
So the sweep's own device time is left out, and the metric reads what the
host's wait adds to a sweep.  Sums over the traced window's ranges, over
the window's sweeps; ``None`` without a device trace or ranges."""

from bisect import bisect_right

from perfbench.spans import ranges


def read(run):
    tr = run.trace
    reads = ranges(run, "pagerank.converged")
    if tr is None or not reads or run.units <= 0:
        return None
    ends = sorted(e for name, _, e in tr.ops
                  if not name.startswith(("Memcpy", "Memset")))
    if not ends:
        return None
    total = 0.0
    for s, e in reads:
        i = bisect_right(ends, e) - 1
        total += e - max(s, ends[i]) if i >= 0 else e - s
    return 1e6 * total / run.units
