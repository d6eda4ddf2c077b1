"""``dist.outside_steps_pct``: share of the program's ``dist.solve`` ranges
(the whole of ``run_distributed_heat``) outside their ``dist.steps``
ranges (the timed step loop): the initial blocks, the ranks' barrier, the
gather and the copy to the host, from the profiler's host ranges."""

from perfbench.spans import ranges, self_s


def read(run):
    solves = ranges(run, "dist.solve")
    total = sum(e - s for s, e in solves)
    if total <= 0:
        return None
    return 100.0 * self_s(solves, ranges(run, "dist.steps")) / total
