"""``dist_step_ms``: rank 0's window wall time over all the distributed heat
steps its solves completed, in milliseconds."""

from perfbench.readers import ms_per_unit


def read(run):
    return ms_per_unit(run)
