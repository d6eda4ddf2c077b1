"""``heat_step_ms``: the window's wall time over all the heat steps its
solves completed, in milliseconds, on a grid that does not fit the L2."""

from perfbench.readers import ms_per_unit


def read(run):
    return ms_per_unit(run)
