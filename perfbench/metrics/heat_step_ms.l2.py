"""``heat_step_ms.l2``: the heat cells' ms a step (the window's wall time over
all the steps its solves completed) where the grid sits in the card's L2, so
that launches and host dispatch decide it."""

from perfbench.readers import ms_per_unit


def read(run):
    return ms_per_unit(run)
