"""``pr.device_idle_pct``: share of the traced window in which no kernel,
copy or set ran on the card, from the profiler's trace."""

from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run)
