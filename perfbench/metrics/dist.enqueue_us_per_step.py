"""``dist.enqueue_us_per_step``: the host time of the program's
``dist.enqueue`` ranges (the step loop of a distributed solve, up to its
closing synchronise) over the steps those ranges ran (``iters`` each), in
microseconds a step: below the card's time a step, the cards pace the
gang; near it, the host does.

It assumes every range ran the cell's ``iters`` steps.  The program tags
each ``dist.steps`` span with its own ``iters`` and block, but the trace's
host ranges carry no tags, so a range of other steps inside the window (a
gate's probe solve, a supervised epoch) would be misread; the cell's
driver runs none there (its probes run in set-up)."""

from perfbench.spans import ranges


def read(run):
    loops = ranges(run, "dist.enqueue")
    if not loops:
        return None
    steps = len(loops) * int(run.params["iters"])
    return 1e6 * sum(e - s for s, e in loops) / steps
