"""``pr.sweeps_per_solve``: the program's ``pagerank.SWEEPS`` counts over
the window, sweeps over solves."""


def read(run):
    solves = run.counters.get("pagerank.solves")
    if not solves:
        return None
    return run.counters["pagerank.sweeps"] / solves
