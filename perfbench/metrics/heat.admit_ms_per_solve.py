"""``heat.admit_ms_per_solve``: the time of the program's
``admission.admit`` spans inside its ``heat.solve`` spans (the footprint
check and its read of the card's memory), over the solves, from the
profiler's host ranges."""

from perfbench.spans import inside_s, ranges


def read(run):
    solves = ranges(run, "heat.solve")
    admits = ranges(run, "admission.admit")
    if not solves or not admits:
        return None
    return 1e3 * inside_s(solves, admits) / len(solves)
