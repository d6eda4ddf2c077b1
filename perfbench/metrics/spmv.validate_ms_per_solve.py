"""``spmv.validate_ms_per_solve``: the time of the program's
``spmv_scan.validate`` ranges inside its ``spmv_scan.solve`` ranges (the
host's check of the problem's invariants, ``Problem.validate``), over the
solves, from the profiler's host ranges."""

from perfbench.spans import inside_s, ranges


def read(run):
    solves = ranges(run, "spmv_scan.solve")
    parts = ranges(run, "spmv_scan.validate")
    if not solves or not parts:
        return None
    return 1e3 * inside_s(solves, parts) / len(solves)
