"""``spmv.upload_ms_per_solve``: the time of the program's
``spmv_scan.upload`` ranges inside its ``spmv_scan.solve`` ranges (the
host gather ``x[k]`` and the pageable copies of the problem to the card,
``problem_tensors``), over the solves, from the profiler's host ranges."""

from perfbench.spans import inside_s, ranges


def read(run):
    solves = ranges(run, "spmv_scan.solve")
    parts = ranges(run, "spmv_scan.upload")
    if not solves or not parts:
        return None
    return 1e3 * inside_s(solves, parts) / len(solves)
