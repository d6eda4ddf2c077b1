"""``spmv.download_ms_per_solve``: the time of the program's
``spmv_scan.download`` ranges inside its ``spmv_scan.solve`` ranges (the
copy of the answer to the host, after the solve's ``spmv_scan.run`` has
waited for its last scan), over the solves, from the profiler's host
ranges."""

from perfbench.spans import inside_s, ranges


def read(run):
    solves = ranges(run, "spmv_scan.solve")
    parts = ranges(run, "spmv_scan.download")
    if not solves or not parts:
        return None
    return 1e3 * inside_s(solves, parts) / len(solves)
