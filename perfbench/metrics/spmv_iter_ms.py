"""``spmv_iter_ms``: the window's wall time over all the SpMV-scan iterations
its solves completed (each solve's validation, upload, iterations and
download included), in milliseconds."""

from perfbench.readers import ms_per_unit


def read(run):
    return ms_per_unit(run)
