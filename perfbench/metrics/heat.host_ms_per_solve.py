"""``heat.host_ms_per_solve``: the host time of a solve outside its kernel
run: the self time of the program's ``heat.solve`` spans less their
``heat.run`` children (admission, tuning, the program cache, the gate and
the ladder), over the solves, from the profiler's host ranges."""

from perfbench.spans import host_ms_per_solve


def read(run):
    return host_ms_per_solve(run)
