"""``heat.dispatch_us_per_launch.l2``: the host time of the heat kernel's
launch loop (the program's ``heat.launch_loop`` spans, from the profiler's
host ranges) over the kernel's launches in the window (the program's
``ops/stencil_pipeline.LAUNCHES``), in microseconds a launch."""

from perfbench.spans import ranges


def read(run):
    loops = ranges(run, "heat.launch_loop")
    launches = run.counters.get("heat.launches")
    if not loops or not launches:
        return None
    return 1e6 * sum(e - s for s, e in loops) / launches
