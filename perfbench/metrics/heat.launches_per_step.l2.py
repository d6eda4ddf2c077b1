"""``heat.launches_per_step.l2``: the heat kernel's launches in the window
(the program's ``ops/stencil_pipeline.LAUNCHES``, every entry) over the
steps completed."""


def read(run):
    launches = run.counters.get("heat.launches")
    if launches is None or run.units <= 0:
        return None
    return launches / run.units
