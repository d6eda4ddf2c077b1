"""The program's spans as the profiler recorded them: the host ranges of
the traced window (``run.trace.host``, on the device trace's clock), which
the program's spans join while a profiler session records
(``core/trace.span``'s profiler mirror).  Read by the per-layer metrics of
the heat solve's host work; each returns ``None`` where the program
recorded none of the spans it reads."""

from __future__ import annotations


def ranges(run, name: str) -> list[tuple[float, float]]:
    """``(start, end)`` (wall seconds) of the host ranges named ``name``,
    sorted by start; ``[]`` without a trace."""
    tr = run.trace
    if tr is None:
        return []
    return sorted((s, e) for n, s, e in tr.host if n == name)


def covered(lo: float, hi: float, ivs) -> float:
    """Seconds of ``[lo, hi]`` that the union of ``ivs`` (sorted by start)
    covers."""
    total, end = 0.0, lo
    for s, e in ivs:
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def self_s(parents, children) -> float:
    """The parents' self time: their durations less the part of each that
    the children cover."""
    return sum(e - s - covered(s, e, children) for s, e in parents)


def inside_s(parents, children) -> float:
    """Seconds of the children that lie inside the parents."""
    return sum(covered(s, e, children) for s, e in parents)


def host_ms_per_solve(run) -> float | None:
    """Self time of the ``heat.solve`` spans outside their ``heat.run``
    children, in ms a solve."""
    solves = ranges(run, "heat.solve")
    if not solves:
        return None
    return 1e3 * self_s(solves, ranges(run, "heat.run")) / len(solves)
