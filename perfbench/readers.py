"""Arithmetic the metric readers share (``metrics/<name>.py`` each call
one of these on the finished window, ``harness.Run``)."""

from __future__ import annotations


def ms_per_unit(run) -> float | None:
    """The window's wall time over all the work units (steps or
    iterations) completed in it, in milliseconds."""
    if run.units <= 0:
        return None
    return run.wall_s * 1e3 / run.units


def idle_pct(run) -> float | None:
    """Share of the traced window in which nothing ran on the card."""
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def span_intervals(run, name: str) -> list[tuple[float, float]]:
    return [(b, e) for b, e, _ in run.spans.get(name, [])]


def device_s_in_spans(run, name: str) -> float | None:
    """Device seconds of the operations inside the program's spans
    ``name`` (a span that blocks on its result holds all its work)."""
    tr = run.trace
    ivs = span_intervals(run, name)
    if tr is None or not tr.ops or not ivs:
        return None
    t = tr.time_in(ivs, match=lambda op: not op.startswith(("Memcpy",
                                                            "Memset")))
    return t if t > 0 else None
