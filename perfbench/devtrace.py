"""Reading a ``torch.profiler`` trace of the measured window: the device's
busy time, its kernels and copies, and what the host was doing while the
device idled.

Times are turned into wall-clock seconds (``time.time()``), the clock the
program's spans carry, by a marker range recorded next to a reading of
that clock.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field

MARKER = "perfbench.clock"


def _ns(ev, what: str) -> float:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return float(fn())
    return float(getattr(ev, f"{what}_us")()) * 1e3


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type()).upper()


def _is_annotation(ev) -> bool:
    """A range recorded by name (on the host, or projected onto the
    card's timeline), not an operation."""
    fn = getattr(ev, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


def clock_marker():
    """Record the marker range; returns the wall clock in ns at its middle.
    Call inside the profiled block."""
    import torch

    a = time.time_ns()
    with torch.profiler.record_function(MARKER):
        pass
    return (a + time.time_ns()) / 2


@dataclass
class DeviceTrace:
    """The device activity of one card over ``[w0, w1]`` (wall seconds):
    ``ops`` are ``(name, start, end)`` of kernels, copies and sets, sorted
    by start and clipped to the window; ``host`` the host's ranges."""

    w0: float
    w1: float
    ops: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        busy, end = 0.0, self.w0
        for _, s, e in self.ops:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def gaps(self) -> list[tuple[float, float]]:
        out, end = [], self.w0
        for _, s, e in self.ops:
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.w1 > end:
            out.append((end, self.w1))
        return out

    def time_in(self, intervals, match=None) -> float:
        """Device seconds of the operations (those whose name ``match``
        accepts, if given) that fall inside ``intervals`` (sorted, non-
        overlapping ``(start, end)`` pairs)."""
        total, j = 0.0, 0
        ivs = sorted(intervals)
        for name, s, e in self.ops:
            if match is not None and not match(name):
                continue
            while j < len(ivs) and ivs[j][1] <= s:
                j += 1
            k = j
            while k < len(ivs) and ivs[k][0] < e:
                total += max(0.0, min(e, ivs[k][1]) - max(s, ivs[k][0]))
                k += 1
        return total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the innermost host range that was open at each gap's middle."""
        by_op: dict[str, float] = {}
        for name, s, e in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (e - s)
        idle: dict[str, float] = {}
        host = sorted(self.host, key=lambda h: h[1])
        heap: list = []
        i = 0
        for g0, g1 in self.gaps():
            mid = (g0 + g1) / 2
            while i < len(host) and host[i][1] <= mid:
                name, s, e = host[i]
                heapq.heappush(heap, (e - s, e, name))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            label = heap[0][2] if heap else "host outside any traced range"
            idle[label] = idle.get(label, 0.0) + (g1 - g0)

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(by_op), "idle_gaps": ranked(idle)}


def read(prof, w0: float, w1: float, marker_wall_ns: float,
         device_index: int | None) -> DeviceTrace:
    """The trace of the card ``device_index`` (every card if ``None``)
    between the wall-clock seconds ``w0`` and ``w1``."""
    events = prof.profiler.kineto_results.events()
    offset = None
    for ev in events:
        if ev.name() == MARKER and not _is_device(ev):
            offset = marker_wall_ns - (_ns(ev, "start") + _ns(ev, "duration")
                                       / 2)
            break
    if offset is None:
        raise RuntimeError("the profiler's trace lacks the clock marker")
    tr = DeviceTrace(w0, w1)
    for ev in events:
        s = (_ns(ev, "start") + offset) / 1e9
        e = s + _ns(ev, "duration") / 1e9
        if e <= w0 or s >= w1:
            continue
        if _is_device(ev):
            if _is_annotation(ev) or (device_index is not None
                                      and ev.device_index() != device_index):
                continue
            tr.ops.append((ev.name(), max(s, w0), min(e, w1)))
        elif ev.name() != MARKER:
            tr.host.append((ev.name(), s, e))
    tr.ops.sort(key=lambda o: o[1])
    return tr
