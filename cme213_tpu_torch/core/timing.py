"""Phase timers and derived-metric helpers.

Counterpart of ``cme213_tpu/core/timing.py``.  CUDA work is asynchronous:
a phase's clock stops only after the devices of the tensors handed to
``.block`` have synchronised, the analog of ``cudaEventSynchronize``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseRecord:
    label: str
    ms: float


class _Phase:
    def __init__(self):
        self._blocked: list[torch.Tensor] = []

    def block(self, *tensors: torch.Tensor) -> None:
        """Wait for ``tensors`` before the phase's clock stops."""
        self._blocked.extend(tensors)


def _synchronize(tensors) -> None:
    for t in tensors:
        if torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)


@dataclass
class PhaseTimer:
    """Labeled wall-clock phase timer.

    Usage::

        timer = PhaseTimer()
        with timer.phase("gpu computation shared") as ph:
            out = run_heat_pipeline(u, ...)
            ph.block(out)          # synchronise before stopping the clock
        timer.report()
    """

    records: list[PhaseRecord] = field(default_factory=list)
    verbose: bool = False

    @contextmanager
    def phase(self, label: str):
        ph = _Phase()
        start = time.perf_counter()
        try:
            yield ph
        finally:
            _synchronize(ph._blocked)
            ms = (time.perf_counter() - start) * 1e3
            self.records.append(PhaseRecord(label, ms))
            if self.verbose:
                # labeled timing printout, like stop_timer's "%s took %.1f ms"
                print(f"{label} took {ms:.1f} ms")

    def ms(self, label: str) -> float:
        """Total milliseconds across all phases with this label."""
        return sum(r.ms for r in self.records if r.label == label)

    def last_ms(self, label: str | None = None) -> float:
        if label is None:
            return self.records[-1].ms
        for r in reversed(self.records):
            if r.label == label:
                return r.ms
        raise KeyError(label)

    def report(self) -> str:
        out = "\n".join(f"{r.label} took {r.ms:.1f} ms" for r in self.records)
        print(out)
        return out


def time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Best-of-``iters`` milliseconds for ``fn(*args)`` after ``warmup``
    untimed calls.

    When an argument is a CUDA tensor the time is taken with CUDA events
    around the call (device time of everything the call enqueued);
    otherwise with the host clock.
    """
    cuda = [a for a in args if torch.is_tensor(a) and a.is_cuda]
    for _ in range(warmup):
        _synchronize([fn(*args)])
    best = float("inf")
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def bandwidth_gbs(num_bytes: int, ms: float) -> float:
    """Effective bandwidth in GB/s given bytes moved and elapsed ms."""
    return (num_bytes / 1e9) / (ms / 1e3)


def gflops(num_flops: int, ms: float) -> float:
    return (num_flops / 1e9) / (ms / 1e3)
