"""Memory-aware admission control: a footprint check before dispatch.

Counterpart of ``cme213_tpu/core/admission.py``.  The reference assumed
its problems fit: a grid too large died inside a CUDA allocation with
whatever the CUDA runtime printed.  This module moves that discovery before
dispatch:

- :func:`memory_budget`: the per-device byte budget.
  ``CME213_MEMORY_BUDGET`` (bytes, or with a ``K``/``M``/``G`` suffix)
  wins; otherwise the total memory ``torch.cuda.mem_get_info()`` reports
  for a CUDA device (the counterpart of XLA's ``bytes_limit``); on the CPU
  ``None``, so admission there is opt-in through the variable.
- :func:`preflight`: a call's device footprint against the budget, as a
  :class:`Decision`.  Torch has no ``memory_analysis()``, so the footprint
  is the caller's own count (argument + output + workspace bytes); an
  over-budget call is rejected with an ``admission-rejected`` event before
  any allocation.  The checkpointed runners preflight their first chunk
  (``apps/heat2d.run_heat_checkpointed``, ``apps/spmv_scan.
  run_spmv_scan_checkpointed``).
- :func:`admit`: :func:`preflight` that raises :class:`AdmissionError` on a
  rejection.  The heat ladder admits its grid and two ping-pong buffers
  (``ops/stencil_pipeline.run_heat_resilient``).

- :func:`admit_chunk`: the degradation loop, halving a size knob until
  its preflight fits, a ``chunk-shrunk`` event (and the
  ``admission.chunk_shrunk`` counter) a halving; only a floor size still
  over the budget raises :class:`AdmissionError`.
- :func:`admit_batch`: :func:`admit_chunk` over the serve batcher's batch
  width (``serve/server.py``), whose adapters count a batch's bytes at
  each candidate width (``serve/workloads.py``).

``oom:<op>`` fault clauses raise a synthetic RESOURCE_EXHAUSTED,
to which the heat ladder responds by halving its tile and the
checkpointed solves by halving their chunk (``core/resilience.
classify_failure`` buckets it as RESOURCE).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import metrics
from .errors import FrameworkError
from .trace import host_range, record_event

#: per-device memory budget override, bytes (suffixes K/M/G accepted)
BUDGET_ENV = "CME213_MEMORY_BUDGET"

_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


class AdmissionError(FrameworkError):
    """A call's device footprint is over the memory budget."""


def parse_budget(raw: str) -> int:
    """``"1073741824"`` / ``"512M"`` / ``"16g"`` -> bytes."""
    raw = raw.strip().lower()
    mult = 1
    if raw and raw[-1] in _SUFFIX:
        mult = _SUFFIX[raw[-1]]
        raw = raw[:-1]
    return int(float(raw) * mult)


def memory_budget(device=None) -> int | None:
    """The effective per-device byte budget, or None (admission off).

    ``CME213_MEMORY_BUDGET`` wins.  Otherwise the total memory of the CUDA
    ``device`` (default: the current CUDA device when there is one) from
    ``torch.cuda.mem_get_info``; None for a CPU device or with no card.
    """
    raw = os.environ.get(BUDGET_ENV)
    if raw and raw.strip():
        try:
            return parse_budget(raw)
        except ValueError:
            return None
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    try:
        return int(torch.cuda.mem_get_info(device)[1])
    except RuntimeError:  # detection must never break dispatch
        return None


@dataclass(frozen=True)
class Decision:
    admitted: bool
    required_bytes: int
    budget_bytes: int | None   # None when admission is off
    detail: str


def preflight(op: str, required_bytes: int, device=None) -> Decision:
    """Admission decision for ``op``, whose device footprint is
    ``required_bytes`` by the caller's own count, against
    ``memory_budget(device)``.  With no budget it admits pass-open:
    admission must never turn a healthy call away on missing information.
    A rejection records ``admission-rejected`` and bumps
    ``admission.rejected``; an admission against a budget bumps
    ``admission.admitted``."""
    budget = memory_budget(device)
    required = int(required_bytes)
    if budget is None:
        return Decision(True, required, None, "no budget: admission off")
    if required > budget:
        metrics.counter("admission.rejected").inc()
        detail = f"footprint {required} > budget {budget}"
        record_event("admission-rejected", op=op, requested_bytes=required,
                     budget_bytes=budget, detail=detail)
        return Decision(False, required, budget, detail)
    metrics.counter("admission.admitted").inc()
    return Decision(True, required, budget,
                    f"footprint {required} <= budget {budget}")


def admit(op: str, required_bytes: int, device=None) -> None:
    """:func:`preflight` that raises :class:`AdmissionError` when ``op``'s
    footprint is over the budget.  The call, the budget's read of the
    device's memory included, is an ``admission.admit`` host range on the
    profiler's clock (``trace.host_range``)."""
    with host_range("admission.admit"):
        decision = preflight(op, required_bytes, device=device)
        if not decision.admitted:
            raise AdmissionError(f"{op}: {decision.detail} ({BUDGET_ENV} "
                                 f"or the device's memory)")


def admit_chunk(op: str, initial: int, preflight_at, floor: int = 1,
                halve=None) -> int:
    """Largest admitted size knob, halving down from ``initial``.

    ``preflight_at(size) -> Decision`` runs the admission check at a
    candidate size (count the call's bytes at that chunk length, tile
    height or batch width and :func:`preflight` them).  Each rejection
    records a ``chunk-shrunk`` event and halves (``halve(size)`` when
    given, else integer halving).  A ``floor``-size call still over the
    budget raises :class:`AdmissionError`: the budget says it can never
    fit, and a structured refusal beats an out-of-memory error mid-solve.
    """
    size = initial
    while True:
        decision = preflight_at(size)
        if decision.admitted:
            return size
        if size <= floor:
            raise AdmissionError(
                f"{op}: floor size {size} still over budget "
                f"({decision.detail})")
        smaller = max(floor, halve(size) if halve is not None else size // 2)
        if smaller >= size:
            raise AdmissionError(
                f"{op}: cannot shrink below {size} ({decision.detail})")
        metrics.counter("admission.chunk_shrunk").inc()
        record_event("chunk-shrunk", op=op, from_size=size, to_size=smaller,
                     reason="admission-preflight")
        size = smaller


def admit_batch(op: str, requested: int, preflight_at,
                floor: int = 1) -> int:
    """Batch-width admission for the serving layer: the largest batch
    (at most ``requested``) whose stacked solve preflights within the
    budget, the :func:`admit_chunk` loop with the size knob meaning
    "requests a batch".  Requests beyond the admitted width stay queued
    for the next batch: each lane is an independent solve, so a batch can
    always shrink to 1 without changing a result, and only a
    single-request batch over the budget raises :class:`AdmissionError`.
    The server caches the verdicts per (op, shape class, rung, width)."""
    return admit_chunk(op, requested, preflight_at, floor=floor)
