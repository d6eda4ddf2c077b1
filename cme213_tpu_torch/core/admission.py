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
- :func:`admit`: a call's device footprint against the budget.  Torch has
  no ``memory_analysis()``, so the footprint is the caller's own count
  (argument + output + workspace bytes); an over-budget call raises
  :class:`AdmissionError` with an ``admission-rejected`` event, before any
  allocation.  The heat ladder admits its grid and two ping-pong buffers
  (``ops/stencil_pipeline.run_heat_resilient``).

The JAX package's ``preflight`` (a footprint measured from one run),
``admit_chunk`` and ``admit_batch`` (halve a size knob until it fits) wait
for the solvers that shrink a chunk or a batch (ROADMAP.md, queue A,
items 3 and 7).  ``oom:<op>`` fault clauses raise a synthetic
RESOURCE_EXHAUSTED, to which the heat ladder responds by halving its tile
(``core/resilience.classify_failure`` buckets it as RESOURCE).
"""

from __future__ import annotations

import os

from . import metrics
from .errors import FrameworkError
from .trace import record_event

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


def admit(op: str, required_bytes: int, device=None) -> None:
    """Hold ``op``'s device footprint, ``required_bytes`` by the caller's
    own count, to ``memory_budget(device)``.  Over the budget it records
    ``admission-rejected``, bumps ``admission.rejected`` and raises
    :class:`AdmissionError`; with no budget it admits (admission must never
    turn a healthy call away on missing information)."""
    budget = memory_budget(device)
    if budget is None or required_bytes <= budget:
        return
    metrics.counter("admission.rejected").inc()
    detail = f"footprint {required_bytes} > budget {budget}"
    record_event("admission-rejected", op=op, requested_bytes=required_bytes,
                 budget_bytes=budget, detail=detail)
    raise AdmissionError(f"{op}: {detail} ({BUDGET_ENV} or the device's "
                         f"memory)")
