"""Op-level error barriers.

Counterpart of ``cme213_tpu/core/errors.py``.  CUDA work is asynchronous, so
a fault inside a kernel shows up at the next synchronisation; ``check_op``
forces it at a named point so the failure carries the op's name, like the
reference's ``check_launch(name)``.

A failed barrier emits a structured ``op-failure`` record (op name,
exception class, elapsed ms) through the ``core/trace.py`` event log, and
rejected input data a ``data-validation`` record, before raising.
"""

from __future__ import annotations

import time

import torch

from .trace import record_event


class FrameworkError(RuntimeError):
    """A named op failed (a kernel build, a launch, or a device fault);
    ``.record`` holds the structured trace record where there is one."""

    record: dict | None = None


class KernelError(FrameworkError):
    """A hand-written kernel could not be built (``nvcc``/``ptxas``, a
    missing toolchain) or its launch was refused (a CUDA error code out of
    the C entry).  The resilience ladder re-raises it instead of demoting:
    a rung whose kernel cannot build or launch is a fault of the program,
    not a reason to serve another rung (``core/resilience.with_fallback``).
    """


class DataValidationError(FrameworkError):
    """External input data failed an invariant check at ingestion (corrupt
    or truncated matrix file, inconsistent header, out-of-range indices,
    non-finite values).  ``.record`` holds the structured
    ``data-validation`` record (source, invariant, detail)."""


def data_error(source: str, invariant: str, detail: str) -> DataValidationError:
    """A ``DataValidationError`` with its ``data-validation`` record
    emitted: where, which invariant, what."""
    rec = record_event("data-validation", source=source,
                       invariant=invariant, detail=detail[:300])
    err = DataValidationError(f"{source}: {invariant}: {detail}")
    err.record = rec
    return err


def check_op(name: str, *tensors, timer=None):
    """Synchronise the devices of ``tensors``; re-raise a CUDA error as a
    ``FrameworkError`` naming ``name``.

    Returns the tensors (a single tensor unwrapped) so it can be used
    inline: ``out = check_op("heat.pipeline", run_heat_pipeline(...))``.
    With ``timer`` (a ``PhaseTimer``), the time spent waiting is appended
    to its records under ``name``, on success or failure.  On failure the
    record ``{event: "op-failure", op, error, ms, message}`` is emitted and
    attached to the raised error as ``.record``.
    """
    from .timing import PhaseRecord

    start = time.perf_counter()
    try:
        for t in tensors:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
    except RuntimeError as e:  # torch raises CUDA faults as RuntimeError
        ms = (time.perf_counter() - start) * 1e3
        rec = record_event("op-failure", op=name, error=type(e).__name__,
                           ms=round(ms, 3), message=str(e)[:300])
        if timer is not None:
            timer.records.append(PhaseRecord(name, ms))
        err = FrameworkError(f"error in {name}: {e}")
        err.record = rec
        raise err from e
    if timer is not None:
        timer.records.append(
            PhaseRecord(name, (time.perf_counter() - start) * 1e3))
    return tensors[0] if len(tensors) == 1 else tensors
