"""Op-level error barriers.

Counterpart of ``cme213_tpu/core/errors.py``.  CUDA work is asynchronous, so
a fault inside a kernel shows up at the next synchronisation; ``check_op``
forces it at a named point so the failure carries the op's name, like the
reference's ``check_launch(name)``.
"""

from __future__ import annotations

import torch


class FrameworkError(RuntimeError):
    """A named op failed (a kernel build, a launch, or a device fault)."""


class DataValidationError(FrameworkError):
    """External input data failed an invariant check at ingestion."""


def check_op(name: str, *tensors):
    """Synchronise the devices of ``tensors``; re-raise a CUDA error as a
    ``FrameworkError`` naming ``name``.

    Returns the tensors (a single tensor unwrapped) so it can be used
    inline: ``out = check_op("heat.pipeline", run_heat_pipeline(...))``.
    """
    try:
        for t in tensors:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
    except RuntimeError as e:  # torch raises CUDA faults as RuntimeError
        raise FrameworkError(f"error in {name}: {e}") from e
    return tensors[0] if len(tensors) == 1 else tensors
