"""Carry the JAX package's state across to the port.

The heat solve has no weights: its state is the parameters and the halo
grid.  Both cross as plain data, so the port never imports the JAX
package: the parameters as the dict of a ``cme213_tpu.config.SimParams``'s
init fields, the grid as a numpy array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import GridMethod, SimParams
from .core.platform import resolve_device

_INIT_FIELDS = tuple(f.name for f in dataclasses.fields(SimParams) if f.init)


def params_from_reference(fields: dict) -> SimParams:
    """A ``SimParams`` from the reference's init fields (e.g.
    ``{f.name: getattr(p, f.name) for f in dataclasses.fields(p) if
    f.init}``); the derived fields (dt, CFL numbers, extents) are computed
    again by the same formulas."""
    unknown = set(fields) - set(_INIT_FIELDS)
    if unknown:
        raise ValueError(f"not SimParams init fields: {sorted(unknown)}")
    kw = dict(fields)
    if "grid_method" in kw:
        kw["grid_method"] = GridMethod(int(kw["grid_method"]))
    return SimParams(**kw)


def grid_from_reference(u: np.ndarray, device) -> torch.Tensor:
    """The reference's halo grid as a tensor on ``device`` (``None`` means
    ``cuda``), same dtype and values."""
    return torch.from_numpy(np.array(u, copy=True)).to(resolve_device(device))
