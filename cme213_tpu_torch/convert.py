"""Carry the JAX package's state across to the port.

No workload has weights.  The heat solve's state is the parameters and the
halo grid; the SpMV-scan engine's is its ``Problem`` (values, segment
starts, gather indices, x, iterations).  Everything crosses as plain data,
so the port never imports the JAX package: the parameters as the dict of a
``cme213_tpu.config.SimParams``'s init fields, arrays as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .apps.spmv_scan import Problem
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


def problem_from_reference(a, s, k, x, iters: int) -> Problem:
    """The port's SpMV-scan ``Problem`` from the arrays of a reference
    ``cme213_tpu.apps.spmv_scan.Problem`` (``prob.a, prob.s, prob.k,
    prob.x, prob.iters``): copies with the same dtypes and values,
    validated like a loaded problem."""
    prob = Problem(*(np.array(v, copy=True) for v in (a, s, k, x)),
                   int(iters))
    prob.validate()
    return prob
