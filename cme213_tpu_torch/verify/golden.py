"""Host golden models (numpy) — the "embedded golden model" half of the
reference's dual-implementation testing strategy.

Counterpart of ``cme213_tpu/verify/golden.py``; this slice carries the heat
golden (``cpuComputation``, ``hw/hw2/programming/2dHeat.cu:361-428``).  The
other goldens come with the slices that need them.
"""

from __future__ import annotations

import numpy as np

from ..ops.stencil import BORDER_FOR_ORDER, STENCIL_COEFFS


def host_heat(u: np.ndarray, iters: int, order: int, xcfl, ycfl) -> np.ndarray:
    """Vectorized numpy heat iteration in the device stencil's expression
    order, every product and sum rounded separately."""
    coeffs = STENCIL_COEFFS[order]
    b = BORDER_FOR_ORDER[order]
    u = np.array(u, copy=True)
    gy, gx = u.shape
    ny, nx = gy - 2 * b, gx - 2 * b
    xcfl = u.dtype.type(xcfl)
    ycfl = u.dtype.type(ycfl)
    for _ in range(iters):
        center = u[b:-b, b:-b]
        accx = np.zeros_like(center)
        accy = np.zeros_like(center)
        for k, c in enumerate(coeffs):
            c = u.dtype.type(c)
            accx = accx + c * u[b:b + ny, k:k + nx]
            accy = accy + c * u[k:k + ny, b:b + nx]
        u[b:-b, b:-b] = center + xcfl * accx + ycfl * accy
    return u
