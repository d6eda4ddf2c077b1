"""Host golden models (numpy) — the "embedded golden model" half of the
reference's dual-implementation testing strategy.

Counterpart of ``cme213_tpu/verify/golden.py``; the ported slices carry the
heat golden (``cpuComputation``, ``hw/hw2/programming/2dHeat.cu:361-428``)
and the segmented-scan goldens (the OpenMP CPU golden of
``hw/hw_final/programming/fp.cu:130-152``).  The other goldens come with the
slices that need them.
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


def host_segmented_scan(values: np.ndarray,
                        seg_starts: np.ndarray) -> np.ndarray:
    """Inclusive segmented sum scan; one serial cumsum per segment
    (fp.cu:130-152 CPU golden)."""
    out = np.empty_like(values)
    n = values.shape[0]
    p = seg_starts.shape[0]
    for si in range(p):
        lo = seg_starts[si]
        hi = seg_starts[si + 1] if si + 1 < p else n
        out[lo:hi] = np.cumsum(values[lo:hi], dtype=values.dtype)
    return out


def host_spmv_scan(a: np.ndarray, seg_starts: np.ndarray, xx: np.ndarray,
                   iters: int, dtype=None) -> np.ndarray:
    """Iterated multiply + segmented scan, ``a ← segscan(a·xx)`` N times
    (fp.cu:130-152; the double-precision external checker
    ``aux/reference_spMVscan-released.cu:65-144``)."""
    if dtype is not None:
        a = a.astype(dtype)
        xx = xx.astype(dtype)
    a = np.array(a, copy=True)
    for _ in range(iters):
        a = host_segmented_scan(a * xx, seg_starts)
    return a
