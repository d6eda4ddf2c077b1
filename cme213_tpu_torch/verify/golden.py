"""Host golden models (numpy) — the "embedded golden model" half of the
reference's dual-implementation testing strategy.

Counterpart of ``cme213_tpu/verify/golden.py``: the shift cipher
(``host_shift_cypher``, ``hw/hw1/programming/cipher.cu:53-60``), PageRank
(``host_graph_propagate/iterate``, ``pagerank.cu:45-67``), the heat stencil
(``cpuComputation``, ``hw/hw2/programming/2dHeat.cu:361-428``), the
segmented scans (the OpenMP CPU golden of
``hw/hw_final/programming/fp.cu:130-152``) and the ``std::sort`` golden of
hw4.
"""

from __future__ import annotations

import numpy as np

from ..ops.stencil import BORDER_FOR_ORDER, STENCIL_COEFFS


def host_shift_cipher(data: np.ndarray, shift: int) -> np.ndarray:
    """Wrapping unsigned-char shift (cipher.cu:53-60)."""
    if data.dtype != np.uint8:
        raise TypeError(f"host_shift_cipher takes uint8, got {data.dtype}")
    return (data + np.uint8(int(shift) % 256)).astype(np.uint8)


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


def host_graph_propagate(indices: np.ndarray, edges: np.ndarray,
                         rank_in: np.ndarray, inv_deg: np.ndarray) -> np.ndarray:
    """One PageRank sweep: CSR gather + ``0.5/n + 0.5·Σ rank·inv_deg``
    (pagerank.cu:45-56) in float32, each row summed by ``np.add.reduceat``
    (the first value plus numpy's pairwise sum of the rest).  Rows are never
    empty (degrees ≥ 1 by construction), so reduceat's empty-slice caveat
    does not apply."""
    n = rank_in.shape[0]
    contrib = (rank_in[edges] * inv_deg[edges]).astype(np.float32)
    sums = np.add.reduceat(contrib, indices[:-1].astype(np.int64))
    return (np.float32(0.5) / np.float32(n)
            + np.float32(0.5) * sums).astype(np.float32)


def host_graph_iterate(indices, edges, rank0, inv_deg, nr_iterations: int):
    """Ping-pong iteration (pagerank.cu:59-67); nr_iterations must be even."""
    if nr_iterations % 2:
        raise ValueError(f"nr_iterations must be even, got {nr_iterations}")
    a = np.array(rank0, copy=True)
    for _ in range(nr_iterations):
        a = host_graph_propagate(indices, edges, a, inv_deg)
    return a


#: segments at least this long are scanned one ``np.cumsum`` each; the
#: shorter ones one position at a time, across all of them at once
LONG_SEGMENT = 4096


def host_segmented_scan(values: np.ndarray,
                        seg_starts: np.ndarray) -> np.ndarray:
    """Inclusive segmented sum scan, serial within each segment
    (fp.cu:130-152 CPU golden): ``out[i] = out[i-1] + values[i]`` in the
    values' dtype, ``np.cumsum``'s order.  Long segments run one cumsum
    each; the others advance together, position j of every segment longer
    than j in one vectorised add, the same additions in the same order, so
    a suite instance with 10^5-10^6 segments takes a few numpy calls a
    position instead of a Python step a segment."""
    out = np.array(values, copy=True)
    n = out.shape[0]
    starts = np.asarray(seg_starts, dtype=np.int64)
    lens = np.diff(np.append(starts, n))
    long = lens >= LONG_SEGMENT
    for lo, ln in zip(starts[long], lens[long]):
        out[lo:lo + ln] = np.cumsum(values[lo:lo + ln], dtype=values.dtype)
    order = np.argsort(-lens[~long], kind="stable")
    short_starts = starts[~long][order]
    short_lens = lens[~long][order]
    for j in range(1, int(short_lens[0]) if short_lens.size else 0):
        live = short_starts[:np.searchsorted(-short_lens, -j, side="left")]
        out[live + j] = out[live + j - 1] + values[live + j]
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


def host_sort(keys: np.ndarray) -> np.ndarray:
    """``std::sort`` golden (mergesort.cpp:167-172, radixsort.cpp:180-186)."""
    return np.sort(keys, kind="stable")
