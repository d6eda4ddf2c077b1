"""The yardstick's counts and peaks, frozen here so that a change to the
program cannot move them.

Copied from the program's roofline table and cost functions at the time
the benchmark was written (``core/roofline.py``: ``PEAKS["h100-sxm"]``,
``heat_cost``, ``spmv_scan_cost``; ``ops/stencil.flops_per_point``),
except ``spmv_scan_bytes``, which counts what the inputs need and not the
program's own per-iteration traffic.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, the data sheet's dense rates at 700 W: HBM3 bytes a
#: second and float32 operations a second outside the tensor cores
PEAK_BYTES_PER_S = 3350e9
PEAK_F32_FLOPS_PER_S = 67e12

#: order -> taps of the 1-D second-derivative stencil
TAPS = {2: 3, 4: 5, 8: 9}


def stencil_flops_per_point(order: int) -> int:
    """Operations a grid point a step: a multiply per tap and an add per
    accumulation on each axis, then two multiplies and two adds to
    combine (order 8: 38, the hw2 report's count)."""
    taps = TAPS[order]
    return 2 * taps + 2 * (taps - 1) + 4


def heat_bytes(ny: int, nx: int, elem: int = 4) -> int:
    """Bytes of one pass over the grid: the interior read once and written
    once."""
    return 2 * elem * ny * nx


def heat_flops(ny: int, nx: int, order: int, steps: int) -> int:
    return stencil_flops_per_point(order) * ny * nx * steps


def spmv_scan_bytes(n: int, p: int, q: int, elem: int = 4) -> int:
    """Bytes one solve's inputs need: the values ``a`` and ``x`` (``elem``
    bytes each) and the int32 ``k`` and ``p + 1`` segment starts read
    once, ``a`` written once.  A segment's iterations depend on that
    segment alone, so a kernel may keep it on chip through all of them:
    neither the iterations nor a representation of the program's own
    (head flags, ``x[k]`` gathered) add bytes."""
    return elem * (2 * n + q) + 4 * (n + p + 1)


def spmv_scan_flops(n: int, iters: int) -> int:
    """A multiply and a scan add an element an iteration."""
    return 2 * n * iters


def least_seconds(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the chip could take, and which bound sets it."""
    t_mem = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS_PER_S
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")
