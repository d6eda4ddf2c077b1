"""Roofline attribution for the port: cost models and the card's peaks.

Counterpart of ``cme213_tpu/core/roofline.py``, cut to what the heat solve
needs.  The peak table holds NVIDIA's data-sheet figures for the H100
(dense, no sparsity), chosen by ``torch.cuda.get_device_name()``.  They
assume the card's full power limit; a card set below it runs slower, so
every measurement states the limit beside it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.stencil import flops_per_point


def elem_size(dtype) -> int:
    """Element size in bytes for a torch dtype or anything ``np.dtype``
    accepts."""
    itemsize = getattr(dtype, "itemsize", None)  # torch.dtype
    if isinstance(itemsize, int):
        return itemsize
    return int(np.dtype(dtype).itemsize)


@dataclass(frozen=True)
class Cost:
    """Useful-traffic accounting for one op invocation: ``nbytes`` counts
    each input read once and each output written once; ``flops`` counts
    each separately rounded multiply and add once."""

    nbytes: int
    flops: int

    def gbs(self, ms: float) -> float:
        return self.nbytes / 1e9 / (ms / 1e3) if ms > 0 else 0.0

    def gflops(self, ms: float) -> float:
        return self.flops / 1e9 / (ms / 1e3) if ms > 0 else 0.0


@dataclass(frozen=True)
class DevicePeak:
    name: str
    gbs: float      # device-memory bandwidth, GB/s
    gfs_f32: float  # FP32 outside the tensor cores, GF/s (an FMA counts 2)
    gfs_f64: float  # FP64 outside the tensor cores, GF/s (an FMA counts 2)

    def gfs(self, dtype) -> float:
        return self.gfs_f64 if elem_size(dtype) == 8 else self.gfs_f32


#: NVIDIA H100 data sheet: SXM5 (700 W) and PCIe (350 W) parts
PEAKS = {
    "h100-sxm": DevicePeak("h100-sxm", 3350.0, 67_000.0, 34_000.0),
    "h100-pcie": DevicePeak("h100-pcie", 2000.0, 51_000.0, 26_000.0),
}


def peak_for(device_name: str | None) -> DevicePeak | None:
    """Peak entry for a CUDA device name (``torch.cuda.get_device_name``);
    None for a card the table does not hold."""
    name = (device_name or "").lower()
    if "h100" not in name:
        return None
    return PEAKS["h100-pcie" if "pcie" in name else "h100-sxm"]


def detect_device() -> str:
    """Name of CUDA device 0, or ``"cpu"`` where there is none."""
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def bound_ms(cost: Cost, peak: DevicePeak, dtype) -> tuple[float, str]:
    """The least time the card could take for ``cost``, and what bounds it.

    The larger of bytes over the memory rate and operations over the
    arithmetic rate.  ``Cost.flops`` counts separately rounded operations,
    one instruction each (the heat kernel issues no FMA), so the rate is
    half the data sheet's, which counts an FMA as two.
    """
    mem_ms = cost.nbytes / (peak.gbs * 1e9) * 1e3
    ops_ms = cost.flops / (peak.gfs(dtype) / 2 * 1e9) * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def attribute(gbs: float, gflops: float = 0.0,
              device: str | None = None) -> dict:
    """Roofline verdict for an achieved (GB/s, GF/s) pair.

    Returns ``{"device", "peak_gbs", "peak_gfs", "pct_peak", "bound"}``;
    ``pct_peak`` (achieved over peak bandwidth, in percent) is None when
    the card has no peak entry.  ``bound`` is "memory" when the op's share
    of peak bandwidth exceeds its share of peak FP32 rate, else "compute".
    """
    dev = device if device is not None else detect_device()
    pk = peak_for(dev)
    out = {"device": dev, "peak_gbs": pk.gbs if pk else None,
           "peak_gfs": pk.gfs_f32 if pk else None,
           "pct_peak": None, "bound": ""}
    if pk is None or gbs <= 0:
        return out
    mem_frac = gbs / pk.gbs
    comp_frac = gflops / pk.gfs_f32
    out["pct_peak"] = round(100.0 * mem_frac, 2)
    out["bound"] = "compute" if comp_frac > mem_frac else "memory"
    return out


def heat_cost(ny: int, nx: int | None = None, *, order: int, iters: int,
              dtype="float32") -> Cost:
    """hw2 stencil accounting: (1 read + 1 write) × elem × ny×nx per
    iteration; flops from ``ops.stencil.flops_per_point`` (order 8 → the
    reference's 38 flops/point)."""
    nx = ny if nx is None else nx
    elem = elem_size(dtype)
    return Cost(2 * elem * ny * nx * iters,
                flops_per_point(order) * ny * nx * iters)
