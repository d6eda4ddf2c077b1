"""Roofline attribution for the port: cost models and the card's peaks.

Counterpart of ``cme213_tpu/core/roofline.py``, cut to what the ported
workloads need (the heat solve, the SpMV-scan engine, the scans, the
transpose and the host transfers of the sweeps).  The peak table holds
NVIDIA's data-sheet figures for the H100
(dense, no sparsity), chosen by ``torch.cuda.get_device_name()``.  They
assume the card's full power limit; a card set below it runs slower, so
every measurement states the limit beside it.
``CME213_DEVICE_PEAKS=name:gbs:gfs[,...]`` overrides or extends the table,
as in the JAX package (an entry's ``gfs`` sets both the f32 and the f64
rate).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..ops.stencil import flops_per_point


_DTYPE_SIZES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2,
                "i32": 4, "u32": 4, "u8": 1, "i8": 1}


def elem_size(dtype) -> int:
    """Element size in bytes for a torch dtype, a short name ("f32") or
    anything ``np.dtype`` accepts."""
    if isinstance(dtype, str) and dtype in _DTYPE_SIZES:
        return _DTYPE_SIZES[dtype]
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


#: override/extend the peak table: ``name:gbs:gfs[,name:gbs:gfs...]``
DEVICE_PEAKS_ENV = "CME213_DEVICE_PEAKS"

#: NVIDIA H100 data sheet: SXM5 (700 W) and PCIe (350 W) parts
PEAKS = {
    "h100-sxm": DevicePeak("h100-sxm", 3350.0, 67_000.0, 34_000.0),
    "h100-pcie": DevicePeak("h100-pcie", 2000.0, 51_000.0, 26_000.0),
}


def normalize(name: str) -> str:
    return str(name).strip().lower().replace(" ", "-").replace("_", "-")


def peaks() -> dict[str, DevicePeak]:
    """The peak table: ``PEAKS`` overlaid with ``CME213_DEVICE_PEAKS``
    entries (malformed entries are ignored: a mistyped variable must not
    take down a bench run)."""
    table = dict(PEAKS)
    for entry in os.environ.get(DEVICE_PEAKS_ENV, "").split(","):
        parts = entry.strip().split(":")
        if len(parts) != 3:
            continue
        key = normalize(parts[0])
        try:
            gbs, gfs = float(parts[1]), float(parts[2])
        except ValueError:
            continue
        table[key] = DevicePeak(key, gbs, gfs, gfs)
    return table


def peak_for(device_name: str | None) -> DevicePeak | None:
    """Peak entry for a CUDA device name (``torch.cuda.get_device_name``):
    the exact normalised name first, then the H100 parts by name; None for
    a card the table does not hold."""
    if not device_name:
        return None
    table = peaks()
    key = normalize(device_name)
    if key in table:
        return table[key]
    if "h100" not in key:
        return None
    return table["h100-pcie" if "pcie" in key else "h100-sxm"]


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

    Returns ``{"device", "peak_gbs", "peak_gfs", "pct_peak", "bound"}``
    with the normalised device name;
    ``pct_peak`` (achieved over peak bandwidth, in percent) is None when
    the card has no peak entry.  ``bound`` is "memory" when the op's share
    of peak bandwidth exceeds its share of peak FP32 rate, else "compute".
    """
    dev = device if device is not None else detect_device()
    pk = peak_for(dev)
    out = {"device": normalize(dev) if dev else "unknown",
           "peak_gbs": pk.gbs if pk else None,
           "peak_gfs": pk.gfs_f32 if pk else None,
           "pct_peak": None, "bound": ""}
    if pk is None or not gbs or gbs <= 0:
        return out
    mem_frac = gbs / pk.gbs
    comp_frac = (gflops / pk.gfs_f32) if (gflops and pk.gfs_f32) else 0.0
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


def spmv_scan_cost(n: int, iters: int, dtype="float32") -> Cost:
    """Single-pass form of the iterated SpMV-scan engine (fp.cu): per
    iteration read the value vector, the gathered ``xx`` vector and the
    int32 head flags, write the value vector — ``(3·elem + 4)·n`` bytes;
    one multiply and one scan add per element."""
    elem = elem_size(dtype)
    return Cost(n * (3 * elem + 4) * iters, 2 * n * iters)


def segmented_scan_cost(n: int, dtype="float32") -> Cost:
    """One segmented scan (the unfused kernel, B6): read the values and the
    int32 head flags, write the values — ``(2·elem + 4)·n`` bytes; one add
    per element."""
    elem = elem_size(dtype)
    return Cost(n * (2 * elem + 4), n)


def scan_cost(n: int, dtype="float32") -> Cost:
    """Single-pass scan family traffic: read and write each element once.
    Multi-sweep forms (the flat log-n scan) are quoted against this same
    useful-byte count, so their extra traffic shows as lost bandwidth."""
    elem = elem_size(dtype)
    return Cost(2 * elem * n, n)


def transpose_cost(rows: int, cols: int, dtype="float32") -> Cost:
    """Transpose of a (rows, cols) matrix: read and write each element
    once; no arithmetic."""
    elem = elem_size(dtype)
    return Cost(2 * elem * rows * cols, 0)


def transfer_cost(nbytes: int) -> Cost:
    """Host↔device copy: the bytes themselves, no flops."""
    return Cost(int(nbytes), 0)
