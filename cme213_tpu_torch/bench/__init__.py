"""The sweep harness: counterpart of ``cme213_tpu/bench`` (``sweeps.py``,
``run_all.py``); ``regress``, ``report``, ``batch`` and ``transport_sweep``
are not ported yet."""

from .sweeps import (
    dist_heat_compile_coverage,
    dist_heat_sweep,
    heat_kernel_sweep,
    heat_sweep,
    pallas_tile_sweep,
    pipeline_tune_sweep,
    scan_sweep,
    spmv_pallas_coverage,
    spmv_scan_sweep,
    transfer_bandwidth_sweep,
    write_csv,
)

__all__ = [
    "dist_heat_compile_coverage",
    "dist_heat_sweep",
    "heat_kernel_sweep",
    "heat_sweep",
    "pallas_tile_sweep",
    "pipeline_tune_sweep",
    "scan_sweep",
    "spmv_pallas_coverage",
    "spmv_scan_sweep",
    "transfer_bandwidth_sweep",
    "write_csv",
]
