"""The sweep harness: counterpart of ``cme213_tpu/bench`` (``sweeps.py``,
``run_all.py``, ``regress.py``, ``report.py``, ``batch.py``,
``transport_sweep.py``)."""

from .sweeps import (
    cipher_vector_length_sweep,
    dist_heat_compile_coverage,
    dist_heat_sweep,
    heat_kernel_sweep,
    heat_sweep,
    pagerank_avg_edges_sweep,
    pallas_tile_sweep,
    pipeline_tune_sweep,
    scan_sweep,
    sort_sweep,
    sort_thread_sweep,
    spmv_pallas_coverage,
    spmv_scan_sweep,
    spmv_suite_sweep,
    transfer_bandwidth_sweep,
    write_csv,
)

#: where the port's harness writes and its gate and report read (the JAX
#: package's own evidence lives in ``bench_results/``)
RESULTS_DIR = "bench_results_torch"

__all__ = [
    "RESULTS_DIR",
    "cipher_vector_length_sweep",
    "dist_heat_compile_coverage",
    "dist_heat_sweep",
    "heat_kernel_sweep",
    "heat_sweep",
    "pagerank_avg_edges_sweep",
    "pallas_tile_sweep",
    "pipeline_tune_sweep",
    "scan_sweep",
    "sort_sweep",
    "sort_thread_sweep",
    "spmv_pallas_coverage",
    "spmv_scan_sweep",
    "spmv_suite_sweep",
    "transfer_bandwidth_sweep",
    "write_csv",
]
