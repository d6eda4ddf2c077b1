import atexit

from ..core import metrics  # its exit snapshot registers first
from .elementwise import (parallel_sum, saxpy, shift_cipher,
                          shift_cipher_packed, vigenere_shift,
                          vigenere_unshift)
from .gather import csr_row_ids, pagerank_iterate, pagerank_propagate
from .histogram import histogram_onehot, histogram_segment, histogram_sort
from .scan import blocked_inclusive_scan, exclusive_scan, inclusive_scan
from .segmented import (BLOCKED_SCAN_THRESHOLD, DEFAULT_SCAN_BLOCK,
                        head_flags_from_starts, scan_threshold,
                        segment_ids_from_starts, segmented_scan,
                        segmented_scan_blocked, segmented_scan_dense,
                        segmented_scan_flat, segmented_scan_from_starts,
                        validate_segments)
from .segmented_pallas import LAUNCHES as SEGSCAN_LAUNCHES
from .segmented_pallas import (segmented_scan_pallas,
                               segmented_scan_pallas_plain, spmv_scan_pallas,
                               spmv_scan_pallas_plain)
from .stencil import (BORDER_FOR_ORDER, STENCIL_COEFFS, flops_per_point,
                      heat_step, run_heat, run_heat_conv, run_heat_roll,
                      stencil_interior, stencil_interior_conv)
from .stencil_pipeline import (LAUNCHES, pick_pipeline_tile,
                               run_heat_pipeline, run_heat_pipeline2d,
                               run_heat_pipeline_plain,
                               stencil_local_multistep,
                               stencil_local_multistep_plain,
                               stencil_local_multistep_shards,
                               stencil_local_multistep_shards_plain)
from .sort import bitonic_sort, radix_sort, sort, sort_pairs
from .spmv import csr_spmv, csr_to_ell, ell_spmv
from .transpose import transpose_pallas, transpose_xla

__all__ = [
    "BLOCKED_SCAN_THRESHOLD",
    "BORDER_FOR_ORDER",
    "DEFAULT_SCAN_BLOCK",
    "LAUNCHES",
    "SEGSCAN_LAUNCHES",
    "STENCIL_COEFFS",
    "bitonic_sort",
    "blocked_inclusive_scan",
    "csr_row_ids",
    "csr_spmv",
    "csr_to_ell",
    "ell_spmv",
    "exclusive_scan",
    "flops_per_point",
    "head_flags_from_starts",
    "heat_step",
    "histogram_onehot",
    "histogram_segment",
    "histogram_sort",
    "inclusive_scan",
    "pagerank_iterate",
    "pagerank_propagate",
    "parallel_sum",
    "pick_pipeline_tile",
    "radix_sort",
    "run_heat",
    "run_heat_conv",
    "run_heat_pipeline",
    "run_heat_pipeline2d",
    "run_heat_pipeline_plain",
    "run_heat_roll",
    "saxpy",
    "scan_threshold",
    "segment_ids_from_starts",
    "segmented_scan",
    "segmented_scan_blocked",
    "segmented_scan_dense",
    "segmented_scan_flat",
    "segmented_scan_from_starts",
    "segmented_scan_pallas",
    "segmented_scan_pallas_plain",
    "shift_cipher",
    "shift_cipher_packed",
    "sort",
    "sort_pairs",
    "spmv_scan_pallas",
    "spmv_scan_pallas_plain",
    "stencil_interior",
    "stencil_interior_conv",
    "stencil_local_multistep",
    "stencil_local_multistep_plain",
    "stencil_local_multistep_shards",
    "stencil_local_multistep_shards_plain",
    "transpose_pallas",
    "transpose_xla",
    "validate_segments",
    "vigenere_shift",
    "vigenere_unshift",
]


def _record_launches() -> None:
    """At exit, add the process's kernel launches to the metrics registry
    as ``kernel.launches.<kernel>`` counters, the heat solves' calls of
    the C launch loop as ``kernel.launch_loops.<entry>``, and the plain
    torch segmented scans by form as ``kernel.scans.<form>``, so the final
    ``metrics-snapshot`` of a traced run names the kernels it launched.
    Registered after ``core/metrics`` registered its exit snapshot, so it
    runs first; a process that launched nothing adds nothing."""
    from . import (segmented, segmented_pallas, stencil_pallas,
                   stencil_pipeline, transpose)

    for counts in (stencil_pipeline.LAUNCHES, segmented_pallas.LAUNCHES,
                   segmented_pallas.PULL_LAUNCHES, stencil_pallas.LAUNCHES,
                   transpose.LAUNCHES):
        for name, n in counts.items():
            if n:
                metrics.counter(f"kernel.launches.{name}").inc(n)
    for name, n in stencil_pipeline.LAUNCH_LOOPS.items():
        if n:
            metrics.counter(f"kernel.launch_loops.{name}").inc(n)
    for name, n in segmented.SCANS.items():
        if n:
            metrics.counter(f"kernel.scans.{name}").inc(n)


atexit.register(_record_launches)
