"""``spmv.outside_run_pct``: share of the solves' wall time outside the
program's ``spmv_scan.run`` spans (``run_spmv_scan``'s validation,
upload, gate and download), from the spans' own durations."""


def read(run):
    spans = run.spans.get("spmv_scan.run", [])
    total = sum(run.latencies_s)
    if not spans or total <= 0:
        return None
    inside = sum(ms for _, _, ms in spans) / 1e3
    return 100.0 * (1.0 - inside / total)
