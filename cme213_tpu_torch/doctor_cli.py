"""Device-health doctor CLI: ``python -m cme213_tpu_torch doctor``.

Counterpart of ``cme213_tpu/doctor_cli.py``, the runnable face of
``core/diag.py``:

- ``doctor [--json] [--timeout S] [--device=cpu]`` runs the staged health
  ladder (enumerate → memory → timed liveness) on the card and exits 0
  when it is healthy, 1 when any required stage failed or timed out.  With
  no card and no ``--device=cpu`` the report is unhealthy: the CPU is
  probed only when asked for.  ``--json`` prints the structured report;
  the text form prints one line per stage.  When ``CME213_DIAG_DIR`` is
  set the report is also appended to the persistent health-history ring.

- ``doctor calibrate [--json] [--device=cpu]`` runs the
  predicted-vs-measured attribution table for the flagship ops (spmv_scan
  and heat, a torch rung and a kernel rung each) on the card: the
  ``core/roofline.py`` cost model each bench row is graded with, against
  what the rung stages (a kernel's launch plan) or counts
  (``FlopCounterMode``).  Report-only (exit 0): drift is a diagnosis; the
  dispatch-time check (``CME213_DIAG_ATTRIBUTION``) turns it into
  ``attribution-mismatch`` events.
"""

from __future__ import annotations

import argparse
import json
import sys


def _render_health(report: dict, out) -> None:
    verdict = "HEALTHY" if report["healthy"] else "UNHEALTHY"
    out.write(f"doctor: device {verdict} "
              f"(platform {report.get('platform')}, "
              f"{report.get('device_count')} device(s))\n")
    for st in report["stages"]:
        status = "ok" if st["ok"] else (
            "TIMEOUT" if st.get("timed_out") else "FAIL")
        line = f"  {st['stage']:<10} {status:<8} {st['ms']:>9.2f} ms"
        if not st["ok"]:
            line += f"  {st.get('detail')}"
        elif st["stage"] == "liveness":
            line += f"  probe {(st['detail'] or {}).get('probe_ms')} ms"
        elif st["stage"] == "enumerate":
            kinds = sorted({d["kind"] for d in st["detail"]["devices"]})
            line += f"  {', '.join(kinds)}"
        out.write(line + "\n")
    if report.get("ring_path"):
        out.write(f"  history ring: {report['ring_path']}\n")


def _render_calibration(rows: list, out) -> None:
    out.write(f"calibration: {len(rows)} program(s) (roofline model vs "
              f"launch plan / FlopCounterMode)\n")
    out.write(f"  {'op.rung [shape]':<34} {'metric':<7} {'predicted':>12} "
              f"{'measured':>12} {'ratio':>7}  verdict\n")
    for r in rows:
        label = f"{r.get('op')}.{r.get('rung')} [{r.get('shape_class')}]"
        if "error" in r:
            out.write(f"  {label:<34} probe failed: {r['error']}\n")
            continue
        for metric in ("flops", "bytes"):
            ratio = r.get(f"{metric}_ratio")
            measured = r.get(f"measured_{metric}")
            verdict = ("no signal" if ratio is None
                       else "MISMATCH" if metric in r["mismatches"]
                       else "ok")
            out.write(
                f"  {label:<34} {metric:<7} "
                f"{r[f'predicted_{metric}']:>12.3g} "
                f"{(measured if measured is not None else float('nan')):>12.3g} "
                f"{(ratio if ratio is not None else float('nan')):>7.3g}"
                f"  {verdict}\n")
            label = ""


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    calibrating = bool(argv) and argv[0] == "calibrate"
    if calibrating:
        argv = argv[1:]
    ap = argparse.ArgumentParser(
        prog=("python -m cme213_tpu_torch doctor"
              + (" calibrate" if calibrating else "")),
        description=("roofline cost models vs what each rung stages"
                     if calibrating else
                     "staged device-health ladder (exit 1 when unhealthy)"))
    ap.add_argument("--json", action="store_true",
                    help="print the structured report instead of text")
    if not calibrating:
        ap.add_argument("--timeout", type=float, default=None, metavar="S",
                        help="per-stage watchdog budget in seconds "
                             "(default CME213_DOCTOR_TIMEOUT_S or 30)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .core import diag, flight, trace

    flight.install_from_env()
    if calibrating:
        try:
            rows = diag.calibrate(device=args.device)
        except RuntimeError as e:  # no card and no --device=cpu
            print(f"doctor calibrate: {e}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(rows, indent=2, default=str))
        else:
            _render_calibration(rows, sys.stdout)
        trace.flush_sink()
        return 0

    report = diag.health_report(timeout_s=args.timeout, device=args.device)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        _render_health(report, sys.stdout)
    trace.flush_sink()
    return 0 if report["healthy"] else 1


if __name__ == "__main__":
    sys.exit(main())
