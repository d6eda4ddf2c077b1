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

- ``doctor calibrate`` exits 2: the predicted-vs-measured cost
  attribution it runs in the JAX package is not ported yet.
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


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "calibrate":
        print("doctor calibrate: not ported yet (the roofline-vs-measured "
              "cost attribution runs from the program cache, which the "
              "port does not have yet)", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(
        prog="python -m cme213_tpu_torch doctor",
        description="staged device-health ladder (exit 1 when unhealthy)")
    ap.add_argument("--json", action="store_true",
                    help="print the structured report instead of text")
    ap.add_argument("--timeout", type=float, default=None, metavar="S",
                    help="per-stage watchdog budget in seconds "
                         "(default CME213_DOCTOR_TIMEOUT_S or 30)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .core import diag, trace

    report = diag.health_report(timeout_s=args.timeout, device=args.device)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        _render_health(report, sys.stdout)
    trace.flush_sink()
    return 0 if report["healthy"] else 1


if __name__ == "__main__":
    sys.exit(main())
