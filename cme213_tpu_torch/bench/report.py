"""Render the port's captured measurements into one markdown document.

Counterpart of ``cme213_tpu/bench/report.py``, over what the port writes:
it scans ``bench_results_torch/`` (the headline lines of ``bench.headline``
saved as ``bench_f32.json`` / ``bench_f64.json``, the sweep CSVs of
``bench.run_all`` at the root, the regression gate's ``regress.json``, and
the batch campaigns' summaries under ``jobs/``) and writes one table per
artifact, the headline lines first:

    python -m cme213_tpu_torch.bench.report [--dir bench_results_torch]
        [--out bench_results_torch/DATA.md]

``--out`` never defaults to the JAX package's committed ``docs/DATA.md``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

from . import RESULTS_DIR


def _md_table(rows: list[dict]) -> str:
    rows = [r for r in rows if r]
    if not rows:
        return "(empty)\n"
    # column union across rows, first-seen order: heterogeneous rows (an
    # error row before a measured one) must not hide the measured columns
    cols = list(dict.fromkeys(c for r in rows for c in r))
    out = ["| " + " | ".join(cols) + " |",
           "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(r.get(c, "")) for c in cols) + " |")
    return "\n".join(out) + "\n"


def _read_csv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _bench_section(path: str, label: str) -> list[str]:
    try:
        with open(path) as f:
            # the headline prints ONE JSON line (possibly after other
            # output in a hand-captured file); take the last parseable one
            doc = None
            for line in f:
                line = line.strip()
                if line.startswith("{"):
                    try:
                        doc = json.loads(line)
                    except json.JSONDecodeError:
                        continue
    except OSError:
        return []
    if doc is None:
        return []
    lines = [f"## Headline bench ({label})", ""]
    lines.append(f"- **metric**: {doc.get('metric')}")
    lines.append(f"- **value**: {doc.get('value')} {doc.get('unit')}"
                 f" — {doc.get('vs_baseline')}× the GTX-580 baseline"
                 + (f", {doc.get('pct_hbm_peak')}% of HBM peak"
                    if doc.get("pct_hbm_peak") is not None else "")
                 + (f", {doc.get('bound')}-bound"
                    if doc.get("bound") else ""))
    if doc.get("device_kind"):
        lines.append(f"- **device**: {doc['device_kind']}")
    kernels = doc.get("kernels")
    if kernels:
        lines += ["", _md_table(kernels)]
    lines.append("")
    return lines


def generate(results_dir: str) -> str:
    lines = ["# Measurement data (auto-generated)", "",
             f"Rendered from `{results_dir}/` by "
             "`python -m cme213_tpu_torch.bench.report`.", ""]
    for dtype in ("f32", "f64"):
        lines += _bench_section(
            os.path.join(results_dir, f"bench_{dtype}.json"), dtype)

    sections = [("Sweeps", results_dir),
                ("Batch campaigns", os.path.join(results_dir, "jobs"))]
    for title, d in sections:
        if not os.path.isdir(d):
            continue
        csvs = sorted(f for f in os.listdir(d) if f.endswith(".csv"))
        if not csvs:
            continue
        lines += [f"## {title} (`{os.path.relpath(d)}`)", ""]
        for fname in csvs:
            rows = _read_csv(os.path.join(d, fname))
            lines += [f"### {fname}", ""]
            if "coverage" in fname:
                lines += ["Coverage, not a timing table: `ok` means the "
                          "kernel builds and runs at that shape; "
                          "`mode=plain` rows ran its plain PyTorch "
                          "version on the CPU.", ""]
            lines += [_md_table(rows)]
    # regression-gate verdict (bench/regress.py --json), when banked
    regress = os.path.join(results_dir, "regress.json")
    if os.path.isfile(regress):
        try:
            with open(regress) as f:
                verdict = json.load(f)
        except (OSError, json.JSONDecodeError):
            verdict = None
        if verdict:
            lines += [
                "## Regression gate", "",
                f"- **verdict**: {verdict.get('verdict')} "
                f"(threshold {verdict.get('threshold')})", ""]
            if verdict.get("regressions"):
                lines += [_md_table(verdict["regressions"])]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cme213_tpu_torch.bench.report",
        description="render the port's bench artifacts into markdown")
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "DATA.md"))
    args = ap.parse_args(argv)
    doc = generate(args.dir)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(doc)
    print(f"{args.out}: {len(doc.splitlines())} lines")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
