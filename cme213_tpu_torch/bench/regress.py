"""Bench regression gate: fresh sweep artifacts against banked baselines.

``python -m cme213_tpu_torch.bench.regress [--fresh DIR] [--baseline DIR]
[--threshold F] [--strict] [--json PATH] [--bench JSON] [--history DIR]``
(also reachable as ``python -m cme213_tpu_torch trace regress ...``).

Counterpart of ``cme213_tpu/bench/regress.py``: the same comparisons and
verdict document, with two changes.  The defaults read the port's own
output (``--fresh bench_results_torch``, ``--baseline
bench_results_torch/baseline``), never the JAX package's
``bench_results/``.  And the trajectory check compares a headline line
only with captures of the same ``device_kind``: a capture of another
device, or one that names none (the ``BENCH_r*.json`` TPU captures at the
repo root), is listed under ``skipped`` and never becomes the best prior.
The gate:

- **Sweep CSVs** — for every CSV basename present in both directories,
  rows are matched on their identity columns (everything that is not a
  known metric column) and each shared metric column is compared.
  Higher-is-better metrics (``gbs``, ``gflops``, ``*_gbs``,
  ``radix_elems_per_s``, ``pct_peak``) regress when the fresh value
  drops below ``(1 - threshold) ×`` baseline; lower-is-better ones
  (``ms``, ``seconds``, ``merge_s``, ``cpu_ms``) when it rises above
  ``(1 + threshold) ×``.  A baseline row that measured fine but has no
  signal in the fresh run (error row / zeroed metric) is a regression
  too — a kernel that stopped producing data is the worst kind of slow.
- **metrics.json** — per-sweep row counts from ``bench/run_all.py``'s
  sidecar: a sweep that produced fewer rows than its baseline lost
  coverage.  The sidecar's ``compile.<op>.<class>.ms`` histograms are
  compared too (mean, lower-better); a compile histogram that vanished
  from the fresh run means the program cache served it warm and is
  never flagged.
- **Headline trajectory** — ``--bench`` (a ``bench.headline`` JSON line
  or a capture file whose ``tail`` embeds one) compared against the best
  prior value across ``--history``'s ``BENCH_r*.json`` captures of the
  same ``device_kind``.

Output: human-readable lines plus a machine-readable verdict document
(``--json PATH``, also embedded in the exit semantics): exit 0 when
clean or advisory, 1 under ``--strict`` when any regression was found,
2 on unusable inputs.  Unmatched files/rows are reported but never fail
the gate — quick CI sweeps at toy sizes share no keys with full-size
banked baselines and must stay advisory-clean.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

from . import RESULTS_DIR

#: metric columns where bigger is better
HIGHER_BETTER = {"gbs", "gflops", "h2d_gbs", "d2h_gbs", "char_gbs",
                 "uint_gbs", "uint2_gbs", "achieved_gbs",
                 "radix_elems_per_s", "pct_peak", "mbs", "req_s"}
#: metric columns where smaller is better
LOWER_BETTER = {"ms", "seconds", "merge_s", "cpu_ms"}
#: columns that are neither identity nor comparable signal.  ``bytes``
#: is deliberately NOT here: it is derived from the problem shape, so it
#: serves as identity — keeping a quick toy-size row from matching a
#: full-size banked row that happens to share the visible key columns.
IGNORED = {"error", "rel_l2", "rel_l2_vs_flat", "bound", "evidence", "ok"}

#: default noise threshold (fraction): CPU sweep timings jitter by a few
#: percent run-to-run; 10% is far above noise and still catches the 20%+
#: drops that matter (a 0.61× event is a 39% drop)
DEFAULT_THRESHOLD = 0.1


def _fnum(v) -> float | None:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f


def _read_rows(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _row_key(row: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in row.items()
                        if k not in HIGHER_BETTER and k not in LOWER_BETTER
                        and k not in IGNORED))


def compare_rows(fname: str, fresh: list[dict],
                 base: list[dict], threshold: float) -> dict:
    """Per-file comparison: matched row pairs, regressions, improvements."""
    fresh_by_key = {_row_key(r): r for r in fresh}
    regs, imps, compared, unmatched = [], [], 0, 0
    for brow in base:
        frow = fresh_by_key.get(_row_key(brow))
        if frow is None:
            unmatched += 1
            continue
        key_txt = " ".join(f"{k}={v}" for k, v in _row_key(brow))
        for col in sorted((set(brow) & set(frow))
                          & (HIGHER_BETTER | LOWER_BETTER)):
            bval, fval = _fnum(brow.get(col)), _fnum(frow.get(col))
            if bval is None or bval <= 0:
                continue  # baseline had no signal for this metric
            compared += 1
            entry = {"file": fname, "row": key_txt, "metric": col,
                     "baseline": bval, "fresh": fval}
            if fval is None or fval <= 0:
                # measured before, error/zero now: always a regression
                regs.append({**entry, "ratio": 0.0})
                continue
            ratio = fval / bval
            entry["ratio"] = round(ratio, 4)
            if col in HIGHER_BETTER:
                if ratio < 1 - threshold:
                    regs.append(entry)
                elif ratio > 1 + threshold:
                    imps.append(entry)
            else:
                if ratio > 1 + threshold:
                    regs.append(entry)
                elif ratio < 1 - threshold:
                    imps.append(entry)
    return {"compared": compared, "unmatched_rows": unmatched,
            "regressions": regs, "improvements": imps}


def compare_dirs(fresh_dir: str, baseline_dir: str,
                 threshold: float) -> dict:
    """Compare every shared CSV (plus the metrics.json row counts)."""
    fresh_csvs = {f for f in os.listdir(fresh_dir) if f.endswith(".csv")}
    base_csvs = {f for f in os.listdir(baseline_dir) if f.endswith(".csv")}
    files, regs, imps = {}, [], []
    for fname in sorted(fresh_csvs & base_csvs):
        res = compare_rows(fname,
                           _read_rows(os.path.join(fresh_dir, fname)),
                           _read_rows(os.path.join(baseline_dir, fname)),
                           threshold)
        files[fname] = {"compared": res["compared"],
                        "unmatched_rows": res["unmatched_rows"],
                        "regressions": len(res["regressions"]),
                        "improvements": len(res["improvements"])}
        regs.extend(res["regressions"])
        imps.extend(res["improvements"])

    # metrics.json sidecar: lost sweep coverage is a regression
    for side in ("metrics.json",):
        fp, bp = (os.path.join(fresh_dir, side),
                  os.path.join(baseline_dir, side))
        if not (os.path.exists(fp) and os.path.exists(bp)):
            continue
        try:
            with open(fp) as f:
                fm = json.load(f)
            with open(bp) as f:
                bm = json.load(f)
        except ValueError:
            continue
        for sweep, brec in bm.items():
            brows = brec.get("rows")
            frows = fm.get(sweep, {}).get("rows")
            if not isinstance(brows, (int, float)) or brows <= 0:
                continue
            if not isinstance(frows, (int, float)) or frows < brows:
                regs.append({"file": side, "row": sweep, "metric": "rows",
                             "baseline": brows, "fresh": frows,
                             "ratio": round((frows or 0) / brows, 4)})
            # compile-time histograms (``compile.<op>.<class>.ms`` from
            # the program cache's miss spans): mean is lower-better.  A
            # compile histogram present in the baseline but absent from
            # the fresh run means the program came from a warm cache —
            # that's the win this sidecar exists to verify, never a
            # regression — so only pairs present on both sides compare.
            bhists = brec.get("metrics", {}).get("histograms", {})
            fhists = fm.get(sweep, {}).get("metrics", {}) \
                       .get("histograms", {})
            for hname in sorted(set(bhists) & set(fhists)):
                if not (hname.startswith("compile.")
                        and hname.endswith(".ms")):
                    continue
                bmean = _fnum(bhists[hname].get("mean"))
                fmean = _fnum(fhists[hname].get("mean"))
                if bmean is None or bmean <= 0 or fmean is None:
                    continue
                ratio = fmean / bmean
                entry = {"file": side, "row": sweep, "metric": hname,
                         "baseline": bmean, "fresh": fmean,
                         "ratio": round(ratio, 4)}
                if ratio > 1 + threshold:
                    regs.append(entry)
                elif ratio < 1 - threshold:
                    imps.append(entry)
    return {"files": files,
            "baseline_only": sorted(base_csvs - fresh_csvs),
            "fresh_only": sorted(fresh_csvs - base_csvs),
            "regressions": regs, "improvements": imps}


def _parse_bench_doc(path: str) -> dict | None:
    """A ``bench.py`` JSON output — either the document itself or a
    capture record whose ``tail`` embeds the JSON line."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(doc, dict) and "value" in doc:
        return doc
    for line in reversed(str(doc.get("tail", "")).splitlines()
                         if isinstance(doc, dict) else []):
        line = line.strip()
        if line.startswith("{"):
            try:
                cand = json.loads(line)
            except ValueError:
                continue
            if isinstance(cand, dict) and "value" in cand:
                return cand
    return None


def trajectory_check(bench_path: str, history_dir: str,
                     threshold: float) -> dict:
    """Fresh headline value vs the best prior BENCH_r* capture of the same
    ``device_kind``; captures of another kind, or of none, are listed
    under ``skipped``."""
    fresh = _parse_bench_doc(bench_path) if bench_path else None
    kind = fresh.get("device_kind") if fresh else None
    history, skipped = [], []
    try:
        names = sorted(os.listdir(history_dir))
    except OSError:
        names = []
    for name in names:
        if not (name.startswith("BENCH_r") and name.endswith(".json")):
            continue
        doc = _parse_bench_doc(os.path.join(history_dir, name))
        doc_kind = doc.get("device_kind") if doc else None
        if doc_kind is None or doc_kind != kind:
            skipped.append({"capture": name, "device_kind": doc_kind})
        elif _fnum(doc.get("value")):
            history.append({"capture": name,
                            "value": float(doc["value"])})
    out = {"history": history, "skipped": skipped, "device_kind": kind,
           "fresh": None, "best_prior": None, "ratio": None,
           "regression": False}
    if not history or fresh is None or not _fnum(fresh.get("value")):
        return out
    best = max(history, key=lambda h: h["value"])
    value = float(fresh["value"])
    out.update(fresh=value, best_prior=best,
               ratio=round(value / best["value"], 4),
               regression=value < (1 - threshold) * best["value"])
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cme213_tpu_torch.bench.regress",
        description="compare fresh bench artifacts against banked "
                    "baselines; exit nonzero under --strict on any "
                    "regression beyond the noise threshold")
    ap.add_argument("--fresh", default=RESULTS_DIR,
                    help="directory with the fresh sweep CSVs + "
                         f"metrics.json (default: {RESULTS_DIR})")
    ap.add_argument("--baseline", default=os.path.join(RESULTS_DIR,
                                                       "baseline"),
                    help="banked baseline directory "
                         f"(default: {RESULTS_DIR}/baseline)")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="noise threshold as a fraction "
                         f"(default {DEFAULT_THRESHOLD})")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when any regression is flagged "
                         "(default: report-only)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable verdict here "
                         "('-' for stdout)")
    ap.add_argument("--bench", default=None, metavar="JSON",
                    help="fresh headline bench JSON line (or capture "
                         "file) for the trajectory check")
    ap.add_argument("--history", default=".", metavar="DIR",
                    help="directory holding BENCH_r*.json captures "
                         "(default: .)")
    args = ap.parse_args(argv)

    for d in (args.fresh, args.baseline):
        if not os.path.isdir(d):
            print(f"regress: not a directory: {d}", file=sys.stderr)
            return 2

    verdict = compare_dirs(args.fresh, args.baseline, args.threshold)
    verdict["trajectory"] = trajectory_check(args.bench, args.history,
                                             args.threshold)
    if verdict["trajectory"]["regression"]:
        t = verdict["trajectory"]
        verdict["regressions"].append({
            "file": "BENCH trajectory", "row": t["best_prior"]["capture"],
            "metric": "value", "baseline": t["best_prior"]["value"],
            "fresh": t["fresh"], "ratio": t["ratio"]})
    n_reg = len(verdict["regressions"])
    verdict.update(threshold=args.threshold, strict=args.strict,
                   verdict="fail" if n_reg else "pass")

    compared = sum(f["compared"] for f in verdict["files"].values())
    print(f"regress: {len(verdict['files'])} file(s), {compared} "
          f"metric(s) compared, {n_reg} regression(s), "
          f"{len(verdict['improvements'])} improvement(s) "
          f"[threshold {args.threshold:.0%}]")
    for r in verdict["regressions"]:
        print(f"  REGRESSION {r['file']} [{r['row']}] {r['metric']}: "
              f"{r['baseline']} -> {r['fresh']} ({r['ratio']}x)")
    for r in verdict["improvements"]:
        print(f"  improved   {r['file']} [{r['row']}] {r['metric']}: "
              f"{r['baseline']} -> {r['fresh']} ({r['ratio']}x)")
    if not compared and not n_reg:
        print("  (no overlapping rows — nothing to compare; advisory pass)")

    if args.json == "-":
        json.dump(verdict, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    elif args.json:
        with open(args.json, "w") as f:
            json.dump(verdict, f, indent=2, default=str)

    return 1 if (args.strict and n_reg) else 0


if __name__ == "__main__":
    raise SystemExit(main())
