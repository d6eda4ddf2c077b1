"""The port's bench regression gate (``cme213_tpu_torch/bench/regress.py``)
against the JAX package's.

Ports the regress cases of ``tests/test_perf_observability.py``; on the
same fixture directories both gates must write the same verdict document
(the port's trajectory section adds ``skipped`` and ``device_kind``).  Two
cases are the port's own: a capture of another ``device_kind``, or of
none, is skipped rather than compared, and the repo's ``BENCH_r*.json``
TPU captures never become the best prior of an H100 line.
"""

import csv
import json
import pathlib

import pytest

from cme213_tpu.bench import regress as jregress
from cme213_tpu_torch import trace_cli
from cme213_tpu_torch.bench import regress

ROOT = pathlib.Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def _fixture_dirs(tmp_path, fresh_gbs):
    base_d, fresh_d = tmp_path / "base", tmp_path / "fresh"
    base_d.mkdir()
    fresh_d.mkdir()
    rows = [{"size": 100, "kernel": "xla", "ms": 10.0, "gbs": 50.0,
             "error": ""}]
    _write_csv(base_d / "heat.csv", rows)
    _write_csv(fresh_d / "heat.csv", [{**rows[0], "gbs": fresh_gbs}])
    return str(fresh_d), str(base_d)


def _verdicts(tmp_path, argv):
    """Both gates over the same arguments (and no BENCH history): (rc,
    verdict) of each.  The trajectory sections must agree but for the
    port's two added keys, and are left out of the returned verdicts."""
    if "--history" not in argv:
        argv = [*argv, "--history", str(tmp_path / "no-history")]
    out = []
    for name, mod in (("ours", regress), ("ref", jregress)):
        path = tmp_path / f"{name}.json"
        rc = mod.main([*argv, "--json", str(path)])
        out.append((rc, json.loads(path.read_text())))
    (_, ours), (_, ref) = out
    ours_t, ref_t = ours.pop("trajectory"), ref.pop("trajectory")
    assert {k: v for k, v in ours_t.items()
            if k not in ("skipped", "device_kind")} == ref_t
    return out


def test_regress_strict_fails_on_20pct_gbs_drop(tmp_path, capsys):
    fresh, base = _fixture_dirs(tmp_path, fresh_gbs=40.0)
    assert regress.main(["--fresh", fresh, "--baseline", base,
                         "--strict"]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    assert regress.main(["--fresh", fresh, "--baseline", base]) == 0


def test_regress_passes_within_noise(tmp_path):
    fresh, base = _fixture_dirs(tmp_path, fresh_gbs=47.5)
    assert regress.main(["--fresh", fresh, "--baseline", base,
                         "--strict"]) == 0


def test_regress_lower_better_and_lost_signal(tmp_path):
    base_d, fresh_d = tmp_path / "b", tmp_path / "f"
    base_d.mkdir()
    fresh_d.mkdir()
    _write_csv(base_d / "s.csv", [
        {"op": "a", "ms": 10.0}, {"op": "b", "ms": 10.0}])
    _write_csv(fresh_d / "s.csv", [
        {"op": "a", "ms": 15.0}, {"op": "b", "ms": -1.0}])
    out = tmp_path / "v.json"
    assert regress.main(["--fresh", str(fresh_d), "--baseline", str(base_d),
                         "--strict", "--json", str(out)]) == 1
    verdict = json.loads(out.read_text())
    assert verdict["verdict"] == "fail"
    assert {(r["row"], r["metric"]) for r in verdict["regressions"]} == {
        ("op=a", "ms"), ("op=b", "ms")}


def test_regress_metrics_json_row_counts(tmp_path):
    base_d, fresh_d = tmp_path / "b", tmp_path / "f"
    base_d.mkdir()
    fresh_d.mkdir()
    (base_d / "metrics.json").write_text(json.dumps(
        {"heat_bandwidth": {"rows": 12}, "scan_bandwidth": {"rows": 4}}))
    (fresh_d / "metrics.json").write_text(json.dumps(
        {"heat_bandwidth": {"rows": 9}, "scan_bandwidth": {"rows": 4}}))
    out = tmp_path / "v.json"
    assert regress.main(["--fresh", str(fresh_d), "--baseline", str(base_d),
                         "--strict", "--json", str(out)]) == 1
    verdict = json.loads(out.read_text())
    assert verdict["regressions"][0]["row"] == "heat_bandwidth"
    assert verdict["regressions"][0]["metric"] == "rows"


def test_regress_compile_histograms(tmp_path):
    """A compile histogram that slowed is a regression; one that vanished
    from the fresh run (a warm program cache) never is."""
    base_d, fresh_d = tmp_path / "b", tmp_path / "f"
    base_d.mkdir()
    fresh_d.mkdir()
    hist = {"compile.heat.s.ms": {"mean": 10.0},
            "compile.spmv_scan.s.ms": {"mean": 4.0}}
    (base_d / "metrics.json").write_text(json.dumps(
        {"heat_kernels": {"rows": 3, "metrics": {"histograms": hist}}}))
    (fresh_d / "metrics.json").write_text(json.dumps(
        {"heat_kernels": {"rows": 3, "metrics": {"histograms": {
            "compile.heat.s.ms": {"mean": 15.0}}}}}))
    (ours_rc, ours), (ref_rc, ref) = _verdicts(
        tmp_path, ["--fresh", str(fresh_d), "--baseline", str(base_d),
                   "--strict"])
    assert ours_rc == ref_rc == 1
    assert ours == ref
    assert [r["metric"] for r in ours["regressions"]] == \
        ["compile.heat.s.ms"]


def test_regress_no_overlap_is_advisory_pass(tmp_path, capsys):
    base_d, fresh_d = tmp_path / "b", tmp_path / "f"
    base_d.mkdir()
    fresh_d.mkdir()
    _write_csv(base_d / "x.csv", [{"k": 1, "gbs": 5.0}])
    _write_csv(fresh_d / "y.csv", [{"k": 1, "gbs": 5.0}])
    assert regress.main(["--fresh", str(fresh_d), "--baseline", str(base_d),
                         "--strict"]) == 0
    assert "nothing to compare" in capsys.readouterr().out


@pytest.mark.parametrize("fresh_gbs", [40.0, 47.5, 60.0, -1.0])
def test_verdict_document_equals_reference(tmp_path, fresh_gbs, capsys):
    fresh, base = _fixture_dirs(tmp_path, fresh_gbs=fresh_gbs)
    argv = ["--fresh", fresh, "--baseline", base, "--strict",
            "--history", str(tmp_path / "no-history")]
    (ours_rc, ours), (ref_rc, ref) = _verdicts(tmp_path, argv)
    assert ours_rc == ref_rc
    assert ours == ref
    capsys.readouterr()
    regress.main(argv)
    text = capsys.readouterr().out
    jregress.main(argv)
    assert text == capsys.readouterr().out


def test_banked_sweeps_self_compare(tmp_path):
    """The JAX package's banked CPU sweeps against themselves: both gates
    pass with the same document (read only; the port's defaults never
    point there)."""
    banked = str(ROOT / "bench_results" / "cpu")
    argv = ["--fresh", banked, "--baseline", banked, "--strict",
            "--history", str(tmp_path)]
    (ours_rc, ours), (ref_rc, ref) = _verdicts(tmp_path, argv)
    assert ours_rc == ref_rc == 0
    assert ours == ref and ours["verdict"] == "pass"


def test_defaults_read_the_port_s_results(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert regress.main([]) == 2
    assert "not a directory: bench_results_torch" in capsys.readouterr().err
    (tmp_path / "bench_results_torch" / "baseline").mkdir(parents=True)
    assert regress.main(["--strict"]) == 0


def _capture(path, value, kind=None, tail=False):
    line = {"metric": "heat", "value": value, "unit": "GB/s"}
    if kind is not None:
        line["device_kind"] = kind
    doc = ({"n": 1, "rc": 0, "tail": "noise\n" + json.dumps(line)}
           if tail else line)
    path.write_text(json.dumps(doc))


def test_regress_trajectory_from_bench_captures(tmp_path):
    hist = tmp_path / "hist"
    hist.mkdir()
    _capture(hist / "BENCH_r01.json", 100.0, H100, tail=True)
    _capture(hist / "BENCH_r02.json", 50.0, H100)
    fresh_bench = tmp_path / "bench.json"
    _capture(fresh_bench, 61.0, H100)
    t = regress.trajectory_check(str(fresh_bench), str(hist), 0.1)
    assert t["best_prior"]["value"] == 100.0
    assert t["regression"] is True
    assert t["skipped"] == [] and t["device_kind"] == H100
    ref = jregress.trajectory_check(str(fresh_bench), str(hist), 0.1)
    assert {k: v for k, v in t.items()
            if k not in ("skipped", "device_kind")} == ref
    ok = regress.trajectory_check(str(fresh_bench), str(hist), 0.5)
    assert ok["regression"] is False


def test_trajectory_skips_other_device_kinds(tmp_path):
    """A capture of another device, or one that names none, is listed
    under ``skipped`` and never becomes the best prior."""
    hist = tmp_path / "hist"
    hist.mkdir()
    _capture(hist / "BENCH_r01.json", 5000.0, "NVIDIA H100 PCIe")
    _capture(hist / "BENCH_r02.json", 9000.0)
    _capture(hist / "BENCH_r03.json", 2500.0, H100, tail=True)
    fresh_bench = tmp_path / "bench.json"
    _capture(fresh_bench, 2450.0, H100)
    t = regress.trajectory_check(str(fresh_bench), str(hist), 0.1)
    assert t["history"] == [{"capture": "BENCH_r03.json", "value": 2500.0}]
    assert t["skipped"] == [
        {"capture": "BENCH_r01.json", "device_kind": "NVIDIA H100 PCIe"},
        {"capture": "BENCH_r02.json", "device_kind": None}]
    assert t["best_prior"]["capture"] == "BENCH_r03.json"
    assert t["regression"] is False
    # the reference compares across devices and flags the same line
    assert jregress.trajectory_check(str(fresh_bench), str(hist),
                                     0.1)["regression"] is True
    # a fresh line without a device kind compares with nothing
    _capture(fresh_bench, 1.0)
    t = regress.trajectory_check(str(fresh_bench), str(hist), 0.1)
    assert t["history"] == [] and t["best_prior"] is None
    assert len(t["skipped"]) == 3 and t["regression"] is False


def test_repo_tpu_captures_never_the_best_prior(tmp_path, capsys):
    """The ``BENCH_r*.json`` at the repo root are TPU captures with no
    device kind: an H100 headline line far below every one of them still
    passes, and each of them is listed as skipped."""
    fresh_bench = tmp_path / "bench_f32.json"
    _capture(fresh_bench, 0.5, H100)
    t = regress.trajectory_check(str(fresh_bench), str(ROOT), 0.1)
    captures = sorted(p.name for p in ROOT.glob("BENCH_r*.json"))
    assert captures and [s["capture"] for s in t["skipped"]] == captures
    assert all(s["device_kind"] is None for s in t["skipped"])
    assert t["history"] == [] and t["regression"] is False
    fresh, base = _fixture_dirs(tmp_path, fresh_gbs=50.0)
    out = tmp_path / "v.json"
    assert regress.main(["--fresh", fresh, "--baseline", base, "--strict",
                         "--bench", str(fresh_bench), "--history",
                         str(ROOT), "--json", str(out)]) == 0
    verdict = json.loads(out.read_text())
    assert verdict["verdict"] == "pass"
    assert len(verdict["trajectory"]["skipped"]) == len(captures)


def test_regress_via_trace_cli(tmp_path):
    fresh, base = _fixture_dirs(tmp_path, fresh_gbs=40.0)
    assert trace_cli.main(["regress", "--fresh", fresh, "--baseline", base,
                           "--strict"]) == 1
    assert trace_cli.main(["regress", "--fresh", fresh, "--baseline",
                           base]) == 0
