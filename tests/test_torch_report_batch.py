"""The port's evidence report (``bench/report.py``) and batch runner
(``bench/batch.py``), against the JAX package's where they share code.

Ports ``tests/test_report.py`` over the artifacts the port writes (the
headline lines, the sweep CSVs, ``regress.json``, the batch summaries;
the TPU-only sections are gone) and ``tests/test_batch.py``; every job
file of both packages parses to the reference's spec and lists the same
points under ``--dry-run``.
"""

import glob
import json
import os

import pytest

from cme213_tpu.bench import batch as jbatch
from cme213_tpu_torch.bench.batch import JobSpec, main, parse_job, run_job
from cme213_tpu_torch.bench.report import generate
from cme213_tpu_torch.bench.report import main as report_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_FILES = sorted(glob.glob(os.path.join(REPO, "jobs", "*.job"))
                   + glob.glob(os.path.join(REPO, "cme213_tpu_torch", "jobs",
                                            "*.job")))
PORT_JOBS = ("spmv_scaling", "heat_kernels")


# ------------------------------------------------------------ the report

def _fixture(tmp_path):
    d = tmp_path / "results"
    (d / "jobs").mkdir(parents=True)
    (d / "heat_kernels.csv").write_text(
        "size,order,kernel,gbs,pct_peak\n4000,8,pipeline-k1,2296.5,68.55\n")
    (d / "spmv_pallas_coverage.csv").write_text(
        "name,mode,ok\npwtk,compiled,True\n")
    (d / "jobs" / "spmv_scaling.jobs.csv").write_text(
        "point,OMP_NUM_THREADS,rc,seconds\n0,1,0,9.1\n")
    (d / "bench_f32.json").write_text("noise\n" + json.dumps({
        "metric": "heat2d stencil order-8 4000x4000 f32 effective "
                  "bandwidth", "value": 2609.04, "unit": "GB/s",
        "vs_baseline": 108.85, "pct_hbm_peak": 77.9, "bound": "memory",
        "device_kind": "NVIDIA H100 80GB HBM3",
        "kernels": [{"kernel": "pipeline-k2", "ok": True, "gbs": 2609.04}],
    }) + "\n")
    (d / "regress.json").write_text(json.dumps({
        "verdict": "fail", "threshold": 0.1,
        "regressions": [{"file": "heat_kernels.csv", "row": "k=1",
                         "metric": "gbs", "baseline": 2296.5,
                         "fresh": 1800.0, "ratio": 0.7838}]}))
    return d


def test_generate_covers_all_artifacts(tmp_path):
    doc = generate(str(_fixture(tmp_path)))
    assert "## Headline bench (f32)" in doc
    assert "108.85× the GTX-580 baseline, 77.9% of HBM peak, " \
           "memory-bound" in doc
    assert "- **device**: NVIDIA H100 80GB HBM3" in doc
    assert "| kernel | ok | gbs |" in doc
    assert "### heat_kernels.csv" in doc
    assert "| 4000 | 8 | pipeline-k1 | 2296.5 | 68.55 |" in doc
    assert "`mode=plain` rows" in doc
    assert "### spmv_scaling.jobs.csv" in doc
    assert "## Regression gate" in doc and "**verdict**: fail" in doc
    assert "| heat_kernels.csv | k=1 | gbs |" in doc
    for tpu_only in ("tranche", "smoke", "Pallas", "interpret"):
        assert tpu_only not in doc


def test_missing_artifacts_are_skipped(tmp_path):
    d = tmp_path / "empty"
    d.mkdir()
    doc = generate(str(d))
    assert "Headline bench" not in doc
    assert "Sweeps" not in doc and "Regression gate" not in doc
    assert generate(str(tmp_path / "absent")).startswith(
        "# Measurement data")


def test_main_writes_file(tmp_path, capsys):
    d = _fixture(tmp_path)
    out = tmp_path / "DATA.md"
    assert report_main(["--dir", str(d), "--out", str(out)]) == 0
    assert out.read_text().startswith("# Measurement data")
    assert f"{out}:" in capsys.readouterr().out


def test_defaults_are_the_port_s_own(tmp_path, monkeypatch):
    """With no arguments the report reads and writes
    ``bench_results_torch/``, never the JAX package's ``docs/DATA.md``."""
    monkeypatch.chdir(tmp_path)
    assert report_main([]) == 0
    assert (tmp_path / "bench_results_torch" / "DATA.md").is_file()
    assert not (tmp_path / "docs").exists()


# --------------------------------------------------------------- batch

def _write(tmp_path, text, name="j.job"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_parse_directives(tmp_path):
    path = _write(tmp_path, (
        "#CME name=myjob\n"
        "#CME out=some/dir\n"
        "#CME timeout=12.5\n"
        "#CME sweep A=1,2\n"
        "#CME sweep B=x,y,z\n"
        "echo hello\n"))
    spec = parse_job(path)
    assert spec.name == "myjob"
    assert spec.out == "some/dir"
    assert spec.timeout == 12.5
    assert spec.sweeps == [("A", ["1", "2"]), ("B", ["x", "y", "z"])]
    assert spec.body == "echo hello\n"
    assert spec == JobSpec(**vars(jbatch.parse_job(path)))


def test_points_cartesian_last_axis_fastest():
    spec = JobSpec(name="j", sweeps=[("A", ["1", "2"]), ("B", ["x", "y"])],
                   body="true\n")
    assert spec.points() == [
        {"A": "1", "B": "x"}, {"A": "1", "B": "y"},
        {"A": "2", "B": "x"}, {"A": "2", "B": "y"},
    ]


def test_parse_rejects_bad_directives(tmp_path):
    with pytest.raises(ValueError, match="unknown directive"):
        parse_job(_write(tmp_path, "#CME nodes=2\ntrue\n"))
    with pytest.raises(ValueError, match="bad sweep"):
        parse_job(_write(tmp_path, "#CME sweep =1,2\ntrue\n"))
    with pytest.raises(ValueError, match="unparseable"):
        parse_job(_write(tmp_path, "#CME whatever\ntrue\n"))
    with pytest.raises(ValueError, match="body is empty"):
        parse_job(_write(tmp_path, "#CME name=x\n"))


def test_run_captures_o_e_and_summary(tmp_path):
    out = tmp_path / "logs"
    spec = JobSpec(name="cap", out=str(out), timeout=60,
                   sweeps=[("MYVAR", ["7", "8"])],
                   body="echo val=$MYVAR\necho err=$MYVAR >&2\n")
    rows = run_job(spec)
    assert [r["rc"] for r in rows] == [0, 0]
    assert (out / "cap.o0").read_text() == "val=7\n"
    assert (out / "cap.o1").read_text() == "val=8\n"
    assert (out / "cap.e1").read_text() == "err=8\n"
    summary = (out / "cap.jobs.csv").read_text().splitlines()
    assert summary[0] == "point,MYVAR,rc,seconds"
    assert summary[1].startswith("0,7,0,")


def test_failing_point_recorded_and_exit_nonzero(tmp_path):
    jobfile = _write(tmp_path, (
        "#CME out={out}\n"
        "#CME sweep N=0,3\n"
        "exit $N\n").format(out=tmp_path / "logs"))
    assert main([jobfile]) == 1
    assert [r["rc"] for r in run_job(parse_job(jobfile))] == [0, 3]


def test_timeout_kills_the_point(tmp_path):
    spec = JobSpec(name="slow", out=str(tmp_path / "logs"), timeout=0.5,
                   body="sleep 30\n")
    rows = run_job(spec)
    assert rows[0]["rc"] == 124 and rows[0]["seconds"] < 10


def test_dry_run_writes_nothing(tmp_path, capsys):
    out = tmp_path / "logs"
    jobfile = _write(tmp_path, (
        f"#CME out={out}\n"
        "#CME sweep A=1,2\n"
        "echo run\n"))
    assert main([jobfile, "--dry-run"]) == 0
    assert not out.exists()
    text = capsys.readouterr().out
    assert "A=1" in text and "A=2" in text


@pytest.mark.parametrize("path", JOB_FILES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_job_files_parse_to_the_reference_s_points(path, capsys):
    spec, ref = parse_job(path), jbatch.parse_job(path)
    assert vars(spec) == vars(ref)
    assert spec.points() == ref.points() and spec.sweeps
    assert main([path, "--dry-run"]) == 0
    ours = capsys.readouterr().out
    assert jbatch.main([path, "--dry-run"]) == 0
    assert ours == capsys.readouterr().out
    assert ours.count("\n") == len(spec.points())


@pytest.mark.parametrize("name", PORT_JOBS)
def test_port_job_files_run_the_port(name):
    """The port's job files write into the port's results, run the port's
    package, read no JAX platform, and keep their work in a scratch
    directory."""
    spec = parse_job(os.path.join(REPO, "cme213_tpu_torch", "jobs",
                                  f"{name}.job"))
    assert spec.name == name
    assert spec.out == "bench_results_torch/jobs"
    assert "python -m cme213_tpu_torch " in spec.body
    assert "python -m cme213_tpu " not in spec.body
    assert "JAX_PLATFORMS" not in spec.body
    assert 'WORK=$(mktemp -d)' in spec.body and 'cd "$WORK"' in spec.body
    assert "${DEVICE:+--device=$DEVICE}" in spec.body


def test_port_sweeps_match_the_reference_campaigns():
    ours = parse_job(os.path.join(REPO, "cme213_tpu_torch", "jobs",
                                  "spmv_scaling.job"))
    ref = parse_job(os.path.join(REPO, "jobs", "spmv_scaling.job"))
    assert ours.sweeps == ref.sweeps
    assert "gen a.txt x.txt 200000 3000 50000 10" in ours.body
    assert "cpu_check" in ours.body
    heat = parse_job(os.path.join(REPO, "cme213_tpu_torch", "jobs",
                                  "heat_kernels.job"))
    assert heat.sweeps == [("LOCAL_KERNEL", ["xla", "pallas"])]


def test_run_job_on_a_tiny_port_job(tmp_path):
    """A job body that runs the port's SpMV-scan CLI on the CPU, swept over
    two kernels (one process a point)."""
    from cme213_tpu_torch.apps import spmv_scan

    spmv_scan.save_problem(spmv_scan.generate_problem(4096, 64, 63, iters=4),
                           str(tmp_path / "a.txt"), str(tmp_path / "x.txt"))
    out = tmp_path / "logs"
    jobfile = _write(tmp_path, (
        f"#CME name=tiny\n#CME out={out}\n#CME timeout=300\n"
        "#CME sweep KERNEL=flat,pallas-fused\n"
        f"export PYTHONPATH={REPO}\n"
        f"cd {tmp_path}\n"
        "python -m cme213_tpu_torch spmv_scan a.txt x.txt cpu_check "
        "--kernel=$KERNEL --device=cpu\n"))
    rows = run_job(parse_job(jobfile))
    assert [(r["KERNEL"], r["rc"]) for r in rows] == [
        ("flat", 0), ("pallas-fused", 0)]
    for i in range(2):
        text = (out / f"tiny.o{i}").read_text()
        assert "Worked!" in text and "running time" in text
    assert (out / "tiny.jobs.csv").read_text().startswith(
        "point,KERNEL,rc,seconds")
