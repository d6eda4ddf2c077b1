"""The port's headline bench (``cme213_tpu_torch/bench/headline.py``)
against ``bench.py``, the JAX package's: the parent's aggregation, retry
and short-circuit rules on faked child processes, the children's command
line, the pipeline candidates' one tile, and a child's measurement on the
CPU at a small size.

Where both parents are given the same fake child rows, their JSON lines
agree in ``metric``, ``value``, ``vs_baseline`` and ``kernels`` (the rows
name their platform, ``tpu`` for one and ``cuda`` for the other);
``pct_hbm_peak`` is against the H100's memory peak.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
from cme213_tpu.core import faults as jfaults  # noqa: E402
from cme213_tpu.core import trace as jtrace  # noqa: E402
from cme213_tpu_torch.bench import headline  # noqa: E402
from cme213_tpu_torch.config import SimParams  # noqa: E402
from cme213_tpu_torch.core import faults as tfaults  # noqa: E402
from cme213_tpu_torch.core import roofline  # noqa: E402
from cme213_tpu_torch.core import trace as ttrace  # noqa: E402
from cme213_tpu_torch.core.errors import FrameworkError  # noqa: E402
from cme213_tpu_torch.ops import stencil_pipeline as sp  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
PLATFORM = {bench: "tpu", headline: "cuda"}


class FakeProc:
    def __init__(self, stdout="", returncode=0, stderr=""):
        self.stdout = stdout
        self.returncode = returncode
        self.stderr = stderr


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("CME213_FAULTS", "BENCH_TILE_Y", "BENCH_TILE_X",
                "CME213_BENCH_RETRY_S", "CME213_TRACE_FILE"):
        monkeypatch.delenv(var, raising=False)
    for faults, trace in ((jfaults, jtrace), (tfaults, ttrace)):
        faults.reset()
        trace.clear_events()
    yield
    for faults, trace in ((jfaults, jtrace), (tfaults, ttrace)):
        faults.reset()
        trace.clear_events()


def _row(mod, name, gbs, platform=None, **extra):
    platform = platform or PLATFORM[mod]
    row = {"kernel": name, "ok": True, "iters": 100, "platform": platform,
           "ms_per_iter": 1.0, "gbs": gbs, "gflops": 1.0,
           "pct_peak": round(gbs / 33.5, 2), "bound": "memory", **extra}
    if mod is headline and platform == "cuda":
        row["device_kind"] = H100
    return json.dumps(row)


def _kernel(cmd):
    return next(a.split("=", 1)[1] for a in cmd if a.startswith("--kernel="))


def _run(mod, monkeypatch, capsys, fake, argv=()):
    """Run ``mod``'s parent on faked children; return its JSON line."""
    monkeypatch.setattr(subprocess, "run", fake)
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    rc = mod.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, out


def _comparable(out):
    """The parent's line in the fields both packages share, with each
    row's own platform naming dropped."""
    return {"metric": out["metric"], "value": out["value"],
            "vs_baseline": out["vs_baseline"],
            "kernels": [{k: v for k, v in r.items()
                         if k not in ("platform", "device_kind")}
                        for r in out["kernels"]]}


GBS = {"xla": 14.0, "xla-roll": 100.0, "xla-roll-k8": 120.0,
       "xla-conv": 0.1, "pipeline-k1": 300.0, "pipeline-k2": 500.0,
       "pipeline-k4": 450.0, "pipeline-k8": 400.0, "pipeline2d-k1": 290.0,
       "pipeline2d-k8": 390.0}


def test_best_kernel_selection_matches_reference(monkeypatch, capsys):
    outs = {}
    for mod in (bench, headline):
        def fake(cmd, mod=mod, **kwargs):
            name = _kernel(cmd)
            return FakeProc(stdout=_row(mod, name, GBS[name]) + "\n")

        outs[mod] = _run(mod, monkeypatch, capsys, fake)[1]
    port = outs[headline]
    assert _comparable(port) == _comparable(outs[bench])
    assert "pipeline-k2" in port["metric"] and port["value"] == 500.0
    assert port["vs_baseline"] == round(500.0 / headline.BASELINE_GBS, 3)
    assert headline.BASELINE_GBS == bench.BASELINE_GBS
    assert port["pct_hbm_peak"] == round(100 * 500.0 / 3350.0, 1)
    assert port["pct_hbm_peak"] != round(100 * 500.0 / bench.HBM_PEAK_GBS, 1)
    assert port["device_kind"] == H100 and port["platform"] == "cuda"
    assert len(port["kernels"]) == len(headline.KERNELS)
    assert headline.KERNELS == bench.KERNELS


def test_rows_without_attribution_get_the_card_s(monkeypatch, capsys):
    def fake(cmd, **kwargs):
        row = {"kernel": _kernel(cmd), "ok": True, "platform": "cuda",
               "device_kind": H100, "gbs": 1675.0, "gflops": 1.0,
               "ms_per_iter": 1.0}
        return FakeProc(stdout=json.dumps(row) + "\n")

    out = _run(headline, monkeypatch, capsys, fake)[1]
    assert out["pct_peak"] == 50.0 and out["bound"] == "memory"
    assert out["pct_hbm_peak"] == 50.0


def test_one_faulting_kernel_does_not_poison_others(monkeypatch, capsys):
    outs = {}
    for mod in (bench, headline):
        def fake(cmd, mod=mod, **kwargs):
            name = _kernel(cmd)
            if name == "xla-conv":
                return FakeProc(returncode=1, stderr="kernel fault")
            return FakeProc(stdout=_row(mod, name, 20.0) + "\n")

        outs[mod] = _run(mod, monkeypatch, capsys, fake)[1]
    rows = {r["kernel"]: r for r in outs[headline]["kernels"]}
    assert not rows["xla-conv"]["ok"]
    assert rows["xla-conv"]["error"].startswith("child exit 1")
    assert all(rows[k]["ok"] for k in rows if k != "xla-conv")
    assert outs[headline]["value"] == outs[bench]["value"] == 20.0
    ev = ttrace.events("kernel-failure")
    assert [e["kernel"] for e in ev] == ["xla-conv"]
    assert ev[0]["stage"] == "execute"


def test_a_failed_build_is_its_row_with_its_stage(monkeypatch, capsys):
    """A child whose kernel does not build reports its row; the parent
    keeps the row, records the child's stage, and never retries it."""
    spawned = []

    def fake(cmd, **kwargs):
        name = _kernel(cmd)
        spawned.append(name)
        if name == "pipeline-k4":
            return FakeProc(stdout=json.dumps(
                {"kernel": name, "ok": False, "platform": "cuda",
                 "error": "FrameworkError: nvcc failed on heat_stencil.cu",
                 "kind": "compile", "stage": "compile"}) + "\n")
        return FakeProc(stdout=_row(headline, name, 10.0) + "\n")

    out = _run(headline, monkeypatch, capsys, fake)[1]
    assert spawned.count("pipeline-k4") == 1
    rows = {r["kernel"]: r for r in out["kernels"]}
    assert rows["pipeline-k4"]["stage"] == "compile"
    ev = ttrace.events("kernel-failure")
    assert [(e["kernel"], e["stage"]) for e in ev] == \
        [("pipeline-k4", "compile")]
    assert ttrace.validate_record(ev[0]) == []


def test_dead_device_short_circuits(monkeypatch, capsys):
    """Two consecutive preflight failures skip the remaining kernels; the
    tail carries a doctor report."""
    results = {}
    for mod in (bench, headline):
        calls = []

        def fake(cmd, calls=calls, mod=mod, **kwargs):
            calls.append(cmd)
            return FakeProc(returncode=mod._PREFLIGHT_EXIT)

        import time
        monkeypatch.setattr(time, "sleep", lambda s: None)
        rc, out = _run(mod, monkeypatch, capsys, fake)
        results[mod] = (rc, out, len(calls))
    rc, out, spawned = results[headline]
    assert (rc, spawned) == (results[bench][0], results[bench][2]) == (1, 4)
    assert out["value"] == 0.0 and out["vs_baseline"] == 0.0
    assert "DEVICE UNAVAILABLE" in out["metric"]
    assert out["metric"] == results[bench][1]["metric"]
    assert [r["error"] for r in out["kernels"]] == \
        [r["error"] for r in results[bench][1]["kernels"]]
    skipped = [r for r in out["kernels"] if "skipped" in r.get("error", "")]
    assert len(skipped) == len(headline.KERNELS) - 2
    assert "healthy" in out["doctor"]
    assert out["banked_device_rows"] == headline._banked_rows("f32")


def test_retry_waits_the_configured_backoff(monkeypatch, capsys):
    sleeps = []
    attempts = []

    def fake(cmd, **kwargs):
        attempts.append(_kernel(cmd))
        if len(attempts) == 1:
            return FakeProc(returncode=headline._PREFLIGHT_EXIT)
        return FakeProc(stdout=_row(headline, _kernel(cmd), 5.0) + "\n")

    import time
    monkeypatch.setattr(time, "sleep", sleeps.append)
    monkeypatch.setenv("CME213_BENCH_RETRY_S", "3")
    rc, out = _run(headline, monkeypatch, capsys, fake)
    assert rc == 0 and sleeps == [3.0]
    assert attempts[:2] == ["xla", "xla"]
    assert ttrace.events("retry")[0]["op"] == "bench.heat2d"


def test_non_cuda_platform_skips_remaining_non_xla(monkeypatch, capsys):
    spawned = {}
    outs = {}
    for mod in (bench, headline):
        names = spawned.setdefault(mod, [])

        def fake(cmd, names=names, mod=mod, **kwargs):
            name = _kernel(cmd)
            names.append(name)
            return FakeProc(stdout=_row(mod, name, 0.3, platform="cpu")
                            + "\n")

        outs[mod] = _run(mod, monkeypatch, capsys, fake)[1]
    assert spawned[headline] == spawned[bench] == ["xla"]
    assert outs[headline]["value"] == outs[bench]["value"] == 0.3
    assert outs[headline]["pct_hbm_peak"] is None
    assert {r["error"] for r in outs[headline]["kernels"][1:]} == \
        {headline.SKIP_NOT_CUDA}


def test_f64_runs_xla_only(monkeypatch, capsys):
    spawned = {}
    for mod in (bench, headline):
        names = spawned.setdefault(mod, [])

        def fake(cmd, names=names, mod=mod, **kwargs):
            names.append(_kernel(cmd))
            assert "--dtype=f64" in cmd
            return FakeProc(stdout=_row(mod, _kernel(cmd), 25.0) + "\n")

        out = _run(mod, monkeypatch, capsys, fake, ["--dtype=f64"])[1]
        assert "f64" in out["metric"]
    assert spawned[headline] == spawned[bench] == ["xla"]


def test_child_command_line(monkeypatch, capsys):
    seen = []

    def fake(cmd, **kwargs):
        seen.append((cmd, kwargs))
        return FakeProc(stdout=_row(headline, _kernel(cmd), 1.0,
                                    platform="cpu") + "\n")

    _run(headline, monkeypatch, capsys, fake, ["--device=cpu"])
    cmd, kwargs = seen[0]
    assert cmd[1:] == ["-m", "cme213_tpu_torch.bench.headline",
                       "--run-measurement", "--kernel=xla", "--dtype=f32",
                       "--device=cpu"]
    assert kwargs["timeout"] == 900
    assert kwargs["env"]["PYTHONPATH"].split(":")[0] == headline.ROOT


def test_device_preflight_cpu():
    assert headline._preflight(30.0, device="cpu")


def test_preflight_retries_once_then_gives_up():
    sleeps = []
    with tfaults.injected("unreachable:1:2"):
        assert not headline._preflight(30.0, retry_sleep=sleeps.append,
                                       device="cpu")
    assert sleeps == [5.0]
    with tfaults.injected("unreachable:1"):
        assert headline._preflight(30.0, retry_sleep=sleeps.append,
                                   device="cpu")


# ----------------------------------------------------- pipeline candidates

PARAMS = SimParams(nx=4000, ny=4000, order=8, iters=8)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_pipeline_candidate_is_the_launch_plan_s_tile(k):
    variants = headline._pipeline_candidates(f"pipeline-k{k}", PARAMS, k)
    ty = sp.pick_pipeline_tile(PARAMS.gy, k, 8)
    assert [label for label, _ in variants] == [f"tile_y={ty}"]
    variants = headline._pipeline_candidates(f"pipeline2d-k{k}", PARAMS, k)
    assert [label for label, _ in variants] == \
        [f"tile_y={ty},tile_x={sp.PIPELINE2D_TILE_BYTES // 4}"]


def test_bench_tile_overrides_are_honoured_and_clamped(monkeypatch):
    monkeypatch.setenv("BENCH_TILE_Y", "40")
    assert [lb for lb, _ in headline._pipeline_candidates(
        "pipeline-k8", PARAMS, 8)] == ["tile_y=40"]
    monkeypatch.setenv("BENCH_TILE_Y", "100000")
    (label, _), = headline._pipeline_candidates("pipeline-k8", PARAMS, 8)
    ty = int(label.split("=")[1])
    assert sp.smem_bytes(ty, 8, 8) <= sp.SMEM_BUDGET_BYTES < \
        sp.smem_bytes(ty + sp.design(8).rows, 8, 8)
    monkeypatch.setenv("BENCH_TILE_X", "128")
    (label, _), = headline._pipeline_candidates("pipeline2d-k1", PARAMS, 1)
    assert label.endswith("tile_x=128")


def test_make_candidate_names():
    for name in headline.KERNELS:
        cand, quantum = headline._make_candidate(name, PARAMS)
        assert quantum == (int(name.split("-k")[1]) if "-k" in name else 1)
        assert isinstance(cand, list) == name.startswith("pipeline")
    with pytest.raises(SystemExit):
        headline._make_candidate("nope", PARAMS)


# ------------------------------------------------------------ a child

@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(headline, "SIZE", 48)


def test_measure_one_on_the_cpu(small):
    row = headline.measure_one("xla", "f32", device="cpu")
    assert row["ok"] and row["platform"] == "cpu"
    assert row["device_kind"] == "cpu" and row["pct_peak"] is None
    assert row["iters"] == headline._MAX_ITERS
    assert row["calibration_iters"] == 8
    assert row["launches"] == {}  # run_heat launches no kernel
    cost = roofline.heat_cost(48, 48, order=8, iters=1)
    # gbs is rounded to 2 decimals, ms_per_iter to 4
    assert row["gbs"] == pytest.approx(
        cost.nbytes / (row["ms_per_iter"] / 1e3) / 1e9, rel=1e-2, abs=0.01)


def test_measure_one_skips_the_card_s_kernels_on_the_cpu(small):
    assert headline.measure_one("pipeline-k1", "f32", "cpu")["error"] == \
        headline.SKIP_NOT_CUDA
    assert headline.measure_one("xla-roll", "f64", "cpu")["error"] == \
        headline.SKIP_NOT_CUDA
    row = headline.measure_one("xla", "f64", "cpu")
    assert row["ok"] and row["dtype"] == "f64"


def test_measure_one_turns_a_failure_into_its_row(small, monkeypatch):
    def broken(name, params, elem=4):
        def fn(u, it):
            raise FrameworkError("nvcc failed on heat_stencil.cu (rc 1)")
        return fn, 1

    monkeypatch.setattr(headline, "_make_candidate", broken)
    row = headline.measure_one("xla", "f32", "cpu")
    assert not row["ok"] and row["stage"] == "compile"
    assert row["kind"] == "compile"
    assert row["error"].startswith("FrameworkError: nvcc failed")


def test_child_main_prints_its_row(small, capsys):
    assert headline.main(["--run-measurement", "--kernel=xla",
                          "--device=cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip())
    assert row["kernel"] == "xla" and row["ok"]


def test_child_exits_42_when_the_preflight_finds_no_device(monkeypatch):
    import time
    monkeypatch.setattr(time, "sleep", lambda s: None)
    with tfaults.injected("unreachable:1:2"):
        with pytest.raises(SystemExit) as info:
            headline.main(["--run-measurement", "--kernel=xla",
                           "--device=cpu"])
    assert info.value.code == headline._PREFLIGHT_EXIT == \
        bench._PREFLIGHT_EXIT


# ----------------------------------------------------------- banked rows

def test_banked_rows_read_only_card_rows(tmp_path, monkeypatch):
    rows = {"headline_a.json": {"ok": True, "platform": "cuda", "gbs": 1},
            "headline_b.json": {"ok": True, "platform": "tpu", "gbs": 2},
            "headline_c.json": {"ok": True, "platform": "cuda",
                                "dtype": "f64", "gbs": 3},
            "headline_d.json": {"ok": False, "platform": "cuda"},
            "tranche1_e.json": {"ok": True, "platform": "cuda", "gbs": 5}}
    for name, row in rows.items():
        (tmp_path / name).write_text(json.dumps(row))
    (tmp_path / "headline_bad.json").write_text("{")
    monkeypatch.setattr(headline, "RESULTS_DIR", str(tmp_path))
    assert [r["gbs"] for r in headline._banked_rows("f32")] == [1]
    assert [r["gbs"] for r in headline._banked_rows("f64")] == [3]
    assert headline._banked_rows("f32")[0]["evidence"] == \
        "bench_results_torch/headline_a.json"
    monkeypatch.setattr(headline, "RESULTS_DIR", str(tmp_path / "none"))
    assert headline._banked_rows() == []


# ------------------------------------------------------------------ --spmv

SPMV_ROWS = [
    {"n": 1 << 16, "kernel": "flat", "gbs": 10.0, "error": "",
     "pct_peak": 0.3, "bound": "memory"},
    {"n": 1 << 22, "kernel": "flat", "gbs": 50.0, "error": "",
     "pct_peak": 1.5, "bound": "memory"},
    {"n": 1 << 22, "kernel": "pallas-fused", "gbs": 900.0, "error": "",
     "pct_peak": 26.9, "bound": "memory"},
    {"n": 1 << 22, "kernel": "pallas", "gbs": 0.0,
     "error": "FrameworkError", "pct_peak": "", "bound": ""},
]


def test_spmv_line_matches_reference(monkeypatch, capsys):
    import cme213_tpu.bench.sweeps as jsweeps
    import cme213_tpu_torch.bench.sweeps as tsweeps

    monkeypatch.setattr(jsweeps, "spmv_scan_sweep",
                        lambda **kw: [dict(r) for r in SPMV_ROWS])
    monkeypatch.setattr(tsweeps, "spmv_scan_sweep",
                        lambda **kw: [dict(r) for r in SPMV_ROWS])
    monkeypatch.setattr(sys, "argv", ["bench.py", "--spmv"])
    bench.main()
    ref = json.loads(capsys.readouterr().out.strip())
    headline.main(["--spmv", "--device=cpu"])
    port = json.loads(capsys.readouterr().out.strip())
    for key in ("metric", "value", "unit", "pct_peak", "bound", "kernels"):
        assert port[key] == ref[key]
    assert port["platform"] == "cpu" and port["pct_hbm_peak"] is None
    assert [e["kernel"] for e in ttrace.events("kernel-failure")] == \
        ["pallas"]


def test_spmv_runs_the_sweep_on_the_cpu(monkeypatch, capsys):
    import cme213_tpu_torch.bench.sweeps as tsweeps

    real = tsweeps.spmv_scan_sweep
    monkeypatch.setattr(tsweeps, "spmv_scan_sweep",
                        lambda **kw: real(ns=(1 << 10,), iters=2, **kw))
    assert headline.main(["--spmv", "--device=cpu"]) == 0
    # the solves print their timing lines first; the JSON line is last
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["unit"] == "GB/s" and out["value"] > 0
    assert {r["kernel"] for r in out["kernels"]} == {"flat", "blocked"}
    assert out["launches"] == {"segscan": 0, "spmv_fused": 0}
