"""The serving layer's neighbours in the port, on the CPU: shadow drift
sampling on served batches (the JAX package's ``tests/test_numerics.py``
serving cases), the ``serve.<op>`` tuning spaces and ``tuned_batch_cap``
(``tests/test_tune.py``), the program cache under the serving adapters
(``tests/test_programs.py``), and the ``serve loadgen`` / ``serve warmup``
CLIs, whose report layout is held to the JAX package's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cme213_tpu_torch.core import (admission, conformance, faults, metrics,
                                   numerics, programs, trace, tune)
from cme213_tpu_torch.core.resilience import VirtualClock
from cme213_tpu_torch.serve import Server
from cme213_tpu_torch.serve import slo as slo_mod

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in (admission.BUDGET_ENV, tune.CACHE_ENV, conformance.CACHE_ENV,
                numerics.SHADOW_RATE_ENV):
        monkeypatch.delenv(var, raising=False)
    trace.clear_events()
    metrics.reset()
    numerics.reset()
    tune.reset()
    conformance.reset()
    yield
    faults.reset()
    numerics.reset()
    tune.reset()
    conformance.reset()
    metrics.reset()


class FloatEchoAdapter:
    """Two-rung echo over float payloads: ``fast`` and ``safe`` both
    return the payload array unchanged, so the reference rung (``safe``)
    is bitwise-correct by construction and any drift on ``fast`` comes
    from an injected ``drift:serve.echo.fast`` clause."""

    op = "echo"

    def __init__(self):
        self.calls: list[tuple[str, int]] = []

    def shape_class(self, payload, coarse: bool = False) -> str:
        return "any" if coarse else payload[0]

    def rungs(self, degraded: bool = False):
        return ("safe",) if degraded else ("fast", "safe")

    def run_batch(self, payloads, rung: str, coarse: bool = False,
                  device=None):
        self.calls.append((rung, len(payloads)))
        return [np.array(p[1], dtype=np.float32) for p in payloads]

    def preflight_builder(self, payloads, rung, coarse=False, device=None):
        return None


def echo_server(**kw):
    adapter = FloatEchoAdapter()
    kw.setdefault("clock", VirtualClock())
    return Server(adapters={"echo": adapter}, device=CPU, **kw), adapter


# ------------------------------------------------- the full shadow loop

def test_drift_fault_caught_budget_burns_rung_demoted(monkeypatch):
    monkeypatch.setenv(numerics.SHADOW_RATE_ENV, "1")
    server, adapter = echo_server(max_batch=4)
    payloads = [np.full(8, float(i + 1), dtype=np.float32)
                for i in range(12)]
    results = []
    with faults.injected("drift:serve.echo.fast"):
        for payload in payloads:
            server.submit("echo", ("k", payload))
            results.extend(server.step())

    assert [r.status for r in results] == ["ok"] * 12
    drift_events = trace.events("numeric-drift")
    assert len(drift_events) >= numerics.budget().min_samples
    assert all(e["op"] == "serve.echo" and e["rung"] == "fast"
               and e["over_budget"] for e in drift_events)
    assert all(0 < e["rel_l2"] < 1e-2 for e in drift_events)

    burns = trace.events("drift-budget-burn")
    assert len(burns) == 1
    assert burns[0]["op"] == "serve.echo" and burns[0]["rung"] == "fast"
    assert numerics.demoted("serve.echo", "fast")
    snap = numerics.last_drift()
    assert snap["demoted"] == ["serve.echo|fast"]
    assert snap["budget"]["serve.echo|fast"]["burning"]

    demoted_at = next(i for i, r in enumerate(results) if r.rung == "safe")
    assert demoted_at <= numerics.budget().min_samples
    for i, r in enumerate(results[demoted_at:], start=demoted_at):
        assert r.rung == "safe"
        np.testing.assert_array_equal(np.asarray(r.value), payloads[i])
    assert not np.array_equal(np.asarray(results[0].value), payloads[0])
    assert all(e["rung"] == "fast" for e in trace.events("numeric-drift"))


def test_clean_serving_has_zero_drift_over_budget(monkeypatch):
    monkeypatch.setenv(numerics.SHADOW_RATE_ENV, "1")
    server, adapter = echo_server(max_batch=4)
    for i in range(6):
        server.submit("echo", ("k", np.full(4, float(i + 1), np.float32)))
        server.step()
    drift_events = trace.events("numeric-drift")
    assert len(drift_events) == 6
    assert not any(e["over_budget"] for e in drift_events)
    assert not trace.events("drift-budget-burn")
    assert numerics.last_drift()["demoted"] == []


def test_shadow_off_by_default():
    server, adapter = echo_server(max_batch=4)
    server.submit("echo", ("k", np.ones(4, np.float32)))
    server.step()
    assert not trace.events("numeric-drift")
    assert [c[0] for c in adapter.calls] == ["fast"]


def test_slo_drift_rate_objective_burns():
    clock = VirtualClock()
    mon = slo_mod.from_flags(clock, drift_rate=0.1, short_s=5.0,
                             long_s=10.0, min_samples=4)
    for _ in range(4):
        mon.observe(latency_ms=1.0, drift=True)
        clock.advance(0.1)
    state = mon.evaluate()
    assert state["drift-rate"]["burning"]
    assert any(e["objective"] == "drift-rate"
               for e in trace.events("slo-burn"))
    mon2 = slo_mod.from_flags(clock, drift_rate=0.1, min_samples=1)
    mon2.observe(latency_ms=1.0)
    assert mon2.evaluate()["drift-rate"]["burn_short"] is None


def test_shadow_samples_a_real_workload_against_its_reference_rung(
        monkeypatch):
    """Shadow sampling on the spmv adapter: the blocked rung's sampled
    lanes are re-run on ``flat`` (the reference rung) on the server's
    device, one ``numeric-drift`` record a batch, within the default
    rel-L2 tolerance (the scans associate differently, so not bitwise)."""
    from cme213_tpu_torch.apps.spmv_scan import generate_problem

    monkeypatch.setenv(numerics.SHADOW_RATE_ENV, "1")
    server = Server(max_batch=4, clock=VirtualClock(), device=CPU)
    for s in range(3):
        server.submit("spmv_scan", generate_problem(256, p=6, q=64,
                                                    iters=3, seed=s))
    results = server.drain()
    assert {r.rung for r in results} == {"blocked"}
    (ev,) = trace.events("numeric-drift")
    assert ev["op"] == "serve.spmv_scan" and ev["rung"] == "blocked"
    assert 0 < ev["rel_l2"] < 1e-5 and not ev["over_budget"]
    assert metrics.counter("numerics.shadow.samples").value == 1


# ----------------------------------------------------- tuned batch widths

def test_serve_batch_cap_consults_cache():
    from cme213_tpu_torch.serve.server import tuned_batch_cap

    tune.store("serve.spmv_scan", "n64/i2", "float32",
               statics={"max_batch": 2}, candidate="b2", ms=1.0, gbs=0.0,
               device=CPU)
    assert tuned_batch_cap("spmv_scan", "n64/i2", 8, device=CPU) == 2
    # the tuned width is a cap, never an escalation past the server's
    assert tuned_batch_cap("spmv_scan", "n64/i2", 1, device=CPU) == 1
    assert tuned_batch_cap("spmv_scan", "other", 8, device=CPU) == 8


def test_tune_run_serve_spmv_persists_and_the_server_reads_it(tmp_path,
                                                              monkeypatch):
    """``tune run --op serve.spmv --device=cpu`` gates every width on
    lane 0 being bitwise the width-1 solve, times them, persists the
    winner; a server on the same cache caps that bucket at it."""
    from cme213_tpu_torch import tune_cli
    from cme213_tpu_torch.serve.loadgen import build_mix
    from cme213_tpu_torch.serve.server import tuned_batch_cap

    cache = tmp_path / "tune.json"
    monkeypatch.setenv(tune.CACHE_ENV, str(cache))
    assert tune_cli.main(["run", "--op", "serve.spmv", "--runs", "1",
                          "--max-batch", "4", "--device=cpu"]) == 0
    (key, rec), = json.loads(cache.read_text()).items()
    assert key == "cpu|serve.spmv_scan|n512/i6|float32"
    width = rec["statics"]["max_batch"]
    assert width in (1, 2, 4)
    probes = trace.events("conformance-probe")
    assert {e["rung"] for e in probes} >= {"b2", "b4"}
    assert all(e["ok"] for e in probes)
    tune.reset()
    assert tuned_batch_cap("spmv_scan", "n512/i6", 8, device=CPU) == width
    server = Server(max_batch=8, clock=VirtualClock(), device=CPU)
    for spec in build_mix("spmv", 8, seed=0):
        server.submit(spec.op, spec.payload)
    sizes = {r.batch_size for r in server.drain()
             if r.shape_class == "n512/i6"}
    assert max(sizes) <= width


def test_serve_space_trials_synchronise_the_device_and_scale():
    space = tune.build_space("serve.cipher", device=CPU, max_batch=4)
    assert space.op == "serve.cipher" and space.shape_class == "n4096/u8"
    assert [(c.label, c.scale) for c in space.candidates] == \
        [("b1", 1.0), ("b2", 2.0), ("b4", 4.0)]
    assert space.candidates[0].gate is None


# ----------------------------------------- the program cache in serving

def test_serve_cipher_second_batch_is_a_hit():
    from cme213_tpu_torch.serve.workloads import CipherAdapter, CipherRequest

    programs.reset()
    adapter = CipherAdapter()
    reqs = [CipherRequest(np.arange(64, dtype=np.uint8), s) for s in (3, 7)]
    out1 = adapter.run_batch(reqs, "bytes", device=CPU)
    n_miss = len(trace.events("program-cache-miss"))
    out2 = adapter.run_batch(reqs, "bytes", device=CPU)
    assert len(trace.events("program-cache-miss")) == n_miss
    assert trace.events("program-cache-hit")
    assert trace.events("compile-retrace") == []
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)


def test_serve_mixed_sizes_pad_into_one_bucket_bitwise():
    from cme213_tpu_torch.apps import spmv_scan as sp
    from cme213_tpu_torch.serve.workloads import SpmvAdapter

    adapter = SpmvAdapter()
    probs = [sp.generate_problem(500, 8, 32, iters=3, seed=1),
             sp.generate_problem(512, 8, 32, iters=3, seed=2)]
    assert {adapter.shape_class(p) for p in probs} == {"n512/i3"}
    outs = adapter.run_batch(probs, "flat", device=CPU)
    for p, out in zip(probs, outs):
        assert out.shape == (p.n,)
        ref = sp.run_spmv_scan(p, kernel="flat", device=CPU)
        np.testing.assert_array_equal(np.asarray(out), ref)


def test_bucket_gate_makes_its_probe_on_a_verdict_miss_only(monkeypatch):
    """A cached pad-and-mask verdict costs no probe problem: at pwtk's
    2^24 bucket the probe is 12.6 M values, which every serving batch
    paid before."""
    import torch

    from cme213_tpu_torch.apps import spmv_scan as sp

    made = []
    real = sp.generate_problem
    monkeypatch.setattr(sp, "generate_problem",
                        lambda *a, **k: made.append(a) or real(*a, **k))
    for _ in range(3):
        assert sp._bucket_gate(1024, "blocked", torch.float32, CPU)
    assert made == [(768,)]
    conformance.reset()
    assert sp._bucket_gate(1024, "blocked", torch.float32, CPU)
    assert len(made) == 2


def test_loadgen_max_retraces_gate(capsys):
    from cme213_tpu_torch.serve import loadgen

    argv = ["--requests", "4", "--mode", "closed", "--concurrency", "2",
            "--max-batch", "2", "--mix", "cipher", "--seed", "0",
            "--device=cpu"]
    assert loadgen.main([*argv, "--max-retraces", "0"]) == 0
    assert "program cache" in capsys.readouterr().out
    assert loadgen.main([*argv, "--max-retraces", "-1"]) == 1
    assert "--max-retraces=-1" in capsys.readouterr().err


# ------------------------------------------------------------- the CLIs

def _layout(text: str) -> list[str]:
    """The report's line heads (the words before the first number)."""
    import re

    return [re.split(r"[-\d(]", line.strip(), maxsplit=1)[0]
            for line in text.splitlines()]


@pytest.mark.parametrize("mode", ["closed", "open"])
def test_loadgen_cli_report_layout_is_the_reference_s(mode, capsys):
    from cme213_tpu.serve import loadgen as jloadgen
    from cme213_tpu_torch.serve import loadgen

    argv = ["--requests", "12", "--mix", "spmv,heat,cipher,sort",
            "--mode", mode, "--burst", "6", "--capacity", "8",
            "--baseline"]
    assert loadgen.main([*argv, "--device=cpu"]) == 0
    ours = capsys.readouterr().out
    assert jloadgen.main(argv) == 0
    theirs = capsys.readouterr().out
    mine, ref = _layout(ours), _layout(theirs)
    # the per-class compile lines name each package's programs; the
    # sections and their order are the same
    assert [h for h in mine if not h.startswith(" ")] == \
        [h for h in ref if not h.startswith(" ")]
    assert "requests 12:" in ours and "batched speedup" in ours
    assert loadgen.main([*argv, "--device=cpu", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert set(rep) >= {"throughput_rps", "latency_ms", "phases",
                        "batch_mean_size", "shed_by_reason", "baseline"}


def test_loadgen_transport_self_stub_reports_codec_share(capsys):
    from cme213_tpu_torch.serve import loadgen

    assert loadgen.main(["--transport", "self", "--mix", "stub",
                         "--requests", "64", "--concurrency", "4",
                         "--pipeline", "4", "--device=cpu",
                         "--max-codec-share", "1.0"]) == 0
    out = capsys.readouterr().out
    assert "transport (p50/p99 ms):" in out and "codec share" in out
    assert "requests 64: 64 served" in out
    assert loadgen.main(["--transport", "self", "--stub-solve", "--mix",
                         "stub", "--requests", "32", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["served"] == 32 and rep["fleet"]["replicas_seen"] == []


def test_warmup_builds_buckets_and_second_process_probes_nothing(tmp_path):
    """Warm-up on the CPU in two processes sharing a conformance cache:
    the first builds every bucket's programs and runs the probes, the
    second finds every verdict on disk; neither claims a compiled-program
    disk cache (``CME213_COMPILE_CACHE`` does not apply to eager torch)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           conformance.CACHE_ENV: str(tmp_path / "verdicts.json"),
           "CME213_COMPILE_CACHE": str(tmp_path / "xla")}
    cmd = [sys.executable, "-m", "cme213_tpu_torch", "serve", "warmup",
           "--mix", "spmv,sort", "--requests", "4", "--max-batch", "2",
           "--device=cpu", "--json"]

    def run():
        r = subprocess.run(cmd, env=env, cwd=tmp_path, timeout=300,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        return json.loads(r.stdout)

    rep1 = run()
    assert rep1["warmed"] and rep1["programs"] > 0
    assert rep1["persistent_cache"] is None
    assert rep1["compile_cache_env"].startswith("not applicable")
    assert rep1["compile"]["cache_misses"] > 0
    verdicts = json.loads((tmp_path / "verdicts.json").read_text())
    assert any("serve.sort" in k for k in verdicts)
    assert not (tmp_path / "xla").exists()
    rep2 = run()
    assert rep2["warmed"] == rep1["warmed"]
    assert json.loads((tmp_path / "verdicts.json").read_text()) == verdicts
