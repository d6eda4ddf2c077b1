"""The port's program cache (``core/programs.py``) and pad-and-mask
canonical sizes, against the JAX package's.

Counterpart of ``tests/test_programs.py``.  ``canonical_size`` must agree
with the JAX package's exactly; the cache's hit/miss telemetry, its key
(which gains the device: a program built for ``cuda:0`` never serves
``cpu``) and its reset follow the reference's contract; a second solve of
a known shape class builds nothing and probes nothing; a canonical
(padded) SpMV-scan equals the unpadded one bit for bit, and equals the JAX
package's ``flat`` solve bit for bit.
"""

import numpy as np
import pytest
import torch

from cme213_tpu.apps import spmv_scan as j_spmv
from cme213_tpu.core import conformance as jconf
from cme213_tpu.core import programs as jprograms
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import conformance, diag, metrics, programs, trace
from cme213_tpu_torch.core import faults
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops.stencil_pipeline import run_heat_resilient


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in ("CME213_FAULTS", "CME213_TUNE_CACHE",
                "CME213_CONFORMANCE_CACHE", "CME213_DIAG_ATTRIBUTION"):
        monkeypatch.delenv(var, raising=False)
    trace.clear_events()   # also resets the program cache
    metrics.reset()
    conformance.reset()
    jconf.reset()
    faults.reset()
    yield
    trace.clear_events()
    metrics.reset()
    conformance.reset()
    faults.reset()


# ------------------------------------------------------------ cache unit

@pytest.mark.parametrize("floor", [1, 16])
def test_canonical_size_matches_jax(floor):
    for n in (1, 2, 3, 7, 8, 9, 15, 16, 17, 512, 513, 1000, 1023, 1024,
              100_000, 11_634_424):
        assert programs.canonical_size(n, floor) == \
            jprograms.canonical_size(n, floor), n
    assert programs.canonical_size(3, floor=16) == 16


def test_miss_builds_and_warms_once_then_hits():
    calls = {"build": 0, "warm": 0}

    def build():
        calls["build"] += 1
        return lambda x: x + 1

    def warm(fn):
        calls["warm"] += 1
        assert fn(1) == 2

    fn1 = programs.get("probe", "r", "n8", build, dtype="f32", warm=warm,
                       device="cpu", iters=2)
    assert calls == {"build": 1, "warm": 1}
    fn2 = programs.get("probe", "r", "n8", build, dtype="f32", warm=warm,
                       device="cpu", iters=2)
    assert fn2 is fn1 and calls == {"build": 1, "warm": 1}
    assert programs.size() == 1
    assert len(trace.events("program-cache-miss")) == 1
    hit = trace.events("program-cache-hit")[0]
    assert (hit["op"], hit["rung"], hit["shape_class"]) == ("probe", "r",
                                                            "n8")
    snap = metrics.snapshot()
    assert snap["counters"]["programs.hits"] == 1
    assert snap["counters"]["programs.misses"] == 1
    assert snap["histograms"]["compile.probe.n8.ms"]["count"] == 1


def test_key_includes_statics_dtype_and_device():
    built = []

    def tagged(tag):
        def build():
            built.append(tag)
            return tag
        return build

    programs.get("op", "r", "n8", tagged("a"), dtype="f32", device="cpu",
                 iters=2)
    programs.get("op", "r", "n8", tagged("b"), dtype="f32", device="cpu",
                 iters=3)
    programs.get("op", "r", "n8", tagged("c"), dtype="f64", device="cpu",
                 iters=2)
    programs.get("op", "r", "n8", tagged("d"), dtype="f32", device="cpu",
                 iters=2, tile=64)
    # the same program for the card is another program
    programs.get("op", "r", "n8", tagged("e"), dtype="f32",
                 device="cuda:0", iters=2)
    programs.get("op", "r", "n8", tagged("f"), dtype="f32",
                 device=torch.device("cuda", 0), iters=2)
    assert built == ["a", "b", "c", "d", "e"]
    assert programs.size() == 5
    assert programs.get("op", "r", "n8", tagged("g"), dtype="f32",
                        device="cpu", iters=2) == "a"
    assert {k[4] for k in programs.keys()} == {"cpu", "cuda:0"}
    assert programs.device_key(None) == "host"


def test_failed_build_or_warm_caches_nothing_and_names_the_stage():
    def no_build():
        raise RuntimeError("no build")

    with pytest.raises(RuntimeError) as info:
        programs.get("op", "r", "n8", no_build)
    assert diag.failure_stage(info.value) == "lower"
    assert programs.size() == 0

    def bad_warm(fn):
        raise RuntimeError("warm-up died")

    with pytest.raises(RuntimeError) as info:
        programs.get("op", "r", "n8", lambda: "fn", warm=bad_warm)
    assert diag.failure_stage(info.value) == "compile"
    assert programs.size() == 0
    # the key is not poisoned: a later good build caches
    assert programs.get("op", "r", "n8", lambda: "fn") == "fn"
    assert programs.size() == 1


def test_stage_faults_fire_at_build_and_warm():
    with faults.injected("stage:op.r:lower"):
        with pytest.raises(faults.InjectedFault) as info:
            programs.get("op", "r", "n8", lambda: "fn")
    assert diag.failure_stage(info.value) == "lower"
    with faults.injected("stage:op.r:compile"):
        with pytest.raises(faults.InjectedFault) as info:
            programs.get("op", "r", "n8", lambda: "fn", warm=lambda f: None)
    assert diag.failure_stage(info.value) == "compile"
    assert programs.size() == 0


def test_clear_events_resets_the_cache():
    programs.get("op", "r", "n8", lambda: "fn")
    assert programs.size() == 1
    trace.clear_events()
    assert programs.size() == 0 and programs.keys() == []


# ----------------------------------------- a second dispatch builds nothing

def test_spmv_second_call_is_all_hits():
    prob = spmv.generate_problem(256, 6, 32, iters=3, seed=11)
    out1 = spmv.run_spmv_scan(prob, kernel="blocked", device="cpu")
    n_miss = len(trace.events("program-cache-miss"))
    n_probe = len(trace.events("conformance-probe"))
    n_hit = len(trace.events("program-cache-hit"))
    out2 = spmv.run_spmv_scan(prob, kernel="blocked", device="cpu")
    assert len(trace.events("program-cache-miss")) == n_miss
    assert len(trace.events("conformance-probe")) == n_probe
    assert len(trace.events("program-cache-hit")) > n_hit
    assert trace.events("compile-retrace") == []
    np.testing.assert_array_equal(out1, out2)


def test_heat_second_call_is_all_hits():
    p = SimParams(nx=24, ny=24, order=2, iters=3)
    u0 = make_initial_grid(p, device="cpu")
    r1 = run_heat_resilient(u0, 3, 2, p.xcfl, p.ycfl, p.bc, k=1)
    assert r1.rung == "pipeline" and not r1.demoted
    n_miss = len(trace.events("program-cache-miss"))
    assert n_miss == 3  # the probe's pipeline and xla programs, the solve's
    assert len(trace.events("conformance-probe")) == 1
    r2 = run_heat_resilient(u0, 3, 2, p.xcfl, p.ycfl, p.bc, k=1)
    assert len(trace.events("program-cache-miss")) == n_miss
    assert len(trace.events("conformance-probe")) == 1
    assert trace.events("compile-retrace") == []
    torch.testing.assert_close(r1.value, r2.value, rtol=0, atol=0)


# ------------------------------------------------ pad-and-mask equality

@pytest.mark.parametrize("n", [1023, 513, 512])
def test_canonical_solve_bitwise_equals_unpadded_and_jax(n):
    prob = spmv.generate_problem(n, 8, 32, iters=3, seed=n)
    base = spmv.run_spmv_scan(prob, kernel="flat", device="cpu")
    canon = spmv.run_spmv_scan(prob, kernel="flat", canonical=True,
                               device="cpu")
    assert canon.shape == (n,)
    np.testing.assert_array_equal(canon, base)
    n_to = programs.canonical_size(n)
    assert any(k[2] == f"n{n_to}/i3" for k in programs.keys())
    if n_to != n:
        assert trace.events("conformance-probe")[-1]["op"] == "spmv_scan.pad"
    jprob = j_spmv.Problem(prob.a, prob.s, prob.k, prob.x, prob.iters)
    jcanon = j_spmv.run_spmv_scan(jprob, kernel="flat", canonical=True)
    np.testing.assert_array_equal(canon, np.asarray(jcanon))


def test_bucket_gate_refuses_unpaddable_bucket():
    assert spmv._bucket_gate(2, "flat", torch.float32, "cpu") is False


def test_bucket_gate_wrong_fault_keeps_the_exact_shape():
    prob = spmv.generate_problem(300, 8, 32, iters=3, seed=3)
    base = spmv.run_spmv_scan(prob, kernel="flat", device="cpu")
    with faults.injected("wrong:spmv_scan.pad"):
        out = spmv.run_spmv_scan(prob, kernel="flat", canonical=True,
                                 device="cpu")
    assert trace.events("conformance-failed")[-1]["op"] == "spmv_scan.pad"
    # the gate's probe solved in the bucket (2 iterations); the request
    # did not
    assert not any(k[2] == "n512/i3" for k in programs.keys())
    np.testing.assert_array_equal(out, base)


def test_cli_canonical_writes_the_unpadded_answer(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.chdir(tmp_path)
    assert spmv.main(["spmv_scan", "gen", "a.txt", "x.txt", "1500", "40",
                      "30", "4", "--seed=5"]) == 0
    assert spmv.main(["spmv_scan", "a.txt", "x.txt", "--kernel=blocked",
                      "--device=cpu"]) == 0
    exact = np.loadtxt(tmp_path / "b.txt", dtype=np.float32)
    assert spmv.main(["spmv_scan", "a.txt", "x.txt", "cpu_check",
                      "--kernel=blocked", "--canonical",
                      "--device=cpu"]) == 0
    assert "Worked!" in capsys.readouterr().out
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "b.txt", dtype=np.float32), exact)
    assert any(k[2] == "n2048/i4" for k in programs.keys())
