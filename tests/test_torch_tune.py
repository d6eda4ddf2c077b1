"""The port's autotuner (``core/tune.py``, ``tune_cli.py``) against the
JAX package's.

Counterpart of ``tests/test_tune.py``: the gate-then-time search (a
candidate whose probe fails never reaches timing), the persistent winner
cache keyed ``device_kind|op|shape_class|dtype``, dispatch consuming the
winners (``tune-hit``), the kill switch, and ties broken by registration
order under a scripted clock, where the JAX package's ``run_space`` must
pick the same winner.  The port's own rule: every clock read of a trial
comes after a synchronise of the space's device.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cme213_tpu.core import tune as jtune
from cme213_tpu_torch import tune_cli
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import conformance, faults, metrics, programs
from cme213_tpu_torch.core import trace, tune
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import segmented
from cme213_tpu_torch.ops.stencil_pipeline import run_heat_resilient

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in (tune.CACHE_ENV, tune.KILL_ENV, "CME213_CONFORMANCE_CACHE",
                "CME213_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    trace.clear_events()
    metrics.reset()
    tune.reset()
    jtune.reset()
    conformance.reset()
    faults.reset()
    yield
    trace.clear_events()
    metrics.reset()
    tune.reset()
    jtune.reset()
    conformance.reset()
    faults.reset()


# ---------------------------------------------------------- cache unit

def test_store_lookup_resolve_roundtrip():
    tune.store("toy", "n64", "float32", statics={"block": 8},
               candidate="b8", ms=1.0, gbs=2.0, device="cpu")
    rec = tune.lookup("toy", "n64", device="cpu")
    assert rec["statics"] == {"block": 8} and rec["candidate"] == "b8"
    out = tune.resolve("toy", "n64", "float32", device="cpu", block=1,
                       other=0)
    assert out == {"block": 8, "other": 0}
    hits = trace.events("tune-hit")
    assert hits and json.loads(hits[0]["statics"]) == {"block": 8}
    # the JAX package resolves the same statics from the same record
    jtune.store("toy", "n64", "float32", statics={"block": 8},
                candidate="b8", ms=1.0, gbs=2.0)
    assert jtune.resolve("toy", "n64", "float32", block=1, other=0) == out


def test_key_names_the_device_kind():
    tune.store("toy", "n64", "float32", statics={"block": 8},
               candidate="b8", ms=1.0, gbs=2.0, device="cpu")
    assert list(tune.entries()) == ["cpu|toy|n64|float32"]
    assert tune.device_kind("cpu") == "cpu"
    assert tune.lookup("toy", "n64", device="cpu") is not None


def test_resolve_default_when_empty():
    assert tune.resolve("toy", "n64", "float32", device="cpu",
                        block=4) == {"block": 4}
    assert trace.events("tune-default")
    assert metrics.snapshot()["counters"]["tune.defaults"] == 1


def test_disk_cache_persist_and_reload(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tune.CACHE_ENV, str(path))
    tune.store("toy", "n64", "float32", statics={"block": 8},
               candidate="b8", ms=1.0, gbs=2.0, device="cpu")
    assert path.exists()
    tune.reset()
    assert tune.lookup("toy", "n64", device="cpu")["statics"] == {"block": 8}


def test_corrupt_disk_cache_serves_defaults(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    path.write_text("{not json")
    monkeypatch.setenv(tune.CACHE_ENV, str(path))
    assert tune.lookup("toy", "n64", device="cpu") is None


def test_clear_removes_disk_and_memory(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tune.CACHE_ENV, str(path))
    tune.store("toy", "n64", "float32", statics={}, candidate="x", ms=1.0,
               gbs=0.0, device="cpu")
    assert tune.clear() == 1
    assert not path.exists()
    assert tune.lookup("toy", "n64", device="cpu") is None


def test_kill_switch_restores_defaults(monkeypatch):
    tune.store("heat", "34x34/order2/k1", "float32",
               statics={"tile_y": 8}, candidate="pipeline/ty8", ms=1.0,
               gbs=1.0, device="cpu")
    assert tune.resolve("heat", "34x34/order2/k1", "float32",
                        device="cpu", tile_y=None) == {"tile_y": 8}
    monkeypatch.setenv(tune.KILL_ENV, "0")
    assert tune.lookup("heat", "34x34/order2/k1", device="cpu") is None
    assert tune.resolve("heat", "34x34/order2/k1", "float32",
                        device="cpu", tile_y=None) == {"tile_y": None}
    assert tune.resolve("toy", "n64", "float32", block=4) == {"block": 4}
    monkeypatch.setenv(tune.KILL_ENV, "1")
    assert tune.lookup("heat", "34x34/order2/k1",
                       device="cpu")["statics"] == {"tile_y": 8}


# ------------------------------------------------ gate-then-time search

class ScriptClock:
    """``now()`` advances a fixed quantum a call: every candidate measures
    the same duration, so ties are exact by construction."""

    def __init__(self, step_s: float = 0.001):
        self.t = 0.0
        self.step = step_s

    def now(self) -> float:
        self.t += self.step
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


def _cand(mod, label, statics=None, gate=None, runner=None):
    runner = runner or (lambda: None)
    return mod.Candidate(label, statics if statics is not None
                         else {"which": label}, lambda: runner, gate)


@pytest.mark.parametrize("order", [("a", "b"), ("b", "a")])
def test_tie_breaks_to_first_registered_like_jax(order):
    winners = []
    for mod in (tune, jtune):
        space = mod.TuneSpace("toy", "sc", "float32",
                              tuple(_cand(mod, c) for c in order))
        rep = mod.run_space(space, clock=ScriptClock(), runs=3,
                            persist=False)
        winners.append(rep["winner"]["candidate"])
    assert winners == [order[0], order[0]]


def test_gated_out_candidate_cannot_win():
    space = tune.TuneSpace("toy", "sc", "float32", (
        _cand(tune, "bad", gate=lambda: False), _cand(tune, "good")))
    rep = tune.run_space(space, clock=ScriptClock(), runs=2, persist=False)
    assert rep["winner"]["candidate"] == "good"
    bad = [t for t in rep["trials"] if t["candidate"] == "bad"]
    assert bad and not bad[0]["ok"]
    assert metrics.counter("tune.rejected").value == 1


def test_dying_probe_or_build_is_a_veto_not_a_crash():
    def boom():
        raise RuntimeError("probe died")

    space = tune.TuneSpace("toy", "sc", "float32", (
        _cand(tune, "bad", gate=boom),
        tune.Candidate("unbuildable", {}, boom),
        _cand(tune, "good")))
    rep = tune.run_space(space, clock=ScriptClock(), runs=2, persist=False)
    assert rep["winner"]["candidate"] == "good"
    assert [t["ok"] for t in rep["trials"]] == [False, False, True]


@pytest.mark.parametrize("where", ["gate", "build"])
def test_kernel_error_raises_out_of_the_search(where):
    """A kernel that cannot build or launch is an error out of the tuner,
    as out of a ladder, not a rejected candidate."""
    from cme213_tpu_torch.core import KernelError

    def broken():
        raise KernelError("nvcc failed on heat_stencil.cu (rc 1)")

    bad = (_cand(tune, "bad", gate=broken) if where == "gate"
           else tune.Candidate("bad", {}, broken))
    space = tune.TuneSpace("toy", "sc", "float32",
                           (_cand(tune, "good"), bad))
    with pytest.raises(KernelError):
        tune.run_space(space, clock=ScriptClock(), runs=1, persist=False)


def test_no_survivor_raises_tune_error():
    space = tune.TuneSpace("toy", "sc", "float32",
                           (_cand(tune, "bad", gate=lambda: False),))
    with pytest.raises(tune.TuneError):
        tune.run_space(space, clock=ScriptClock(), runs=1, persist=False)


def test_every_clock_read_follows_a_synchronise(monkeypatch):
    """The trial's clock is read only after the space's device has been
    synchronised: a host clock around an asynchronous launch would
    measure the enqueue."""
    log = []
    monkeypatch.setattr(tune, "synchronize",
                        lambda device: log.append(("sync", device)))
    monkeypatch.setattr(tune, "device_kind", lambda device: "a card")

    class LoggingClock(ScriptClock):
        def now(self):
            log.append(("clock",))
            return super().now()

    space = tune.TuneSpace("toy", "sc", "float32",
                           (_cand(tune, "a", runner=lambda: log.append(
                               ("run",))),), device="cuda:0")
    tune.run_space(space, clock=LoggingClock(), runs=2, persist=False)
    assert log == [("sync", "cuda:0"), ("clock",), ("run",),
                   ("sync", "cuda:0"), ("clock",)] * 2


def test_wrong_fault_candidate_is_excluded_before_timing():
    """A ``wrong:spmv_scan``-poisoned probe excludes exactly the first
    gated candidate, as in the JAX package."""
    reports = []
    for mod, conf, flt, kw in (
            (tune, conformance, faults, {"device": "cpu"}),
            (jtune, None, None, {})):
        if conf is None:
            from cme213_tpu.core import conformance as conf
            from cme213_tpu.core import faults as flt
        conf.reset()
        with flt.injected("wrong:spmv_scan"):
            reports.append(mod.run("spmv_scan", n=2048, iters=2, runs=1,
                                   persist=False, block_sizes=(512, 1024),
                                   **kw))
        conf.reset()
    for rep in reports:
        bad = [t for t in rep["trials"] if t["candidate"] == "blocked/bs512"]
        assert bad and not bad[0]["ok"]
        assert rep["winner"]["candidate"] != "blocked/bs512"
        assert {t["candidate"] for t in rep["trials"] if t["ok"]} == \
            {"flat", "blocked/bs1024"}


def test_winner_event_and_persist(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tune.CACHE_ENV, str(path))
    space = tune.TuneSpace("toy", "sc", "float32",
                           (_cand(tune, "a", statics={"block": 2}),))
    tune.run_space(space, clock=ScriptClock(), runs=2)
    winners = trace.events("tune-winner")
    assert winners and winners[0]["candidate"] == "a"
    trials = trace.events("tune-trial")
    assert trials and trials[0]["ok"]
    data = json.loads(path.read_text())
    assert list(data) == ["cpu|toy|sc|float32"]
    assert data["cpu|toy|sc|float32"]["statics"] == {"block": 2}
    for rec in trace.events():
        assert trace.validate_record(rec) == [], rec


@pytest.mark.parametrize("op,item", [("serve.heat", "serve.heat"),
                                     ("serve.spmv", "serve.spmv_scan")])
def test_spaces_of_unported_ops_name_their_roadmap_item(op, item):
    """The serve spaces, which waited for the serving layer, now build;
    an op with no space still names what there is."""
    space = tune.build_space(op, device="cpu", max_batch=2)
    assert space.op == item and space.device == "cpu"
    assert [c.label for c in space.candidates] == ["b1", "b2"]
    with pytest.raises(tune.TuneError, match="no candidate space"):
        tune.build_space("nope")


# ------------------------------------------- dispatch consumes winners

def test_spmv_and_crossover_winners_stay_out_of_dispatch():
    """The SpMV-scan and crossover spaces record their winners; no
    dispatch reads them until a card's measurement says what to serve."""
    prob = spmv.generate_problem(256, p=8, q=128, iters=2, seed=0)
    bucket = f"n{programs.canonical_size(prob.n)}"
    tune.store("spmv_scan", bucket, "float32",
               statics={"kernel": "blocked", "block_size": 128},
               candidate="blocked/bs128", ms=1.0, gbs=1.0, device="cpu")
    tune.store("segmented_scan", "crossover", "float32",
               statics={"threshold": 123}, candidate="thr123", ms=1.0,
               gbs=1.0)
    out = spmv.run_spmv_scan(prob, kernel="auto", device="cpu")
    assert spmv.external_check(prob, out)["rel_l2"] < 1e-4
    assert not trace.events("tune-hit")
    assert trace.events("served")[-1]["rung"] == "auto"
    assert segmented.scan_threshold() == segmented.BLOCKED_SCAN_THRESHOLD


def test_heat_dispatch_pins_explicit_tiles_over_tuned():
    p = SimParams(nx=32, ny=32, order=2, iters=2)
    u0 = make_initial_grid(p, device="cpu")
    # the grid carries its halo: nx = ny = 32 at order 2 is 34 x 34
    tune.store("heat", "34x34/order2/k1", "float32",
               statics={"tile_y": 8}, candidate="pipeline/ty8", ms=1.0,
               gbs=1.0, device="cpu")
    res = run_heat_resilient(u0, 2, 2, p.xcfl, p.ycfl, p.bc, tile_y=16)
    assert torch.isfinite(res.value).all()
    assert not trace.events("tune-hit")
    assert {dict(k[5]).get("tile_y") for k in programs.keys()
            if k[1] == "pipeline" and k[2] == "34x34/order2/k1"} == {"16"}
    # with the knob open, the tuned tile is the one the solve runs
    run_heat_resilient(u0, 2, 2, p.xcfl, p.ycfl, p.bc)
    hits = trace.events("tune-hit")
    assert hits and json.loads(hits[0]["statics"]) == {"tile_y": 8}
    assert any(dict(k[5]).get("tile_y") == "8"
               for k in programs.keys() if k[1] == "pipeline")


def test_spmv_sweep_carries_tuned_column():
    from cme213_tpu_torch.bench import sweeps

    tune.store("spmv_scan", "n4096", "float32", statics={"kernel": "flat"},
               candidate="flat", ms=1.0, gbs=1.0, device="cpu")
    rows = sweeps.spmv_scan_sweep(ns=(4096,), iters=2, kernels=("flat",),
                                  device="cpu")
    assert rows and rows[0]["tuned"] == "flat"
    assert not trace.events("conformance-probe")  # fallback=False: ungated


# ------------------------------------------------------- spaces on the CPU

def test_heat_space_winner_serves_the_next_open_dispatch():
    rep = tune.run("heat", gy=16, gx=16, order=2, k=1, iters=2, runs=1,
                   device="cpu", clock=ScriptClock())
    labels = [t["candidate"] for t in rep["trials"]]
    assert labels[0] == "xla" and all(t["ok"] for t in rep["trials"])
    # tile_y: the picked tile (18, the grid) and its half
    assert labels[1:] == ["pipeline/ty9", "pipeline/ty18"]
    assert rep["shape_class"] == "18x18/order2/k1"
    p = SimParams(nx=16, ny=16, order=2, iters=2)
    trace.clear_events()
    res = run_heat_resilient(make_initial_grid(p, device="cpu"), 2, 2,
                             p.xcfl, p.ycfl, p.bc)
    assert trace.events("tune-hit") and res.rung == "pipeline"


def test_crossover_space_times_both_sides():
    rep = tune.run("segmented_scan", n=4096, runs=1, device="cpu",
                   persist=False, clock=ScriptClock())
    assert [t["candidate"] for t in rep["trials"]] == \
        ["thr16384/flat", "thr65536/flat", "thr262144/flat"]
    rep = tune.run("segmented_scan", n=1 << 16, runs=1, device="cpu",
                   persist=False, clock=ScriptClock(),
                   thresholds=(1 << 14, 1 << 18))
    assert [t["candidate"] for t in rep["trials"]] == \
        ["thr16384/blocked", "thr262144/flat"]
    assert trace.events("conformance-probe")[-1]["ok"]


# ---------------------------------------------------------------- the CLI

def test_cli_run_show_clear(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "tune.json"))
    assert tune_cli.main(["run", "--op", "heat", "--gy", "12", "--gx", "12",
                          "--heat-iters", "2", "--runs", "1",
                          "--device=cpu", "--json"]) == 0
    (rep,) = json.loads(capsys.readouterr().out)
    assert rep["op"] == "heat" and rep["device"] == "cpu"
    assert tune_cli.main(["show"]) == 0
    out = capsys.readouterr().out
    assert "1 cached winner(s)" in out and "14x14/order2/k1" in out
    assert tune_cli.main(["show", "--json"]) == 0
    assert list(json.loads(capsys.readouterr().out)) == \
        ["cpu|heat|14x14/order2/k1|float32"]
    assert tune_cli.main(["clear"]) == 0
    assert "cleared 1" in capsys.readouterr().out
    assert tune_cli.main(["run", "--op", "serve.stub", "--runs", "1",
                          "--max-batch", "2", "--device=cpu",
                          "--dry-run"]) == 0
    assert "serve.stub [n1024/float32] on cpu: winner" in \
        capsys.readouterr().out


def test_cli_module_entry_dry_run(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               CME213_TUNE_CACHE=str(tmp_path / "tune.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "cme213_tpu_torch", "tune", "run", "--op",
         "spmv_scan", "--n", "2048", "--iters", "2", "--runs", "1",
         "--device=cpu", "--dry-run"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "spmv_scan [n2048/float32] on cpu: winner" in proc.stdout
    assert "winners NOT persisted" in proc.stdout
    assert not (tmp_path / "tune.json").exists()
