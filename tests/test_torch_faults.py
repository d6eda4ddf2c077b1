"""The port's fault plan against the JAX package's: the clause grammar, the
firing windows, and the value guards on tensors.

The same specs and call sequences go to ``cme213_tpu.core.faults`` and to
``cme213_tpu_torch.core.faults``.  Each package keeps its own plan, so each
is installed through its own ``install``/``injected``; ``CME213_FAULTS`` is
never left set.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from cme213_tpu.core import faults as jfaults
from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import trace as jtrace
from cme213_tpu_torch.core import faults as tfaults
from cme213_tpu_torch.core import flight as tflight
from cme213_tpu_torch.core import metrics as tmetrics
from cme213_tpu_torch.core import trace as ttrace

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = sorted((ROOT / "tests" / "chaos_fixtures").glob("*.json"))
PAIRS = ((jfaults, jtrace, jmetrics), (tfaults, ttrace, tmetrics))

#: the specs of ``tests/test_resilience.py`` and ``tests/test_diag.py``, and
#: one of every clause kind with and without its optional fields
SPECS = [
    "fail:op.a:2:3, nan:solve, ckpt:truncate:4, rankkill:1:5",
    "fail:op.x:2:2",
    "nan:solve:2",
    "fail:rt.a",
    "stage:diagop.fancy:lower:1",
    "stage:diagop.fancy:compile:1",
    "stage:diagop.fancy:execute:1",
    "stage:diagop.fancy:conformance:1",
    "unreachable:1",
    "unreachable:2:3",
    "slow:serve.sort",
    "slow:serve.sort:20:2:4",
    "drift:spmv",
    "drift:spmv:0.5:3",
    "wrong:heat.pipeline:2,oom:heat:3",
    "ckpt:commit,ckpt:truncate:2",
    "replica-kill:1:4,rankkill:0",
    "fail:sweep.heat_bandwidth:1:2",
    "",
    " , ",
]

BAD = ["explode:x", "fail", "ckpt:corrupt", "fail:op:notanint",
       "stage:op:sideways", "stage:op", "slow:op:-1", "drift:op:0",
       "drift:op:-0.1", "unreachable:x", "nan:op:1.5", "rankkill:0:z"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("CME213_FAULTS", "CME213_INCARNATION", "RANK",
                "JAX_PROCESS_ID", "CME213_TRACE_FILE"):
        monkeypatch.delenv(var, raising=False)
    for faults, trace, metrics in PAIRS:
        faults.reset()
        trace.clear_events()
        metrics.reset()
    yield
    for faults, trace, metrics in PAIRS:
        faults.reset()
        trace.clear_events()
        metrics.reset()
    # run_all.main arms the port's flight recorder for the process
    tflight._uninstall_for_tests()


def _fixture_specs():
    out = []
    for path in FIXTURES:
        doc = json.loads(path.read_text())
        for key in ("cocktail", "minimal_cocktail"):
            if doc.get(key):
                out.append(pytest.param(doc[key], id=f"{path.stem}-{key}"))
    return out


@pytest.mark.parametrize("spec", _fixture_specs() + SPECS)
def test_spec_round_trips_like_the_reference(spec):
    a, b = tfaults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert str(a) == str(b)
    assert [str(c) for c in a.clauses] == [str(c) for c in b.clauses]
    assert str(tfaults.FaultPlan.parse(str(a))) == str(a)


@pytest.mark.parametrize("bad", BAD)
def test_bad_specs_raise_in_both(bad):
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.FaultPlan.parse(bad)
    with pytest.raises(tfaults.FaultSpecError):
        tfaults.FaultPlan.parse(bad)


def test_spec_from_the_environment(monkeypatch):
    monkeypatch.setenv("CME213_FAULTS", "fail:op.env:2")
    assert str(tfaults.active()) == str(jfaults.active()) == "fail:op.env:2:1"
    tfaults.maybe_fail("op.env")
    with pytest.raises(tfaults.InjectedFault):
        tfaults.maybe_fail("op.env")


def _fires(faults, guard, calls: int):
    """What each of ``calls`` consecutive guard calls did: its truth value,
    or the name of the fault it raised."""
    out = []
    for _ in range(calls):
        try:
            r = guard(faults)
            out.append(bool(r))
        except faults.InjectedFault as e:
            out.append(type(e).__name__)
    return out


GUARDS = {
    "fail": ("fail:op.x:2:2,fail:op.y:1",
             lambda f: f.maybe_fail("op.x")),
    "oom": ("oom:op.x:3", lambda f: f.maybe_oom("op.x")),
    "slow": ("slow:op.s:7.5:2:3",
             lambda f: f.maybe_slow("op.s", sleep=lambda s: None)),
    "unreachable": ("unreachable:2:2",
                    lambda f: f.maybe_unreachable("device.preflight")),
    "stage": ("stage:op.k:compile:3:2",
              lambda f: f.maybe_fail_stage("op.k", "compile")),
    "stage-other": ("stage:op.k:compile:1",
                    lambda f: f.maybe_fail_stage("op.k", "execute")),
    "commit": ("ckpt:commit:2",
                      lambda f: f.maybe_fail_commit()),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_windows_fire_on_the_same_calls(name):
    spec, guard = GUARDS[name]
    got = []
    for faults, trace, metrics in PAIRS:
        with faults.injected(spec):
            got.append(_fires(faults, guard, 7))
    assert got[0] == got[1]
    assert any(got[1]) or name == "stage-other"
    recs = [[{k: v for k, v in r.items() if k not in ("t", "pid", "trace")}
             for r in trace.events()] for _, trace, _ in PAIRS]
    assert recs[0] == recs[1]
    assert jmetrics.snapshot()["counters"] == tmetrics.snapshot()["counters"]


@pytest.mark.parametrize("guard", [
    lambda f: f.maybe_oom("op"), lambda f: f.maybe_unreachable(),
    lambda f: f.maybe_slow("op", sleep=lambda s: None),
    lambda f: f.maybe_fail_stage("op", "lower")])
def test_later_incarnations_are_spared(monkeypatch, guard):
    monkeypatch.setenv("CME213_INCARNATION", "1")
    spec = ("oom:op,unreachable:1,slow:op:5,stage:op:lower")
    for faults, _, _ in PAIRS:
        with faults.injected(spec):
            assert not guard(faults)


def test_disabled_plan_is_a_noop():
    state = {"u": torch.ones(3)}
    tfaults.maybe_fail("anything")
    assert tfaults.maybe_poison("anything", state) is state
    assert tfaults.maybe_perturb("anything", state) is state
    assert tfaults.maybe_drift("anything", state) is state
    assert tfaults.maybe_slow("anything") == 0.0
    assert not tfaults.maybe_unreachable()


def test_injected_restores_the_previous_plan():
    outer = tfaults.install("fail:a")
    with tfaults.injected("fail:b") as inner:
        assert tfaults.active() is inner
    assert tfaults.active() is outer


# ------------------------------------------------------------ value guards

def _state(lib):
    """One nested state, as numpy arrays (``lib`` np) or tensors."""
    rng = np.random.default_rng(0)
    leaves = {"halo": rng.integers(0, 9, 5).astype(np.int32),
              "grid": rng.uniform(-2, 2, (3, 4)).astype(np.float32),
              "aux": [rng.uniform(-1, 1, 6), np.arange(4, dtype=np.int64)],
              "b": (rng.uniform(0, 1, 2).astype(np.float32),)}
    if lib is np:
        return leaves

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return torch.from_numpy(x.copy())

    return conv(leaves)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree.numpy() if torch.is_tensor(tree) else tree)]


def _compare(kind, spec, op):
    ref_in, port_in = _state(np), _state(torch)
    before = [t.clone() for t in _flat_tensors(port_in)]
    with jfaults.injected(spec):
        ref = getattr(jfaults, kind)(op, ref_in)
    with tfaults.injected(spec):
        port = getattr(tfaults, kind)(op, port_in)
    for a, b in zip(_flat(ref), _flat(port), strict=True):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for t, t0 in zip(_flat_tensors(port_in), before):  # inputs untouched
        assert torch.equal(t, t0)
    return ref, port, port_in


def _flat_tensors(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat_tensors(v)]
    return [tree]


def test_poison_nan_at_the_reference_s_position():
    ref, port, port_in = _compare("maybe_poison", "nan:solve", "solve")
    nan = [np.isnan(a).any() if a.dtype.kind == "f" else False
           for a in _flat(port)]
    assert nan.count(True) == 1
    # a changed leaf is a clone on the tensor's own device; the others
    # are the caller's tensors
    for t, t0 in zip(_flat_tensors(port), _flat_tensors(port_in)):
        assert t.device == t0.device
        changed = t.dtype.is_floating_point and bool(torch.isnan(t).any())
        assert (t is not t0) == changed
    assert ttrace.events("fault-injected")[0]["leaf"] == \
        jtrace.events("fault-injected")[0]["leaf"]


def test_poison_nth_call_only():
    with tfaults.injected("nan:solve:2"):
        s = {"g": torch.ones(4)}
        assert tfaults.maybe_poison("solve", s) is not None
        assert torch.isfinite(tfaults.maybe_poison("solve", s)["g"]).sum() \
            == 3
        assert torch.isfinite(tfaults.maybe_poison("solve", s)["g"]).all()


def test_perturb_first_float_leaf_like_the_reference():
    _compare("maybe_perturb", "wrong:op", "op")


def test_perturb_flips_an_integer_leaf_without_floats():
    ref_in = {"k": np.arange(5, dtype=np.int32), "j": np.ones(2, np.int64)}
    port_in = {k: torch.from_numpy(v.copy()) for k, v in ref_in.items()}
    with jfaults.injected("wrong:sort"):
        ref = jfaults.maybe_perturb("sort", ref_in)
    with tfaults.injected("wrong:sort"):
        port = tfaults.maybe_perturb("sort", port_in)
    for k in ref_in:
        np.testing.assert_array_equal(ref[k], port[k].numpy())
    assert port["j"][0] == ~1 and port["k"][0] == 0


def test_perturb_numpy_leaves_like_the_reference():
    """A host-side probe (the sort golden gate's candidate is numpy) is
    perturbed as the JAX package perturbs any array: the first float
    leaf, else one integer element's bits; the caller's array untouched."""
    keys = np.arange(7, dtype=np.uint32)
    mixed = {"a": np.arange(3, dtype=np.int64),
             "b": torch.ones(2, dtype=torch.float32)}
    with tfaults.injected("wrong:serve.sort"):
        port = tfaults.maybe_perturb("serve.sort", keys)
    with jfaults.injected("wrong:serve.sort"):
        ref = jfaults.maybe_perturb("serve.sort", keys)
    np.testing.assert_array_equal(port, ref)
    assert port.dtype == np.uint32 and port[0] == np.uint32(~np.uint32(0))
    assert keys[0] == 0
    assert [e["kind"] for e in ttrace.events("fault-injected")][-1] == "wrong"
    with tfaults.injected("wrong:op"):
        out = tfaults.maybe_perturb("op", mixed)
    assert out["b"][0] == 3.0 and out["a"] is mixed["a"]
    floats = np.linspace(1.0, 2.0, 4)
    with tfaults.injected("wrong:op"):
        out = tfaults.maybe_perturb("op", [floats])
    with jfaults.injected("wrong:op"):
        ref = jfaults.maybe_perturb("op", [floats])
    np.testing.assert_array_equal(out[0], ref[0])
    assert floats[0] == 1.0


def test_perturb_a_single_tensor_like_the_reference():
    t = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    with tfaults.injected("wrong:op"):
        out = tfaults.maybe_perturb("op", t)
    with jfaults.injected("wrong:op"):
        ref = jfaults.maybe_perturb("op", t.numpy())
    np.testing.assert_array_equal(out.numpy(), ref)
    assert t[0, 0] == 0


def test_perturb_a_non_contiguous_tensor_at_its_first_element():
    t = torch.arange(12, dtype=torch.float64).reshape(3, 4).t()
    with tfaults.injected("wrong:op"):
        out = tfaults.maybe_perturb("op", t)
    want = t.clone()
    want[0, 0] = 1.0
    assert torch.equal(out, want) and t[0, 0] == 0


def test_drift_scales_every_float_leaf_like_the_reference():
    _compare("maybe_drift", "drift:op:0.001:2", "op")  # call 1: no drift
    _compare("maybe_drift", "drift:op:0.25", "op")


def test_drift_is_persistent_from_nth():
    with tfaults.injected("drift:op:0.5:2"):
        seq = [float(tfaults.maybe_drift("op", torch.ones(1))[0])
               for _ in range(4)]
    assert seq == [1.0, 1.5, 1.5, 1.5]


def test_rank_kill_flushes_the_sink_and_exits(tmp_path):
    """``rankkill`` matches ``RANK`` (the port's rank variable) and exits
    with ``KILL_EXIT`` after closing the trace sink."""
    sink = tmp_path / "t.jsonl"
    code = ("from cme213_tpu_torch.core import faults, trace;"
            "trace.record_event('heartbeat', rank=1, step=0);"
            "faults.maybe_kill_rank(step=0);"
            "faults.maybe_kill_rank(step=1);"
            "print('survived')")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CME213_FAULTS", "CME213_INCARNATION", "RANK")}
    env.update(PYTHONPATH=str(ROOT), CME213_FAULTS="rankkill:1:1",
               CME213_TRACE_FILE=str(sink), RANK="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == tfaults.KILL_EXIT == jfaults.KILL_EXIT
    assert "survived" not in proc.stdout
    events = [json.loads(ln)["event"] for ln in
              sink.read_text().splitlines()]
    assert events == ["heartbeat", "fault-injected"]
    env["RANK"] = "0"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "survived" in proc.stdout


# ----------------------------------------------------- the sweep harness

@pytest.mark.parametrize("spec,rc", [("fail:sweep.scan_bandwidth", 0),
                                     ("fail:sweep.scan_bandwidth:1:2", 1),
                                     ("", 0)])
def test_run_all_fault_hooks_match_reference(tmp_path, spec, rc):
    """``sweep.<name>`` guard, ``sweep-failed``/``sweep-complete`` events
    and the metrics delta in ``metrics.json``, in both harnesses."""
    from cme213_tpu.bench import run_all as jrun_all
    from cme213_tpu_torch.bench import run_all as trun_all

    got = []
    for faults, trace, (main, extra) in (
            (jfaults, jtrace, (jrun_all.main, [])),
            (tfaults, ttrace, (trun_all.main, ["--device=cpu"]))):
        out = tmp_path / faults.__name__.split(".")[0]
        with faults.injected(spec):
            assert main(["--quick", "--out", str(out), "--only",
                         "scan_bandwidth", *extra]) == rc
        manifest = json.loads((out / "failures.json").read_text())
        metrics = json.loads((out / "metrics.json").read_text())
        events = [(e["event"], e.get("sweep"), e.get("attempt"),
                   e.get("error"), e.get("kind"), e.get("op"))
                  for e in trace.events()
                  if e["event"] in ("sweep-failed", "sweep-complete",
                                    "fault-injected")]
        got.append(({k: [(r["sweep"], r["attempt"], r["error"])
                         for r in v] for k, v in manifest.items()},
                    {name: m["metrics"]["counters"]
                     for name, m in metrics.items()},
                    events, (out / "scan_bandwidth.csv").exists()))
    assert got[0] == got[1]
    assert got[1][3] == (rc == 0)
