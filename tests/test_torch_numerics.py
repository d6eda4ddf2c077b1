"""The port's numeric-health module against the JAX package's: seeded
shadow sampling, the drift measure, the drift budget, output sentinels,
the convergence tracker and the residuals fed from solver states.

Counterpart of the cases of ``tests/test_numerics.py`` that need no
serving layer.  Every case gives both packages the same inputs (numpy
arrays and residual sequences made from a seed) and compares exactly:
sample membership, (rel_l2, max_ulps), budget transitions and their
events, the tracker's ``solver-progress`` events and STALLED verdicts.
The port takes tensors too; a tensor input must give its array's result.
The checkpointed heat solve's residuals are held to the JAX package's at
rel 1e-4 (the two grids are within ULP-10 of each other).
"""

import numpy as np
import pytest
import torch

from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import numerics as jnum
from cme213_tpu.core import trace as jtrace
from cme213_tpu_torch.core import metrics as tmetrics
from cme213_tpu_torch.core import numerics as tnum
from cme213_tpu_torch.core import trace as ttrace
from cme213_tpu_torch.core.resilience import FailureKind

SIDES = {"jax": (jnum, jtrace, jmetrics), "torch": (tnum, ttrace, tmetrics)}


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in (tnum.SHADOW_RATE_ENV, tnum.SHADOW_REL_L2_ENV,
                tnum.SHADOW_MAX_ULPS_ENV, tnum.DRIFT_BUDGET_ENV,
                "CME213_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    for num, trace, metrics in SIDES.values():
        num.reset()
        trace.clear_events()
        metrics.reset()
    yield
    for num, trace, metrics in SIDES.values():
        num.reset()
        trace.clear_events()
        metrics.reset()


def _records(trace, event=None):
    return [{k: v for k, v in r.items() if k not in ("t", "pid", "trace")}
            for r in trace.events(event)]


# -------------------------------------------------- seeded sampling

@pytest.mark.parametrize("rate", [0, 1, 2, 4, 7])
@pytest.mark.parametrize("trace_id", ["T", "U", "gang-42"])
def test_should_sample_equals_reference(rate, trace_id):
    rids = [str(i) for i in range(400)]
    port = [tnum.should_sample(r, rate=rate, trace=trace_id) for r in rids]
    ref = [jnum.should_sample(r, rate=rate, trace=trace_id) for r in rids]
    assert port == ref
    if 1 < rate:
        assert 0 < sum(port) < len(rids)  # a sample, not all or none


def test_should_sample_is_keyed_by_trace():
    rids = [str(i) for i in range(400)]
    a = {r for r in rids if tnum.should_sample(r, rate=4, trace="T")}
    b = {r for r in rids if tnum.should_sample(r, rate=4, trace="U")}
    assert a != b


@pytest.mark.parametrize("raw,want", [(None, 0), ("8", 8), ("junk", 0),
                                      ("-3", 0), ("1", 1), (" ", 0)])
def test_shadow_rate_env_parsing(monkeypatch, raw, want):
    if raw is not None:
        monkeypatch.setenv(tnum.SHADOW_RATE_ENV, raw)
    assert tnum.shadow_rate() == jnum.shadow_rate() == want


# ------------------------------------------------------ drift measure

def _drift_cases():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(64).astype(np.float32)
    return [
        (a, a),
        (a * np.float32(1.001), a),
        (np.nextafter(a, np.float32(np.inf)), a),
        (np.ones(4, np.float32), np.ones(5, np.float32)),
        (np.array([np.nan], np.float32), np.array([1.0], np.float32)),
        (np.arange(4), np.arange(4)),
        (np.arange(4) + 1, np.arange(4)),
        (a.astype(np.float64), a),
        (rng.standard_normal((3, 5)), rng.standard_normal((3, 5))),
        (np.zeros(0, np.float32), np.zeros(0, np.float32)),
    ]


@pytest.mark.parametrize("case", range(10))
def test_measure_drift_equals_reference(case):
    out, ref = _drift_cases()[case]
    want = jnum.measure_drift(out, ref)
    assert tnum.measure_drift(out, ref) == want
    assert tnum.measure_drift(torch.from_numpy(np.array(out)),
                              torch.from_numpy(np.array(ref))) == want


# ------------------------------------------------------- error budget

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_budget_transitions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    overs = rng.random(120) < np.repeat([0.05, 0.9, 0.0, 0.6], 30)
    states = {}
    for side, (num, trace, _) in SIDES.items():
        b = num.DriftBudget(target=0.1, short_n=4, long_n=8, min_samples=4,
                            burn_threshold=2.0, hysteresis=0.5)
        states[side] = [b.observe("op", "r", bool(o), rel_l2=0.5)
                        for o in overs]
        states[side].append(b.state())
    assert states["torch"] == states["jax"]
    for event in ("drift-budget-burn", "drift-budget-ok"):
        assert _records(ttrace, event) == _records(jtrace, event)
    assert _records(ttrace, "drift-budget-burn")


def test_budget_burns_after_sustained_over_and_recovers():
    b = tnum.DriftBudget(target=0.1, short_n=4, long_n=8, min_samples=4,
                         burn_threshold=2.0, hysteresis=0.5)
    for _ in range(4):
        burning = b.observe("op", "r", True, rel_l2=0.5)
    assert burning and b.burning("op", "r")
    assert len(ttrace.events("drift-budget-burn")) == 1
    for _ in range(4):
        burning = b.observe("op", "r", False)
    assert not burning and not b.burning("op", "r")
    st = b.state()["op|r"]
    assert st["samples"] == 8 and st["over"] == 4


def test_budget_needs_min_samples():
    b = tnum.DriftBudget(target=0.1, short_n=4, long_n=8, min_samples=6)
    for _ in range(5):
        assert not b.observe("op", "r", True)
    assert b.observe("op", "r", True)


@pytest.mark.parametrize("target", [0.0, -1.0])
def test_budget_rejects_nonpositive_target(target):
    for num, _, _ in SIDES.values():
        with pytest.raises(ValueError):
            num.DriftBudget(target=target)


def test_shadow_compare_equals_reference(monkeypatch):
    """Sampled batches, some drifting: the summaries, the demotion and the
    ``numeric-drift`` events equal the JAX package's."""
    monkeypatch.setenv(tnum.DRIFT_BUDGET_ENV, "0.1")
    rng = np.random.default_rng(3)
    ref = [rng.standard_normal(16).astype(np.float32) for _ in range(2)]
    batches = [[r * np.float32(1 + (0.01 if i % 3 else 0)) for r in ref]
               for i in range(20)]
    seen = {}
    for side, (num, trace, _) in SIDES.items():
        seen[side] = [num.shadow_compare("spmv_scan", "blocked", "n16",
                                         outs, ref) for outs in batches]
        seen[side].append(num.last_drift())
    assert seen["torch"] == seen["jax"]
    assert _records(ttrace, "numeric-drift") == \
        _records(jtrace, "numeric-drift")
    assert tnum.demoted("spmv_scan", "blocked")


# ---------------------------------------------------------- sentinels

class _SpyBreaker:
    def __init__(self):
        self.calls = []

    def record_failure(self, op, rung, kind):
        self.calls.append((op, rung, kind))


@pytest.mark.parametrize("outputs,lo,hi", [
    ([np.array([1.0, np.nan, np.inf], np.float32)], None, None),
    ([np.array([0.5, 2.0], np.float32)], 0.0, 1.0),
    ([np.ones(16, np.float32)], 0.0, 2.0),
    ([np.arange(8, dtype=np.uint8)], None, None),
    ([np.array([np.nan, 3.0, -1.0]), np.array([0.2], np.float32)], 0.0,
     1.0),
])
def test_sentinel_equals_reference(outputs, lo, hi):
    br = _SpyBreaker()
    bad = tnum.sentinel("serve.echo", "fast", outputs, lo=lo, hi=hi,
                        breaker=br)
    assert bad == jnum.sentinel("serve.echo", "fast", outputs, lo=lo, hi=hi)
    assert tnum.sentinel("serve.echo", "fast",
                         [torch.from_numpy(o) for o in outputs],
                         lo=lo, hi=hi) == bad
    assert _records(ttrace, "numeric-sentinel")[:1] == \
        _records(jtrace, "numeric-sentinel")
    assert br.calls == ([("serve.echo", "fast", FailureKind.NUMERIC)]
                        if bad else [])


# --------------------------------------------------------- convergence

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("stall_epochs", [1, 3, 5])
def test_tracker_events_and_verdicts_equal_reference(seed, stall_epochs):
    rng = np.random.default_rng(seed)
    residuals = np.concatenate([np.geomspace(1.0, 1e-3, 6),
                                np.full(6, 1e-3) * (1 + 1e-5
                                                   * rng.random(6)),
                                rng.random(8)])
    verdicts = {}
    for side, (num, trace, _) in SIDES.items():
        tr = num.ConvergenceTracker("solve", stall_epochs=stall_epochs,
                                    job="j1" if seed % 2 else None)
        verdicts[side] = []
        for step, r in enumerate(residuals):
            tr.step(step, r, r * 2, 10.0 + step)
            verdicts[side].append((tr.stalled, tr.since_improve, tr.best))
    assert verdicts["torch"] == verdicts["jax"]
    assert _records(ttrace, "solver-progress") == \
        _records(jtrace, "solver-progress")
    assert tmetrics.snapshot()["gauges"] == jmetrics.snapshot()["gauges"]


def test_convergence_tracker_stall_verdict():
    tr = tnum.ConvergenceTracker("solve", stall_epochs=3)
    for step, res in enumerate((1.0, 0.5, 0.25)):
        tr.step(step, res, res, 10.0)
    assert not tr.stalled
    for step in range(3, 6):
        tr.step(step, 0.25, 0.0, 10.0)
    assert tr.stalled
    tr.step(6, 0.1, 0.15, 10.0)
    assert not tr.stalled


@pytest.mark.parametrize("kind", ["numpy", "tensor", "nested"])
def test_progress_from_states_equals_reference(kind):
    rng = np.random.default_rng(5)
    old = rng.standard_normal((6, 5)).astype(np.float32)
    new = old * np.float32(1.5) + rng.standard_normal((6, 5)).astype(
        np.float32) * np.float32(1e-3)
    trs = {side: num.ConvergenceTracker("solve")
           for side, (num, _, _) in SIDES.items()}
    jnum.progress_from_states(trs["jax"], 3, old, new, iters=4,
                              elapsed_s=2.0)
    if kind == "numpy":
        args = (old, new)
    elif kind == "tensor":
        args = (torch.from_numpy(old), torch.from_numpy(new))
    else:  # the first float leaf by sorted key: "grid" before "step"
        args = ({"step": np.int64(3), "grid": torch.from_numpy(old)},
                {"step": np.int64(4), "grid": torch.from_numpy(new)})
    tnum.progress_from_states(trs["torch"], 3, *args, iters=4,
                              elapsed_s=2.0)
    assert _records(ttrace, "solver-progress") == \
        _records(jtrace, "solver-progress")
    assert trs["torch"].last_residual == trs["jax"].last_residual


def test_progress_skips_mismatched_shapes_and_non_float_states():
    tr = tnum.ConvergenceTracker("solve")
    tnum.progress_from_states(tr, 4, np.ones(3), np.ones(5), 1, 1.0)
    tnum.progress_from_states(tr, 5, np.arange(3), np.arange(3), 1, 1.0)
    assert not ttrace.events("solver-progress")


@pytest.mark.parametrize("state", [
    {"b": np.arange(3), "a": [np.ones(2, np.float32), 1.5]},
    (np.int32(4), {"z": np.zeros(2), "y": None}),
    [None, np.arange(2), (np.float64(2.0),)],
])
def test_first_float_leaf_equals_reference(state):
    want = jnum._first_float_leaf(state)
    got = tnum._first_float_leaf(state)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    snap = tnum.state_snapshot(state)
    np.testing.assert_array_equal(snap, want)


def test_checkpointed_heat_emits_progress_like_reference(tmp_path):
    """One ``solver-progress`` event a chunk, at the JAX package's steps;
    residuals within rel 1e-4 of its own (the grids agree to ULP-10)."""
    from cme213_tpu.apps.heat2d import run_heat_checkpointed as j_run
    from cme213_tpu.config import SimParams as JSimParams
    from cme213_tpu_torch.apps.heat2d import run_heat_checkpointed as t_run
    from cme213_tpu_torch.config import SimParams

    t_run(SimParams(nx=16, ny=16, order=2, iters=6),
          str(tmp_path / "t"), every=2, device="cpu")
    j_run(JSimParams(nx=16, ny=16, order=2, iters=6),
          str(tmp_path / "j"), every=2)
    tev = [e for e in ttrace.events("solver-progress")
           if e["op"] == "heat2d"]
    jev = [e for e in jtrace.events("solver-progress")
           if e["op"] == "heat2d"]
    assert len(tev) == len(jev) == 3
    assert [e["step"] for e in tev] == [e["step"] for e in jev] == [2, 4, 6]
    for te, je in zip(tev, jev):
        assert te["residual"] == pytest.approx(je["residual"], rel=1e-4)
        assert te["delta_norm"] == pytest.approx(je["delta_norm"], rel=1e-4)


def test_last_drift_empty_until_sampled():
    assert tnum.last_drift() == jnum.last_drift() == {}
    tnum.budget().observe("op", "r", False)
    jnum.budget().observe("op", "r", False)
    assert tnum.last_drift() == jnum.last_drift() != {}
