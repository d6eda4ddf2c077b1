"""The port's checkpoint layer against the JAX package's: the file format,
the CRC, quarantine and ``.prev`` fallback, nested states, and
``run_with_checkpoints`` with resume, rollback, the retry budget and the
chunk halving.

Counterpart of the checkpoint cases of ``tests/test_resilience.py`` and
``tests/test_aux_subsystems.py``.  Each case runs in both packages on the
same inputs (numpy arrays made from a seed) and compares exactly: the CRCs
and the saved arrays bit for bit, the loaded steps, the events of the
solve.  Bare-array files are exchanged between the packages; a nested
state's skeleton is each package's own (JSON here, a pickled JAX
``PyTreeDef`` there), so the port refuses a JAX-written nested file by
name and does not quarantine it.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from cme213_tpu.core import checkpoint as jckpt
from cme213_tpu.core import faults as jfaults
from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import resilience as jres
from cme213_tpu.core import trace as jtrace
from cme213_tpu_torch.core import checkpoint as tckpt
from cme213_tpu_torch.core import faults as tfaults
from cme213_tpu_torch.core import flight
from cme213_tpu_torch.core import metrics as tmetrics
from cme213_tpu_torch.core import resilience as tres
from cme213_tpu_torch.core import trace as ttrace
from cme213_tpu_torch.core.errors import FrameworkError

SIDES = {"jax": (jckpt, jfaults, jres, jtrace),
         "torch": (tckpt, tfaults, tres, ttrace)}


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in ("CME213_FAULTS", "CME213_INCARNATION", "CME213_FLIGHT_DIR"):
        monkeypatch.delenv(var, raising=False)
    flight._uninstall_for_tests()  # an abort dumps only when asked to
    for _, faults, _, trace in SIDES.values():
        faults.reset()
        trace.clear_events()
    jmetrics.reset()
    tmetrics.reset()
    yield
    for _, faults, _, trace in SIDES.values():
        faults.reset()
        trace.clear_events()


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"state": rng.standard_normal((5, 7)).astype(np.float32),
            "extra": rng.integers(0, 100, 9, dtype=np.int64)}


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        return fn(*a, **kw), [str(x.message) for x in w]


def _solve_events(trace):
    """The solve's events, spans left out (the port's guard runs inside
    the chunk span, so numeric-abort is recorded before the span's end)."""
    keep = ("checkpoint-rollback", "numeric-abort", "chunk-shrunk",
            "checkpoint-quarantine", "fault-injected", "solver-progress")
    drop = ("t", "pid", "trace", "iters_per_s", "residual", "delta_norm",
            "path", "quarantined_to")
    return [{k: v for k, v in e.items() if k not in drop}
            for e in trace.events() if e["event"] in keep]


# ------------------------------------------------------------- the format

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("step", [0, 7, 123456789])
def test_payload_crc_equals_reference(seed, step):
    arrays = _arrays(seed)
    arrays["f64"] = np.linspace(-1, 1, 11)
    arrays["u8"] = np.arange(6, dtype=np.uint8).reshape(2, 3)
    assert tckpt._payload_crc(step, arrays) == jckpt._payload_crc(step,
                                                                  arrays)


def test_crc_of_a_tensor_is_its_array_s(tmp_path):
    arrays = _arrays(3)
    p = str(tmp_path / "t.npz")
    crc = tckpt.save_checkpoint(p, 4, state=torch.from_numpy(
        arrays["state"]), extra=arrays["extra"])
    assert crc == jckpt._payload_crc(4, arrays)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_bare_array_file_loads_across_packages(tmp_path, writer, reader):
    arrays = _arrays(4)
    p = str(tmp_path / "ck.npz")
    crc = SIDES[writer][0].save_checkpoint(p, 9, **arrays)
    step, loaded = SIDES[reader][0].load_checkpoint(p)
    assert step == 9
    assert set(loaded) == set(arrays)
    for k, v in arrays.items():
        assert loaded[k].dtype == v.dtype
        np.testing.assert_array_equal(loaded[k], v)
    assert SIDES[reader][0].read_checkpoint(p, expect_crc=crc)[2] == crc


def test_files_are_byte_identical(tmp_path):
    """np.savez of the same names in the same order: the two packages
    write the same bytes but for the zip's timestamps, so the arrays read
    back bit for bit and the payload CRCs agree."""
    arrays = _arrays(5)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jckpt.save_checkpoint(pj, 2, **arrays) == \
        tckpt.save_checkpoint(pt, 2, **arrays)
    with np.load(pj) as zj, np.load(pt) as zt:
        assert zj.files == zt.files
        for k in zj.files:
            assert zj[k].tobytes() == zt[k].tobytes()


def test_bare_state_checkpoint_loads_across_packages(tmp_path):
    u = np.random.default_rng(6).standard_normal((4, 6)).astype(np.float32)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_state_checkpoint(pj, 3, u)
    tckpt.save_state_checkpoint(pt, 3, torch.from_numpy(u))
    for p in (pj, pt):
        for mod in (jckpt, tckpt):
            step, arrays = mod.load_checkpoint(p)
            assert step == 3
            np.testing.assert_array_equal(mod._unflatten_state(arrays), u)


def test_jax_nested_file_raises_foreign_layout_and_is_kept(tmp_path):
    p = str(tmp_path / "nested.npz")
    state = {"grid": np.ones((2, 3), np.float32), "halo": (np.arange(3),)}
    jckpt.save_state_checkpoint(p, 5, state)
    step, arrays = tckpt.load_checkpoint(p)  # the file itself is sound
    assert step == 5
    with pytest.raises(FrameworkError, match="foreign layout"):
        tckpt._unflatten_state(arrays)
    with pytest.raises(FrameworkError, match="foreign layout"):
        tckpt.run_with_checkpoints(lambda s, k: s, state, 10, p, every=5)
    assert os.path.exists(p) and not os.path.exists(p + tckpt.CORRUPT_SUFFIX)
    assert not ttrace.events("checkpoint-quarantine")


def test_nested_state_leaves_in_the_reference_order(tmp_path):
    """Dicts flatten by sorted key, as JAX's tree flatten does, so the
    ``__leaf<i>`` arrays are the JAX package's (only the skeleton
    differs)."""
    rng = np.random.default_rng(7)
    state = {"zeta": rng.standard_normal(3),
             "alpha": [rng.standard_normal(2), (np.arange(4), 2.5)],
             "mid": {"b": np.ones(2, np.float32), "a": np.zeros(1)}}
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_state_checkpoint(pj, 1, state)
    tckpt.save_state_checkpoint(pt, 1, state)
    _, aj = jckpt.load_checkpoint(pj)
    _, at = tckpt.load_checkpoint(pt)
    leaves = sorted(k for k in aj if k.startswith("__leaf"))
    assert leaves == sorted(k for k in at if k.startswith("__leaf"))
    for k in leaves:
        assert aj[k].dtype == at[k].dtype
        np.testing.assert_array_equal(aj[k], at[k])
    restored = tckpt._unflatten_state(at)
    assert list(restored) == sorted(state)
    assert isinstance(restored["alpha"], list)
    assert isinstance(restored["alpha"][1], tuple)
    np.testing.assert_array_equal(restored["alpha"][1][0], np.arange(4))
    assert float(restored["alpha"][1][1]) == 2.5
    np.testing.assert_array_equal(restored["mid"]["b"], state["mid"]["b"])


def test_tensor_state_round_trips_as_host_arrays(tmp_path):
    p = str(tmp_path / "ck.npz")
    g = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tckpt.save_state_checkpoint(p, 2, {"grid": g, "halo": (g[0],)})
    step, arrays = tckpt.load_checkpoint(p)
    restored = tckpt._unflatten_state(arrays)
    assert step == 2 and isinstance(restored["grid"], np.ndarray)
    np.testing.assert_array_equal(restored["grid"], g.numpy())
    np.testing.assert_array_equal(restored["halo"][0], g[0].numpy())


# ----------------------------------------------- quarantine and fallback

@pytest.mark.parametrize("side", SIDES)
def test_checkpoint_roundtrip(tmp_path, side):
    mod = SIDES[side][0]
    p = str(tmp_path / "ck.npz")
    mod.save_checkpoint(p, 7, state=np.arange(10.0), extra=np.ones(3))
    step, arrays = mod.load_checkpoint(p)
    assert step == 7
    np.testing.assert_array_equal(arrays["state"], np.arange(10.0))
    np.testing.assert_array_equal(arrays["extra"], np.ones(3))
    assert mod.load_checkpoint(str(tmp_path / "missing.npz")) is None


@pytest.mark.parametrize("side", SIDES)
def test_checkpoint_corrupt_quarantine(tmp_path, side):
    mod, _, _, trace = SIDES[side]
    p = str(tmp_path / "ck.npz")
    mod.save_checkpoint(p, 3, state=np.arange(6.0))
    data = open(p, "rb").read()
    open(p, "wb").write(data[: len(data) // 2])  # a torn write
    loaded, msgs = _quiet(mod.load_checkpoint, p)
    assert loaded is None
    assert os.path.exists(p + mod.CORRUPT_SUFFIX) and not os.path.exists(p)
    assert any("quarantined" in m for m in msgs)
    assert trace.events("checkpoint-quarantine")[-1]["path"] == p


def test_quarantine_events_equal_reference(tmp_path):
    seen = {}
    for side, (mod, _, _, trace) in SIDES.items():
        p = str(tmp_path / f"{side}.npz")
        np.savez(p, a=np.arange(3))  # foreign: no __step
        _quiet(mod.load_checkpoint, p)
        seen[side] = [{k: ev[k] for k in ("error", "message")}
                      for ev in trace.events("checkpoint-quarantine")]
        assert os.path.exists(p + mod.CORRUPT_SUFFIX)
    assert seen["torch"] == seen["jax"] != []


@pytest.mark.parametrize("side", SIDES)
def test_checkpoint_checksum_mismatch_falls_back_to_prev(tmp_path, side):
    mod = SIDES[side][0]
    p = str(tmp_path / "ck.npz")
    mod.save_checkpoint(p, 1, state=np.arange(4.0))
    mod.save_checkpoint(p, 2, state=np.arange(4.0) + 1)
    assert os.path.exists(p + mod.PREV_SUFFIX)
    with np.load(p) as z:
        step, crc = int(z["__step"]), z["__crc"]
        arr = z["state"]
    np.savez(p, __step=np.int64(step), __crc=crc, state=arr + 100.0)
    loaded, msgs = _quiet(mod.load_checkpoint, p)
    step, arrays = loaded
    assert step == 1  # recovered from .prev
    np.testing.assert_array_equal(arrays["state"], np.arange(4.0))
    assert any("checksum" in m for m in msgs)


@pytest.mark.parametrize("side", SIDES)
def test_checkpoint_injected_truncation_recovers(tmp_path, side):
    mod, faults, _, _ = SIDES[side]
    p = str(tmp_path / "ck.npz")
    with faults.injected("ckpt:truncate:2"):
        mod.save_checkpoint(p, 1, state=np.zeros(3))
        mod.save_checkpoint(p, 2, state=np.ones(3))  # this write is torn
    (step, arrays), _ = _quiet(mod.load_checkpoint, p)
    assert step == 1
    np.testing.assert_array_equal(arrays["state"], np.zeros(3))


# ------------------------------------------------------ run_with_checkpoints

@pytest.mark.parametrize("side", SIDES)
def test_run_with_checkpoints_resume(tmp_path, side):
    mod = SIDES[side][0]
    p = str(tmp_path / "run.npz")
    calls = []

    def step(state, k):
        calls.append(k)
        return state + k

    out = mod.run_with_checkpoints(step, np.zeros(4), 10, p, every=3)
    np.testing.assert_array_equal(out, np.full(4, 10.0))
    assert calls == [3, 3, 3, 1]
    calls.clear()
    out2 = mod.run_with_checkpoints(step, np.zeros(4), 10, p, every=3)
    np.testing.assert_array_equal(out2, np.full(4, 10.0))
    assert calls == []  # resumed from the final checkpoint


@pytest.mark.parametrize("side", SIDES)
def test_run_with_checkpoints_pytree_resume(tmp_path, side):
    mod = SIDES[side][0]
    p = str(tmp_path / "run.npz")
    calls = []

    def step(state, k):
        calls.append(k)
        return {"grid": state["grid"] + k, "halo": state["halo"] * 1}

    init = {"grid": np.zeros(4), "halo": np.arange(2)}
    out = mod.run_with_checkpoints(step, init, 10, p, every=3)
    np.testing.assert_array_equal(out["grid"], np.full(4, 10.0))
    assert calls == [3, 3, 3, 1]
    calls.clear()
    out2 = mod.run_with_checkpoints(step, init, 10, p, every=3)
    np.testing.assert_array_equal(out2["grid"], np.full(4, 10.0))
    np.testing.assert_array_equal(out2["halo"], np.arange(2))
    assert calls == []


def test_tensor_state_resumes_on_its_device(tmp_path):
    """A tensor state restored from a checkpoint comes back as numpy; the
    step moves it to its device, as a runner's step does."""
    p = str(tmp_path / "run.npz")
    seen = []

    def step(state, k):
        t = torch.as_tensor(state).to("cpu")
        seen.append(type(state).__name__)
        return t + k

    out = tckpt.run_with_checkpoints(step, torch.zeros(3), 4, p, every=2)
    assert torch.equal(out, torch.full((3,), 4.0)) and seen == ["Tensor"] * 2
    out = tckpt.run_with_checkpoints(step, torch.zeros(3), 6, p, every=2)
    assert seen[2:] == ["ndarray"]
    assert torch.equal(out, torch.full((3,), 6.0))


@pytest.mark.parametrize("spec", ["nan:solve:2", "nan:solve:1",
                                  "nan:solve:3"])
def test_run_with_checkpoints_nan_rollback_equals_reference(tmp_path, spec):
    """``nan:`` rollback: the result equals the clean run bit for bit, and
    the events (rollbacks, aborts, progress steps) equal the JAX
    package's."""
    x0 = np.random.default_rng(8).standard_normal(5)
    outs, evs = {}, {}
    for side, (mod, faults, res, trace) in SIDES.items():
        with faults.injected(spec):
            outs[side] = mod.run_with_checkpoints(
                lambda s, k: s * 1.5 + k, x0, 10,
                str(tmp_path / f"{side}.npz"), every=3,
                guard=res.all_finite, op="solve")
        evs[side] = _solve_events(trace)
        clean = mod.run_with_checkpoints(
            lambda s, k: s * 1.5 + k, x0, 10, str(tmp_path / f"{side}c.npz"),
            every=3, guard=res.all_finite, op="clean")
        np.testing.assert_array_equal(outs[side], clean)
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    assert evs["torch"] == evs["jax"]
    assert any(e["event"] == "checkpoint-rollback" for e in evs["torch"])


@pytest.mark.parametrize("side", SIDES)
def test_run_with_checkpoints_retry_budget(tmp_path, side):
    mod, faults, res, _ = SIDES[side]
    with faults.injected("nan:solve,nan:solve:2,nan:solve:3"):
        with pytest.raises(res.NonFiniteError):
            mod.run_with_checkpoints(lambda s, k: s + k, np.zeros(3), 6,
                                     str(tmp_path / "a.npz"), every=2,
                                     guard=res.all_finite, op="solve",
                                     max_retries=1)


@pytest.mark.parametrize("every,spec", [(4, "oom:solve_chunk:1"),
                                        (8, "oom:solve_chunk:1:2"),
                                        (5, "oom:solve_chunk:3")])
def test_injected_oom_halves_the_chunk_like_reference(tmp_path, every, spec):
    x0 = np.random.default_rng(9).standard_normal(4)
    outs, evs = {}, {}
    for side, (mod, faults, res, trace) in SIDES.items():
        with faults.injected(spec):
            outs[side] = mod.run_with_checkpoints(
                lambda s, k: s * 0.5 + k, x0, 12,
                str(tmp_path / f"{side}.npz"), every=every,
                guard=res.all_finite, op="solve")
        evs[side] = _solve_events(trace)
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    assert evs["torch"] == evs["jax"]
    assert [e for e in evs["torch"] if e["event"] == "chunk-shrunk"]


def test_real_out_of_memory_is_not_halved(tmp_path):
    """The allocator's own out-of-memory re-raises at once: an eager chunk
    holds the same buffers at any length."""
    calls = []

    def step(state, k):
        calls.append(k)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        tckpt.run_with_checkpoints(step, np.zeros(2), 8,
                                   str(tmp_path / "a.npz"), every=4,
                                   guard=tres.all_finite, op="solve")
    assert calls == [4] and not ttrace.events("chunk-shrunk")


def test_other_resource_failure_is_halved(tmp_path):
    calls = []

    def step(state, k):
        calls.append(k)
        if len(calls) == 1:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory in a "
                               "device allocation")
        return state + k

    out = tckpt.run_with_checkpoints(step, np.zeros(2), 8,
                                     str(tmp_path / "a.npz"), every=4,
                                     guard=tres.all_finite, op="solve")
    np.testing.assert_array_equal(out, np.full(2, 8.0))
    assert calls == [4, 2, 2, 2, 2]


def test_guard_runs_inside_the_chunk_span(tmp_path):
    seen = []

    def guard(state):
        seen.append([s["span"] for s in ttrace.events("span-begin")
                     if not any(e["id"] == s["id"]
                                for e in ttrace.events("span-end"))])
        return True

    tckpt.run_with_checkpoints(lambda s, k: s + k, np.zeros(2), 4,
                               str(tmp_path / "a.npz"), every=2, guard=guard)
    assert seen and all(open_ == ["checkpoint.chunk"] for open_ in seen)
