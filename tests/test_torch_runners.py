"""The port's checkpointed and batched runners against the JAX package's:
``run_heat_checkpointed``, ``run_spmv_scan_checkpointed``,
``run_heat_batched``, ``run_spmv_scan_batched`` and the admission
preflight in front of them.

Counterpart of the checkpointed cases of ``tests/test_fault_injection.py``
and ``tests/test_guarded_execution.py``, the resume case of
``tests/test_apps_drivers.py`` and the preflight cases of
``tests/test_guarded_execution.py``.  Inputs are small (grids of 20²–24²,
n ≤ 5000) and made from a seed with numpy.  Tolerances:

- the port against itself: bit for bit (a resumed, rolled-back or halved
  solve equals the uninterrupted one; every batched lane equals its
  serial solve);
- heat against the JAX package: ULP-10 (XLA:CPU contracts some
  multiply-adds into FMAs; ROADMAP.md);
- SpMV-scan against the JAX package: rel-L2 1e-5 (``blocked`` and
  ``auto`` sum with ``torch.cumsum``), bit for bit with ``flat`` and on
  integer-valued inputs;
- the events of a faulted solve (rollbacks, halvings, progress steps) and
  the admission decisions: equal to the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cme213_tpu.apps import heat2d as j_heat2d
from cme213_tpu.apps import spmv_scan as j_spmv
from cme213_tpu.config import SimParams as JSimParams
from cme213_tpu.core import admission as jadmission
from cme213_tpu.core import faults as jfaults
from cme213_tpu.core import programs as jprograms
from cme213_tpu.core import trace as jtrace
from cme213_tpu_torch.apps import heat2d
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import (admission, faults, flight, metrics,
                                   programs, trace, ulp_distance)
from cme213_tpu_torch.core.checkpoint import run_with_checkpoints
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import run_heat
from cme213_tpu_torch.verify.checkers import relative_l2_error

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in ("CME213_FAULTS", "CME213_INCARNATION", "CME213_TUNE_CACHE",
                "CME213_FLIGHT_DIR", admission.BUDGET_ENV):
        monkeypatch.delenv(var, raising=False)
    flight._uninstall_for_tests()  # an abort dumps only when asked to
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (trace, jtrace):
        mod.clear_events()
    jprograms.reset()
    metrics.reset()
    yield
    for mod in (faults, jfaults):
        mod.reset()
    trace.clear_events()
    jtrace.clear_events()


def _heat_ref(p):
    return run_heat(make_initial_grid(p, device=CPU), p.iters, p.order,
                    p.xcfl, p.ycfl).numpy()


def _max_ulp(a, b):
    return int(ulp_distance(np.asarray(a, np.float32),
                            np.asarray(b, np.float32)).max())


def _solve_events(tr):
    keep = ("checkpoint-rollback", "numeric-abort", "chunk-shrunk",
            "solver-progress")
    return [(e["event"], e.get("step"), e.get("resumed_step"),
             e.get("from_size"), e.get("to_size"))
            for e in tr.events() if e["event"] in keep]


def _iterate(prob, kernel):
    a, xx, flags, _ = spmv.problem_tensors(prob, device=CPU)
    return spmv._iterate(a, xx, flags, prob.iters, scan=kernel).numpy()


# ------------------------------------------------- checkpointed heat solve

@pytest.mark.parametrize("nx,ny,order,iters,every", [
    (20, 20, 4, 12, 4), (24, 24, 2, 8, 3), (22, 20, 8, 10, 10),
    (20, 23, 4, 9, 0)])
def test_heat_checkpointed_equals_run_heat_and_reference(tmp_path, nx, ny,
                                                         order, iters,
                                                         every):
    p = SimParams(nx=nx, ny=ny, order=order, iters=iters)
    out = heat2d.run_heat_checkpointed(p, str(tmp_path / "t.npz"),
                                       every=every, device=CPU)
    np.testing.assert_array_equal(out, _heat_ref(p))
    ref = j_heat2d.run_heat_checkpointed(
        JSimParams(nx=nx, ny=ny, order=order, iters=iters),
        str(tmp_path / "j.npz"), every=every)
    assert _max_ulp(out, ref) <= 10


@pytest.mark.parametrize("spec", ["nan:heat2d:2", "nan:heat2d:1",
                                  "oom:heat_chunk:1", "oom:heat_chunk:2"])
def test_heat_checkpointed_faults_bitwise_and_events_like_reference(
        tmp_path, spec):
    """``nan:`` rolls back, ``oom:`` halves the chunk: the result equals
    the clean run bit for bit and the events equal the JAX package's."""
    p = SimParams(nx=20, ny=20, order=4, iters=12)
    with faults.injected(spec):
        out = heat2d.run_heat_checkpointed(p, str(tmp_path / "f.npz"),
                                           every=4, device=CPU)
    with jfaults.injected(spec):
        j_heat2d.run_heat_checkpointed(
            JSimParams(nx=20, ny=20, order=4, iters=12),
            str(tmp_path / "jf.npz"), every=4)
    assert _solve_events(trace) == _solve_events(jtrace)
    np.testing.assert_array_equal(out, _heat_ref(p))
    kind = {"nan": "checkpoint-rollback", "oom": "chunk-shrunk"}[spec[:3]]
    assert trace.events(kind)


def test_heat_checkpointed_oom_shrinks_chunk_bitwise_equal(tmp_path):
    p = SimParams(nx=24, ny=24, order=2, iters=8)
    with faults.injected("oom:heat_chunk:1"):
        out_f = heat2d.run_heat_checkpointed(p, str(tmp_path / "f.npz"),
                                             every=4, device=CPU)
    ev = trace.events("chunk-shrunk")[-1]
    assert (ev["op"], ev["from_size"], ev["to_size"]) == ("heat2d", 4, 2)
    faults.reset()
    out_c = heat2d.run_heat_checkpointed(p, str(tmp_path / "c.npz"),
                                         every=4, device=CPU)
    np.testing.assert_array_equal(out_f, out_c)


def test_heat_checkpointed_resume_bitwise(tmp_path):
    """A run to half the iterations, then a second call to all of them
    from the same path, equals the uninterrupted solve bit for bit."""
    ck = str(tmp_path / "h.npz")
    half = SimParams(nx=20, ny=20, order=4, iters=6)
    heat2d.run_heat_checkpointed(half, ck, every=3, device=CPU)
    full = SimParams(nx=20, ny=20, order=4, iters=12)
    trace.clear_events()
    out = heat2d.run_heat_checkpointed(full, ck, every=3, device=CPU)
    assert [e["step"] for e in trace.events("solver-progress")] == [9, 12]
    np.testing.assert_array_equal(out, _heat_ref(full))


def test_heat_checkpoint_resume_integration(tmp_path):
    """``run_with_checkpoints`` around ``run_heat`` directly, interrupted
    and resumed: bit for bit the uninterrupted solve, and within ULP-10 of
    the JAX package's."""
    p = SimParams(nx=20, ny=20, order=4, iters=12)
    u0 = make_initial_grid(p, device=CPU)

    def step(state, k):
        return run_heat(torch.as_tensor(state), k, p.order, p.xcfl, p.ycfl)

    ck = str(tmp_path / "heat.npz")
    run_with_checkpoints(step, u0, 5, ck, every=5)
    out = run_with_checkpoints(step, u0, 12, ck, every=5)
    np.testing.assert_array_equal(np.asarray(out), _heat_ref(p))
    jp = JSimParams(nx=20, ny=20, order=4, iters=12)
    ref = np.asarray(j_heat2d.run_heat(
        jnp.asarray(u0.numpy()), 12, jp.order, jp.xcfl, jp.ycfl))
    assert _max_ulp(out, ref) <= 10


def test_heat_checkpointed_preflight_refuses_before_any_chunk(
        tmp_path, monkeypatch):
    p = SimParams(nx=24, ny=24, order=2, iters=8)
    monkeypatch.setenv(admission.BUDGET_ENV, "1K")
    ck = tmp_path / "h.npz"
    with pytest.raises(admission.AdmissionError, match="heat2d"):
        heat2d.run_heat_checkpointed(p, str(ck), every=4, device=CPU)
    with pytest.raises(jadmission.AdmissionError, match="heat2d"):
        j_heat2d.run_heat_checkpointed(
            JSimParams(nx=24, ny=24, order=2, iters=8),
            str(tmp_path / "j.npz"), every=4)
    assert not ck.exists() and not trace.events("span-begin")
    (ev,) = trace.events("admission-rejected")
    assert ev["requested_bytes"] == (2 * 26 * 26 + 5 * 24 * 24) * 4
    monkeypatch.setenv(admission.BUDGET_ENV, "64M")
    heat2d.run_heat_checkpointed(p, str(ck), every=4, device=CPU)
    assert metrics.snapshot()["counters"]["admission.admitted"] == 1


# ------------------------------------------------- checkpointed SpMV-scan

@pytest.mark.parametrize("kernel", ["flat", "blocked", "auto"])
@pytest.mark.parametrize("n,p,q,iters,every,seed", [
    (512, 16, 15, 6, 2, 4), (1024, 32, 31, 8, 4, 0), (5000, 40, 39, 5, 3, 2)])
def test_spmv_checkpointed_equals_iterate_and_reference(tmp_path, kernel, n,
                                                        p, q, iters, every,
                                                        seed):
    prob = spmv.generate_problem(n, p, q, iters=iters, seed=seed)
    out = spmv.run_spmv_scan_checkpointed(prob, str(tmp_path / "t.npz"),
                                          every=every, kernel=kernel,
                                          device=CPU)
    np.testing.assert_array_equal(out, _iterate(prob, kernel))
    jprob = j_spmv.generate_problem(n, p, q, iters=iters, seed=seed)
    ref = j_spmv.run_spmv_scan_checkpointed(jprob, str(tmp_path / "j.npz"),
                                            every=every, kernel=kernel)
    if kernel == "flat":
        np.testing.assert_array_equal(out, ref)
    else:
        assert relative_l2_error(ref.astype(np.float64), out) <= 1e-5


def test_spmv_checkpointed_bitwise_on_integer_values(tmp_path):
    prob = spmv.generate_problem(5000, 40, 39, iters=3, seed=6)
    rng = np.random.default_rng(6)
    prob.a = rng.integers(-3, 4, prob.n).astype(np.float32)
    prob.x = rng.integers(-1, 2, prob.q).astype(np.float32)
    jprob = j_spmv.Problem(prob.a, prob.s, prob.k, prob.x, prob.iters)
    for kernel in ("blocked", "auto"):
        out = spmv.run_spmv_scan_checkpointed(
            prob, str(tmp_path / f"t{kernel}.npz"), every=2, kernel=kernel,
            device=CPU)
        ref = j_spmv.run_spmv_scan_checkpointed(
            jprob, str(tmp_path / f"j{kernel}.npz"), every=2, kernel=kernel)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("spec", ["nan:spmv_scan:2", "oom:spmv_scan_chunk:1",
                                  "nan:spmv_scan:1,oom:spmv_scan_chunk:2"])
def test_spmv_checkpointed_faults_bitwise_and_events_like_reference(
        tmp_path, spec):
    prob = spmv.generate_problem(1024, 32, 31, iters=8, seed=0)
    with faults.injected(spec):
        out = spmv.run_spmv_scan_checkpointed(prob, str(tmp_path / "f.npz"),
                                              every=4, kernel="flat",
                                              device=CPU)
    with jfaults.injected(spec):
        ref = j_spmv.run_spmv_scan_checkpointed(
            j_spmv.generate_problem(1024, 32, 31, iters=8, seed=0),
            str(tmp_path / "jf.npz"), every=4, kernel="flat")
    assert _solve_events(trace) == _solve_events(jtrace)
    np.testing.assert_array_equal(out, _iterate(prob, "flat"))
    np.testing.assert_array_equal(out, ref)


def test_spmv_checkpointed_nan_resume_bitwise(tmp_path):
    prob = spmv.generate_problem(512, 16, 15, iters=6, seed=4)
    with faults.injected("nan:spmv_scan:2"):
        out_faulted = spmv.run_spmv_scan_checkpointed(
            prob, str(tmp_path / "f.npz"), every=2, kernel="flat",
            device=CPU)
    assert trace.events("checkpoint-rollback")
    out_clean = spmv.run_spmv_scan_checkpointed(
        prob, str(tmp_path / "c.npz"), every=2, kernel="flat", device=CPU)
    np.testing.assert_array_equal(out_faulted, out_clean)


def test_spmv_checkpointed_oom_shrinks_chunk_bitwise_equal(tmp_path):
    prob = spmv.generate_problem(1024, 32, 31, iters=8, seed=0)
    with faults.injected("oom:spmv_scan_chunk:1"):
        out_f = spmv.run_spmv_scan_checkpointed(
            prob, str(tmp_path / "f.npz"), every=4, device=CPU)
    ev = trace.events("chunk-shrunk")[-1]
    assert (ev["from_size"], ev["to_size"]) == (4, 2)
    faults.reset()
    out_c = spmv.run_spmv_scan_checkpointed(
        prob, str(tmp_path / "c.npz"), every=4, device=CPU)
    np.testing.assert_array_equal(out_f, out_c)


def test_spmv_checkpointed_resume_and_program_cache(tmp_path):
    prob = spmv.generate_problem(2048, 20, 19, iters=10, seed=3)
    ck = str(tmp_path / "s.npz")
    half = spmv.Problem(prob.a, prob.s, prob.k, prob.x, 5)
    spmv.run_spmv_scan_checkpointed(half, ck, every=5, kernel="blocked",
                                    device=CPU)
    out = spmv.run_spmv_scan_checkpointed(prob, ck, every=5,
                                          kernel="blocked", device=CPU)
    np.testing.assert_array_equal(out, _iterate(prob, "blocked"))
    # both chunks of 5 came from one cached program
    assert len(trace.events("program-cache-miss")) == 1
    assert len(trace.events("program-cache-hit")) == 1


def test_spmv_checkpointed_refuses_kernels_and_budget(tmp_path, monkeypatch):
    prob = spmv.generate_problem(1024, 32, 31, iters=4, seed=0)
    for kernel in ("pallas", "pallas-fused", "dense"):
        with pytest.raises(ValueError, match="torch scans"):
            spmv.run_spmv_scan_checkpointed(prob, str(tmp_path / "x.npz"),
                                            kernel=kernel, device=CPU)
    monkeypatch.setenv(admission.BUDGET_ENV, "4K")
    with pytest.raises(admission.AdmissionError, match="spmv_scan"):
        spmv.run_spmv_scan_checkpointed(prob, str(tmp_path / "b.npz"),
                                        device=CPU)
    (ev,) = trace.events("admission-rejected")
    # input, previous values, xx, product, flags and starts, then the
    # flat scan's peak at n = 1024
    assert ev["requested_bytes"] == spmv.spmv_chunk_bytes(1024, 32) == \
        4 * 1024 * 4 + 4 * 1024 + 8 * 31 + 1024 * (5 * 4 + 8 + 2 * 4 + 2)
    assert not os.path.exists(tmp_path / "b.npz")


@pytest.mark.parametrize("n,kernel,want", [
    (1000, "flat", 1000 * 38),
    (1 << 16, "auto", (1 << 16) * 33),          # blocked, a block multiple
    (5000, "blocked", 8192 * 33 + 8192 * 8),    # padded: copies of v and f
    (5000, "auto", 5000 * 38),                  # flat below the threshold
])
def test_scan_peak_bytes_counts_the_dispatched_form(n, kernel, want):
    from cme213_tpu_torch.ops.segmented import scan_peak_bytes

    assert scan_peak_bytes(n, 4, kernel) == want
    assert spmv.spmv_chunk_bytes(n, 3, 4, kernel) == \
        4 * n * 4 + 4 * n + 16 + want


# --------------------------------------------------------------- preflight

@pytest.mark.parametrize("budget", ["16K", "64M", "127K", "128K"])
def test_preflight_decisions_agree_with_reference(monkeypatch, budget):
    """The JAX package's toy: 64 KiB in, 64 KiB out (its memory analysis);
    the port counts the same bytes."""
    import jax

    @jax.jit
    def f(a):
        return a * 2.0

    big = jnp.ones((1 << 14,), jnp.float32)
    monkeypatch.setenv(admission.BUDGET_ENV, budget)
    want = jadmission.preflight(f, big, op="toy")
    got = admission.preflight("toy", 2 * (1 << 14) * 4, device=CPU)
    assert (got.admitted, got.required_bytes, got.budget_bytes) == \
        (want.admitted, want.required_bytes, want.budget_bytes)
    assert got.detail == want.detail
    if not got.admitted:
        ev = trace.events("admission-rejected")[-1]
        assert ev["op"] == "toy" and ev["requested_bytes"] == \
            got.required_bytes


def test_preflight_without_budget_is_pass_open():
    d = admission.preflight("toy", 1 << 60, device=CPU)
    assert d.admitted and d.budget_bytes is None
    assert d.detail == "no budget: admission off"
    assert not trace.events("admission-rejected")


def test_admit_is_preflight_that_raises(monkeypatch):
    monkeypatch.setenv(admission.BUDGET_ENV, "1K")
    with pytest.raises(admission.AdmissionError, match="footprint 1025"):
        admission.admit("toy", 1025, CPU)
    assert admission.admit("toy", 1024, CPU) is None
    assert metrics.snapshot()["counters"]["admission.rejected"] == 1
    assert metrics.snapshot()["counters"]["admission.admitted"] == 1


# ---------------------------------------------------------- batched heat

def _heat_batch(b, nx, ny, order, seed):
    p = SimParams(nx=nx, ny=ny, order=order)
    rng = np.random.default_rng(seed)
    bo = p.border_size
    grids = []
    for _ in range(b):
        g = make_initial_grid(p, device=CPU).numpy().copy()
        g[bo:-bo, bo:-bo] += rng.uniform(0, 1, (ny, nx)).astype(np.float32)
        grids.append(g)
    # per-lane factors up to the stable ones of the params
    xs = [p.xcfl * float(v) for v in rng.uniform(0.25, 1.0, b)]
    ys = [p.ycfl * float(v) for v in rng.uniform(0.25, 1.0, b)]
    return grids, xs, ys


@pytest.mark.parametrize("b,nx,ny,order,iters", [
    (8, 24, 24, 2, 4), (3, 20, 22, 8, 6), (1, 21, 20, 4, 5),
    (4, 20, 20, 4, 12)])
def test_heat_batched_lanes_equal_serial_and_reference(b, nx, ny, order,
                                                       iters):
    grids, xs, ys = _heat_batch(b, nx, ny, order, seed=b + order)
    outs = heat2d.run_heat_batched(grids, iters, order, xs, ys, device=CPU)
    refs = j_heat2d.run_heat_batched(grids, iters, order, xs, ys)
    assert len(outs) == b
    for g, x, y, out, ref in zip(grids, xs, ys, outs, refs):
        serial = run_heat(torch.from_numpy(g), iters, order, x, y).numpy()
        np.testing.assert_array_equal(out, serial)
        assert _max_ulp(out, ref) <= 10


def test_heat_batched_program_cache_and_span():
    grids, xs, ys = _heat_batch(2, 20, 20, 2, seed=1)
    heat2d.run_heat_batched(grids, 4, 2, xs, ys, device=CPU)
    heat2d.run_heat_batched(grids, 4, 2, xs[::-1], ys, device=CPU)
    assert [e["shape_class"] for e in trace.events("program-cache-miss")] \
        == ["22x22/order2/i4/b2"]
    assert len(trace.events("program-cache-hit")) == 1
    assert [e["span"] for e in trace.events("span-end")
            if e["span"].startswith("heat_batched")] == \
        ["heat_batched.compile", "heat_batched.run", "heat_batched.run"]
    assert any(k[:3] == ("heat_batched", "xla", "22x22/order2/i4/b2")
               and "cpu" in k for k in programs.keys())


def test_heat_batched_rejects_mixed_shapes_like_reference():
    a = np.zeros((22, 22), np.float32)
    b = np.zeros((22, 24), np.float32)
    with pytest.raises(ValueError, match="mixes grid shapes"):
        heat2d.run_heat_batched([a, b], 2, 2, [0.1, 0.1], [0.1, 0.1],
                                device=CPU)
    with pytest.raises(ValueError, match="mixes grid shapes"):
        j_heat2d.run_heat_batched([a, b], 2, 2, [0.1, 0.1], [0.1, 0.1])
    assert heat2d.run_heat_batched([], 2, 2, [], [], device=CPU) == []


# ------------------------------------------------------ batched SpMV-scan

@pytest.mark.parametrize("kernel", ["flat", "blocked", "auto"])
@pytest.mark.parametrize("b,n,iters", [(8, 512, 6), (3, 5000, 3),
                                       (2, 4096, 2)])
def test_spmv_batched_lanes_equal_serial_and_reference(kernel, b, n, iters):
    probs = [spmv.generate_problem(n, max(3, n // 64), 31, iters=iters,
                                   seed=s) for s in range(b)]
    outs = spmv.run_spmv_scan_batched(probs, kernel=kernel, device=CPU)
    jprobs = [j_spmv.Problem(p.a, p.s, p.k, p.x, p.iters) for p in probs]
    refs = j_spmv.run_spmv_scan_batched(jprobs, kernel=kernel)
    for prob, out, ref in zip(probs, outs, refs):
        np.testing.assert_array_equal(out, _iterate(prob, kernel))
        if kernel == "flat":
            np.testing.assert_array_equal(out, ref)
        else:
            assert relative_l2_error(ref.astype(np.float64), out) <= 1e-5


def test_spmv_batched_scan_never_mixes_lanes():
    """A lane's blocks stay where its own solve puts them: with n not a
    block multiple, lane i of the batch equals lane i alone, whatever the
    other lanes hold (huge values, one segment, a head everywhere)."""
    n = 5000
    base = spmv.generate_problem(n, 40, 39, iters=2, seed=9)
    one_seg = spmv.Problem(base.a * 1e6, np.array([0, n], np.int32),
                           base.k, base.x, 2)
    all_heads = spmv.Problem(base.a, np.arange(n + 1, dtype=np.int32),
                             base.k, base.x, 2)
    for kernel in ("blocked", "auto"):
        outs = spmv.run_spmv_scan_batched([one_seg, base, all_heads],
                                          kernel=kernel, device=CPU)
        for prob, out in zip((one_seg, base, all_heads), outs):
            np.testing.assert_array_equal(out, _iterate(prob, kernel))


def test_spmv_batched_bitwise_on_integer_values():
    rng = np.random.default_rng(4)
    probs = []
    for s in range(3):
        pr = spmv.generate_problem(4500, 30, 29, iters=2, seed=s)
        pr.a = rng.integers(-3, 4, pr.n).astype(np.float32)
        pr.x = rng.integers(-1, 2, pr.q).astype(np.float32)
        probs.append(pr)
    jprobs = [j_spmv.Problem(p.a, p.s, p.k, p.x, p.iters) for p in probs]
    for kernel in ("blocked", "auto"):
        outs = spmv.run_spmv_scan_batched(probs, kernel=kernel, device=CPU)
        refs = j_spmv.run_spmv_scan_batched(jprobs, kernel=kernel)
        for out, ref in zip(outs, refs):
            np.testing.assert_array_equal(out, ref)


def test_spmv_batched_refuses_like_reference():
    probs = [spmv.generate_problem(512, 16, 15, iters=2, seed=s)
             for s in range(2)]
    for kernel in ("pallas", "pallas-fused", "dense"):
        with pytest.raises(ValueError, match="torch scans"):
            spmv.run_spmv_scan_batched(probs, kernel=kernel, device=CPU)
    other = spmv.generate_problem(1024, 16, 15, iters=2, seed=0)
    with pytest.raises(ValueError, match="mixes shape classes"):
        spmv.run_spmv_scan_batched(probs + [other], device=CPU)
    with pytest.raises(ValueError, match="mixes shape classes"):
        j_spmv.run_spmv_scan_batched(
            [j_spmv.Problem(p.a, p.s, p.k, p.x, p.iters)
             for p in probs + [other]])
    assert spmv.run_spmv_scan_batched([], device=CPU) == []


# ------------------------------------------------------- device selection

def test_new_entry_points_run_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    p = SimParams(nx=20, ny=20, order=2, iters=2)
    prob = spmv.generate_problem(512, 16, 15, iters=2, seed=0)
    grids, xs, ys = _heat_batch(2, 20, 20, 2, seed=0)
    calls = [
        lambda: heat2d.run_heat_checkpointed(p, str(tmp_path / "h.npz")),
        lambda: spmv.run_spmv_scan_checkpointed(prob,
                                                str(tmp_path / "s.npz")),
        lambda: heat2d.run_heat_batched(grids, 2, 2, xs, ys),
        lambda: spmv.run_spmv_scan_batched([prob, prob]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.iterdir())
