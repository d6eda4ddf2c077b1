"""Guarded execution in the port: the heat and SpMV-scan ladders with
their conformance gates, admission control, the distributed gates and the
cost-attribution check, against the JAX package.

Counterpart of the heat-ladder, SpMV, admission and distributed cases of
``tests/test_guarded_execution.py``, ``tests/test_stencil_pipeline.py``'s
ladder cases and the attribution cases of ``tests/test_diag.py``.  The
JAX package runs its Pallas rungs in interpret mode.  Tolerances:

- the heat ladder: ULP-10 against the JAX package's ``run_heat_resilient``
  (≤ 44×40, ≤ 32 steps), the same served rung under the same fault plan
  at orders 2 and 4; at order 8 and k > 1 no JAX gate outcome is asserted
  (ROADMAP.md §C), while the port's gate must admit every kernel rung and
  the served grid equal ``run_heat`` bit for bit;
- the SpMV-scan ladder: rel-L2 1e-5 against the JAX package's solve, the
  same served rung under each of ``fail:`` and ``wrong:``;
- ``parse_budget``: exact.

A kernel that cannot build or launch (``KernelError``) raises out of
every ladder, where an injected fault demotes.  On a CUDA device a ladder
ends at its kernel rungs unless the caller asks for the plain one
(``core/resilience.allows_plain_rungs``); the CPU cases below simulate
that by patching it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cme213_tpu.apps import spmv_scan as j_spmv
from cme213_tpu.config import SimParams as JSimParams
from cme213_tpu.core import admission as jadmission
from cme213_tpu.core import conformance as jconf
from cme213_tpu.core import faults as jfaults
from cme213_tpu.core import programs as jprograms
from cme213_tpu.core import trace as jtrace
from cme213_tpu.dist import make_mesh_1d as j_mesh_1d
from cme213_tpu.dist.scan import \
    make_iterated_sharded_scan_gated as j_scan_gated
from cme213_tpu.grid import make_initial_grid as j_make_initial_grid
from cme213_tpu.ops.stencil_pipeline import \
    run_heat_resilient as j_run_heat_resilient
from cme213_tpu_torch.apps import heat2d
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import (FailureKind, KernelError, admission,
                                   conformance, diag, faults, metrics,
                                   programs, resilience, trace,
                                   virtual_devices)
from cme213_tpu_torch.core.errors import FrameworkError
from cme213_tpu_torch.core.roofline import Cost
from cme213_tpu_torch.dist import make_mesh_1d, run_distributed_heat
from cme213_tpu_torch.dist import scan as dscan
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import LAUNCHES, run_heat
from cme213_tpu_torch.ops import segmented_pallas
from cme213_tpu_torch.ops import stencil_pipeline as sp
from cme213_tpu_torch.verify import check_ulp

CPU8 = virtual_devices(8, "cpu")


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in ("CME213_FAULTS", "CME213_TUNE_CACHE", admission.BUDGET_ENV,
                "CME213_CONFORMANCE_CACHE", diag.ATTRIBUTION_ENV):
        monkeypatch.delenv(var, raising=False)
    for mod in (trace, jtrace):
        mod.clear_events()
    for mod in (conformance, jconf, faults, jfaults, diag):
        mod.reset()
    jprograms.reset()
    metrics.reset()
    yield
    for mod in (conformance, jconf, faults, jfaults, diag):
        mod.reset()
    trace.clear_events()


def _grids(order, nx=40, ny=36, **bc):
    kw = dict(nx=nx, ny=ny, order=order, **bc)
    p = SimParams(**kw)
    return p, make_initial_grid(p, device="cpu"), JSimParams(**kw)


def _port_ladder(p, u0, iters, k=1, spec=None, **kw):
    with faults.injected(spec or ""):
        return sp.run_heat_resilient(u0, iters, p.order, p.xcfl, p.ycfl,
                                     p.bc, k=k, **kw)


# --------------------------------------------------- the heat ladder

PLANS = [None, "fail:heat.pipeline", "wrong:heat", "wrong:heat,wrong:heat",
         "oom:heat.pipeline", "stage:heat.pipeline:conformance"]


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("spec", PLANS)
def test_heat_ladder_serves_the_jax_rung_within_ulp10(order, spec):
    p, u0, jp = _grids(order)
    iters = 8
    res = _port_ladder(p, u0, iters, spec=spec)
    ju0 = np.asarray(j_make_initial_grid(jp, dtype=jnp.float32))
    with jfaults.injected(spec or ""):
        jres = j_run_heat_resilient(jnp.array(ju0), iters, order, jp.xcfl,
                                    jp.ycfl, jp.bc, k=1, interpret=True)
    assert res.rung == jres.rung
    assert [f.kind.value for f in res.failures] == \
        [f.kind.value for f in jres.failures]
    assert check_ulp(np.asarray(jres.value), res.value.numpy(), max_ulps=10)
    # every rung, demoted or not, serves run_heat's grid bit for bit
    torch.testing.assert_close(
        res.value, run_heat(u0, iters, order, p.xcfl, p.ycfl), rtol=0,
        atol=0)
    assert LAUNCHES == {"pipeline": 0, "pipeline2d": 0, "local": 0}


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_heat_gate_admits_every_kernel_rung_bitwise(order, k):
    """The port's kernel rungs equal ``run_heat`` bit for bit, so its
    bitwise gate admits them at every order and k, including the order-8
    multi-step classes where the JAX package's gate outcome depends on
    XLA's FMA contraction (no JAX outcome is asserted here)."""
    p, u0, _ = _grids(order, nx=44, ny=40, bc_top=1.5, bc_left=0.5,
                      bc_bottom=2.0, bc_right=0.25)
    gate = sp._heat_conformance_gate(order, k, device="cpu")
    assert gate("pipeline") and gate("pipeline2d") and gate("xla")
    probes = trace.events("conformance-probe")
    assert [(e["rung"], e["ok"]) for e in probes] == [("pipeline", True),
                                                     ("pipeline2d", True)]
    iters = 4 * k
    res = sp.run_heat_resilient(u0, iters, order, p.xcfl, p.ycfl, p.bc, k=k)
    assert res.rung == "pipeline" and not res.demoted
    torch.testing.assert_close(
        res.value, run_heat(u0, iters, order, p.xcfl, p.ycfl), rtol=0,
        atol=0)


def test_probe_grid_matches_the_jax_package_s():
    from cme213_tpu.ops import stencil_pipeline as jsp

    for order in (2, 4, 8):
        p, u0 = sp._conformance_probe_grid(order, device="cpu")
        jp, ju0 = jsp._conformance_probe_grid(order)
        np.testing.assert_array_equal(u0.numpy(), ju0)
        assert (p.nx, p.ny, p.bc) == (jp.nx, jp.ny, jp.bc)


def test_oom_halves_the_tile_and_serves_the_same_grid():
    p, u0, _ = _grids(2)
    res = _port_ladder(p, u0, 4, spec="oom:heat.pipeline", tile_y=32)
    assert res.rung == "pipeline" and not res.demoted
    ev = trace.events("chunk-shrunk")[-1]
    assert (ev["op"], ev["from_size"], ev["to_size"]) == \
        ("heat.pipeline", 32, 16)
    assert metrics.snapshot()["counters"]["admission.chunk_shrunk"] == 1
    torch.testing.assert_close(res.value,
                               run_heat(u0, 4, 2, p.xcfl, p.ycfl),
                               rtol=0, atol=0)


def test_resource_after_halving_to_the_quantum_demotes():
    """Three out-of-memory failures in a row take ``tile_y`` 32 → 16 → 8
    (the k = 1 design's micro-tile rows), then the rung demotes."""
    p, u0, _ = _grids(2)
    res = _port_ladder(p, u0, 4, spec=",".join(["oom:heat.pipeline"] * 3),
                       tile_y=32)
    assert res.rung == "pipeline2d"
    assert [f.kind for f in res.failures] == [FailureKind.RESOURCE]
    assert [(e["from_size"], e["to_size"])
            for e in trace.events("chunk-shrunk")] == [(32, 16), (16, 8)]


def test_conformance_off_runs_no_probe():
    p, u0, _ = _grids(2)
    res = sp.run_heat_resilient(u0, 2, 2, p.xcfl, p.ycfl, p.bc,
                                conformance=False)
    assert res.rung == "pipeline" and not trace.events("conformance-probe")


def test_pipeline2d_is_laddered_by_the_port_s_shared_memory_limit():
    """The JAX package drops ``pipeline2d`` above ``k·border = 128`` (a
    Pallas layout limit); the port keeps it wherever its smallest tile
    fits a block's shared memory: every order up to k = 8, but not order
    8 at k = 16 (K = 64 halo rows a side)."""
    for order in (2, 4, 8):
        for k in (1, 2, 4, 8):
            assert sp.smem_bytes(sp.design(k).rows, k, order) \
                <= sp.SMEM_BUDGET_BYTES
    assert sp.smem_bytes(sp.design(16).rows, 16, 8) > sp.SMEM_BUDGET_BYTES
    p, u0, _ = _grids(8)
    for k, rung in ((8, "pipeline2d"), (16, "xla")):
        with faults.injected("fail:heat.pipeline"):
            res = sp.run_heat_resilient(u0, 2 * k, 8, p.xcfl, p.ycfl, p.bc,
                                        k=k)
        assert res.rung == rung


def test_kernel_error_raises_out_of_the_heat_ladder(monkeypatch):
    """A kernel that cannot build or launch is an error, not a demotion:
    out of the gate's probe and out of the rung itself.  An injected
    ``fail:`` demotes."""
    p, u0, _ = _grids(2)

    def broken(*a, **kw):
        raise KernelError("heat_ksteps launch failed: invalid argument "
                          "(cudaError 1; ...)")

    monkeypatch.setattr(sp, "run_heat_pipeline", broken)
    # the probe's program dies in its warm-up launch: stage compile
    with pytest.raises(KernelError):
        sp.run_heat_resilient(u0, 2, 2, p.xcfl, p.ycfl, p.bc)
    with pytest.raises(KernelError):
        sp.run_heat_resilient(u0, 2, 2, p.xcfl, p.ycfl, p.bc,
                              conformance=False)
    assert [(e["kernel"], e["stage"])
            for e in trace.events("kernel-failure")] == \
        [("pipeline", "compile")] * 2
    assert not trace.events("served") and not trace.events("rung-failed")
    with faults.injected("fail:heat.pipeline"):
        res = sp.run_heat_resilient(u0, 2, 2, p.xcfl, p.ycfl, p.bc,
                                    conformance=False)
    assert res.rung == "pipeline2d"


def test_heat_ladder_admits_its_buffers_against_the_memory_budget(
        monkeypatch):
    """The grid and its two ping-pong buffers are held to
    ``CME213_MEMORY_BUDGET`` before anything runs; the tile is not what the
    budget sizes."""
    p, u0, _ = _grids(2)
    need = 3 * u0.numel() * 4
    tile = sp.pick_pipeline_tile(4008, 1, 8, target=256)
    monkeypatch.setenv(admission.BUDGET_ENV, str(need - 1))
    with pytest.raises(admission.AdmissionError, match="heat"):
        sp.run_heat_resilient(u0, 2, 2, p.xcfl, p.ycfl, p.bc)
    ev = trace.events("admission-rejected")[-1]
    assert (ev["op"], ev["requested_bytes"]) == ("heat", need)
    assert not trace.events("conformance-probe")
    assert sp.pick_pipeline_tile(4008, 1, 8, target=256) == tile
    monkeypatch.setenv(admission.BUDGET_ENV, str(need))
    assert sp.run_heat_resilient(u0, 2, 2, p.xcfl, p.ycfl,
                                 p.bc).rung == "pipeline"


@pytest.fixture
def cuda_rules(monkeypatch):
    """The CUDA ladders' rule on the CPU: a plain rung only when asked."""
    monkeypatch.setattr(resilience, "allows_plain_rungs",
                        lambda device, plain_fallback=False: plain_fallback)


def test_plain_rungs_are_allowed_on_the_cpu_or_when_asked():
    assert resilience.allows_plain_rungs("cpu")
    assert not resilience.allows_plain_rungs(torch.device("cuda"))
    assert resilience.allows_plain_rungs(torch.device("cuda:0"),
                                         plain_fallback=True)


def test_refused_kernel_rungs_raise_unless_plain_is_asked(cuda_rules):
    """Where the plain rung is not allowed, a ladder whose kernel rungs
    are all refused raises; ``plain_fallback`` serves ``xla``.  An
    injected fault on one kernel rung still demotes to the other."""
    p, u0, _ = _grids(2)
    with faults.injected("fail:heat.pipeline"):
        res = sp.run_heat_resilient(u0, 4, 2, p.xcfl, p.ycfl, p.bc)
    assert res.rung == "pipeline2d"
    conformance.reset()
    served = len(trace.events("served"))
    with faults.injected("wrong:heat,wrong:heat"):
        with pytest.raises(FrameworkError, match="all 2 rungs of heat"):
            sp.run_heat_resilient(u0, 4, 2, p.xcfl, p.ycfl, p.bc)
    assert len(trace.events("served")) == served
    conformance.reset()
    with faults.injected("wrong:heat,wrong:heat"):
        res = sp.run_heat_resilient(u0, 4, 2, p.xcfl, p.ycfl, p.bc,
                                    plain_fallback=True)
    assert res.rung == "xla" and res.demoted
    torch.testing.assert_close(res.value, run_heat(u0, 4, 2, p.xcfl,
                                                   p.ycfl), rtol=0, atol=0)


def test_real_out_of_memory_is_not_halved(monkeypatch, cuda_rules):
    """The allocator's out-of-memory is the grid's, whatever the tile:
    the ladder does not halve on it, and with no plain rung it raises."""
    p, u0, _ = _grids(2)

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 64.00 MiB")

    monkeypatch.setattr(sp, "run_heat_pipeline", oom)
    monkeypatch.setattr(sp, "run_heat_pipeline2d", oom)
    with pytest.raises(FrameworkError, match="all 2 rungs"):
        sp.run_heat_resilient(u0, 2, 2, p.xcfl, p.ycfl, p.bc, tile_y=32,
                              conformance=False)
    assert not trace.events("chunk-shrunk")


def test_launch_plan_refusal_is_a_kernel_error():
    """A tile whose windows do not fit a block's shared memory cannot
    launch: ``launch_plan`` raises ``KernelError``, which no ladder
    demotes.  (The plan needs a CUDA grid; the check comes first.)"""
    u = torch.zeros(4008, 4008, device="meta")
    with pytest.raises(KernelError, match="shared memory"):
        sp.launch_plan(u, 1, 16, 8, tile_y=512)


def test_run_single_goes_through_the_ladder_and_labels_demotions(capsys):
    p = SimParams(nx=24, ny=20, iters=6, order=4)
    res = heat2d.run_single(p, device="cpu")
    assert res.ok and [r.split(":")[0] for r in res.reports] == \
        ["torch", "pipeline"]
    assert trace.events("served")[-1]["rung"] == "pipeline"
    conformance.reset()
    with faults.injected("wrong:heat,wrong:heat"):
        res = heat2d.run_single(p, device="cpu")
    assert res.ok and res.reports[1].startswith("pipeline->xla:")
    assert "kernel demoted to 'xla'" in capsys.readouterr().out


# ------------------------------------------------ the SpMV-scan ladder

@pytest.mark.parametrize("kernel", ["blocked", "pallas-fused", "auto"])
@pytest.mark.parametrize("spec", [None, "fail:spmv_scan.{kernel}",
                                  "wrong:spmv_scan"])
def test_spmv_ladder_serves_the_jax_rung_within_rel_l2(kernel, spec):
    prob = spmv.generate_problem(1024, 32, 31, iters=4, seed=0)
    jprob = j_spmv.Problem(prob.a, prob.s, prob.k, prob.x, prob.iters)
    plan = spec.format(kernel=kernel) if spec else ""
    with faults.injected(plan):
        out = spmv.run_spmv_scan(prob, kernel=kernel, device="cpu")
    served = trace.events("served")[-1]
    with jfaults.injected(plan):
        jout = np.asarray(j_spmv.run_spmv_scan(jprob, kernel=kernel))
    jserved = jtrace.events("served")[-1]
    assert (served["rung"], served["demoted"]) == \
        (jserved["rung"], jserved["demoted"])
    rel = np.linalg.norm(out.astype(np.float64) - jout) / \
        np.linalg.norm(jout.astype(np.float64))
    assert rel <= 1e-5


def test_spmv_wrong_fault_demotes_and_matches_flat_bitwise():
    prob = spmv.generate_problem(1024, 32, 31, iters=4, seed=0)
    with faults.injected("wrong:spmv_scan:1"):
        out = spmv.run_spmv_scan(prob, kernel="blocked", device="cpu")
    served = trace.events("served")[-1]
    assert served["rung"] == "flat" and served["demoted"]
    failed = trace.events("rung-failed")[-1]
    assert (failed["rung"], failed["kind"]) == ("blocked", "wrong_answer")
    assert trace.events("conformance-failed")
    ref = spmv.run_spmv_scan(prob, kernel="flat", device="cpu")
    np.testing.assert_array_equal(out, ref)


def test_spmv_unfaulted_rungs_pass_their_probes_once():
    prob = spmv.generate_problem(1024, 32, 31, iters=4, seed=0)
    for kernel in ("blocked", "pallas", "pallas-fused", "dense"):
        spmv.run_spmv_scan(prob, kernel=kernel, device="cpu")
        served = trace.events("served")[-1]
        assert served["rung"] == kernel and not served["demoted"]
    assert not trace.events("conformance-failed")
    n_probes = len(trace.events("conformance-probe"))
    assert n_probes == 4
    spmv.run_spmv_scan(prob, kernel="blocked", device="cpu")
    assert len(trace.events("conformance-probe")) == n_probes
    assert segmented_pallas.LAUNCHES == {"segscan": 0, "spmv_fused": 0}


def test_spmv_fallback_off_runs_the_kernel_alone():
    prob = spmv.generate_problem(512, 16, 15, iters=3, seed=1)
    out = spmv.run_spmv_scan(prob, kernel="blocked", fallback=False,
                             device="cpu")
    assert trace.events("served")[-1]["rung"] == "blocked"
    assert not trace.events("conformance-probe")
    # an injected fault then has no rung to demote to
    with faults.injected("fail:spmv_scan.blocked"):
        with pytest.raises(FrameworkError, match="1 rungs"):
            spmv.run_spmv_scan(prob, kernel="blocked", fallback=False,
                               device="cpu")
    assert spmv.external_check(prob, out)["rel_l2"] < 1e-5


def test_kernel_error_raises_out_of_the_spmv_ladder(monkeypatch):
    prob = spmv.generate_problem(512, 16, 15, iters=3, seed=1)

    def broken(*a, **kw):
        raise KernelError("segmented_scan launch failed: invalid argument "
                          "(cudaError 1; ...)")

    monkeypatch.setattr(spmv, "spmv_scan_pallas", broken)
    with pytest.raises(KernelError):
        spmv.run_spmv_scan(prob, kernel="pallas-fused", device="cpu")
    with pytest.raises(KernelError):
        spmv.run_spmv_scan(prob, kernel="pallas-fused", fallback=False,
                           device="cpu")
    assert not trace.events("served") and not trace.events("rung-failed")
    assert {e["kernel"] for e in trace.events("kernel-failure")} == \
        {"pallas-fused"}


def test_spmv_kernel_ladders_on_a_cuda_device():
    cuda = torch.device("cuda")
    assert spmv.ladder("pallas-fused", "cpu") == \
        ("pallas-fused", "blocked", "flat")
    assert spmv.ladder("pallas-fused", cuda) == ("pallas-fused", "pallas")
    assert spmv.ladder("pallas-fused", cuda, plain_fallback=True) == \
        ("pallas-fused", "pallas", "flat")
    assert spmv.ladder("pallas", cuda) == ("pallas",)
    # auto in float32 is the fused kernel, with its ladder
    assert spmv.ladder("auto", cuda) == ("pallas-fused", "pallas")
    assert spmv.ladder("auto", cuda, plain_fallback=True) == \
        ("pallas-fused", "pallas", "flat")
    # the kernel takes float32 only: auto in float64, and on the CPU, is
    # the torch dispatch, as is a torch scan asked for by name
    assert spmv.ladder("auto", cuda, dtype=torch.float64) == ("auto", "flat")
    assert spmv.ladder("auto", "cpu") == ("auto", "flat")
    assert spmv.ladder("blocked", cuda) == ("blocked", "flat")


@pytest.fixture
def auto_on_card(monkeypatch):
    """``auto``'s ladders as on a CUDA device, over CPU tensors (the kernel
    rungs run their plain versions)."""
    real = spmv.ladder
    monkeypatch.setattr(
        spmv, "ladder", lambda kernel, device, plain_fallback=False,
        dtype=torch.float32: real(kernel, torch.device("cuda"),
                                  plain_fallback, dtype))


def test_auto_on_a_card_serves_the_fused_kernel(auto_on_card):
    prob = spmv.generate_problem(1024, 32, 31, iters=4, seed=0)
    out = spmv.run_spmv_scan(prob, device="cpu")
    served = trace.events("served")[-1]
    assert (served["rung"], served["demoted"]) == ("pallas-fused", False)
    (end,) = [e for e in trace.events("span-end")
              if e["span"] == "spmv_scan.run"]
    assert end["kernel"] == "pallas-fused" and "scan" not in end
    a, xx, flags, _ = spmv.problem_tensors(prob, device="cpu")
    np.testing.assert_array_equal(
        out, segmented_pallas.spmv_scan_pallas(a, xx, flags, 4).numpy())


@pytest.mark.parametrize("spec,plain,rung", [
    ("fail:spmv_scan.pallas-fused", False, "pallas"),
    ("fail:spmv_scan.pallas-fused,fail:spmv_scan.pallas", False, None),
    ("fail:spmv_scan.pallas-fused,fail:spmv_scan.pallas", True, "flat"),
    ("wrong:spmv_scan,wrong:spmv_scan", False, None),
    ("wrong:spmv_scan,wrong:spmv_scan", True, "flat")])
def test_refused_kernels_demote_auto_as_pallas_fused(auto_on_card, spec,
                                                     plain, rung, capsys):
    """On the card ``auto`` is ``pallas-fused`` with its ladder: a refused
    B7 demotes to B6, and with both refused the solve raises unless the
    caller asks for the plain rung, so a wrong kernel is never served
    unasked by a torch scan."""
    prob = spmv.generate_problem(1024, 32, 31, iters=4, seed=0)
    with faults.injected(spec):
        if rung is None:
            with pytest.raises(FrameworkError, match="all 2 rungs"):
                spmv.run_spmv_scan(prob, device="cpu")
            assert not trace.events("served")
            return
        out = spmv.run_spmv_scan(prob, plain_fallback=plain, device="cpu")
    served = trace.events("served")[-1]
    assert (served["rung"], served["demoted"]) == (rung, True)
    assert f"kernel 'pallas-fused' demoted to {rung!r}" in \
        capsys.readouterr().out
    assert spmv.external_check(prob, out)["rel_l2"] < 1e-5


def test_auto_on_a_card_raises_a_kernel_error(auto_on_card, monkeypatch):
    """A kernel that cannot build or launch raises out of ``auto`` as out
    of every kernel rung: no demotion."""
    prob = spmv.generate_problem(512, 16, 15, iters=3, seed=1)

    def broken(*a, **kw):
        raise KernelError("segmented_scan launch failed: invalid argument "
                          "(cudaError 1; ...)")

    monkeypatch.setattr(spmv, "spmv_scan_pallas", broken)
    with pytest.raises(KernelError):
        spmv.run_spmv_scan(prob, device="cpu")
    assert not trace.events("served")


def test_auto_fallback_off_runs_the_rung_it_serves(auto_on_card):
    prob = spmv.generate_problem(512, 16, 15, iters=3, seed=1)
    spmv.run_spmv_scan(prob, fallback=False, device="cpu")
    assert trace.events("served")[-1]["rung"] == "pallas-fused"
    assert not trace.events("conformance-probe")
    with faults.injected("fail:spmv_scan.pallas-fused"):
        with pytest.raises(FrameworkError, match="1 rungs"):
            spmv.run_spmv_scan(prob, fallback=False, device="cpu")


def test_auto_canonical_probes_the_rung_that_serves(auto_on_card):
    prob = spmv.generate_problem(1500, 24, 23, iters=3, seed=2)
    out = spmv.run_spmv_scan(prob, canonical=True, device="cpu")
    pads = [e for e in trace.events("conformance-probe")
            if e["op"] == "spmv_scan.pad"]
    assert [(e["rung"], e["ok"]) for e in pads] == [("pallas-fused", True)]
    assert trace.events("served")[-1]["rung"] == "pallas-fused"
    exact = spmv.run_spmv_scan(prob, device="cpu")
    np.testing.assert_array_equal(out, exact)


def test_spmv_refused_kernels_raise_unless_plain_is_asked(cuda_rules):
    prob = spmv.generate_problem(512, 16, 15, iters=3, seed=1)
    with faults.injected("fail:spmv_scan.pallas-fused"):
        out = spmv.run_spmv_scan(prob, kernel="pallas-fused", device="cpu")
    assert trace.events("served")[-1]["rung"] == "pallas"
    assert spmv.external_check(prob, out)["rel_l2"] < 1e-5
    both = "fail:spmv_scan.pallas-fused,fail:spmv_scan.pallas"
    with faults.injected(both):
        with pytest.raises(FrameworkError, match="all 2 rungs"):
            spmv.run_spmv_scan(prob, kernel="pallas-fused", device="cpu")
    with faults.injected(both):
        out = spmv.run_spmv_scan(prob, kernel="pallas-fused",
                                 plain_fallback=True, device="cpu")
    assert trace.events("served")[-1]["rung"] == "flat"
    assert spmv.external_check(prob, out)["rel_l2"] < 1e-5


def test_spmv_fail_demotes_pallas_fused_to_blocked():
    prob = spmv.generate_problem(512, 16, 15, iters=3, seed=1)
    with faults.injected("fail:spmv_scan.pallas-fused"):
        out = spmv.run_spmv_scan(prob, kernel="pallas-fused", device="cpu")
    assert trace.events("served")[-1]["rung"] == "blocked"
    assert spmv.external_check(prob, out)["rel_l2"] < 1e-5


# ------------------------------------------------------------- admission

def test_parse_budget_matches_jax():
    for raw in ("1024", "4K", "2m", "1.5G", " 16g ", "0.5k", "7"):
        assert admission.parse_budget(raw) == jadmission.parse_budget(raw)
    with pytest.raises(ValueError):
        admission.parse_budget("lots")


def test_memory_budget_env_wins_and_the_cpu_has_none(monkeypatch):
    assert admission.memory_budget("cpu") is None
    monkeypatch.setenv(admission.BUDGET_ENV, "64M")
    assert admission.memory_budget("cpu") == 64 << 20
    monkeypatch.setenv(admission.BUDGET_ENV, "garbage")
    assert admission.memory_budget("cpu") is None


def test_admit_rejects_over_budget_with_an_event(monkeypatch):
    monkeypatch.setenv(admission.BUDGET_ENV, "16K")
    with pytest.raises(admission.AdmissionError, match="toy"):
        admission.admit("toy", 16 * 1024 + 1, "cpu")
    ev = trace.events("admission-rejected")[-1]
    assert (ev["op"], ev["requested_bytes"], ev["budget_bytes"]) == \
        ("toy", 16 * 1024 + 1, 16 * 1024)
    assert metrics.snapshot()["counters"]["admission.rejected"] == 1
    admission.admit("toy", 16 * 1024, "cpu")


def test_admit_without_budget_admits():
    admission.admit("toy", 1 << 60, "cpu")
    assert not trace.events("admission-rejected")


# ------------------------------------------------------- distributed gates

def test_dist_scan_wrong_fault_demotes_ring_to_gather_like_jax():
    mesh = make_mesh_1d(4, devices=CPU8)
    _, mode = dscan.make_iterated_sharded_scan_gated(mesh)
    _, jmode = j_scan_gated(j_mesh_1d(4))
    assert mode == jmode == "ring"
    for mod in (conformance, jconf):
        mod.reset()
    trace.clear_events()
    with faults.injected("wrong:dist_scan:1"):
        _, mode = dscan.make_iterated_sharded_scan_gated(mesh)
    with jfaults.injected("wrong:dist_scan:1"):
        _, jmode = j_scan_gated(j_mesh_1d(4))
    assert mode == jmode == "gather"
    ev = trace.events("rung-failed")[-1]
    assert (ev["op"], ev["rung"], ev["kind"]) == ("dist_scan", "ring",
                                                  "wrong_answer")


def test_spmv_distributed_goes_through_the_gated_scan():
    prob = spmv.generate_problem(1000, 20, 19, iters=3, seed=4)
    out = spmv.run_spmv_scan_distributed(prob,
                                         make_mesh_1d(4, devices=CPU8))
    served = [e for e in trace.events("served") if e["op"] == "dist_scan"]
    assert served and served[-1]["rung"] == "ring"
    assert spmv.external_check(prob, out)["rel_l2"] < 1e-5


def test_dist_heat_gated_pallas_serves_conformant_kernel():
    from cme213_tpu.dist.heat import run_distributed_heat as j_run_dist

    p = SimParams(nx=40, ny=48, order=8, iters=4)
    out = run_distributed_heat(p, make_mesh_1d(4, devices=CPU8),
                               local_kernel="pallas")
    assert not [e for e in trace.events("rung-failed")
                if e["op"] == "dist_heat"]
    probes = [e for e in trace.events("conformance-probe")
              if e["op"] == "dist_heat"]
    assert [(e["rung"], e["ok"]) for e in probes] == [("pallas-k1", True)]
    ref = run_distributed_heat(p, make_mesh_1d(4, devices=CPU8),
                               overlap=False, conformance=False)
    np.testing.assert_array_equal(out, ref)
    jref = j_run_dist(JSimParams(nx=40, ny=48, order=8, iters=4),
                      j_mesh_1d(4), overlap=False, conformance=False)
    assert check_ulp(np.asarray(jref), out, max_ulps=10)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_dist_heat_gate_admits_multistep_at_order8_bitwise(kernel):
    """At order 8 and k > 1 the port's exchange-every-k path equals the
    k = 1 path bit for bit, so its gate admits it; no JAX gate outcome is
    asserted (ROADMAP.md §C)."""
    p = SimParams(nx=64, ny=64, order=8, iters=8)
    mesh = make_mesh_1d(4, devices=CPU8)
    base = run_distributed_heat(p, mesh, overlap=False, conformance=False)
    multi = run_distributed_heat(p, mesh, overlap=False,
                                 steps_per_exchange=4, local_kernel=kernel)
    assert not [e for e in trace.events("rung-failed")
                if e["op"] == "dist_heat"]
    assert {e["rung"] for e in trace.events("conformance-probe")} == \
        {f"{kernel}-k4"}
    np.testing.assert_array_equal(multi, base)


def test_dist_heat_wrong_fault_demotes_pallas_to_xla():
    p = SimParams(nx=40, ny=48, order=4, iters=4)
    mesh = make_mesh_1d(2, devices=CPU8)
    with faults.injected("wrong:dist_heat"):
        out = run_distributed_heat(p, mesh, local_kernel="pallas")
    ev = [e for e in trace.events("rung-failed") if e["op"] == "dist_heat"]
    assert [(e["rung"], e["kind"]) for e in ev] == [("pallas-k1",
                                                     "wrong_answer")]
    ref = run_distributed_heat(p, mesh, conformance=False)
    np.testing.assert_array_equal(out, ref)


def test_dist_heat_wrong_fault_raises_unless_plain_is_asked(cuda_rules):
    p = SimParams(nx=40, ny=48, order=4, iters=4)
    mesh = make_mesh_1d(2, devices=CPU8)
    with faults.injected("wrong:dist_heat"):
        with pytest.raises(FrameworkError, match="pallas local kernel"):
            run_distributed_heat(p, mesh, local_kernel="pallas")
    conformance.reset()
    with faults.injected("wrong:dist_heat"):
        out = run_distributed_heat(p, mesh, local_kernel="pallas",
                                   plain_fallback=True)
    np.testing.assert_array_equal(
        out, run_distributed_heat(p, mesh, conformance=False))


# ------------------------------------------------------------ attribution

def test_wrong_cost_model_trips_attribution_mismatch():
    def kernel_rung(x):
        return x + 1.0
    kernel_rung.staged_cost = lambda x: Cost(2 * 4 * x.numel(), x.numel())
    row = diag.check_attribution("fake", "r", "n4096", kernel_rung,
                                 (torch.zeros(4096),),
                                 Cost(nbytes=10**12, flops=10**12))
    assert row["ok"] is False and set(row["mismatches"]) == {"bytes",
                                                            "flops"}
    evs = trace.events("attribution-mismatch")
    assert evs and all(trace.validate_record(e) == [] for e in evs)
    assert diag.attribution_records()[-1]["op"] == "fake"


def test_sane_cost_model_passes_and_torch_rungs_count_what_they_can():
    n = 4096

    def kernel_rung(x):
        return x + 1.0
    kernel_rung.staged_cost = lambda x: Cost(2 * 4 * x.numel(), x.numel())
    row = diag.check_attribution("fake", "r", f"n{n}", kernel_rung,
                                 (torch.zeros(n),), Cost(2 * 4 * n, n))
    assert row["ok"] and row["source"] == "launch plan"
    # an elementwise torch rung: FlopCounterMode counts nothing, no signal
    row = diag.check_attribution("fake", "t", f"n{n}", lambda x: x + 1.0,
                                 (torch.zeros(n),), Cost(10**12, 10**12))
    assert row["ok"] and row["flops_ratio"] is None
    assert row["source"] == "FlopCounterMode"
    # a matrix product is counted: 2·m·n·k operations
    row = diag.check_attribution("fake", "mm", "64", lambda a: a @ a,
                                 (torch.ones(64, 64),),
                                 Cost(3 * 4 * 64 * 64, 2 * 64 ** 3))
    assert row["measured_flops"] == 2 * 64 ** 3 and row["flops_ratio"] == 1
    assert trace.events("attribution-mismatch") == []


def test_programs_get_runs_attribution_only_when_enabled(monkeypatch):
    def build():
        def fn(x):
            return x * 2.0
        fn.staged_cost = lambda x: Cost(8, 1)
        return fn

    monkeypatch.setenv(diag.ATTRIBUTION_ENV, "1")
    programs.get("attrop", "r", "n128", build, device="cpu",
                 cost=Cost(nbytes=10**12, flops=10**12),
                 probe=lambda: (torch.zeros(128),))
    assert any(r["op"] == "attrop" for r in diag.attribution_records())
    assert trace.events("attribution-mismatch")
    monkeypatch.delenv(diag.ATTRIBUTION_ENV)
    diag.reset()
    trace.clear_events()
    programs.get("attrop", "r", "n128", build, device="cpu",
                 cost=Cost(nbytes=1, flops=1),
                 probe=lambda: (torch.zeros(128),))
    assert diag.attribution_records() == []


def test_the_heat_program_stages_what_its_plan_says(monkeypatch):
    """The kernel rung's staged cost at 1024² order 8, k = 1, tile 64 ×
    128: windows of 72 rows by the strip plus 4 halo columns a side, in
    the grid; the sub-step's micro-tiles over 17 tiles × 9 strips."""
    monkeypatch.setenv(diag.ATTRIBUTION_ENV, "1")
    p = SimParams(nx=1024, ny=1024, order=8, iters=2)
    u = make_initial_grid(p, device="cpu")
    sp._heat_program("pipeline", u, 2, 8, p.xcfl, p.ycfl, p.bc, 1, 64,
                     cost=sp_cost(p))
    (row,) = diag.attribution_records()
    rows = sum(min(1032, t * 64 + 68) - max(0, t * 64 - 4)
               for t in range(17))
    cols = sum(min(1032, c * 128 + 132) - max(0, c * 128 - 4)
               for c in range(9))
    assert row["measured_bytes"] == 2 * (rows * cols + 1032 * 1032) * 4
    assert row["measured_flops"] == 2 * 17 * 9 * 64 * 128 * 38
    assert row["ok"]


def sp_cost(p):
    from cme213_tpu_torch.core.roofline import heat_cost

    return heat_cost(p.gy, p.gx, order=p.order, iters=p.iters)


def test_calibrate_reports_flagship_ops():
    rows = diag.calibrate(device="cpu")
    assert {(r["op"], r["rung"]) for r in rows} == {
        ("spmv_scan", "flat"), ("spmv_scan", "pallas-fused"),
        ("heat", "xla"), ("heat", "pipeline"), ("sort", "xla")}
    by = {(r["op"], r["rung"]): r for r in rows}
    assert all("error" not in r for r in rows)
    for kernel in (("spmv_scan", "pallas-fused"), ("heat", "pipeline")):
        assert by[kernel]["measured_bytes"] is not None and by[kernel]["ok"]
    for plain in (("spmv_scan", "flat"), ("heat", "xla"), ("sort", "xla")):
        assert by[plain]["measured_bytes"] is None
        assert by[plain]["bytes_ratio"] is None


def test_doctor_calibrate_cli_prints_its_rows(capsys):
    import json

    from cme213_tpu_torch import doctor_cli

    assert doctor_cli.main(["calibrate", "--json", "--device=cpu"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 5 and all(r["ok"] for r in rows)
    assert doctor_cli.main(["calibrate", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "heat.pipeline" in out and "no signal" in out
