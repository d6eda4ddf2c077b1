"""The port's conformance gate (``core/conformance.py``) against the JAX
package's, and the fallback ladder's rule for kernels that cannot build or
launch.

Counterpart of the conformance cases of ``tests/test_guarded_execution.py``.
The same inputs go to ``cme213_tpu.core.conformance`` and to
``cme213_tpu_torch.core.conformance``: ``_compare`` must give the same
verdict and detail text exactly; ``check`` the same verdicts, events and
cache behaviour.  Probe outputs on the port's side may be tensors.
"""

import json

import numpy as np
import pytest
import torch

from cme213_tpu.core import conformance as jconf
from cme213_tpu.core import faults as jfaults
from cme213_tpu.core import resilience as jres
from cme213_tpu.core import trace as jtrace
from cme213_tpu_torch.core import FailureKind, KernelError, with_fallback
from cme213_tpu_torch.core import conformance as tconf
from cme213_tpu_torch.core import diag as tdiag
from cme213_tpu_torch.core import faults as tfaults
from cme213_tpu_torch.core import metrics as tmetrics
from cme213_tpu_torch.core import trace as ttrace
from cme213_tpu_torch.core.errors import FrameworkError


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.delenv(tconf.CACHE_ENV, raising=False)
    monkeypatch.delenv("CME213_FAULTS", raising=False)
    for mod in (jtrace, ttrace):
        mod.clear_events()
    for mod in (jconf, tconf, jfaults, tfaults):
        mod.reset()
    tmetrics.reset()
    yield
    for mod in (jconf, tconf, jfaults, tfaults):
        mod.reset()


# ------------------------------------------------------------- _compare

_REF = np.linspace(-2, 3, 64, dtype=np.float32)


def _bump(a, i=5, ulps=1):
    b = a.copy()
    b[i] = np.nextafter(b[i], np.float32(np.inf), dtype=np.float32)
    for _ in range(ulps - 1):
        b[i] = np.nextafter(b[i], np.float32(np.inf), dtype=np.float32)
    return b


def _nan(a):
    b = a.copy()
    b[0] = np.nan
    return b


COMPARE_CASES = {
    "equal": (_REF, _REF, 0.0, 0),
    "one-ulp-bitwise": (_bump(_REF), _REF, 0.0, 0),
    "one-ulp-rel-l2": (_bump(_REF), _REF, 1e-5, 0),
    "far-rel-l2": (_REF * np.float32(1.5), _REF, 1e-5, 0),
    "three-ulps-ulp2": (_bump(_REF, ulps=3), _REF, 0.0, 2),
    "three-ulps-ulp10": (_bump(_REF, ulps=3), _REF, 1e-5, 10),
    "nan": (_nan(_REF), _REF, 1.0, 0),
    "shape": (_REF[:8], _REF, 0.0, 0),
    "dtype": (_REF.astype(np.float64), _REF, 0.0, 0),
    "zero-reference": (np.zeros(4, np.float32), np.zeros(4, np.float32),
                       1e-5, 0),
    "empty": (np.zeros(0, np.float32), np.zeros(0, np.float32), 0.0, 3),
}


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_matches_jax_exactly(case):
    out, ref, rel_l2, max_ulps = COMPARE_CASES[case]
    assert tconf._compare(out, ref, rel_l2, max_ulps) == \
        jconf._compare(out, ref, rel_l2, max_ulps)


# ---------------------------------------------------------------- check

def test_check_pass_fail_and_events():
    ref = np.arange(8, dtype=np.float32)
    v = tconf.check("op", "good", "f32", lambda: ref.copy(),
                    lambda: ref.copy())
    assert v.ok and not v.cached and v.detail == "bitwise"
    bad = ref.copy()
    bad[3] += 1.0
    v2 = tconf.check("op", "bad", "f32", lambda: bad, lambda: ref.copy())
    assert not v2.ok
    failed = ttrace.events("conformance-failed")
    assert [(e["op"], e["rung"]) for e in failed] == [("op", "bad")]
    assert [e["ok"] for e in ttrace.events("conformance-probe")] == \
        [True, False]
    snap = tmetrics.snapshot()["counters"]
    assert snap["conformance.probes"] == 2 and snap["conformance.failed"] == 1


def test_check_takes_tensors_and_copies_them_to_the_host():
    ref = torch.arange(8, dtype=torch.float32)
    v = tconf.check("op", "t", "f32", lambda: ref.clone(), lambda: ref)
    assert v.ok and v.detail == "bitwise"
    # a tensor candidate against a numpy reference compares the same way
    v = tconf.check("op", "t2", "f32", lambda: ref.clone(),
                    lambda: ref.numpy().copy())
    assert v.ok


def test_declared_tolerance_matches_jax():
    ref = np.ones(1000, np.float32)
    near = ref * np.float32(1 + 1e-7)
    far = ref * np.float32(1.5)
    for conf in (jconf, tconf):
        assert not conf.check("op", "r1", "f32", lambda: near,
                              lambda: ref.copy()).ok
        assert conf.check("op", "r2", "f32", lambda: near,
                          lambda: ref.copy(), rel_l2=1e-5).ok
        assert not conf.check("op", "r3", "f32", lambda: far,
                              lambda: ref.copy(), rel_l2=1e-5).ok
    assert {k: v.ok for k, v in tconf.verdicts().items()} == \
        {k: v.ok for k, v in jconf.verdicts().items()}


def test_nonfinite_candidate_fails():
    ref = np.ones(4, np.float32)
    bad = ref.copy()
    bad[0] = np.nan
    assert not tconf.check("op", "r", "f32", lambda: bad,
                           lambda: ref.copy(), rel_l2=1.0).ok


def test_probe_cache_hit_and_miss():
    calls = []

    def candidate():
        calls.append(1)
        return torch.ones(4)

    def ref():
        return torch.ones(4)

    v1 = tconf.check("op", "r", "cls", candidate, ref)
    v2 = tconf.check("op", "r", "cls", candidate, ref)
    assert len(calls) == 1 and not v1.cached and v2.cached and v2.ok
    tconf.check("op", "r", "other-cls", candidate, ref)
    assert len(calls) == 2
    tconf.reset()
    tconf.check("op", "r", "cls", candidate, ref)
    assert len(calls) == 3
    assert tmetrics.snapshot()["counters"]["conformance.cache_hits"] == 1


def test_disk_cache_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "verdicts.json"
    monkeypatch.setenv(tconf.CACHE_ENV, str(path))
    calls = []

    def candidate():
        calls.append(1)
        return torch.ones(4)

    tconf.check("op", "r", "cls", candidate, lambda: torch.ones(4))
    assert json.loads(path.read_text())["op|r|cls"]["ok"] is True
    tconf.reset()  # a "new process": the in-memory verdicts are gone
    v = tconf.check("op", "r", "cls", candidate, lambda: torch.ones(4))
    assert v.ok and v.cached and len(calls) == 1


def test_verdicts_under_a_fault_plan_stay_in_their_process(tmp_path,
                                                          monkeypatch):
    """An injected ``wrong:`` verdict is never written to the disk cache,
    so a later process probes again rather than replaying a demotion."""
    path = tmp_path / "verdicts.json"
    monkeypatch.setenv(tconf.CACHE_ENV, str(path))
    with tfaults.injected("wrong:op"):
        v = tconf.check("op", "r", "cls", lambda: torch.ones(4),
                        lambda: torch.ones(4))
    assert not v.ok and not path.exists()
    tconf.reset()
    v = tconf.check("op", "r", "cls", lambda: torch.ones(4),
                    lambda: torch.ones(4))
    assert v.ok and not v.cached
    assert json.loads(path.read_text())["op|r|cls"]["ok"] is True


def test_gates_key_verdicts_by_the_kernel_build():
    """The gates put ``build_identity`` of their device in the shape
    class: ``cpu`` here; on a card its name and the kernel sources'
    digest, which changes with any source."""
    from cme213_tpu_torch.core.platform import build_identity
    from cme213_tpu_torch.ops import _kernels
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    assert build_identity("cpu") == "cpu"
    digest = _kernels.sources_digest()
    assert len(digest) == 16 and int(digest, 16) >= 0
    assert sp._heat_conformance_gate(2, 1, device="cpu")("pipeline")
    assert list(tconf.verdicts()) == ["heat|pipeline|order2/k1/float32/cpu"]


def test_corrupt_disk_cache_reprobes(tmp_path, monkeypatch):
    path = tmp_path / "verdicts.json"
    path.write_text("{not json")
    monkeypatch.setenv(tconf.CACHE_ENV, str(path))
    v = tconf.check("op", "r", "cls", lambda: torch.ones(2),
                    lambda: torch.ones(2))
    assert v.ok and not v.cached
    assert json.loads(path.read_text())["op|r|cls"]["ok"] is True


@pytest.mark.parametrize("spec", ["wrong:op", "wrong:op:2"])
def test_wrong_fault_perturbs_the_same_probe_as_jax(spec):
    """A ``wrong:`` clause perturbs the candidate of the same probe in
    both packages (the port's on the tensor itself)."""
    got = []
    for conf, faults, make in (
            (jconf, jfaults, lambda: np.ones(4, np.float32)),
            (tconf, tfaults, lambda: torch.ones(4))):
        with faults.injected(spec):
            got.append([conf.check("op", r, "cls", make,
                                   lambda: np.ones(4, np.float32)).ok
                        for r in ("a", "b", "c")])
    assert got[0] == got[1]
    assert got[1].count(False) == 1


def test_stage_fault_kills_the_probe_tagged_conformance():
    with tfaults.injected("stage:op.r:conformance"):
        with pytest.raises(tfaults.InjectedFault) as info:
            tconf.check("op", "r", "cls", lambda: torch.ones(2),
                        lambda: torch.ones(2))
    assert tdiag.failure_stage(info.value) == "conformance"


def test_guarded_events_validate_against_schema():
    ref = torch.ones(4)
    tconf.check("op", "r", "cls", lambda: ref + 1, lambda: ref)
    with tfaults.injected("wrong:op:1"):
        tfaults.maybe_perturb("op", torch.ones(3))
    for rec in ttrace.events():
        assert ttrace.validate_record(rec) == [], rec


# ------------------------------------------------------- the ladder's gate

def _records(trace):
    return [{k: v for k, v in r.items()
             if k in ("event", "op", "rung", "kind", "error", "demoted",
                      "failed_rungs", "stage", "kernel")}
            for r in trace.events()]


def test_gate_demotes_wrong_answer_like_jax():
    results = []
    for res_mod, trace in ((jres, jtrace), (None, ttrace)):
        fb = res_mod.with_fallback if res_mod else with_fallback
        res = fb("op", [("a", lambda: "a-val"), ("b", lambda: "b-val")],
                 gate=lambda rung: rung != "a")
        results.append((res.value, res.rung,
                        [f.kind.value for f in res.failures],
                        _records(trace)))
    assert results[0] == results[1]
    assert results[1][2] == [FailureKind.WRONG_ANSWER.value]


def test_gate_rejecting_every_rung_raises():
    with pytest.raises(FrameworkError, match="rungs"):
        with_fallback("op", [("a", lambda: 1)], gate=lambda r: False)


def test_kernel_error_escapes_while_an_injected_fail_demotes():
    """A rung whose kernel cannot build or launch raises out of the
    ladder; an injected ``fail:`` on the same rung demotes it."""
    def broken():
        raise KernelError("heat_ksteps launch failed: invalid argument "
                          "(cudaError 1; ...)")

    ladder = [("kernel", broken), ("plain", lambda: "plain-val")]
    with pytest.raises(KernelError, match="launch failed"):
        with_fallback("op", ladder)
    ev = ttrace.events("kernel-failure")[-1]
    assert (ev["kernel"], ev["error"], ev["stage"]) == \
        ("kernel", "KernelError", "execute")
    assert not ttrace.events("rung-failed")
    assert not ttrace.events("served")

    ttrace.clear_events()
    with tfaults.injected("fail:op.kernel"):
        res = with_fallback("op", [("kernel", lambda: "kernel-val"),
                                   ("plain", lambda: "plain-val")])
    assert (res.value, res.rung) == ("plain-val", "plain")
    assert [f.kind for f in res.failures] == [FailureKind.RUNTIME]
    assert ttrace.events("served")[-1]["demoted"]


def test_kernel_error_out_of_a_probe_escapes_the_gate():
    def gate(rung):
        raise KernelError("nvcc failed on heat_stencil.cu (rc 1)")

    with pytest.raises(KernelError, match="nvcc failed"):
        with_fallback("op", [("a", lambda: 1), ("b", lambda: 2)], gate=gate)
    ev = ttrace.events("kernel-failure")[-1]
    assert (ev["kernel"], ev["stage"]) == ("a", "compile")
    # any other exception out of a probe is a rung failure: it demotes
    res = with_fallback("op", [("a", lambda: 1), ("b", lambda: 2)],
                        gate=lambda r: r == "b" or 1 / 0)
    assert res.rung == "b" and res.failures[0].kind is FailureKind.NUMERIC
