"""The port's game-day chaos campaigns (``cme213_tpu_torch/core/chaos.py``
and ``chaos_cli.py``) on the CPU.

The counterpart of the JAX package's ``tests/test_chaos.py``: the matrix,
topology and campaign shapes equal the JAX package's (and the topology the
port's adapters), both packages draw the same cocktail strings for the
same seeds (the module and ``chaos draw``), the ddmin shrinker, in-process
campaigns on ``device="cpu"`` holding every invariant, the handicapped
drills that violate, shrink, bank into ``tmp_path`` and replay, the job
campaign over both ``ckpt`` windows, and every banked fixture of
``tests/chaos_fixtures/`` replayed read-only to its recorded ``expect``.
The live-fleet campaign stays ``slow`` as there.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

import cme213_tpu.core.chaos as jchaos
from cme213_tpu_torch.core import (chaos, conformance, faults, metrics,
                                   numerics, trace)
from cme213_tpu_torch.core.chaos import (
    MATRIX,
    TOPOLOGY,
    bank_fixture,
    compatible,
    ddmin,
    draw_cocktail,
    replay_fixture,
    run_campaign,
    run_campaigns,
    shrink,
    validate_cocktail,
)
from cme213_tpu_torch.core.faults import FaultPlan, _Clause
from cme213_tpu_torch.serve.workloads import ADAPTERS, JOB_KINDS

CPU = "cpu"
FIXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "chaos_fixtures", "*.json")))


def _reset_all():
    import cme213_tpu.core.faults as jfaults
    import cme213_tpu.core.metrics as jmetrics
    import cme213_tpu.core.trace as jtrace

    for mod in (faults, jfaults):
        mod.reset()
    for mod in (metrics, jmetrics):
        mod.reset()
    for mod in (trace, jtrace):
        mod.clear_events()
    conformance.reset()
    numerics.reset()


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.delenv("CME213_FAULTS", raising=False)
    monkeypatch.delenv("CME213_MEMORY_BUDGET", raising=False)
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(autouse=True)
def _own_shm_segments_only(request, monkeypatch):
    """``check_leaks`` lists every ``psm_`` segment on the host, and other
    test workers' transport tests create and remove their own meanwhile:
    an in-process campaign counts only the segments this process's shm
    lane created (it creates none; a leak of one would still show).  The
    live fleet campaign (``slow``) keeps the whole host's view."""
    if request.node.get_closest_marker("slow"):
        return
    from cme213_tpu_torch.serve import shm

    created = set()
    real_init = shm.ShmRing.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        if self.created:
            created.add(self.name.lstrip("/"))

    monkeypatch.setattr(shm.ShmRing, "__init__", init)
    host_view = chaos._shm_segments
    monkeypatch.setattr(chaos, "_shm_segments",
                        lambda: host_view() & created)


def _fixture_bytes() -> dict:
    return {p: open(p, "rb").read() for p in FIXTURES}


# ------------------------------------------- tables equal the reference

def test_matrix_equals_reference():
    assert list(MATRIX) == list(jchaos.MATRIX)
    for kind, rule in MATRIX.items():
        assert dataclasses.asdict(rule) == \
            dataclasses.asdict(jchaos.MATRIX[kind]), kind
    assert set(MATRIX) == {"fail", "nan", "wrong", "oom", "slow", "drift",
                           "stage", "unreachable", "rankkill",
                           "replica-kill", "ckpt"}
    assert all(rule.reason for rule in MATRIX.values())


def test_campaign_shape_tables_equal_reference():
    assert TOPOLOGY == jchaos.TOPOLOGY
    assert chaos.JOB_PARAMS == jchaos.JOB_PARAMS
    assert chaos.MIX_TO_OP == jchaos.MIX_TO_OP
    assert chaos.HANDICAPS == jchaos.HANDICAPS
    assert chaos.INVARIANTS == jchaos.INVARIANTS
    assert chaos.fixtures_dir() == jchaos.fixtures_dir()
    assert os.path.isdir(chaos.fixtures_dir())


def test_topology_matches_the_port_s_adapters():
    """The rung ladders are the port's adapters' (normal mode), and the
    port's degraded ladders equal the JAX package's."""
    from cme213_tpu.serve.workloads import ADAPTERS as JADAPTERS

    serving = {op for op, t in TOPOLOGY.items() if not t.get("job")}
    job_ops = {op for op, t in TOPOLOGY.items() if t.get("job")}
    assert serving == set(ADAPTERS)
    assert job_ops == set(JOB_KINDS) == set(chaos.JOB_PARAMS)
    for op in serving:
        assert TOPOLOGY[op]["rungs"] == ADAPTERS[op].rungs(False), op
        assert ADAPTERS[op].rungs(True) == JADAPTERS[op].rungs(True), op


@pytest.mark.parametrize("backend", ["inproc", "fleet"])
def test_clause_targets_equal_reference(backend):
    for ops in (["cipher", "sort"], ["cipher", "heat", "sort", "spmv_scan"],
                ["cipher", "pagerank"], ["stub"]):
        for replicas in (1, 2, 3):
            assert chaos.clause_targets(backend, ops, replicas) == \
                jchaos.clause_targets(backend, ops, replicas)


@pytest.mark.parametrize("backend", ["inproc", "fleet"])
def test_draws_equal_reference_for_every_seed(backend):
    ops = ["cipher", "heat", "sort", "spmv_scan"]
    for seed in range(6):
        for i in range(6):
            port = draw_cocktail(np.random.default_rng([seed, i]), backend,
                                 ops)
            ref = jchaos.draw_cocktail(np.random.default_rng([seed, i]),
                                       backend, ops)
            assert str(port) == str(ref)
            assert validate_cocktail(port, backend) == []


def test_job_campaign_draws_equal_reference():
    ops = ["cipher", "pagerank"]
    for i in range(8):
        port = draw_cocktail(np.random.default_rng([6, i]), "inproc", ops)
        ref = jchaos.draw_cocktail(np.random.default_rng([6, i]), "inproc",
                                   ops)
        assert str(port) == str(ref)


@pytest.mark.parametrize("argv", [
    ["--seed", "1", "--campaigns", "4", "--backend", "fleet",
     "--mix", "cipher,sort,heat"],
    ["--seed", "3", "--campaigns", "3", "--mix", "cipher,sort"],
    ["--seed", "0", "--campaigns", "5", "--mix", "spmv,heat"],
])
def test_chaos_draw_cli_equals_reference(argv, capsys):
    from cme213_tpu import chaos_cli as jcli
    from cme213_tpu_torch import chaos_cli

    assert chaos_cli.main(["draw", *argv]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["draw", *argv]) == 0
    assert capsys.readouterr().out == port
    assert chaos_cli.main(["draw", *argv]) == 0
    assert capsys.readouterr().out == port
    assert len(port.strip().splitlines()) == int(argv[3])


def test_chaos_matrix_cli_equals_reference(capsys):
    from cme213_tpu import chaos_cli as jcli
    from cme213_tpu_torch import chaos_cli

    for flags in (["--json"], []):
        assert chaos_cli.main(["matrix", *flags]) == 0
        port = capsys.readouterr().out
        assert jcli.main(["matrix", *flags]) == 0
        assert capsys.readouterr().out == port
    assert set(json.loads(
        (chaos_cli.main(["matrix", "--json"]), capsys.readouterr().out)[1])
    ) == set(MATRIX)
    assert chaos_cli.main(["--help"]) == 0
    capsys.readouterr()
    assert chaos_cli.main(["no-such"]) == 2


# ------------------------------------------------ grammar and matrix

def test_drawn_cocktails_roundtrip():
    ops = ["cipher", "sort", "spmv_scan", "heat"]
    for s in range(6):
        plan = draw_cocktail(np.random.default_rng([s, 0]), "inproc", ops)
        assert str(FaultPlan.parse(str(plan))) == str(plan)
        assert 2 <= len(plan.clauses) <= 5


def test_validate_flags_ineligible_and_backend():
    assert any("ineligible" in p for p in validate_cocktail(
        FaultPlan.parse("nan:solver:1,fail:serve.cipher.packed:1"),
        "inproc"))
    assert any("backend" in p for p in validate_cocktail(
        FaultPlan.parse("replica-kill:0:1,fail:serve.cipher.packed:1"),
        "inproc"))
    assert validate_cocktail(FaultPlan.parse(
        "replica-kill:0:1,fail:serve.cipher.packed:1"), "fleet") == []


def test_compatible_rejects_conflicts_duplicates_caps():
    drift = _Clause("drift", "serve.heat.xla", nth=1, ms=1e-3)
    kill = _Clause("replica-kill", "0", nth=1)
    assert not compatible([drift], kill)[0]
    assert not compatible([kill], drift)[0]
    f = _Clause("fail", "serve.cipher.packed", nth=1, count=1)
    assert not compatible([f], f)[0]
    s1 = _Clause("stage", "serve.sort.lax", stage="execute")
    s2 = _Clause("stage", "serve.sort.radix", stage="execute")
    assert compatible([s1], s2)[0] is False


def test_wrong_never_codrawn_with_ladder_failure():
    wrong = _Clause("wrong", "serve.sort", nth=1)
    fail_sort = _Clause("fail", "serve.sort.lax", nth=1, count=1)
    fail_ciph = _Clause("fail", "serve.cipher.packed", nth=1, count=1)
    assert not compatible([wrong], fail_sort)[0]
    assert not compatible([fail_sort], wrong)[0]
    assert compatible([wrong], fail_ciph)[0]


def test_inproc_draw_never_contains_kill():
    for i in range(12):
        plan = draw_cocktail(np.random.default_rng([9, i]), "inproc",
                             ["cipher", "sort"])
        assert not any(c.kind in ("replica-kill", "rankkill")
                       for c in plan.clauses)


def test_ckpt_only_drawable_in_job_campaigns():
    ops = ["cipher", "sort"]
    assert "ckpt" not in chaos.clause_targets("inproc", ops, 2)
    pool = chaos.clause_targets("inproc", ops + ["pagerank"], 2)
    assert sorted(t["op"] for t in pool["ckpt"]) == ["commit", "truncate"]
    assert "ckpt" not in chaos.clause_targets("fleet",
                                              ops + ["pagerank"], 2)


# ---------------------------------------------------------- ddmin units

def test_ddmin_single_culprit_and_pair():
    assert ddmin(list("abcdefgh"), lambda s: "e" in s) == ["e"]
    got = ddmin(list("abcdefgh"), lambda s: "b" in s and "g" in s)
    assert sorted(got) == ["b", "g"]
    assert ddmin([3, 1, 2], lambda s: 1 in s and 2 in s) == [1, 2]
    assert ddmin([7], lambda s: True) == [7]


def test_shrink_equals_reference():
    """The same failing predicate shrinks to the same minimal cocktail in
    both packages, parameters simplified too."""
    spec = ("slow:serve.cipher:50.0:2:3,fail:serve.cipher.packed:2:3,"
            "drift:serve.heat.xla:0.001:1")

    def failing(p):
        return any(c.kind == "fail" for c in p.clauses)

    port = shrink(FaultPlan.parse(spec), failing)
    ref = jchaos.shrink(jchaos.FaultPlan.parse(spec), failing)
    assert str(port) == str(ref) == "fail:serve.cipher.packed:1:1"


# --------------------------------------------------- invariant checks

def test_shm_segments_carry_the_checked_prefix():
    """``check_leaks`` looks for ``psm_`` segments; the port's shm lane
    names its segments through ``SharedMemory``'s defaults, which carry
    that prefix, so a leaked ring is seen."""
    from cme213_tpu_torch.serve.shm import ShmRing

    before = chaos._shm_segments()
    ring = ShmRing(slots=1, slot_bytes=4096, create=True)
    try:
        assert ring.name.lstrip("/").startswith("psm_")
        leaked = chaos.check_leaks(before, [])
        assert [v.invariant for v in leaked] == ["leaks"]
        assert ring.name.lstrip("/") in leaked[0].detail
    finally:
        ring.close()
    assert chaos.check_leaks(before, []) == []
    assert [v.invariant for v in chaos.check_leaks(before, ["r0(pid 1)"])] \
        == ["leaks"]


def test_loss_and_report_checks_equal_reference():
    from cme213_tpu_torch.serve.request import SolveResult

    pairs = [(None, SolveResult(0, "cipher", "ok")),
             (None, SolveResult(1, "cipher", "shed", reason="queue-full")),
             (None, SolveResult(2, "cipher", "failed", reason="x"))]
    for submitted in (3, 4):
        port = [v.as_dict() for v in chaos.check_loss(pairs, submitted)]
        ref = [v.as_dict() for v in jchaos.check_loss(pairs, submitted)]
        assert port == ref and port
    for report in ({}, {"trace_id": "t", "requests": 1, "served": 1,
                        "shed": 0, "failed": 0, "latency_ms": {},
                        "throughput_rps": 1.0}):
        assert [v.as_dict() for v in chaos.check_slo_report(report)] == \
            [v.as_dict() for v in jchaos.check_slo_report(report)]
    assert chaos.check_trace({"a", None}, "a") == []
    assert chaos.check_trace({"a", "b"}, "a")[0].invariant == "trace"


# ------------------------------------------------- campaigns end-to-end

def test_benign_campaign_holds_all_invariants_as_the_reference():
    cocktail = "fail:serve.cipher.packed:1:2,slow:serve.cipher:20.0:1:2"
    res = run_campaign(cocktail, backend="inproc", mix="cipher",
                       requests=8, seed=3, device=CPU)
    assert res.ok, [v.as_dict() for v in res.violations]
    assert res.report["served"] + res.report["shed"] == 8
    assert [e["event"] for e in trace.events("chaos-campaign")] == \
        ["chaos-campaign"]
    ref = jchaos.run_campaign(cocktail, backend="inproc", mix="cipher",
                              requests=8, seed=3)
    assert ref.ok
    assert res.as_dict().keys() == ref.as_dict().keys()
    for key in ("served", "shed", "failed", "requests"):
        assert res.report[key] == ref.report[key], key
    assert res.cocktail == ref.cocktail


def test_campaign_is_deterministic_per_seed():
    kw = dict(backend="inproc", mix="cipher", requests=6, seed=7,
              device=CPU)
    a = run_campaign("fail:serve.cipher.packed:1:1", **kw)
    b = run_campaign("fail:serve.cipher.packed:1:1", **kw)
    assert a.ok and b.ok
    assert a.cocktail == b.cocktail
    assert a.report["served"] == b.report["served"]


def test_campaign_refusals():
    with pytest.raises(ValueError, match="kill"):
        run_campaign("replica-kill:0:1", backend="inproc", mix="cipher",
                     requests=2, seed=0, device=CPU)
    with pytest.raises(ValueError, match="handicap"):
        run_campaign("fail:x:1", backend="inproc", mix="cipher",
                     requests=2, seed=0, handicaps=("no-such",),
                     device=CPU)
    with pytest.raises(ValueError, match="backend"):
        run_campaign("fail:x:1", backend="warp", mix="cipher",
                     requests=2, seed=0, device=CPU)
    with pytest.raises(ValueError, match="job campaign"):
        run_campaign("ckpt:commit:1", backend="inproc", mix="cipher",
                     requests=2, seed=0, device=CPU)
    with pytest.raises(ValueError, match="inproc"):
        run_campaign("ckpt:commit:1", backend="fleet", mix="cipher",
                     requests=2, seed=0, job="pagerank", device=CPU)


def test_conformance_re_solves_on_the_campaign_s_device(monkeypatch):
    """The check re-solves each served result on the device that served
    it: the campaign's ``device`` reaches every reference re-solve."""
    seen = []
    real = chaos._reference_resolve

    def spy(spec, rung, device=None):
        seen.append(str(device))
        return real(spec, rung, device)

    monkeypatch.setattr(chaos, "_reference_resolve", spy)
    res = run_campaign("slow:serve.sort:20.0:1:1", backend="inproc",
                       mix="cipher,sort", requests=6, seed=4, device=CPU)
    assert res.ok, [v.as_dict() for v in res.violations]
    assert seen and set(seen) == {"cpu"}


def test_job_campaign_survives_both_ckpt_windows():
    res = run_campaign("ckpt:truncate:1,ckpt:commit:1", backend="inproc",
                       mix="cipher", requests=8, seed=11, job="pagerank",
                       device=CPU)
    assert res.ok, [v.as_dict() for v in res.violations]
    assert res.job == "pagerank"
    done = trace.events("job-done")
    assert done and done[-1]["state"] == "DONE"


def test_job_campaign_handicap_drill_violates_and_replays(tmp_path):
    cocktail = "ckpt:commit:1,slow:serve.cipher:20.0:1:1"
    kw = dict(backend="inproc", mix="cipher", requests=6, seed=12,
              job="pagerank", handicaps=("ckpt-retry",), device=CPU)
    res = run_campaign(cocktail, **kw)
    assert {v.invariant for v in res.violations} == {"job"}

    minimal = shrink(FaultPlan.parse(cocktail),
                     lambda p: bool(run_campaign(p, **kw).violations))
    assert str(minimal) == "ckpt:commit:1"
    path = bank_fixture(res, minimal, directory=str(tmp_path),
                        handicaps=("ckpt-retry",))
    replayed, expected, observed = replay_fixture(path, device=CPU)
    assert expected == observed == ["job"]
    assert replayed.job == "pagerank"


def test_drill_violates_shrinks_banks_and_replays(tmp_path):
    before = _fixture_bytes()
    cocktail = ("drift:serve.spmv_scan.blocked:0.001:1,"
                "slow:serve.spmv_scan:20.0:1:1")
    kw = dict(backend="inproc", mix="spmv", requests=6, seed=5,
              handicaps=("drift-compensation",), device=CPU)
    res = run_campaign(cocktail, **kw)
    assert {v.invariant for v in res.violations} == {"conformance"}
    assert len(trace.events("chaos-violation")) >= 1

    minimal = shrink(FaultPlan.parse(cocktail),
                     lambda p: bool(run_campaign(p, **kw).violations))
    assert len(minimal.clauses) <= 2
    assert minimal.clauses[0].kind == "drift"
    path = bank_fixture(res, minimal, directory=str(tmp_path),
                        handicaps=("drift-compensation",))
    assert os.path.dirname(path) == str(tmp_path)
    replayed, expected, observed = replay_fixture(path, device=CPU)
    assert expected == observed == ["conformance"]
    assert _fixture_bytes() == before       # the shared bank untouched


def test_drift_with_compensation_is_conformant():
    res = run_campaign("drift:serve.spmv_scan.blocked:0.001:1",
                       backend="inproc", mix="spmv", requests=6, seed=5,
                       device=CPU)
    assert res.ok, [v.as_dict() for v in res.violations]


def test_run_campaigns_orchestration_draws_the_reference_s_cocktails(
        tmp_path):
    out = run_campaigns(seed=2, campaigns=2, backend="inproc",
                        mix="cipher", requests=6, bank_dir=str(tmp_path),
                        device=CPU)
    assert len(out["campaigns"]) == 2
    assert out["ok"] == (out["violations_total"] == 0)
    for i, c in enumerate(out["campaigns"]):
        ref = jchaos.draw_cocktail(np.random.default_rng([2, i]), "inproc",
                                   ["cipher"], 2)
        assert c["cocktail"] == str(ref)
        assert validate_cocktail(FaultPlan.parse(c["cocktail"]),
                                 "inproc") == []
    assert json.loads(json.dumps(out)) == out
    assert all(os.path.dirname(p) == str(tmp_path) for p in out["fixtures"])


def test_chaos_run_cli_banks_where_told(tmp_path, capsys):
    from cme213_tpu_torch import chaos_cli

    before = _fixture_bytes()
    rc = chaos_cli.main(["run", "--seed", "2", "--campaigns", "1",
                         "--mix", "cipher", "--requests", "6",
                         "--bank-dir", str(tmp_path), "--device", "cpu",
                         "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == (0 if doc["ok"] else 1)
    assert len(doc["campaigns"]) == 1
    assert _fixture_bytes() == before


# --------------------------------------------------- banked fixtures

@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p) for p in FIXTURES])
def test_banked_fixture_replays(path):
    """The JAX package's four banked fixtures replay to their recorded
    ``expect`` in the port (read-only: nothing is banked back)."""
    before = open(path, "rb").read()
    result, expected, observed = replay_fixture(path, device=CPU)
    assert observed == expected, \
        f"{os.path.basename(path)}: {result.violations}"
    assert open(path, "rb").read() == before


def test_fixture_bank_is_not_empty():
    docs = [json.load(open(p)) for p in FIXTURES]
    assert len(docs) == 4
    assert any(d["expect"]["violated"] == [] for d in docs)
    assert any(d["expect"]["violated"] for d in docs)
    for d in docs:
        assert FaultPlan.parse(d["minimal_cocktail"]).clauses


def test_chaos_replay_cli(capsys):
    from cme213_tpu_torch import chaos_cli

    benign = [p for p in FIXTURES if "benign" in p]
    assert chaos_cli.main(["replay", *benign, "--device", "cpu",
                           "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["fixtures"][0]["match"]


# --------------------------------------------------- live-fleet campaign

@pytest.mark.slow
def test_fleet_campaign_with_replica_kill(monkeypatch):
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    res = run_campaign(
        "replica-kill:0:2,fail:serve.cipher.packed:1:1",
        backend="fleet", mix="cipher,sort", requests=12, seed=6,
        replicas=2, device=CPU)
    assert res.ok, [v.as_dict() for v in res.violations]
    assert res.report["served"] == 12
