"""The port's durable long-job lane (``cme213_tpu_torch/serve/jobs.py``)
on the CPU: the JAX package's ``tests/test_jobs.py`` cases ported one for
one (its ``slow`` fleet arcs wait for the port's fleet), every executor
and server on ``device="cpu"``, plus the cross-package arcs: a job one
package's store committed resumes in the other's, bitwise the numpy
golden, over the store and over the wire.

Durable long-job lane (``serve/jobs.py``): store durability, the
write-ahead epoch loop, preemption/resume, and the transport controls.

The contract under test is the one Torque gave the reference's
``qsub`` scripts: a submitted solve survives the death of whatever was
running it.  Here that means (a) the record store survives torn writes
(CRC + ``.prev`` fallback + quarantine), (b) a committed epoch is never
re-executed — after any crash/injected-fault recovery the ``job-epoch``
numbers stay unique and the final ranking is **bitwise-equal** to an
uninterrupted run, and (c) interactive traffic strictly preempts job
epochs at epoch boundaries.
"""

import json
import threading
import time

import numpy as np
import pytest

from cme213_tpu_torch.core import faults, metrics, trace
from cme213_tpu_torch.serve import Server
from cme213_tpu_torch.serve.loadgen import build_mix
from cme213_tpu_torch.serve import jobs as jobs_mod
from cme213_tpu_torch.serve import wire
from cme213_tpu_torch.serve.jobs import (
    DONE,
    FAILED,
    PENDING,
    PREEMPTED,
    RUNNING,
    JobError,
    JobExecutor,
    JobStore,
    submit_job,
)
from cme213_tpu_torch.serve.workloads import JOB_KINDS, PageRankJob


@pytest.fixture(autouse=True)
def _clean_slate():
    trace.clear_events()
    metrics.reset()
    faults.reset()
    yield
    faults.reset()
    metrics.reset()


#: small-but-multi-epoch PageRank: 3 epochs of 4 iterations (the
#: kind requires even epochs: the fused rung iterates in pairs)
PARAMS = {"nodes": 96, "avg_edges": 4, "iters": 12, "epoch": 4, "seed": 7}


def _bits(arr) -> bytes:
    return np.ascontiguousarray(np.asarray(arr)).tobytes()


def _run_to_terminal(ex: JobExecutor, budget: int = 200) -> None:
    for _ in range(budget):
        if not ex.tick():
            if all(r["state"] in jobs_mod.TERMINAL
                   for r in ex.store.list_jobs()):
                return
        time.sleep(0)
    raise AssertionError("job did not reach a terminal state in budget")


def _clean_result(tmp_path, params=None) -> np.ndarray:
    """Uninterrupted run in a scratch store — the bitwise baseline."""
    store = JobStore(str(tmp_path / "baseline"))
    submit_job(store, "baseline", "pagerank", dict(params or PARAMS))
    _run_to_terminal(JobExecutor(store, rank="base", device="cpu"))
    rec = store.load("baseline")
    assert rec["state"] == DONE
    return store.load_result("baseline")


# ------------------------------------------------------------- the store


def test_submit_is_idempotent(tmp_path):
    store = JobStore(str(tmp_path))
    rec1, created1 = submit_job(store, "j1", "pagerank", dict(PARAMS))
    rec2, created2 = submit_job(store, "j1", "pagerank", dict(PARAMS))
    assert created1 and not created2
    assert rec1 == rec2 and rec2["state"] == PENDING
    assert len(trace.events("job-submitted")) == 1
    assert rec1["total_epochs"] == 3 and rec1["epoch_iters"] == 4


def test_bad_ids_and_unknown_ops_are_refused(tmp_path):
    store = JobStore(str(tmp_path))
    with pytest.raises(JobError):
        submit_job(store, "../escape", "pagerank", {})
    with pytest.raises(JobError):
        submit_job(store, "j1", "not-a-job", {})
    with pytest.raises(ValueError):
        submit_job(store, "j1", "pagerank", {"bogus_knob": 3})


def test_illegal_transition_raises(tmp_path):
    store = JobStore(str(tmp_path))
    rec, _ = submit_job(store, "j1", "pagerank", dict(PARAMS))
    with pytest.raises(JobError):
        store.publish(rec, state=DONE)       # PENDING -> DONE is illegal
    rec = store.load("j1")
    assert rec["state"] == PENDING


def test_torn_record_falls_back_to_prev_and_quarantines(tmp_path):
    store = JobStore(str(tmp_path))
    rec, _ = submit_job(store, "j1", "pagerank", dict(PARAMS))
    store.publish(rec, state=RUNNING)        # retains PENDING at .prev
    path = store.record_path("j1")
    with open(path, "w") as f:
        f.write('{"torn": tru')              # torn mid-write
    loaded = store.load("j1")
    assert loaded is not None and loaded["state"] == PENDING
    assert (tmp_path / "job-j1.json.corrupt").exists()
    assert metrics.counter("jobs.record_quarantines").value == 1
    # a CRC mismatch (bit rot, not torn JSON) is quarantined the same way
    doc = json.loads((tmp_path / "job-j1.json.prev").read_text())
    doc["state"] = RUNNING                   # flipped without re-CRC
    (tmp_path / "job-j1.json.prev").write_text(json.dumps(doc))
    assert store.load("j1") is None
    assert (tmp_path / "job-j1.json.prev.corrupt").exists()


def test_reassign_from_moves_only_live_jobs(tmp_path):
    store = JobStore(str(tmp_path))
    for jid in ("a", "b", "c"):
        submit_job(store, jid, "pagerank", dict(PARAMS))
    assert store.claim("a", "0") and store.claim("b", "0")
    assert store.claim("c", "1")
    rec = store.load("b")
    store.publish(rec, state=FAILED, reason="x")   # terminal: stays put
    moved = store.reassign_from("0", "2")
    assert moved == ["a"]
    assert store.owner("a") == "2" and store.owner("b") == "0"
    assert store.owner("c") == "1"


# ---------------------------------------------------------- the executor


def test_executor_runs_pagerank_to_done(tmp_path):
    store = JobStore(str(tmp_path))
    submit_job(store, "j1", "pagerank", dict(PARAMS))
    ex = JobExecutor(store, rank="0", device="cpu")
    _run_to_terminal(ex)
    rec = store.load("j1")
    assert rec["state"] == DONE
    assert rec["epoch"] == rec["total_epochs"] == 3
    assert rec["iters"] == rec["total_iters"] == 12
    value = store.load_result("j1")
    ref = PageRankJob.reference(rec["params"])
    np.testing.assert_allclose(value, ref, rtol=1e-5, atol=1e-7)
    assert _bits(value) == _bits(ref)        # the port's fold is golden's
    # committed epochs are unique — nothing ran twice
    epochs = [e["epoch"] for e in trace.events("job-epoch")]
    assert epochs == [1, 2, 3]
    done = trace.events("job-done")
    assert done and done[-1]["state"] == DONE


def test_duplicate_submit_after_done_returns_original_result(tmp_path):
    store = JobStore(str(tmp_path))
    submit_job(store, "j1", "pagerank", dict(PARAMS))
    _run_to_terminal(JobExecutor(store, rank="0", device="cpu"))
    first = store.load_result("j1")
    rec, created = submit_job(store, "j1", "pagerank", dict(PARAMS))
    assert not created and rec["state"] == DONE
    assert _bits(store.load_result("j1")) == _bits(first)
    # the executor has nothing to do for it either
    assert JobExecutor(store, rank="0", device="cpu").tick() is False


def test_cancel_finishes_the_job_failed(tmp_path):
    store = JobStore(str(tmp_path))
    submit_job(store, "j1", "pagerank", dict(PARAMS))
    store.request_cancel("j1")
    ex = JobExecutor(store, rank="0", device="cpu")
    assert ex.tick() is True
    rec = store.load("j1")
    assert rec["state"] == FAILED and rec["reason"] == "cancelled"


def test_injected_commit_abort_replays_intent_bitwise(tmp_path):
    """The ``ckpt:commit`` window: the epoch checkpoint is durable but
    the record publish dies.  The write-ahead intent re-targets the SAME
    epoch next tick; iterations already committed are never re-run and
    the final ranking is bitwise-equal to an uninterrupted solve."""
    baseline = _clean_result(tmp_path)
    store = JobStore(str(tmp_path / "jobs"))
    submit_job(store, "j1", "pagerank", dict(PARAMS))
    ex = JobExecutor(store, rank="0", device="cpu")
    # publish #1 is the PENDING->RUNNING activation; #2 is epoch 1's
    with faults.injected("ckpt:commit:2"):
        _run_to_terminal(ex)
    assert metrics.counter("jobs.commit_failures").value == 1
    assert metrics.counter("jobs.intent_replays").value == 1
    rec = store.load("j1")
    assert rec["state"] == DONE
    epochs = [e["epoch"] for e in trace.events("job-epoch")
              if e["job"] == "j1"]
    assert epochs == [1, 2, 3]               # no committed epoch re-ran
    assert _bits(store.load_result("j1")) == _bits(baseline)


def test_commit_retry_budget_fails_the_job(tmp_path):
    store = JobStore(str(tmp_path))
    submit_job(store, "j1", "pagerank", dict(PARAMS))
    ex = JobExecutor(store, rank="0", commit_retries=0, device="cpu")
    with faults.injected("ckpt:commit:2"):
        _run_to_terminal(ex)
    rec = store.load("j1")
    assert rec["state"] == FAILED and rec["reason"] == "commit-failed"


def test_torn_epoch_checkpoint_recovers_from_prev(tmp_path):
    """``ckpt:truncate`` tears the epoch ``.npz`` mid-write: the loader
    quarantines it, the retained ``.prev`` serves, and the job still
    finishes bitwise-equal."""
    baseline = _clean_result(tmp_path)
    store = JobStore(str(tmp_path / "jobs"))
    submit_job(store, "j1", "pagerank", dict(PARAMS))
    ex = JobExecutor(store, rank="0", device="cpu")
    with faults.injected("ckpt:truncate:2"):
        _run_to_terminal(ex)
    rec = store.load("j1")
    assert rec["state"] == DONE
    assert _bits(store.load_result("j1")) == _bits(baseline)


def test_crash_resume_is_bitwise_equal(tmp_path):
    """A new process (new executor, same rank) finds a RUNNING record it
    never started: resumes with source ``crash`` from the last durable
    epoch, continues the epoch numbering, and lands bitwise-equal."""
    baseline = _clean_result(tmp_path)
    store = JobStore(str(tmp_path / "jobs"))
    submit_job(store, "j1", "pagerank", dict(PARAMS))
    ex1 = JobExecutor(store, rank="0", device="cpu")
    assert ex1.tick() and ex1.tick()         # activate + epochs 1..2
    while store.load("j1")["epoch"] < 2:
        ex1.tick()
    del ex1                                  # SIGKILL stand-in: no exit path
    # another rank must NOT steal the claim while the owner may be alive
    thief = JobExecutor(store, rank="1", device="cpu")
    assert thief.tick() is False
    ex2 = JobExecutor(JobStore(str(tmp_path / "jobs")), rank="0",
                      device="cpu")
    _run_to_terminal(ex2)
    resumed = trace.events("job-resumed")
    assert [e["source"] for e in resumed] == ["crash"]
    rec = store.load("j1")
    assert rec["state"] == DONE and rec["resumes"] == 1
    epochs = [e["epoch"] for e in trace.events("job-epoch")
              if e["job"] == "j1"]
    assert sorted(set(epochs)) == epochs == [1, 2, 3]
    assert _bits(store.load_result("j1")) == _bits(baseline)


def test_interactive_queue_preempts_then_resumes(tmp_path):
    """Queued interactive work preempts the job at the epoch boundary
    (never mid-epoch); the drained queue lets it resume where it left
    off with source ``preempted``."""
    server = Server(capacity=8, max_batch=4, device="cpu")
    store = JobStore(str(tmp_path))
    submit_job(store, "j1", "pagerank", dict(PARAMS))
    ex = JobExecutor(store, server=server, rank="0")
    assert ex.tick() is True                 # epoch 1 in an idle gap
    spec = build_mix("cipher", 1, seed=5)[0]
    assert server.submit(spec.op, spec.payload) is not None
    assert ex.tick() is False                # preempted, no epoch ran
    rec = store.load("j1")
    assert rec["state"] == PREEMPTED and rec["preemptions"] == 1
    assert rec["epoch"] == 1                 # boundary, not mid-epoch
    assert trace.events("job-preempted")[-1]["reason"] == "queue-depth"
    server.step()                            # interactive batch drains
    _run_to_terminal(ex)
    assert [e["source"] for e in trace.events("job-resumed")] \
        == ["preempted"]
    assert store.load("j1")["state"] == DONE


def test_stalled_job_gets_the_stalled_verdict(tmp_path):
    store = JobStore(str(tmp_path))
    # tiny graph converges almost immediately; a 1-epoch stall budget
    # trips STALLED long before the iteration budget runs out
    submit_job(store, "j1", "pagerank",
               {"nodes": 16, "avg_edges": 2, "iters": 400, "epoch": 2,
                "stall_epochs": 1})
    _run_to_terminal(JobExecutor(store, rank="0", device="cpu"))
    rec = store.load("j1")
    assert rec["state"] == jobs_mod.STALLED
    assert rec["reason"] == "convergence-stall"
    assert rec["iters"] < rec["total_iters"]


# ------------------------------------------------- controls + transport


def test_handle_control_verbs(tmp_path):
    store = JobStore(str(tmp_path))
    out = jobs_mod.handle_control(
        store, {"control": "job-submit", "job": "j1", "op": "pagerank",
                "params": dict(PARAMS)})
    assert out["ok"] and out["created"] and out["job"]["state"] == PENDING
    again = jobs_mod.handle_control(
        store, {"control": "job-submit", "job": "j1", "op": "pagerank"})
    assert again["ok"] and not again["created"]
    assert jobs_mod.handle_control(
        store, {"control": "job-status", "job": "nope"})["ok"] is False
    assert jobs_mod.handle_control(
        store, {"control": "job-result", "job": "j1"})["ok"] is False
    _run_to_terminal(JobExecutor(store, rank="0", device="cpu"))
    res = jobs_mod.handle_control(store, {"control": "job-result",
                                          "job": "j1"})
    assert res["ok"] and res["job"]["state"] == DONE
    value = wire.nd_b64_decode(res["value"])
    assert _bits(value) == _bits(store.load_result("j1"))
    listing = jobs_mod.handle_control(store, {"control": "job-list"})
    assert [r["job"] for r in listing["jobs"]] == ["j1"]


def test_job_lane_over_transport_under_interactive_load(tmp_path):
    """The full wire arc on one replica: submit over a control frame,
    interactive solves keep landing (and strictly win the server),
    status polls show progress, and the result round-trips bitwise."""
    from cme213_tpu_torch.serve import OK
    from cme213_tpu_torch.serve.transport import (TransportClient,
                                                  TransportServer)

    baseline = _clean_result(tmp_path)
    server = Server(capacity=32, max_batch=4, device="cpu")
    store = JobStore(str(tmp_path / "jobs"))
    ts = TransportServer(server, drive="thread", poll_interval_s=0.01)
    ts.attach_jobs(JobExecutor(store, server=server, rank="0"))
    ts.start()
    try:
        with TransportClient(ts.addr, timeout_s=30.0) as c:
            out = c.control("job-submit", job="j1", op="pagerank",
                            params=dict(PARAMS))
            assert out["ok"] and out["created"]
            for spec in build_mix("cipher", 6, seed=5):
                res = c.solve(spec.op, spec.payload)   # rides along
                assert res.status == OK
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                st = c.control("job-status", job="j1")
                assert st["ok"]
                if st["job"]["state"] in jobs_mod.TERMINAL:
                    break
                time.sleep(0.05)
            assert st["job"]["state"] == DONE
            assert st["job"]["owner"] == "0"
            res = c.control("job-result", job="j1")
            assert res["ok"]
            assert _bits(wire.nd_b64_decode(res["value"])) \
                == _bits(baseline)
    finally:
        ts.close()


def test_orphan_adoption_after_restart(tmp_path):
    """Whole-fleet restart in miniature: the previous owner's rank is
    gone, the store's claim is reassigned, and the adopting executor
    resumes from the durable epoch — the ``job-reassigned`` +
    ``job-resumed(restart/crash)`` arc ``serve/fleet.py`` drives."""
    baseline = _clean_result(tmp_path)
    store = JobStore(str(tmp_path / "jobs"))
    submit_job(store, "j1", "pagerank", dict(PARAMS))
    ex0 = JobExecutor(store, rank="7", device="cpu")   # will not return
    while store.load("j1")["epoch"] < 2:
        ex0.tick()
    del ex0
    moved = store.reassign_from("7", "0")
    assert moved == ["j1"]
    _run_to_terminal(JobExecutor(store, rank="0", device="cpu"))
    rec = store.load("j1")
    assert rec["state"] == DONE and rec["resumes"] == 1
    assert trace.events("job-resumed")[-1]["source"] == "crash"
    assert _bits(store.load_result("j1")) == _bits(baseline)


# ------------------------------------------------- across the packages


def _golden(params) -> np.ndarray:
    return PageRankJob.reference(PageRankJob.normalize(dict(params)))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_job_committed_by_one_package_resumes_in_the_other(tmp_path,
                                                           first):
    """One package's executor commits two epochs (record + ``.npz``
    checkpoint) and dies; the other package's executor, same rank, finds
    the RUNNING record, resumes with source ``crash`` from the durable
    epoch and finishes, running no epoch twice.  The port's epochs are
    bitwise the numpy golden (``verify.golden.host_graph_iterate``) from
    the state they start at; the JAX package's are within 10 ULP of it
    (its XLA fold associates differently, ``test_torch_cipher_pagerank``)."""
    from cme213_tpu.core import trace as jtrace
    from cme213_tpu.core.checkpoint import load_checkpoint as jload
    from cme213_tpu.serve import jobs as jjobs
    from cme213_tpu_torch.apps.pagerank import build_graph
    from cme213_tpu_torch.core.compare import ulp_distance
    from cme213_tpu_torch.verify import golden

    jtrace.clear_events()
    jdir = str(tmp_path / "jobs")
    p = PageRankJob.normalize(dict(PARAMS))
    g = build_graph(p["nodes"], p["avg_edges"], p["seed"])

    def iterate(rank, iters):
        return golden.host_graph_iterate(g.indices, g.edges, rank,
                                         g.inv_deg, iters)

    if first == "jax":
        store = jjobs.JobStore(jdir)
        jjobs.submit_job(store, "x1", "pagerank", dict(PARAMS))
        ex1 = jjobs.JobExecutor(store, rank="0")
    else:
        store = JobStore(jdir)
        submit_job(store, "x1", "pagerank", dict(PARAMS))
        ex1 = JobExecutor(store, rank="0", device="cpu")
    while store.load("x1")["epoch"] < 2:
        ex1.tick()
    del ex1
    step, arrays = jload(store.checkpoint_path("x1"))
    assert step == 8
    committed = np.asarray(arrays["state"])
    if first == "port":
        assert _bits(committed) == _bits(iterate(g.rank0, 8))
        ex2 = jjobs.JobExecutor(jjobs.JobStore(jdir), rank="0")
        events = jtrace
    else:
        ex2 = JobExecutor(JobStore(jdir), rank="0", device="cpu")
        events = trace
    _run_to_terminal(ex2)
    rec = ex2.store.load("x1")
    assert rec["state"] == DONE and rec["resumes"] == 1
    # both packages read the record the other wrote: same CRC discipline
    assert jjobs._record_crc(rec) == jobs_mod._record_crc(rec) == rec["crc"]
    assert [e["source"] for e in events.events("job-resumed")] == ["crash"]
    assert [e["epoch"] for e in events.events("job-epoch")] == [3]
    value = JobStore(jdir).load_result("x1")
    assert _bits(jjobs.JobStore(jdir).load_result("x1")) == _bits(value)
    if first == "jax":
        assert _bits(value) == _bits(iterate(committed, 4))
    else:
        assert int(ulp_distance(value, iterate(g.rank0, 12)).max()) <= 10


def test_job_over_the_wire_across_packages(tmp_path):
    """A port client submits a job to the JAX package's transport with a
    job lane and gets its result (within 10 ULP of the numpy golden, the
    JAX package's PageRank tolerance); the JAX package's client fetches a
    port-served job's result, bitwise the golden."""
    from cme213_tpu_torch.core.compare import ulp_distance
    from cme213_tpu.serve import Server as JServer
    from cme213_tpu.serve import jobs as jjobs
    from cme213_tpu.serve.transport import TransportClient as JClient
    from cme213_tpu.serve.transport import TransportServer as JTransport
    from cme213_tpu_torch.serve.transport import (TransportClient,
                                                  TransportServer)

    golden = _golden(PARAMS)

    def wait_done(client):
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = client.control("job-status", job="w1")
            assert st["ok"], st
            if st["job"]["state"] in jobs_mod.TERMINAL:
                return st["job"]
            time.sleep(0.02)
        raise AssertionError("job not terminal in 60 s")

    jserver = JServer(capacity=8, max_batch=4)
    jts = JTransport(jserver, drive="thread", poll_interval_s=0.01)
    jts.attach_jobs(jjobs.JobExecutor(jjobs.JobStore(str(tmp_path / "a")),
                                      server=jserver, rank="0"))
    jts.start()
    try:
        with TransportClient(jts.addr, timeout_s=30.0) as c:
            assert c.control("job-submit", job="w1", op="pagerank",
                             params=dict(PARAMS))["created"]
            assert wait_done(c)["state"] == DONE
            res = c.control("job-result", job="w1")
        value = wire.nd_b64_decode(res["value"])
        assert int(ulp_distance(value, golden).max()) <= 10
    finally:
        jts.close()

    server = Server(capacity=8, max_batch=4, device="cpu")
    ts = TransportServer(server, drive="thread", poll_interval_s=0.01)
    ts.attach_jobs(JobExecutor(JobStore(str(tmp_path / "b")),
                               server=server, rank="0"))
    ts.start()
    try:
        with JClient(ts.addr, timeout_s=30.0) as c:
            assert c.control("job-submit", job="w1", op="pagerank",
                             params=dict(PARAMS))["created"]
            assert wait_done(c)["state"] == DONE
            res = c.control("job-result", job="w1")
        assert _bits(wire.nd_b64_decode(res["value"])) == _bits(golden)
    finally:
        ts.close()


def test_executor_runs_on_its_server_s_device(tmp_path, monkeypatch):
    """The executor takes its device from the argument, else its server;
    with neither and no card it refuses (``FrameworkError``)."""
    import torch

    from cme213_tpu_torch.core.errors import FrameworkError

    store = JobStore(str(tmp_path))
    assert JobExecutor(store, device="cpu").device == torch.device("cpu")
    server = Server(device="cpu")
    assert JobExecutor(store, server=server).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FrameworkError):
        JobExecutor(store)
