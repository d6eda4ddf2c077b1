"""The port's replicated fleet (``cme213_tpu_torch/serve/fleet.py`` and
``fleet_cli.py``) on the CPU.

What the port changed against the JAX package's fleet: the spawn command
(``-m cme213_tpu_torch``), the replica's rank variable (``RANK``) and the
device every replica serves on (``--device``, resolved in the front
process, ``FrameworkError`` with no card before anything is spawned).
Then the fleet's mechanism: the pipelined channel's zero-loss sweep
(``tests/test_fleet_serving.py``'s sever case), the flight post-mortem and
the job reassignment held to the JAX package's on the same inputs, the
``fleet jobs`` CLI of both packages against a port replica, and one live
2-replica CPU fleet under ``replica-kill:1:2``: zero loss, every result
bitwise its serial solve, the dead replica relaunched, and the JAX
package's client served bitwise by the port's front end.  The JAX
package's live-fleet arcs (``test_fleet_serving.py``, ``test_jobs.py``,
``test_waterfall.py``) stay ``slow`` here as there.
"""

import io
import json
import os
import signal
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cme213_tpu_torch.core import faults, metrics, trace
from cme213_tpu_torch.core.errors import FrameworkError
from cme213_tpu_torch.core.resilience import VirtualClock
from cme213_tpu_torch.serve import OK, Server, wire
from cme213_tpu_torch.serve import fleet as fleet_mod
from cme213_tpu_torch.serve import jobs as jobs_mod
from cme213_tpu_torch.serve.loadgen import build_mix
from cme213_tpu_torch.serve.router import Router
from cme213_tpu_torch.serve.transport import (TransportClient,
                                              TransportServer,
                                              decode_result)
from cme213_tpu_torch.serve.workloads import ADAPTERS, PageRankJob

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _reset_all():
    import cme213_tpu.core.faults as jfaults
    import cme213_tpu.core.metrics as jmetrics
    import cme213_tpu.core.trace as jtrace

    for mod in (trace, jtrace):
        mod.clear_events()
    for mod in (metrics, jmetrics):
        mod.reset()
    for mod in (faults, jfaults):
        mod.reset()


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    # a replica inherits this process's environment: no stray plan,
    # budget or job directory from elsewhere, and the package importable
    for var in ("CME213_FAULTS", "CME213_JOBS_DIR", "CME213_MEMORY_BUDGET",
                "CME213_FLIGHT_DIR", "JAX_PROCESS_ID", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    _reset_all()
    yield
    _reset_all()


def _bits(value) -> bytes:
    return np.ascontiguousarray(np.asarray(value)).tobytes()


def _serve_serial(specs):
    """Reference values: each spec solved alone on a CPU server."""
    server = Server(adapters=ADAPTERS, clock=VirtualClock(), device=CPU)
    out = []
    for spec in specs:
        server.submit(spec.op, spec.payload, tenant=spec.tenant)
        out.extend(server.drain())
    return out


class _FakeProc:
    """A spawned replica that never runs: what ``_spawn`` and ``close``
    need of a ``Popen``."""

    _pids = iter(range(900000, 999999))

    def __init__(self, cmd, env=None, **_):
        self.cmd, self.env = cmd, env
        self.pid = next(self._pids)
        self.stdout = io.StringIO("")
        self.rc = None

    def poll(self):
        return self.rc

    def terminate(self):
        self.rc = -15

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


@pytest.fixture
def spawned(monkeypatch):
    """Record the replicas the fleet spawns instead of starting them."""
    procs = []

    def fake_popen(cmd, env=None, **kw):
        procs.append(_FakeProc(cmd, env=env, **kw))
        return procs[-1]

    monkeypatch.setattr(fleet_mod.subprocess, "Popen", fake_popen)
    return procs


# ----------------------------------------------------- spawn and device

def test_spawn_argv_and_environment(spawned, tmp_path):
    """A replica is ``python -m cme213_tpu_torch fleet worker`` with the
    fleet's device, its rank in ``RANK`` (never ``JAX_PROCESS_ID``), its
    incarnation, per-rank sinks and the shared job directory."""
    fleet = fleet_mod.Fleet(replicas=2, capacity=16, max_batch=4,
                            mix="cipher,sort", warm_requests=3,
                            device=CPU, jobs_dir=str(tmp_path / "jobs"))
    try:
        fleet._spawn(incarnation=0)
        fleet._spawn(incarnation=0)
        fleet._spawn(incarnation=2, rank=1)
    finally:
        fleet.close()
    assert len(spawned) == 3
    for proc in spawned:
        cmd = proc.cmd
        assert cmd[1:5] == ["-m", "cme213_tpu_torch", "fleet", "worker"]
        flags = dict(zip(cmd[5::2], cmd[6::2]))
        assert flags["--device"] == "cpu"
        assert flags["--capacity"] == "16"
        assert flags["--max-batch"] == "4"
        assert flags["--mix"] == "cipher,sort"
        assert flags["--warm-requests"] == "3"
        assert int(flags["--port"]) > 0
        assert "JAX_PROCESS_ID" not in proc.env
        assert proc.env["CME213_JOBS_DIR"] == str(tmp_path / "jobs")
    assert [p.env["RANK"] for p in spawned] == ["0", "1", "1"]
    assert [p.env["CME213_INCARNATION"] for p in spawned] == ["0", "0", "2"]
    assert fleet.device == torch.device("cpu")
    # close stopped the replicas it holds (the relaunch replaced rank 1's)
    assert spawned[0].rc is not None and spawned[2].rc is not None


def test_spawn_command_differs_from_the_reference_only_in_package(
        spawned):
    """The JAX package's fleet spawns the same worker command but for
    its own package, its rank variable and the device flag."""
    import cme213_tpu.serve.fleet as jfleet

    assert jfleet.subprocess is fleet_mod.subprocess   # one stub for both
    kw = dict(replicas=1, capacity=8, max_batch=2, mix="cipher",
              warm_requests=1)
    for fl in (fleet_mod.Fleet(device=CPU, **kw), jfleet.Fleet(**kw)):
        try:
            fl._spawn(incarnation=0)
        finally:
            fl.close()
    port, ref = spawned
    port_cmd, jax_cmd = port.cmd, ref.cmd
    assert jax_cmd[2] == "cme213_tpu" and port_cmd[2] == "cme213_tpu_torch"
    i = port_cmd.index("--device")
    strip = port_cmd[:i] + port_cmd[i + 2:]
    flags = lambda c: {k: v for k, v in zip(c[5::2], c[6::2])
                       if k != "--port"}
    assert flags(strip) == flags(jax_cmd)
    assert ref.env["JAX_PROCESS_ID"] == port.env["RANK"] == "0"


def test_no_card_and_no_device_raises_before_any_spawn(spawned, monkeypatch,
                                                       tmp_path):
    """With no card, ``Fleet()``, ``fleet up`` and ``chaos run`` refuse
    (``FrameworkError``) before a replica exists, not after a ready
    timeout; ``--device=cpu`` is the way to serve on the host."""
    from cme213_tpu_torch import chaos_cli, fleet_cli
    from cme213_tpu_torch.core import chaos

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FrameworkError, match="--device=cpu"):
        fleet_mod.Fleet(replicas=2)
    with pytest.raises(FrameworkError):
        fleet_cli.main(["up", "--replicas", "2", "--max-seconds", "1"])
    with pytest.raises(FrameworkError):
        chaos_cli.main(["run", "--backend", "fleet", "--campaigns", "1",
                        "--bank-dir", str(tmp_path)])
    with pytest.raises(FrameworkError):
        chaos.run_campaign("slow:serve.cipher:20.0:1:1", backend="fleet",
                           mix="cipher", requests=2)
    assert spawned == []
    assert fleet_mod.Fleet(replicas=2, device=CPU).device.type == "cpu"


def test_worker_serves_on_its_device_under_its_rank(monkeypatch, capsys):
    """``fleet worker --device cpu`` builds its server there, announces
    itself as ``RANK`` and exits at ``--max-seconds``."""
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    port = fleet_mod.free_port()
    assert fleet_mod.worker_main(
        ["--port", str(port), "--device", "cpu", "--warm-requests", "1",
         "--mix", "cipher", "--max-seconds", "0"]) == 0
    up = trace.events("replica-up")
    assert up and up[-1]["replica"] == 3
    out = capsys.readouterr().out
    assert "fleet worker r3: warmed" in out
    assert f"serving on 127.0.0.1:{port}" in out


# ------------------------------------------- pipelined channel faults

class _MiniFleet:
    """Just enough fleet for a ReplicaChannel: the router lock, the
    completion hooks, and v1-style ticket delivery."""

    def __init__(self, router):
        self.router = router
        self._cv = threading.Condition()

    def _observe(self, meta):
        pass

    def _deliver(self, ticket, meta, sections=()):
        ticket.result = (wire.inline_sections(meta, list(sections))
                         if sections else meta)
        ticket.done.set()


def _v2_tickets(router, specs):
    tickets = []
    for spec in specs:
        sw = wire.SectionWriter()
        doc = {"op": spec.op,
               "payload": wire.encode_payload(spec.op, spec.payload, sw),
               "tenant": spec.tenant}
        t = router.submit(doc)
        assert t is not None
        t.sections = sw.arrays
        t.done = threading.Event()
        tickets.append(t)
    return tickets


def test_sever_with_eight_in_flight_requeues_all_via_ledger():
    """ONE connection with 8 requests in flight dies mid-pipeline; the
    channel fails all 8 back to the router's ledger, and a healthy
    replica then serves every one bitwise its serial solve."""
    router = Router(clock=VirtualClock())
    router.register_replica(0, capacity=8)
    fleet = _MiniFleet(router)
    specs = build_mix("cipher", 8, seed=17, tenants=2)
    tickets = _v2_tickets(router, specs)

    server_a = Server(adapters=ADAPTERS, clock=VirtualClock(), max_batch=8,
                      device=CPU)
    ts_a = TransportServer(server_a, drive="caller").start()
    chan = fleet_mod.ReplicaChannel(fleet, 0, ts_a.addr, shm=False)
    try:
        sent = 0
        while True:
            a = router.next_assignment()
            if a is None:
                break
            ticket, rank = a
            assert rank == 0
            chan.send(ticket)
            sent += 1
        assert sent == 8 and router.inflight() == 8
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(server_a.queue) < 8:
            time.sleep(0.01)
        assert len(server_a.queue) == 8

        ts_a.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and router.backlog() < 8:
            time.sleep(0.01)
        assert router.backlog() == 8 and router.inflight() == 0
        assert router.total_requeues == 8
        assert len(trace.events("request-requeued")) == 8
        assert all(t.requeues == 1 for t in tickets)
    finally:
        chan.close()
        ts_a.close()

    router.mark_down(0, reason="severed")
    router.register_replica(1, capacity=8)
    server_b = Server(adapters=ADAPTERS, clock=VirtualClock(), max_batch=8,
                      device=CPU)
    ts_b = TransportServer(server_b, drive="thread").start()
    chan_b = fleet_mod.ReplicaChannel(fleet, 1, ts_b.addr, shm=False)
    try:
        while True:
            a = router.next_assignment()
            if a is None:
                break
            chan_b.send(a[0])
        for t in tickets:
            assert t.done.wait(30)
        results = [decode_result(t.result) for t in tickets]
        assert all(r.status == OK for r in results)
        assert all(getattr(r, "replica", None) == 1 for r in results)
        for res, ref in zip(results, _serve_serial(specs)):
            assert _bits(res.value) == _bits(ref.value)
        assert router.inflight() == 0 and router.backlog() == 0
    finally:
        chan_b.close()
        ts_b.close()


# ------------------------------------ post-mortem and job reassignment

def _write_dump(fdir, pid, reason, counters, served, seq=1):
    doc = {"flight": 1, "reason": reason, "pid": pid,
           "platform": {"torch": "x"},
           "metrics": {"counters": counters, "gauges": {},
                       "histograms": {}},
           "events": ([{"event": "request-served", "rid": i}
                       for i in range(served)]
                      + [{"event": "span-begin", "span": "serve.batch"}])}
    path = Path(fdir) / f"flight-{pid}-{1000 + seq}-{seq}.json"
    path.write_text(json.dumps(doc))


def test_flight_post_mortem_equals_reference(tmp_path, monkeypatch):
    """From a dead replica's dumps the front end counts the requests it
    had accepted but not served, reading only ``reason``, the
    ``serve.requests``/``serve.shed.*`` counters and ``request-served``
    events; the JAX package's reader counts the same on the same files."""
    import cme213_tpu.serve.fleet as jfleet

    fdir = tmp_path / "flight"
    fdir.mkdir()
    monkeypatch.setenv("CME213_FLIGHT_DIR", str(fdir))
    _write_dump(fdir, 4242, "replica-kill",
                {"serve.requests": 9, "serve.shed.deadline": 1}, 5)
    _write_dump(fdir, 4242, "rankkill", {"serve.requests": 3}, 1, seq=2)
    _write_dump(fdir, 4242, "unhandled-exception", {"serve.requests": 50},
                0, seq=3)
    _write_dump(fdir, 4343, "replica-kill", {"serve.requests": 7}, 0)
    (fdir / "flight-4242-9-9.json").write_text("{torn")

    def count(mod, pid):
        rep = mod.ReplicaProc(1, 0, 1, _FakeProc(["x"]))
        rep.proc.pid = pid
        return mod.Fleet._read_flight_dump(None, rep)

    assert count(fleet_mod, 4242) == count(jfleet, 4242) == 3 + 2
    assert count(fleet_mod, 4343) == count(jfleet, 4343) == 7
    assert count(fleet_mod, 1) == count(jfleet, 1) == 0


def _fleet_with_fake_replicas(mod, tmp_path, ranks, spawned, **kw):
    fl = (mod.Fleet(device=CPU, **kw) if mod is fleet_mod
          else mod.Fleet(**kw))
    for rank in ranks:
        rep = mod.ReplicaProc(rank, 0, 1, _FakeProc(["x"]))
        rep.state = "up"
        fl._procs[rank] = rep
        fl.router.register_replica(rank, capacity=4)
    return fl


@pytest.mark.parametrize("package", ["port", "jax"])
def test_dead_replica_s_jobs_move_to_a_live_rank(tmp_path, spawned,
                                                 package):
    """With no relaunch left, a dead replica's claimed jobs move to the
    lowest live rank (``job-reassigned``); a fleet restart adopts jobs
    whose owner no longer exists.  Same store, same moves, either
    package."""
    import cme213_tpu.serve.fleet as jfleet
    import cme213_tpu.core.trace as jtrace

    mod, tr = ((fleet_mod, trace) if package == "port"
               else (jfleet, jtrace))
    jobs_dir = tmp_path / "jobs"
    store = jobs_mod.JobStore(str(jobs_dir))
    for jid, owner in (("a", "1"), ("b", "1"), ("c", "2"), ("d", None)):
        jobs_mod.submit_job(store, jid, "pagerank",
                            {"nodes": 16, "iters": 4, "epoch": 2})
        if owner is not None:
            store.claim(jid, owner)
    fl = _fleet_with_fake_replicas(mod, tmp_path, (0, 1, 3), spawned,
                                   jobs_dir=str(jobs_dir), max_restarts=0)
    try:
        fl._handle_death(fl._procs[1], -9)
        assert store.owner("a") == store.owner("b") == "0"
        assert fl._procs[1].state == "down"
        fl._adopt_orphan_jobs()
        assert store.owner("c") == "0"      # rank 2 is not in this fleet
        assert store.owner("d") is None     # unclaimed: any rank may take it
    finally:
        fl.close()
    moved = [(e["job"], e["source"], e["target"])
             for e in tr.events("job-reassigned")]
    assert moved == [("a", "1", "0"), ("b", "1", "0"), ("c", "2", "0")]
    down = tr.events("replica-down")[-1]
    assert (down["replica"], down["reason"]) == (1, "replica-kill")


def test_front_end_job_controls_need_a_jobs_dir(spawned, tmp_path):
    """The front end answers ``job-*`` controls from the shared store, and
    refuses them as the JAX package's does when the lane is off."""
    import cme213_tpu.serve.fleet as jfleet

    off = fleet_mod.Fleet(device=CPU)
    ref = jfleet.Fleet()
    try:
        assert off.front.control({"control": "job-list"}) == \
            ref.front.control({"control": "job-list"})
        assert off.front.control({"control": "job-list"})["ok"] is False
    finally:
        off.close()
        ref.close()
    on = fleet_mod.Fleet(device=CPU, jobs_dir=str(tmp_path / "jobs"))
    try:
        out = on.front.control({"control": "job-submit", "job": "j",
                                "op": "pagerank",
                                "params": {"nodes": 16, "iters": 4,
                                           "epoch": 2}})
        assert out["ok"] and out["created"]
        assert on.front.stats()["jobs"] == {"PENDING": 1}
        assert on.front.stats()["replicas_up"] == 0
    finally:
        on.close()


# --------------------------------------------------------- fleet jobs CLI

@pytest.mark.parametrize("package", ["port", "jax"])
def test_fleet_jobs_cli_against_a_port_replica(tmp_path, capsys, package):
    """``fleet jobs submit|status|wait|result|list|cancel`` of either
    package drive a port replica's job lane; the result is bitwise the
    numpy golden."""
    if package == "port":
        from cme213_tpu_torch import fleet_cli
    else:
        from cme213_tpu import fleet_cli

    params = {"nodes": 64, "avg_edges": 4, "iters": 8, "epoch": 4,
              "seed": 2}
    golden = PageRankJob.reference(PageRankJob.normalize(dict(params)))
    server = Server(capacity=8, max_batch=4, device=CPU)
    ts = TransportServer(server, drive="thread", poll_interval_s=0.01)
    ts.attach_jobs(jobs_mod.JobExecutor(
        jobs_mod.JobStore(str(tmp_path / "jobs")), server=server, rank="0"))
    ts.start()
    out_npy = tmp_path / "rank.npy"
    try:
        addr = ["--addr", ts.addr]
        kv = [f"--param={k}={v}" for k, v in params.items()]
        assert fleet_cli.main(["jobs", "submit", *addr, "--job", "j1",
                               *kv, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["created"] is True
        assert fleet_cli.main(["jobs", "wait", *addr, "--job", "j1",
                               "--wait-s", "60"]) == 0
        assert "job j1: DONE" in capsys.readouterr().out
        assert fleet_cli.main(["jobs", "result", *addr, "--job", "j1",
                               "--out", str(out_npy), "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["shape"] == list(golden.shape)
        assert fleet_cli.main(["jobs", "list", *addr]) == 0
        assert "j1" in capsys.readouterr().out
        assert fleet_cli.main(["jobs", "status", *addr]) == 2  # no --job
        assert fleet_cli.main(["jobs", "submit", *addr, "--job", "j2",
                               "--param", "bad"]) == 2
        assert fleet_cli.main(["jobs", "cancel", *addr, "--job", "nope"]) \
            == 1
    finally:
        ts.close()
    assert _bits(np.load(out_npy)) == _bits(golden)


def test_fleet_cli_help_and_unknown(capsys):
    from cme213_tpu_torch import fleet_cli
    from cme213_tpu_torch.models import WORKLOADS

    assert fleet_cli.main(["--help"]) == 0
    assert "python -m cme213_tpu_torch fleet" in capsys.readouterr().out
    assert fleet_cli.main([]) == 2
    assert fleet_cli.main(["sideways"]) == 2
    assert WORKLOADS["fleet"].run(["--help"]) == 0
    assert fleet_cli.main(["up", "--autoscale", "--device", "cpu"]) == 2


def test_fleet_up_serves_on_the_cpu_when_asked(spawned, monkeypatch,
                                               capsys, tmp_path):
    """``fleet up --device=cpu`` hands the device to every replica and
    tears the fleet down at ``--max-seconds`` (replicas stubbed: they
    answer nothing, so the ready wait times out and ``up`` exits 1)."""
    from cme213_tpu_torch import fleet_cli

    rc = fleet_cli.main(["up", "--replicas", "2", "--device=cpu",
                         "--ready-timeout-s", "0.3", "--max-seconds", "0"])
    assert rc == 1
    assert "not ready" in capsys.readouterr().err
    assert len(spawned) == 2
    assert all(p.cmd[p.cmd.index("--device") + 1] == "cpu"
               for p in spawned)


# ------------------------------------------------------ one live fleet

def test_live_cpu_fleet_replica_kill_zero_loss_and_jax_client(monkeypatch,
                                                              tmp_path):
    """Two CPU replica processes behind the port's front end, rank 1
    SIGKILLed at its second batch: every accepted request is served,
    bitwise its serial solve, the flight dump confirms the in-flight
    set, rank 1 relaunches at incarnation 1; then the JAX package's
    client (v2 and v1 frames) is served bitwise by the same front end.
    Every wait is bounded, so the test stops within about two minutes."""
    from cme213_tpu.serve.transport import TransportClient as JClient

    monkeypatch.setenv("CME213_FAULTS", "replica-kill:1:2")
    monkeypatch.setenv("CME213_FLIGHT_DIR", str(tmp_path / "flight"))
    # the front end runs here and must not arm the cocktail itself
    faults.install_plan(faults.FaultPlan([]))
    specs = build_mix("cipher,sort", 24, seed=21, tenants=2)
    refs = _serve_serial(specs)
    # no shm lane to the replicas: a shared-memory segment is visible to
    # every process on the host, and the chaos campaigns' leak check of
    # other test workers lists them all (the lane has its own tests)
    fleet = fleet_mod.Fleet(replicas=2, mix="cipher,sort", warm_requests=2,
                            max_batch=4, device=CPU, shm=False,
                            ready_timeout_s=60.0).start()
    procs = list(fleet._procs.values())
    try:
        results = [None] * len(specs)

        def client(i, spec):
            with TransportClient(fleet.addr, timeout_s=60.0) as c:
                results[i] = c.solve(spec.op, spec.payload,
                                     tenant=spec.tenant)

        threads = [threading.Thread(target=client, args=(i, s), daemon=True)
                   for i, s in enumerate(specs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(90)
        assert all(r is not None and r.status == OK for r in results)
        for res, ref in zip(results, refs):
            assert _bits(res.value) == _bits(ref.value)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            stats = fleet.stats()
            r1 = stats["replicas"].get("r1", {})
            if r1.get("incarnation") == 1 and r1.get("up"):
                break
            time.sleep(0.1)
        assert stats["replicas"]["r1"]["incarnation"] == 1
        assert stats["replicas"]["r1"]["up"] is True
        assert stats["requeues"] >= 1
        assert stats["flight_confirmed"] >= 1
        assert trace.events("request-requeued")
        assert {e["replica"] for e in trace.events("request-routed")} \
            == {0, 1}

        # the JAX package's client against the port's front end
        jspecs = build_mix("cipher,sort", 8, seed=23)
        jrefs = _serve_serial(jspecs)
        for proto in (2, 1):
            with JClient(fleet.addr, timeout_s=60.0, proto=proto) as c:
                got = [c.solve(s.op, s.payload, tenant=s.tenant)
                       for s in jspecs]
            assert all(r.status == OK for r in got)
            for res, ref in zip(got, jrefs):
                assert _bits(res.value) == _bits(ref.value)
        procs = list(fleet._procs.values())
    finally:
        fleet.close()
    assert all(p.proc.poll() is not None for p in procs)


# ----------------------------------------- the JAX package's slow arcs

def _tolerant_load(path):
    out = []
    for line in Path(path).read_text().splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "event" in rec:
            out.append(rec)
    return out


@pytest.mark.slow
def test_requeued_request_renders_one_aligned_waterfall(tmp_path,
                                                        monkeypatch):
    """``tests/test_waterfall.py``'s fleet arc on the port: the requeued
    request renders as one waterfall tree over the front tier's pid and
    both incarnations of the killed replica."""
    from cme213_tpu_torch import trace_cli

    monkeypatch.setenv("CME213_FAULTS", "replica-kill:1:1")
    monkeypatch.setenv(trace.TRACE_FILE_ENV,
                       str(tmp_path / "wf-{rank}.jsonl"))
    faults.install_plan(faults.FaultPlan([]))
    fleet = fleet_mod.Fleet(replicas=2, mix="cipher", warm_requests=2,
                            max_batch=4, device=CPU).start()
    try:
        specs = build_mix("cipher", 16, seed=19, tenants=2)
        results = [None] * len(specs)

        def client(i, spec):
            with TransportClient(fleet.addr) as c:
                results[i] = c.solve(spec.op, spec.payload,
                                     tenant=spec.tenant)

        threads = [threading.Thread(target=client, args=(i, s), daemon=True)
                   for i, s in enumerate(specs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(r is not None and r.status == "ok" for r in results)
        requeued = trace.events("request-requeued")
        assert requeued
    finally:
        fleet.close()
    trace.flush_sink()
    events = [dict(e) for e in trace.events()]
    for p in sorted(tmp_path.glob("wf-*.jsonl")):
        events.extend(_tolerant_load(p))
    rid = str(requeued[0]["rid"])
    doc = trace_cli.build_waterfalls(events, rid)
    trees = [t for t in doc["trees"]
             if any(h["span"] == "serve.hop.requeue"
                    and str(h["rid"]) == rid for h in t["hops"])]
    assert len(trees) == 1
    tree = trees[0]
    assert len(tree["trace_ids"]) == 1
    assert len(tree["hops"]) >= 5
    assert len(tree["pids"]) >= 3
    by_span = {}
    for h in tree["hops"]:
        by_span.setdefault(h["span"], []).append(h)
    route = by_span["serve.hop.route"][0]
    assert by_span["serve.hop.client"][0]["dur_ms"] >= route["dur_ms"]
    assert any(h["open"] for h in by_span.get("serve.hop.replica", []))
    served = [h for h in by_span.get("serve.hop.replica", [])
              if not h["open"]]
    assert served
    for h in served:
        assert h["aligned"]
        slack = h["err_ms"] + route["err_ms"] + 20.0
        assert h["start_ms"] >= route["start_ms"] - slack
        assert (h["start_ms"] + h["dur_ms"]
                <= route["start_ms"] + route["dur_ms"] + slack)


@pytest.mark.slow
def test_tail_sampling_keeps_under_ten_percent_on_clean_fleet(monkeypatch):
    monkeypatch.setenv(trace.TRACE_TAIL_ENV, "1")
    monkeypatch.delenv(trace.TRACE_HEAD_RATE_ENV, raising=False)
    fleet = fleet_mod.Fleet(replicas=2, mix="cipher", warm_requests=2,
                            max_batch=4, device=CPU).start()
    try:
        before = metrics.snapshot()
        with TransportClient(fleet.addr) as c:
            for spec in build_mix("cipher", 30, seed=7, tenants=2):
                assert c.solve(spec.op, spec.payload,
                               tenant=spec.tenant).status == "ok"
        after = metrics.snapshot()
    finally:
        fleet.close()
    d = metrics.delta(before, after)["counters"]
    kept = d.get("trace.sampling.kept", 0)
    dropped = d.get("trace.sampling.dropped", 0)
    assert kept + dropped >= 60
    assert kept / (kept + dropped) < 0.10
    assert trace.tail_pending() == 0


def _clean_job_result(tmp_path, params):
    store = jobs_mod.JobStore(str(tmp_path / "baseline"))
    jobs_mod.submit_job(store, "baseline", "pagerank", dict(params))
    ex = jobs_mod.JobExecutor(store, rank="base", device=CPU)
    for _ in range(500):
        if not ex.tick() and all(r["state"] in jobs_mod.TERMINAL
                                 for r in store.list_jobs()):
            break
    return store.load_result("baseline")


def _fleet_submit_and_wait(addr, job, params, deadline_s=120.0,
                           min_epoch_before=None, poke=None):
    with TransportClient(addr) as c:
        assert c.control("job-submit", job=job, op="pagerank",
                         params=params)["ok"]
    deadline = time.monotonic() + deadline_s
    poked = False
    last = None
    while time.monotonic() < deadline:
        try:
            with TransportClient(addr) as c:
                st = c.control("job-status", job=job)
        except (ConnectionError, OSError):
            time.sleep(0.2)
            continue
        assert st["ok"], st
        last = st["job"]
        if (poke is not None and not poked
                and (last["epoch"] or 0) >= (min_epoch_before or 1)):
            poke()
            poked = True
        if last["state"] in jobs_mod.TERMINAL:
            return last
        time.sleep(0.1)
    raise AssertionError(f"job never finished: {last}")


def _fleet_result(addr, job):
    with TransportClient(addr) as c:
        res = c.control("job-result", job=job)
    assert res["ok"], res
    return wire.nd_b64_decode(res["value"])


@pytest.mark.slow
def test_fleet_job_survives_replica_sigkill(tmp_path, monkeypatch):
    """``tests/test_jobs.py``'s kill arc on the port: the relaunched
    replica resumes its own claim and the ranking is bitwise an
    uninterrupted run."""
    params = {"nodes": 3000, "avg_edges": 6, "iters": 160, "epoch": 4,
              "seed": 11, "stall_epochs": 1000}
    baseline = _clean_job_result(tmp_path, params)
    monkeypatch.setenv("CME213_FAULTS", "replica-kill:0:1")
    faults.install_plan(faults.FaultPlan([]))
    fleet = fleet_mod.Fleet(replicas=1, mix="cipher", warm_requests=2,
                            max_batch=4, device=CPU,
                            jobs_dir=str(tmp_path / "jobs")).start()
    try:
        def poke():
            with TransportClient(fleet.addr) as c:
                for spec in build_mix("cipher", 4, seed=5):
                    assert c.solve(spec.op, spec.payload).status == OK

        rec = _fleet_submit_and_wait(fleet.addr, "kill-arc", params,
                                     min_epoch_before=1, poke=poke)
        assert rec["state"] == jobs_mod.DONE
        assert rec["resumes"] >= 1
        value = _fleet_result(fleet.addr, "kill-arc")
        stats = fleet.front.stats()
    finally:
        fleet.close()
    assert _bits(value) == _bits(baseline)
    assert stats["replicas"]["r0"]["incarnation"] >= 1
    assert stats["jobs"].get(jobs_mod.DONE) == 1


@pytest.mark.slow
def test_fleet_down_up_resumes_job(tmp_path):
    params = {"nodes": 3000, "avg_edges": 6, "iters": 160, "epoch": 4,
              "seed": 12, "stall_epochs": 1000}
    baseline = _clean_job_result(tmp_path, params)
    jobs_dir = str(tmp_path / "jobs")
    fleet = fleet_mod.Fleet(replicas=1, mix="cipher", warm_requests=2,
                            jobs_dir=jobs_dir, device=CPU).start()
    try:
        with TransportClient(fleet.addr) as c:
            out = c.control("job-submit", job="downup", op="pagerank",
                            params=params)
            assert out["ok"] and out["created"]
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            with TransportClient(fleet.addr) as c:
                st = c.control("job-status", job="downup")
            if (st["job"]["epoch"] or 0) >= 2:
                break
            time.sleep(0.1)
        assert (st["job"]["epoch"] or 0) >= 2, st
    finally:
        fleet.close()
    fleet2 = fleet_mod.Fleet(replicas=1, mix="cipher", warm_requests=2,
                             jobs_dir=jobs_dir, device=CPU).start()
    try:
        rec = _fleet_submit_and_wait(fleet2.addr, "downup", params)
        assert rec["state"] == jobs_mod.DONE
        assert rec["resumes"] >= 1
        value = _fleet_result(fleet2.addr, "downup")
    finally:
        fleet2.close()
    assert _bits(value) == _bits(baseline)
