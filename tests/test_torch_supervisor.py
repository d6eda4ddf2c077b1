"""Gang supervision in the port (``dist/supervisor.py``,
``dist/launch.launch_supervised``): heartbeat plumbing, stall detection,
and the supervised launcher — a rank killed mid-solve (deterministic
``rankkill``) or frozen (step counter stuck) is detected, the WHOLE gang is
killed and relaunched, and the workload resumes from the last committed
epoch with a final grid bit for bit the uninterrupted solve's.

Ports every case of ``tests/test_supervisor.py`` (the gang runs here are
2 ranks over gloo on the CPU; the stall case is held to its own assertions,
which the reference misses: its worker takes longer to import than the
1 s stall budget), ``test_flight.py::
test_supervised_gang_rankkill_leaves_per_rank_dump`` and
``test_fleet_telemetry.py::test_top_folds_supervisor_heartbeats`` and
``::test_supervised_gang_shares_one_trace_id``.  Workers that need no torch
import none: the heartbeat path is light.
"""

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from cme213_tpu_torch import top_cli, trace_cli
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.core import faults, flight, metrics, trace
from cme213_tpu_torch.core.collector import Collector
from cme213_tpu_torch.core.resilience import VirtualClock
from cme213_tpu_torch.dist.supervisor import (GangSupervisor, HeartbeatWriter,
                                              heartbeat_from_env,
                                              read_all_heartbeats,
                                              read_heartbeat)

from torch_gang import ROOT, write_worker


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.delenv(flight.FLIGHT_DIR_ENV, raising=False)
    flight._uninstall_for_tests()
    trace.flush_sink()
    trace.clear_events()
    metrics.reset()
    yield
    flight._uninstall_for_tests()
    trace.flush_sink()
    trace.clear_events()
    metrics.reset()
    faults.reset()


# ------------------------------------------------------------ heartbeats

def test_heartbeat_roundtrip(tmp_path):
    hb = HeartbeatWriter(str(tmp_path), rank=3)
    hb.beat(7)
    rec = read_heartbeat(str(tmp_path), 3)
    assert rec["rank"] == 3 and rec["step"] == 7
    assert rec["pid"] == os.getpid() and rec["incarnation"] == 0
    assert trace.events("heartbeat")[-1]["step"] == 7


def test_heartbeat_step_change_always_publishes(tmp_path):
    hb = HeartbeatWriter(str(tmp_path), rank=0, interval=3600)
    hb.beat(1)
    hb.beat(2)  # interval must not suppress a step CHANGE
    assert read_heartbeat(str(tmp_path), 0)["step"] == 2


def test_heartbeat_same_step_throttled(tmp_path):
    hb = HeartbeatWriter(str(tmp_path), rank=0, interval=3600)
    hb.beat(1)
    t0 = os.path.getmtime(hb.path)
    rec0 = read_heartbeat(str(tmp_path), 0)
    hb.beat(1)  # same step inside the interval: no rewrite
    assert os.path.getmtime(hb.path) == t0
    assert read_heartbeat(str(tmp_path), 0) == rec0
    assert len(trace.events("heartbeat")) == 1


def test_heartbeat_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("CME213_HEARTBEAT_DIR", raising=False)
    assert heartbeat_from_env() is None
    monkeypatch.setenv("CME213_HEARTBEAT_DIR", str(tmp_path))
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("CME213_HEARTBEAT_INTERVAL", "0.5")
    hb = heartbeat_from_env()
    hb.beat(4)
    assert read_heartbeat(str(tmp_path), 2)["step"] == 4
    assert hb.interval == 0.5


def test_missing_heartbeat_reads_none(tmp_path):
    assert read_heartbeat(str(tmp_path), 9) is None


def test_supervisor_import_leaves_torch_out():
    """A rank can beat before its first heavy import: the supervisor, the
    launcher and the fault and trace modules import no torch."""
    code = ("import sys, cme213_tpu_torch.dist.supervisor, "
            "cme213_tpu_torch.dist.launch, cme213_tpu_torch.core.faults, "
            "cme213_tpu_torch.core.trace\n"
            "from cme213_tpu_torch.dist.supervisor import HeartbeatWriter\n"
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# ------------------------------------------------------- stall detection

def test_supervisor_distinguishes_progress_from_frozen(tmp_path):
    clock = VirtualClock()
    sup = GangSupervisor(str(tmp_path), num_ranks=2, stall_timeout=0.15,
                         clock=clock)
    hb0 = HeartbeatWriter(str(tmp_path), 0)
    hb1 = HeartbeatWriter(str(tmp_path), 1)
    hb0.beat(1)
    hb1.beat(1)
    assert sup.stalled() == []          # first beats: progress
    clock.advance(0.2)
    hb0.beat(2)                         # rank 0 advances; rank 1 frozen
    stalled = sup.stalled()
    assert [s["rank"] for s in stalled] == [1]
    assert stalled[0]["step"] == 1 and stalled[0]["stalled_s"] >= 0.15


def test_supervisor_catches_rank_that_never_beat(tmp_path):
    """A rank wedged before its first beat (a rendezvous that never
    completes) is timed from gang spawn."""
    clock = VirtualClock()
    sup = GangSupervisor(str(tmp_path), num_ranks=1, stall_timeout=0.1,
                         clock=clock)
    assert sup.stalled() == []
    clock.advance(0.15)
    assert [s["rank"] for s in sup.stalled()] == [0]


def test_supervisor_reset_clears_stale_beats(tmp_path):
    sup = GangSupervisor(str(tmp_path), num_ranks=1, stall_timeout=0.1)
    HeartbeatWriter(str(tmp_path), 0).beat(5)
    assert sup.step_of(0) == 5
    sup.reset()
    assert sup.step_of(0) is None       # previous incarnation's beat gone
    assert sup.stalled() == []          # and the progress clock restarted


# ------------------------------------------------- supervised launcher

HEAT = dict(nx=32, ny=32, order=4, iters=8, bc_top=2.0, bc_left=0.5,
            bc_bottom=1.0, bc_right=3.0)

# the supervised heat worker: the heat2d CLI with --supervised on the CPU
# (epoch commits and heartbeats from the launcher's env); the grid it
# returns is caught at full precision for the bitwise check
_HEAT_WORKER = """
import os
import numpy as np
from cme213_tpu_torch.apps import heat2d
from cme213_tpu_torch.config import GridMethod, SimParams

path = sys.argv[1] + "/p.in"
SimParams(**HEAT, grid_method=GridMethod.BLOCKS_2D).to_file(
    path, distributed=True)
supervised = heat2d.run_distributed_supervised


def caught(*args, **kwargs):
    out = supervised(*args, **kwargs)
    np.save(f"{sys.argv[1]}/final-rank{os.environ['RANK']}.npy", out)
    return out


heat2d.run_distributed_supervised = caught
sys.exit(heat2d.main(["heat2d", path, "--distributed", "--supervised",
                      "--device=cpu"]))
"""

# a rank that beats through step 1 then freezes forever in its first
# incarnation — a rank stuck in an exchange (its step counter stops while
# the process stays alive); the relaunched incarnation completes
_STALL_WORKER = """
import time
from cme213_tpu_torch.core.faults import incarnation
from cme213_tpu_torch.dist.supervisor import heartbeat_from_env

hb = heartbeat_from_env()
hb.beat(1)
if incarnation() == 0:
    time.sleep(600)   # frozen: alive, but the step never advances
hb.beat(2)
print("recovered incarnation", incarnation())
"""


def test_gang_rank_kill_restarts_and_recovers_bitwise(tmp_path, monkeypatch,
                                                      capsys):
    """The acceptance ladder on a 2-rank gang of 2 shards each:
    ``rankkill:1:1`` fires at epoch 1 (one commit banked), the launcher
    sees the rank die, condemns and relaunches the gang, which resumes
    from the committed epoch; both ranks' final grids are bit for bit the
    uninterrupted single-process solve's."""
    from cme213_tpu_torch.core import virtual_devices
    from cme213_tpu_torch.dist import make_mesh_2d, run_distributed_heat
    from cme213_tpu_torch.dist.launch import launch_supervised

    worker = write_worker(tmp_path, _HEAT_WORKER, HEAT=HEAT)
    monkeypatch.setenv("CME213_FAULTS", "rankkill:1:1")
    monkeypatch.chdir(tmp_path)
    rc = launch_supervised(
        2, [sys.executable, worker, str(tmp_path)], devices_per_proc=2,
        stall_timeout=120, max_restarts=1,
        ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2, timeout=300)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "injected kill: rank 1" in out
    assert "condemning the gang" in out
    assert "gang restart (incarnation 1/1)" in out
    assert out.count("supervised solve complete: 8 iters") == 2

    p = SimParams(**HEAT, grid_method=GridMethod.BLOCKS_2D)
    ref = run_distributed_heat(p, make_mesh_2d(
        2, 2, devices=virtual_devices(4, "cpu")))
    for rank in (0, 1):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"final-rank{rank}.npy"), ref)
    assert (tmp_path / "grid_final.txt").exists()
    assert trace.events("rank-failed")[-1]["reason"] == "exit"
    assert trace.events("gang-restart")[-1]["incarnation"] == 1


def test_gang_stall_detected_and_restarted(tmp_path, capsys):
    """A rank alive but frozen (step counter stuck) is condemned by
    --stall-timeout — not by the whole-job --timeout — and the relaunched
    incarnation completes."""
    from cme213_tpu_torch.dist.launch import launch_supervised

    worker = write_worker(tmp_path, _STALL_WORKER)
    t0 = time.monotonic()
    rc = launch_supervised(1, [sys.executable, worker],
                           stall_timeout=1.0, max_restarts=1, timeout=120)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert time.monotonic() - t0 < 60  # stall clock, not the job deadline
    assert "stalled at step 1" in out
    assert "recovered incarnation 1" in out
    assert trace.events("rank-failed")[-1]["reason"] == "stall"
    assert trace.events("gang-restart")


def test_gang_restart_budget_exhausted_fails(tmp_path, monkeypatch, capsys):
    from cme213_tpu_torch.dist.launch import launch_supervised

    script = tmp_path / "die.py"
    script.write_text(
        f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
        "from cme213_tpu_torch.core import faults\n"
        "faults.maybe_kill_rank(step=0)\n")
    monkeypatch.setenv("CME213_FAULTS", "rankkill:0:0")
    rc = launch_supervised(1, [sys.executable, str(script)],
                           max_restarts=0, stall_timeout=60, timeout=60)
    assert rc == faults.KILL_EXIT
    assert "gang restart budget exhausted (0)" in capsys.readouterr().out


def test_gang_clean_exit_is_zero(tmp_path):
    from cme213_tpu_torch.dist.launch import launch_supervised

    script = tmp_path / "ok.py"
    script.write_text("print('fine')\n")
    rc = launch_supervised(2, [sys.executable, str(script)],
                           stall_timeout=60, timeout=60)
    assert rc == 0


def test_launcher_cli_supervised_flags(tmp_path, capsys):
    """--stall-timeout routes main() into supervised mode, the checkpoint
    plumbing reaches the ranks, and the process group's timeout is raised
    to the stall timeout (a rank waiting for a frozen peer is condemned by
    the stall clock first)."""
    from cme213_tpu_torch.dist.launch import main

    script = tmp_path / "env.py"
    script.write_text(
        "import os\n"
        "print('CKPT', os.environ['CME213_CKPT_DIR'],\n"
        "      os.environ['CME213_CKPT_EVERY'],\n"
        "      os.environ['CME213_RESUME'],\n"
        "      os.environ['CME213_HANDSHAKE_TIMEOUT'],\n"
        "      'HB' in os.environ['CME213_HEARTBEAT_DIR'] or\n"
        "      os.environ['CME213_HEARTBEAT_DIR'])\n")
    rc = main(["--np", "1", "--stall-timeout", "30",
               "--ckpt-dir", str(tmp_path / "c"), "--ckpt-every", "5",
               "--heartbeat-interval", "0.5", "--handshake-timeout", "5",
               "--timeout", "60", "--", sys.executable, str(script)])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"CKPT {tmp_path / 'c'} 5 0 30.0" in out


def test_supervised_gang_rankkill_leaves_per_rank_dump(tmp_path,
                                                       monkeypatch, capsys):
    """A rank hard-killed inside a supervised gang leaves a parseable
    flight dump behind while the gang restarts and completes."""
    from cme213_tpu_torch.dist.launch import launch_supervised

    monkeypatch.setenv("CME213_FAULTS", "rankkill:1:0")
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    body = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import os; "
            "from cme213_tpu_torch.core import faults; "
            "faults.maybe_kill_rank(); print('rank', os.environ['RANK'], "
            "'ok')")
    rc = launch_supervised(2, [sys.executable, "-c", body],
                           stall_timeout=60, max_restarts=1, timeout=120)
    out = capsys.readouterr().out
    assert rc == 0, out
    (path,) = sorted(glob.glob(str(tmp_path / "flight-*.json")))
    doc = json.loads(open(path).read())
    assert doc["reason"] == "rankkill"
    assert doc["rank"] == "1" and doc["incarnation"] == "0"


# ------------------------------------------------------- fleet telemetry

def _line(step, t=1.0, rank=0):
    return json.dumps({"event": "heartbeat", "t": t, "rank": rank,
                       "step": step, "pid": 1, "incarnation": 0,
                       "trace": "T1"}) + "\n"


def test_top_folds_supervisor_heartbeats(tmp_path, capsys):
    HeartbeatWriter(str(tmp_path), rank=0).beat(4)
    HeartbeatWriter(str(tmp_path), rank=1).beat(9)
    assert {r: b["step"] for r, b in read_all_heartbeats(
        str(tmp_path)).items()} == {0: 4, 1: 9}
    sink = tmp_path / "s.jsonl"
    sink.write_text(_line(None, t=1.0, rank=0).replace('"step": null',
                                                       '"x": 0'))
    assert top_cli.main([str(sink), "--once", "--json",
                         "--hb-dir", str(tmp_path)]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["heartbeats"]["1"]["step"] == 9
    assert st["ranks"]["r0"]["step"] == 4   # folded from the beat file


_GANG_WORKER = """
import time
from cme213_tpu_torch.core import faults, metrics, trace
from cme213_tpu_torch.dist.supervisor import heartbeat_from_env

hb = heartbeat_from_env()
metrics.counter("fleet.steps")        # arm the exit snapshot
with trace.span("fleet.worker"):
    for step in range(6):
        hb.beat(step)
        faults.maybe_kill_rank(step)
        metrics.counter("fleet.steps").inc()
        time.sleep(0.05)
"""


def test_supervised_gang_shares_one_trace_id(tmp_path, monkeypatch, capsys):
    """Launcher + both ranks + the post-restart incarnation all stamp ONE
    trace id; worker root spans parent under the launcher's gang-launch
    span; the collector and the federated exposition reconstruct the same
    fleet."""
    from cme213_tpu_torch.dist.launch import launch_supervised

    worker = write_worker(tmp_path, _GANG_WORKER)
    monkeypatch.setenv(trace.TRACE_FILE_ENV,
                       str(tmp_path / "gang-{rank}.jsonl"))
    monkeypatch.setenv(metrics.METRICS_FILE_ENV,
                       str(tmp_path / "fleet.prom"))
    monkeypatch.setenv("CME213_FAULTS", "rankkill:1:2")
    rc = launch_supervised(2, [sys.executable, worker],
                           stall_timeout=60, max_restarts=1, timeout=240)
    out = capsys.readouterr().out
    assert rc == 0, out
    trace.flush_sink()

    files = sorted(tmp_path.glob("gang-*.jsonl"))
    assert [f.name for f in files] == ["gang-0.jsonl", "gang-1.jsonl",
                                       "gang-main.jsonl"]
    recs = [json.loads(ln) for f in files
            for ln in f.read_text().splitlines()]
    ids = {r.get("trace") for r in recs}
    assert ids == {trace.trace_id()}, ids          # ONE id, this process's
    pids = {r["pid"] for r in recs}
    assert len(pids) >= 4                          # launcher + 2x2 workers
    assert {r["incarnation"] for r in recs} >= {0, 1}

    # causal parenting: every worker root span hangs off a gang-launch
    gang_spans = {r["id"] for r in recs
                  if r["event"] == "span-begin" and r["span"] == "gang-launch"}
    worker_roots = [r for r in recs if r["event"] == "span-begin"
                    and r["span"] == "fleet.worker"]
    assert len(gang_spans) == 2 and len(worker_roots) >= 3
    assert all(r["parent"] in gang_spans for r in worker_roots)

    coll = Collector([str(tmp_path / "gang-*.jsonl")])
    coll.poll()
    st = coll.state()
    assert st["fleet"]["launches"] == 2 and st["fleet"]["restarts"] == 1
    assert st["verdicts"][0]["rank"] == 1
    assert st["ranks"]["r0"]["state"] == "running"
    assert st["ranks"]["r1"]["incarnation"] == 1

    # the merged stream passes the CI gate form
    capsys.readouterr()
    assert trace_cli.main(
        ["summary", *[str(f) for f in files], "--single-trace",
         "--require", "gang-launch,heartbeat"]) == 0

    # federated exposition: both ranks labeled, launcher rolled in
    prom = (tmp_path / "fleet.prom").read_text()
    assert 'rank="r0"' in prom and 'rank="r1"' in prom
    assert "# HELP" in prom
