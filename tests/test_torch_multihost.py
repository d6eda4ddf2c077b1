"""The port's multi-process layer (``dist/multihost.py``, ``dist/launch.py``)
and the hw5 solves run as a gang, against the single-process mesh and the
JAX package.

Ports every case of ``tests/test_multihost.py``, the launcher and
handshake cases of ``tests/test_fault_injection.py``,
``test_telemetry.py::test_launcher_templates_trace_file_per_worker`` and
``test_fleet_telemetry.py::test_plain_launch_propagates_context``.  Gangs
are 2 ranks on the CPU over gloo (``tests/torch_gang.py``); the workers
read ``RANK`` where the reference's read ``JAX_PROCESS_ID``.  Tolerances:

- bit for bit against the port's single-process mesh and the numpy golden
  ``cme213_tpu.verify.golden.host_heat`` (every scheme and decomposition
  computes each cell with ``run_heat``'s expression);
- ULP-10 against JAX's ``run_distributed_heat`` on the same mesh shape
  (XLA:CPU contracts some multiply-adds into FMAs, the port never does);
- the scan bit for bit against the single-process ``ring`` and ``gather``
  carries, rel L2 1e-5 against JAX's ``distributed_segmented_scan``.
"""

import datetime
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu.config import GridMethod as JGridMethod
from cme213_tpu.config import SimParams as JSimParams
from cme213_tpu.dist import distributed_segmented_scan as j_dist_scan
from cme213_tpu.dist import make_mesh_1d as j_mesh_1d
from cme213_tpu.dist import make_mesh_2d as j_mesh_2d
from cme213_tpu.dist import run_distributed_heat as j_run_distributed_heat
from cme213_tpu.verify.golden import host_heat
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.core import faults, trace, ulp_distance, virtual_devices
from cme213_tpu_torch.dist import (distributed_segmented_scan, make_mesh_1d,
                                   make_mesh_2d, run_distributed_heat)
from cme213_tpu_torch.dist import multihost
from cme213_tpu_torch.dist.launch import (Rendezvous, _template_trace_file,
                                          launch, main)
from cme213_tpu_torch.grid import make_initial_grid

from torch_gang import ROOT, run_gang, write_worker

CPU4 = virtual_devices(4, "cpu")


@pytest.fixture(autouse=True)
def _clean_slate():
    trace.clear_events()
    yield
    faults.reset()


# ------------------------------------------------------------ start-up


class _Group:
    """Stands in for ``torch.distributed``'s group start-up."""

    def __init__(self):
        self.calls = []

    def init(self, backend, **kwargs):
        self.calls.append(dict(kwargs, backend=backend))


@pytest.fixture
def group(monkeypatch):
    g = _Group()
    monkeypatch.setattr(torch.distributed, "init_process_group", g.init)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    return g


def test_env_parsing_defaults(group, monkeypatch):
    """torchrun's variables are the argument source, like MPI ranks."""
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.delenv(multihost.HANDSHAKE_TIMEOUT_ENV, raising=False)
    multihost.initialize_multihost()
    assert group.calls == [{"backend": "gloo",
                            "init_method": "tcp://10.0.0.1:1234",
                            "world_size": 4, "rank": 3}]


def test_env_parsing_single_process_noop(group, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize_multihost()  # no-op
    assert group.calls == []
    assert multihost.process_info() == (0, 1)


def test_explicit_args_override_env(group, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "7")
    monkeypatch.delenv(multihost.HANDSHAKE_TIMEOUT_ENV, raising=False)
    multihost.initialize_multihost("127.0.0.1:9", num_processes=2,
                                   process_id=1)
    assert group.calls == [{"backend": "gloo",
                            "init_method": "tcp://127.0.0.1:9",
                            "world_size": 2, "rank": 1}]


def test_multihost_handshake_deadline_reaches_init_process_group(
        group, monkeypatch):
    """``--handshake-timeout`` (``CME213_HANDSHAKE_TIMEOUT``) becomes the
    process group's timeout."""
    monkeypatch.setenv(multihost.HANDSHAKE_TIMEOUT_ENV, "12")
    multihost.initialize_multihost(coordinator_address="127.0.0.1:1234",
                                   num_processes=2, process_id=0)
    (call,) = group.calls
    assert call["timeout"] == datetime.timedelta(seconds=12)
    assert call["rank"] == 0


def test_multiprocess_unsupported_keys_on_torch_s_message():
    assert multihost.multiprocess_unsupported(
        "RuntimeError: torch.distributed is not available")
    assert not multihost.multiprocess_unsupported("ValueError: boom")


_GROUP_WORKER = """
import torch
import torch.distributed as dist
from cme213_tpu_torch.dist.mesh import default_devices
from cme213_tpu_torch.dist.multihost import initialize_multihost, process_info

# the shards are on the CPU; the rest from the env, like an MPI launcher
initialize_multihost(device="cpu")
rank, world = process_info()
assert world == 2, world
devs = default_devices("cpu")
assert len(devs) == 2 * PER, devs
# one value a shard, 1..4 over the gang, summed across ranks
t = torch.arange(PER, dtype=torch.float32) + rank * PER + 1
total = float(t.sum())
t = torch.tensor([total])
dist.all_reduce(t)
print(f"rank {rank}/{world} devices={len(devs)} OK psum={float(t[0])}")
"""


@pytest.mark.parametrize("via", ["processes", "launcher"])
def test_two_process_gloo_group(tmp_path, capsys, via):
    """Two real processes form the gloo group from torchrun's variables
    and all-reduce across 2 ranks × 2 shards (the MPI_Allreduce smoke
    test): spawned by hand, and by the mpirun-style launcher."""
    if via == "launcher":
        rc = run_gang(tmp_path, _GROUP_WORKER, PER=2)
        out = capsys.readouterr().out
        assert rc == 0, out
        for rank in (0, 1):
            assert f"[rank {rank}] rank {rank}/2 devices=4 OK psum=10.0" \
                in out
        return
    script = write_worker(tmp_path, _GROUP_WORKER, PER=2)
    # the rendezvous is held here, bound to a port the system picks, as
    # the launcher holds it: no window for another socket to take the port
    rendezvous = Rendezvous().serve()
    port = rendezvous.port
    procs = [subprocess.Popen(
        [sys.executable, script],
        env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 WORLD_SIZE="2", RANK=str(rank),
                 CME213_DEVICES_PER_PROC="2",
                 TORCHELASTIC_USE_AGENT_STORE="True",
                 TORCHELASTIC_RESTART_COUNT="0"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1] for p in procs]
        pytest.fail("the two ranks did not finish in 150 s; stderr:\n"
                    + "\n".join(f"--- rank {r} ---\n{e[-3000:]}"
                                 for r, e in enumerate(errs)))
    finally:
        for p in procs:
            p.kill()
        rendezvous.close()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "OK psum=10.0" in out


def test_launcher_fail_fast(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys, os\n"
                      "sys.exit(3 if os.environ['RANK'] == '0' else 0)\n")
    assert launch(2, [sys.executable, str(script)], timeout=120) == 3


def test_launcher_cli_requires_command(capsys):
    with pytest.raises(SystemExit):
        main(["--np", "2", "--"])


def test_launcher_exports_torchrun_variables(tmp_path, capsys):
    script = tmp_path / "env.py"
    script.write_text(
        "import os\n"
        "print('ENV', *(os.environ[k] for k in ('MASTER_ADDR', "
        "'WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'CME213_INCARNATION', "
        "'CME213_DEVICES_PER_PROC')), int(os.environ['MASTER_PORT']) > 0)\n")
    assert launch(2, [sys.executable, str(script)], devices_per_proc=3,
                  timeout=120) == 0
    out = capsys.readouterr().out
    assert "[rank 1] ENV 127.0.0.1 2 1 1 0 3 True" in out
    assert "[rank 0] ENV 127.0.0.1 2 0 0 0 3 True" in out


# ------------------------------------------------- fault-injection cases

# a rank body that needs no torch: report rank+incarnation, honour rankkill
_RANK_BODY = (
    f"import sys; sys.path.insert(0, {str(ROOT)!r}); import os; "
    "from cme213_tpu_torch.core import faults; faults.maybe_kill_rank(); "
    "print('rank', os.environ['RANK'], "
    "'incarnation', faults.incarnation(), 'ok')")


def test_launch_rank_kill_restart_survives(monkeypatch, capsys):
    monkeypatch.setenv("CME213_FAULTS", "rankkill:1:0")
    rc = launch(2, [sys.executable, "-c", _RANK_BODY], max_restarts=1,
                timeout=120)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "injected kill: rank 1" in out
    assert "restarting (incarnation 1/1)" in out
    assert "rank 1 incarnation 1 ok" in out  # same rank id relaunched
    assert "rank 0 incarnation 0 ok" in out


def test_launch_rank_kill_without_restart_budget_fails(monkeypatch):
    monkeypatch.setenv("CME213_FAULTS", "rankkill:1:0")
    rc = launch(2, [sys.executable, "-c", _RANK_BODY], max_restarts=0,
                timeout=120)
    assert rc == faults.KILL_EXIT


def test_launch_timeout_kills_stuck_job():
    t0 = time.monotonic()
    rc = launch(1, [sys.executable, "-c", "import time; time.sleep(60)"],
                timeout=1.0)
    assert rc == 124
    assert time.monotonic() - t0 < 30


def test_launch_exports_handshake_deadline(capsys):
    rc = launch(1, [sys.executable, "-c",
                    "import os; print('HS', "
                    "os.environ['CME213_HANDSHAKE_TIMEOUT'], "
                    "os.environ['CME213_INCARNATION'])"],
                handshake_timeout=7.5, timeout=120)
    out = capsys.readouterr().out
    assert rc == 0
    assert "HS 7.5 0" in out


# ------------------------------------------------------------ telemetry


def test_launcher_templates_trace_file_per_worker():
    env = {"CME213_TRACE_FILE": "/tmp/x/t-{rank}.jsonl"}
    _template_trace_file(env, 3)
    assert env["CME213_TRACE_FILE"] == "/tmp/x/t-3.jsonl"
    env2 = {"CME213_TRACE_FILE": "/tmp/x/flat.jsonl"}
    _template_trace_file(env2, 3)  # no placeholder: untouched
    assert env2["CME213_TRACE_FILE"] == "/tmp/x/flat.jsonl"
    _template_trace_file({}, 0)  # no sink configured: no-op


def test_plain_launch_propagates_context(monkeypatch, capsys):
    """A plain (unsupervised) launch child inherits the launcher's trace
    id, and the launcher records the gang-launch/gang-exit lifecycle, its
    span naming the gang's backend."""
    code = ("from cme213_tpu_torch.core import trace; "
            "print('CHILD', trace.trace_id())")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    rc = launch(1, [sys.executable, "-c", code], timeout=120)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"CHILD {trace.trace_id()}" in out
    assert trace.events("gang-launch")[-1]["world"] == 1
    assert trace.events("gang-exit")[-1]["rc"] == 0
    (begin,) = [e for e in trace.events("span-begin")
                if e["span"] == "gang-launch"]
    assert begin["backend"] == "gloo"


# ------------------------------------------------- hw5 heat as a gang

BCS = dict(bc_top=2.0, bc_left=0.5, bc_bottom=1.0, bc_right=3.0)
#: 38 x 46 does not divide over 4 or 2 x 2 shards: ghost padding crosses
#: ranks too
HEAT = dict(nx=46, ny=38, order=8, iters=4, **BCS)
#: (name, grid method, overlap, k, local kernel)
HEAT_CASES = [(f"{m}-{'overlap' if ov else 'sync'}-k{k}-{kern}", m, ov, k,
               kern)
              for m in (1, 2) for ov, k, kern in
              ((False, 1, "xla"), (True, 1, "xla"), (False, 2, "xla"),
               (False, 1, "pallas"), (False, 2, "pallas"))]

_HEAT_WORKER = """
import numpy as np
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.core import conformance, faults, trace
from cme213_tpu_torch.dist import mesh_for_method, run_distributed_heat
from cme213_tpu_torch.dist.mesh import default_devices
from cme213_tpu_torch.dist.multihost import initialize_multihost, process_info

initialize_multihost(device="cpu")
rank, world = process_info()
out = sys.argv[1]
for name, method, overlap, k, kernel in CASES:
    p = SimParams(**HEAT, grid_method=GridMethod(method))
    mesh = mesh_for_method(p.grid_method, devices=default_devices("cpu"))
    assert list(mesh.owners.flat) == [0, 0, 1, 1], mesh.owners
    g = run_distributed_heat(p, mesh, overlap=overlap, steps_per_exchange=k,
                             local_kernel=kernel, conformance=False)
    np.save(f"{out}/{name}-rank{rank}.npy", g)
# one rank's probe perturbed: the gang takes one verdict, both ranks
# demote pallas and neither waits for the other
conformance.reset()
trace.clear_events()
if rank == 1:
    faults.install("wrong:dist_heat")
p = SimParams(**HEAT, grid_method=GridMethod.BLOCKS_2D)
mesh = mesh_for_method(p.grid_method, devices=default_devices("cpu"))
g = run_distributed_heat(p, mesh, local_kernel="pallas")
print("demoted", [e["rung"] for e in trace.events("rung-failed")])
np.save(f"{out}/wrong-rank{rank}.npy", g)
"""


def _port_mesh(method):
    return (make_mesh_2d(2, 2, devices=CPU4) if method == 2
            else make_mesh_1d(4, devices=CPU4))


def test_gang_heat_equals_single_process_golden_and_jax(tmp_path, capsys):
    """The 2-rank gang (2 shards a rank) gives the port's single-process
    4-shard mesh and the numpy golden bit for bit, on every rank, for the
    2 x 2 and 1-D x 4 meshes, sync and overlap, k = 1 and 2, ``xla`` and
    ``pallas`` (B3's plain version here); within ULP-10 of JAX's
    ``run_distributed_heat`` on the same mesh shape.  A ``wrong:`` clause
    on one rank demotes ``pallas`` on both."""
    rc = run_gang(tmp_path, _HEAT_WORKER, CASES=HEAT_CASES, HEAT=HEAT)
    out = capsys.readouterr().out
    assert rc == 0, out
    p1 = SimParams(**HEAT)
    u0 = make_initial_grid(p1, device="cpu").numpy()
    golden = host_heat(u0, p1.iters, p1.order, p1.xcfl, p1.ycfl)
    jax_done = {}
    for name, method, overlap, k, kernel in HEAT_CASES:
        g0 = np.load(tmp_path / f"{name}-rank0.npy")
        np.testing.assert_array_equal(np.load(tmp_path / f"{name}-rank1.npy"),
                                      g0)
        p = SimParams(**HEAT, grid_method=GridMethod(method))
        single = run_distributed_heat(p, _port_mesh(method), overlap=overlap,
                                      steps_per_exchange=k,
                                      local_kernel=kernel, conformance=False)
        np.testing.assert_array_equal(g0, single, err_msg=name)
        np.testing.assert_array_equal(g0, golden, err_msg=name)
        key = (method, overlap, k)
        if kernel == "xla" and key not in jax_done:
            jp = JSimParams(**HEAT, grid_method=JGridMethod(method))
            jmesh = j_mesh_2d(2, 2) if method == 2 else j_mesh_1d(4)
            ref = np.asarray(j_run_distributed_heat(
                jp, jmesh, dtype=jnp.float32, overlap=overlap,
                steps_per_exchange=k, conformance=False))
            jax_done[key] = int(ulp_distance(g0, ref).max())
    assert len(jax_done) == 6 and max(jax_done.values()) <= 10, jax_done
    wrong = np.load(tmp_path / "wrong-rank0.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "wrong-rank1.npy"),
                                  wrong)
    np.testing.assert_array_equal(wrong, golden)
    assert out.count("demoted ['pallas-k1']") == 2, out


def test_gang_heat_cli_equals_single_process(tmp_path, monkeypatch, capsys):
    """``dist.launch --np 2 --devices-per-proc 2 -- python -m
    cme213_tpu_torch heat2d P --distributed --device=cpu`` exits 0 with
    the single-process solve's dumps (rank 0 the whole grid, each owner
    its shards'); without ``--device=cpu`` and with no card the ranks
    raise: they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the no-card case needs a machine without CUDA")
    params = tmp_path / "p.in"
    SimParams(nx=40, ny=36, order=4, iters=6, **BCS,
              grid_method=GridMethod.BLOCKS_2D).to_file(str(params),
                                                       distributed=True)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    gang_dir, single_dir = tmp_path / "gang", tmp_path / "single"
    gang_dir.mkdir()
    single_dir.mkdir()
    monkeypatch.chdir(gang_dir)
    cmd = [sys.executable, "-m", "cme213_tpu_torch", "heat2d", str(params),
           "--distributed"]
    assert main(["--np", "2", "--devices-per-proc", "2", "--timeout", "200",
                 "--", *cmd, "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "backend gloo" in out and "halo exchange" in out
    assert sorted(os.listdir(gang_dir)) == [
        "grid0_final.txt", "grid1_final.txt", "grid2_final.txt",
        "grid3_final.txt", "grid_final.txt", "grid_init.txt"]
    monkeypatch.chdir(single_dir)
    from cme213_tpu_torch.apps import heat2d

    assert heat2d.main(["heat2d", str(params), "--distributed",
                        "--device=cpu"]) == 0
    for name in ("grid_final.txt", "grid_init.txt"):
        assert (gang_dir / name).read_text() == \
            (single_dir / name).read_text()
    monkeypatch.chdir(gang_dir)
    assert launch(2, cmd, devices_per_proc=2, timeout=200) != 0
    assert "no CUDA device available" in capsys.readouterr().out


# ------------------------------------------------- sharded scan as a gang

_SCAN_WORKER = """
import numpy as np
import torch
from cme213_tpu_torch.apps import spmv_scan as sp
from cme213_tpu_torch.dist import distributed_segmented_scan, make_mesh_1d
from cme213_tpu_torch.dist.mesh import default_devices
from cme213_tpu_torch.dist.multihost import initialize_multihost, process_info

initialize_multihost(device="cpu")
rank, world = process_info()
mesh = make_mesh_1d(devices=default_devices("cpu"))
rng = np.random.default_rng(7)
vals = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
flags = torch.zeros(N, dtype=torch.int32)
flags[[0, 10, 50, 90, 100]] = 1
for mode in ("ring", "gather"):
    out = distributed_segmented_scan(vals, flags, mesh, carry_mode=mode)
    np.save(f"{sys.argv[1]}/{mode}-rank{rank}.npy", out.numpy())
prob = sp.generate_problem(512, 16, 15, iters=6, seed=0)
np.save(f"{sys.argv[1]}/spmv-rank{rank}.npy",
        sp.run_spmv_scan_distributed(prob, mesh))
"""


def test_gang_scan_equals_single_process_and_jax(tmp_path, capsys):
    """The 2-rank gang's sharded scan (carries all-gathered over gloo)
    gives the single-process 4-shard ``ring`` and ``gather`` carries bit
    for bit on both ranks, within rel L2 1e-5 of JAX's
    ``distributed_segmented_scan``; the gated sharded SpMV-scan gives the
    single-process solve bit for bit."""
    from cme213_tpu_torch.apps import spmv_scan as sp

    n = 128
    rc = run_gang(tmp_path, _SCAN_WORKER, N=n)
    assert rc == 0, capsys.readouterr().out
    rng = np.random.default_rng(7)
    vals = rng.standard_normal(n).astype(np.float32)
    flags = np.zeros(n, np.int32)
    flags[[0, 10, 50, 90, 100]] = 1
    mesh = make_mesh_1d(4, devices=CPU4)
    ref = np.asarray(j_dist_scan(jnp.asarray(vals), jnp.asarray(flags),
                                 j_mesh_1d(4)))
    for mode in ("ring", "gather"):
        single = distributed_segmented_scan(
            torch.from_numpy(vals), torch.from_numpy(flags), mesh,
            carry_mode=mode).numpy()
        for rank in (0, 1):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"{mode}-rank{rank}.npy"), single)
        rel = np.linalg.norm(single - ref) / np.linalg.norm(ref)
        assert rel <= 1e-5, (mode, rel)
    prob = sp.generate_problem(512, 16, 15, iters=6, seed=0)
    single = sp.run_spmv_scan_distributed(prob, mesh)
    for rank in (0, 1):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"spmv-rank{rank}.npy"), single)
