"""The port's gang over several cards, checked where no card is: the
backend each layout takes (``dist/multihost.choose_backend``), the batched
exchange's message plan (``dist/halo.exchange_plan``) on both sides of
every pair, and a gloo gang on the CPU through the batched exchange, bit
for bit the single-process solve and the numpy golden.

The card cases (a mesh over four cards, the NCCL gang) are in
``tests/test_torch_cuda.py`` under the ``cuda`` marker.  Tolerance: bit
for bit (every decomposition computes each cell with ``run_heat``'s
expression, and the sharded scan combines its carries in one order).
"""

import itertools

import numpy as np
import pytest
import torch

from cme213_tpu.verify.golden import host_heat
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.core import FrameworkError, trace, virtual_devices
from cme213_tpu_torch.dist import (distributed_segmented_scan, halo,
                                   make_mesh_1d, make_mesh_2d, mesh,
                                   multihost, run_distributed_heat)
from cme213_tpu_torch.dist.halo import exchange_plan
from cme213_tpu_torch.dist.launch import _rank_env, gang_backend
from cme213_tpu_torch.grid import make_initial_grid

from torch_gang import run_gang


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.delenv(multihost.BACKEND_ENV, raising=False)
    trace.clear_events()
    yield


# ------------------------------------------------------ the backend choice

#: (label, device the entry points run on, ranks, shards a rank, cards,
#: the backend)
LAYOUTS = [
    ("cpu", "cpu", 2, 1, 4, "gloo"),
    ("no card, default device", None, 2, 1, 0, "gloo"),
    ("2 ranks on 1 card", "cuda", 2, 1, 1, "gloo"),
    ("2 ranks x 2 shards on 1 card", "cuda", 2, 2, 1, "gloo"),
    ("more ranks than cards", "cuda", 8, 1, 4, "gloo"),
    ("one card named for all", "cuda:0", 2, 1, 4, "gloo"),
    ("4 ranks on 4 cards", "cuda", 4, 1, 4, "nccl"),
    ("4 ranks on 4 cards, default device", None, 4, 1, 4, "nccl"),
    ("2 ranks x 2 shards on 4 cards", "cuda", 2, 2, 4, "nccl"),
    ("2 ranks on 8 cards", "cuda", 2, 1, 8, "nccl"),
]


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("label,device,world,per,cards,want", LAYOUTS,
                         ids=[row[0] for row in LAYOUTS])
def test_backend_follows_the_layout(monkeypatch, label, device, world, per,
                                    cards, want):
    """``nccl`` exactly when every rank's shards lie on a card no other
    rank uses (``mesh.default_devices``' placement), else ``gloo``; the
    launcher expects the same from the command's ``--device=`` and, by
    default, asks for nothing, so the rank's own choice stands in the
    environment it hands the rank."""
    _cards(monkeypatch, cards)
    assert multihost.choose_backend(world, device, cards) == want
    assert multihost.resolve_backend(world, device) == want
    cmd = ["python", "-m", "cme213_tpu_torch", "heat2d", "p.in"]
    if device is not None:
        cmd.append(f"--device={device}")
    assert gang_backend(world, cmd) == want
    env = _rank_env(0, world, "127.0.0.1", 9, 0, {}, per, None, "auto")
    assert multihost.BACKEND_ENV not in env
    assert multihost.resolve_backend(
        world, device, env.get(multihost.BACKEND_ENV, "auto")) == want
    # the placement the backend was chosen for
    monkeypatch.setattr(multihost, "process_info", lambda: (0, world))
    monkeypatch.setenv(multihost.DEVICES_PER_PROC_ENV, str(per))
    if device is None and not cards:
        device = "cpu"
    devs = mesh.default_devices(device)
    by_rank = [set(map(str, devs[r * per:(r + 1) * per]))
               for r in range(world)]
    own_card = all(d.startswith("cuda:") for s in by_rank for d in s) and \
        all(a.isdisjoint(b) for a, b in itertools.combinations(by_rank, 2))
    assert own_card == (want == "nccl"), by_rank


def test_backend_asked_for(monkeypatch):
    """``CME213_DIST_BACKEND`` (``dist.launch --backend gloo``): ``gloo``
    where NCCL could serve, and the launcher exports only that; ``nccl``
    is no name to ask for (a guess would become a demand), nor is any
    other."""
    _cards(monkeypatch, 4)
    monkeypatch.setenv(multihost.BACKEND_ENV, "gloo")
    assert multihost.resolve_backend(4, "cuda") == "gloo"
    assert multihost.resolve_backend(4, None) == "gloo"
    env = _rank_env(0, 4, "127.0.0.1", 9, 0, {}, None, None, "gloo")
    assert env[multihost.BACKEND_ENV] == "gloo"
    assert gang_backend(4, ["x"], "gloo") == "gloo"
    for name in ("nccl", "mpi"):
        with pytest.raises(ValueError, match="expected one of"):
            gang_backend(4, ["x"], name)
        monkeypatch.setenv(multihost.BACKEND_ENV, name)
        with pytest.raises(ValueError, match="expected one of"):
            multihost.resolve_backend(2, "cpu")


def test_gloo_start_up_is_unchanged_and_named(monkeypatch):
    """A gloo gang joins as before (no card set, no side group) and the
    process remembers the backend it joined with."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setitem(multihost._GANG, "backend", None)
    multihost.initialize_multihost("127.0.0.1:9", num_processes=2,
                                   process_id=1, device="cpu")
    assert calls == [("gloo", {"init_method": "tcp://127.0.0.1:9",
                               "world_size": 2, "rank": 1})]
    assert multihost.backend() == "gloo" and multihost.control() is None


def test_nccl_start_up_failure_raises(monkeypatch):
    """An NCCL start-up that fails raises ``FrameworkError`` naming the
    rank and its card; it never re-forms the group on gloo."""
    _cards(monkeypatch, 4)
    calls = []

    def refuse(backend, **kw):
        calls.append(backend)
        raise RuntimeError("ncclUnhandledCudaError")

    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setitem(multihost._GANG, "backend", None)
    with pytest.raises(FrameworkError, match="rank 2/4: NCCL start-up on "
                                             "cuda:2 failed"):
        multihost.initialize_multihost("127.0.0.1:9", num_processes=4,
                                       process_id=2)
    assert calls == ["nccl"]
    assert multihost.backend() is None


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_a_failed_collective_raises_by_backend(monkeypatch, backend):
    """Under NCCL a failed exchange or gather raises ``FrameworkError``
    naming the rank; under gloo the error propagates as it is."""
    monkeypatch.setitem(multihost._GANG, "backend", backend)
    monkeypatch.setattr(multihost, "process_info", lambda: (1, 4))
    want = FrameworkError if backend == "nccl" else RuntimeError
    with pytest.raises(want) as err:
        with multihost.collective("gather"):
            raise RuntimeError("peer closed")
    if backend == "nccl":
        assert "rank 1/4: NCCL gather failed: RuntimeError: peer closed" \
            in str(err.value)
    else:
        assert type(err.value) is RuntimeError


@pytest.mark.parametrize("device", [torch.device("cpu"),
                                    torch.device("cuda", 0)],
                         ids=["cpu", "cuda"])
@pytest.mark.parametrize("name", ["nccl", "gloo", None])
def test_host_staging_follows_backend_and_device(monkeypatch, name, device):
    """A cross-rank message goes through a host buffer exactly when its
    tensor lies on a card and the backend is not NCCL (gloo's ops take CPU
    tensors); the exchange and the gather ask the same question."""
    monkeypatch.setattr(halo, "backend", lambda: name)
    assert halo._through_host(device) == (name != "nccl"
                                          and device.type == "cuda")
    assert halo._through_host(str(device)) == halo._through_host(device)


@pytest.mark.parametrize("name", ["nccl", "gloo"])
def test_an_exchange_waits_on_the_host_only_through_it(monkeypatch, name):
    """An exchange synchronises with the card exactly where its messages
    stage through the host: ``_through_host`` decides both, so under NCCL
    on a card the exchange makes no host wait (``EXCHANGE["host_waits"]``
    stays), and under gloo it waits before and after the batch and for
    each slab it copies out.  (CPU tensors stand in for the card's: the
    decision is patched to see a card.)"""
    monkeypatch.setattr(halo, "backend", lambda: name)
    monkeypatch.setattr(halo, "_through_host",
                        lambda device: halo.backend() != "nccl")
    waits = []
    monkeypatch.setattr(halo, "_sync_streams",
                        lambda devices: waits.append(len(devices)))
    monkeypatch.setattr(multihost, "process_info", lambda: (0, 2))
    posted = []

    class Done:
        def wait(self):
            return True

    def batch(ops):
        posted.extend(ops)
        return [Done() for _ in ops]

    monkeypatch.setattr(torch.distributed, "batch_isend_irecv", batch)
    monkeypatch.setattr(torch.distributed, "P2POp",
                        lambda op, t, peer: (op, t, peer))
    before = dict(halo.EXCHANGE)
    blocks = [torch.ones(6, 5), None]
    halos = [[[None, None], None]]
    halo._exchange_batched([blocks], halos, 2, 0, [[0, 1]])
    assert len(posted) == 2 and halos[0][0][1].shape == (2, 5)
    host_waits = halo.EXCHANGE["host_waits"] - before["host_waits"]
    if name == "nccl":
        assert waits == [] and host_waits == 0
    else:
        assert waits == [1, 1] and host_waits == 1  # the slab sent
    assert halo.EXCHANGE["seconds"] > before["seconds"]


# ------------------------------------------------------- the message plan

#: (mesh shape, shards a rank): rank-major owners, every rank a shard
MESHES = [((4,), 1), ((4,), 2), ((8,), 2), ((2, 2), 1), ((2, 2), 2),
          ((2, 4), 1), ((2, 4), 2), ((4, 2), 2), ((4, 4), 4), ((3, 3), 3)]


def _lines(shape, per):
    """The owners of every line of the mesh, by axis: y (columns) and x
    (rows), as ``dist/heat._pad_axis`` hands them to the exchange."""
    owners = (np.arange(int(np.prod(shape))) // per).reshape(
        shape if len(shape) == 2 else (shape[0], 1))
    return {"y": [list(owners[:, x]) for x in range(owners.shape[1])],
            "x": [list(row) for row in owners]}


@pytest.mark.parametrize("shape,per", MESHES,
                         ids=[f"{'x'.join(map(str, s))}-{p}a-rank"
                              for s, p in MESHES])
@pytest.mark.parametrize("axis", ["y", "x"])
def test_both_sides_of_every_pair_agree(shape, per, axis):
    """Each rank derives its posting order from ``owners`` alone; for every
    pair of ranks the sender's messages and the receiver's come in one
    order, message for message, with no tag to match them, and every
    cross-rank halo of the exchange is filled exactly once."""
    lines = _lines(shape, per)[axis]
    world = max(max(line) for line in lines) + 1
    plans = {r: exchange_plan(lines, r) for r in range(world)}
    pairs = set()
    for a, b in itertools.permutations(range(world), 2):
        sent = [m[2:] for m in plans[a] if m[0] == "send" and m[1] == b]
        got = [m[2:] for m in plans[b] if m[0] == "recv" and m[1] == a]
        assert sent == got, (a, b)
        if sent:
            pairs.add((a, b))
    received = sorted(m[2:] for r in range(world) for m in plans[r]
                      if m[0] == "recv")
    want = sorted((li, i, side) for li, line in enumerate(lines)
                  for i in range(len(line))
                  for side, j in ((0, i - 1), (1, i + 1))
                  if 0 <= j < len(line) and line[j] != line[i])
    assert received == want
    assert pairs == {(a, b) for line in lines for i in range(len(line) - 1)
                     for a, b in ((line[i], line[i + 1]),
                                  (line[i + 1], line[i])) if a != b}


def test_one_pair_carries_several_messages_in_one_batch():
    """2 ranks x 2 shards on a 2 x 2 mesh: the y exchange's one batch
    carries two messages each way between ranks 0 and 1 (one a column),
    in the same order on both sides."""
    lines = _lines((2, 2), 2)["y"]
    assert exchange_plan(lines, 0) == [("recv", 1, 0, 0, 1),
                                       ("send", 1, 0, 1, 0),
                                       ("recv", 1, 1, 0, 1),
                                       ("send", 1, 1, 1, 0)]
    assert exchange_plan(lines, 1) == [("send", 0, 0, 0, 1),
                                       ("recv", 0, 0, 1, 0),
                                       ("send", 0, 1, 0, 1),
                                       ("recv", 0, 1, 1, 0)]
    assert exchange_plan(_lines((2, 2), 2)["x"], 0) == []


# ------------------------------------------- a gloo gang, batched exchange

HEAT = dict(nx=46, ny=38, order=8, iters=4, bc_top=2.0, bc_left=0.5,
            bc_bottom=1.0, bc_right=3.0)
#: (name, grid method, overlap, k, local kernel, sizes that replace
#: HEAT's): the last grid divides over neither axis of the 2 x 2 mesh
CASES = [("2d-sync", 2, False, 1, "xla", {}),
         ("1d-sync", 1, False, 1, "xla", {}),
         ("2d-overlap", 2, True, 1, "xla", {}),
         ("2d-k2-pallas", 2, False, 2, "pallas", {}),
         ("2d-ragged-pallas", 2, False, 1, "pallas", dict(nx=45, ny=37))]

_WORKER = """
import json
import numpy as np
import torch
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.core import metrics
from cme213_tpu_torch.dist import (distributed_segmented_scan, halo,
                                   mesh_for_method, make_mesh_1d,
                                   run_distributed_heat)
from cme213_tpu_torch.dist.mesh import default_devices
from cme213_tpu_torch.dist.multihost import (backend, initialize_multihost,
                                             process_info)

initialize_multihost(device="cpu")
rank, world = process_info()
calls = {"batched": 0}
real = halo._exchange_batched


def counted(*a, **k):
    calls["batched"] += 1
    return real(*a, **k)


halo._exchange_batched = counted
out = sys.argv[1]
clocks = {}
for name, method, overlap, k, kernel, sizes in CASES:
    p = SimParams(**{**HEAT, **sizes}, grid_method=GridMethod(method))
    mesh = mesh_for_method(p.grid_method, devices=default_devices("cpu"))
    g = run_distributed_heat(p, mesh, overlap=overlap, steps_per_exchange=k,
                             local_kernel=kernel, conformance=False)
    np.save(f"{out}/{name}-rank{rank}.npy", g)
    clocks[name] = [metrics.gauge(f"dist_heat.{what}_s").value
                    for what in ("exchange", "solve")]
n = 4 * 1000
v = torch.from_numpy(np.sin(np.arange(n, dtype=np.float32)) + 0.5)
f = torch.from_numpy((np.arange(n) % 37 == 0).astype(np.int32))
s = distributed_segmented_scan(v, f, make_mesh_1d(devices=default_devices(
    "cpu")))
np.save(f"{out}/scan-rank{rank}.npy", s.numpy())
with open(f"{out}/calls-rank{rank}.json", "w") as fh:
    json.dump(dict(calls, backend=backend(), clocks=clocks,
                   messages=halo.EXCHANGE["messages"],
                   host_waits=halo.EXCHANGE["host_waits"],
                   pads=halo.PADS), fh)
"""


#: (interior ny, nx, mesh shape): grids that divide, and grids whose last
#: blocks hold ghost rows, columns or both (one block wholly ghost)
BLOCK_LAYOUTS = [(38, 46, (2, 2)), (37, 45, (2, 2)), (37, 46, (4, 1)),
                 (9, 20, (4, 1)), (38, 45, (2, 4)), (30, 31, (3, 3))]


@pytest.mark.parametrize("ny,nx,shape", BLOCK_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_initial_blocks_are_slices_of_the_padded_grid(ny, nx, shape, dtype):
    """Each rank builds its own initial blocks on their devices
    (``dist/heat._initial_blocks``), bit for bit the slices that
    ``_scatter`` cuts from ``make_initial_grid``'s interior ghost-padded by
    ``_pad_interior_for_mesh``; with owners, only the rank's own."""
    from cme213_tpu_torch.dist import heat as dheat
    from cme213_tpu_torch.grid import interior

    p = SimParams(nx=nx, ny=ny, order=8, ic=1.37, bc_top=2.1, bc_left=0.5,
                  bc_bottom=1.3, bc_right=3.7)
    y_size, x_size = shape
    ny_loc, nx_loc = -(-ny // y_size), -(-nx // x_size)
    devices = np.array(virtual_devices(y_size * x_size, "cpu"),
                       dtype=object).reshape(shape)
    u = dheat._pad_interior_for_mesh(
        interior(make_initial_grid(p, dtype=dtype, device="cpu"),
                 p.border_size).numpy(), p, y_size, x_size)
    want = dheat._scatter(torch.from_numpy(u), devices, ny_loc, nx_loc)
    got = dheat._initial_blocks(p, dtype, devices, ny_loc, nx_loc)
    for wrow, grow in zip(want, got):
        for w, g in zip(wrow, grow):
            assert g.dtype == dtype and g.device == w.device
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    owners = np.arange(y_size * x_size).reshape(shape) % 2
    mine = dheat._initial_blocks(p, dtype, devices, ny_loc, nx_loc, owners,
                                 rank=1)
    for yi in range(y_size):
        for xi in range(x_size):
            if owners[yi, xi] == 1:
                assert torch.equal(mine[yi][xi], got[yi][xi])
            else:
                assert mine[yi][xi] is None


#: the host ranges of one distributed solve and the range each lies in
SOLVE_RANGES = {"dist.solve": None, "dist.prepare": "dist.solve",
                "dist.steps": "dist.solve", "dist.enqueue": "dist.steps",
                "dist.gather": "dist.solve", "dist.download": "dist.solve"}


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_a_solve_records_each_of_its_ranges_once(kernel):
    """While a profiler records, every ``run_distributed_heat`` call
    leaves one host range of each name, each inside its parent
    (``dist.solve`` holds ``dist.prepare``, ``dist.steps``,
    ``dist.gather`` and ``dist.download``; ``dist.steps`` holds
    ``dist.enqueue``), never one a step; the ``dist.steps`` span's
    records carry the kernel, the block and the steps."""
    from torch.profiler import ProfilerActivity, profile

    p = SimParams(nx=45, ny=37, order=8, iters=6, grid_method=GridMethod(2))
    mesh = make_mesh_2d(2, 2, devices=virtual_devices(4, "cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            run_distributed_heat(p, mesh, local_kernel=kernel,
                                 conformance=False)
    found = {name: [] for name in SOLVE_RANGES}
    for ev in prof.events():
        if ev.name in found:
            found[ev.name].append((ev.time_range.start, ev.time_range.end))
    for name, parent in SOLVE_RANGES.items():
        assert len(found[name]) == 2, (name, found[name])
        if parent is not None:
            for (s, e), (ps, pe) in zip(sorted(found[name]),
                                        sorted(found[parent])):
                assert ps <= s and e <= pe, (name, parent)
    ends = [e for e in trace.events("span-end") if e["span"] == "dist.steps"]
    assert [(e["kernel"], e["block"], e["iters"]) for e in ends] == \
        [(kernel, "19x23", 6)] * 2


def _check_cpu_gang(tmp_path, np_procs):
    """The CPU gang's grids and scans against the single-process 4-shard
    runs and the numpy golden, bit for bit, and each rank's record of its
    exchange and its backend."""
    cpu4 = virtual_devices(4, "cpu")
    for name, method, overlap, k, kernel, sizes in CASES:
        p1 = SimParams(**{**HEAT, **sizes})
        golden = host_heat(make_initial_grid(p1, device="cpu").numpy(),
                           p1.iters, p1.order, p1.xcfl, p1.ycfl)
        p = SimParams(**{**HEAT, **sizes}, grid_method=GridMethod(method))
        mesh = (make_mesh_2d(2, 2, devices=cpu4) if method == 2
                else make_mesh_1d(4, devices=cpu4))
        single = run_distributed_heat(p, mesh, overlap=overlap,
                                      steps_per_exchange=k,
                                      local_kernel=kernel, conformance=False)
        np.testing.assert_array_equal(single, golden, err_msg=name)
        for rank in range(np_procs):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"{name}-rank{rank}.npy"), single,
                err_msg=f"{name} rank {rank}")
    n = 4 * 1000
    v = torch.from_numpy(np.sin(np.arange(n, dtype=np.float32)) + 0.5)
    f = torch.from_numpy((np.arange(n) % 37 == 0).astype(np.int32))
    scan = distributed_segmented_scan(v, f, make_mesh_1d(4, devices=cpu4))
    import json

    for rank in range(np_procs):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"scan-rank{rank}.npy"), scan.numpy())
        calls = json.loads((tmp_path / f"calls-rank{rank}.json").read_text())
        assert calls["backend"] == "gloo"
        assert calls["batched"] > 0, calls
        assert calls["messages"] > 0, calls
        # CPU shards: nothing to wait for; every solve still clocks its
        # exchanges (the host clock) inside its timed bracket
        assert calls["host_waits"] == 0, calls
        # one padded assembly a step on each rank: in place for B3, by
        # concatenation for the plain steps
        steps = {"pallas": 0, "xla": 0}
        for _name, _method, _overlap, k, kernel, _sizes in CASES:
            steps[kernel] += HEAT["iters"] // k
        assert calls["pads"] == {"in_place": steps["pallas"],
                                 "cat": steps["xla"]}, calls
        for name, (exchange_s, solve_s) in calls["clocks"].items():
            assert 0 < exchange_s <= solve_s, (name, calls["clocks"])


@pytest.mark.parametrize("np_procs,per", [(2, 2), (4, 1)],
                         ids=["2-ranks-x-2-shards", "4-ranks-x-1-shard"])
def test_gloo_gang_through_the_batched_exchange(tmp_path, capsys, np_procs,
                                                per):
    """A gloo gang on the CPU posts every exchange as one batch in the
    plan's order and gives the single-process 4-shard mesh and the numpy
    golden bit for bit on every rank, with each rank's initial blocks
    built on its own devices and a grid that does not divide over the
    mesh among the cases; the sharded scan gives the single-process
    scan's bits.  ``dist_heat.exchange_s`` is set by every solve."""
    rc = run_gang(tmp_path, _WORKER, np_procs=np_procs, devices_per_proc=per,
                  CASES=CASES, HEAT=HEAT)
    out = capsys.readouterr().out
    assert rc == 0, out
    _check_cpu_gang(tmp_path, np_procs)


#: run first in each rank: every exchange takes the path of one card under
#: NCCL (``halo._graphed``), and a batch's "graph" replays it by posting
#: its buffers again; each rank leaves the count of replays
_GRAPHED = """
import atexit
import json
import sys
from cme213_tpu_torch.dist import halo
from cme213_tpu_torch.dist.multihost import process_info

replays = []


def capture(post):
    def replay():
        replays.append(1)
        post()
    return replay


halo._graphed = lambda devices: True
halo._capture = capture
atexit.register(lambda: open(
    f"{sys.argv[1]}/replays-rank{process_info()[0]}.json", "w").write(
        json.dumps(len(replays))))
"""


@pytest.mark.parametrize("np_procs,per", [(2, 2), (4, 1)],
                         ids=["2-ranks-x-2-shards", "4-ranks-x-1-shard"])
def test_gloo_gang_replays_the_batches_it_has_seen(tmp_path, capsys,
                                                   np_procs, per):
    """Where a gang replays its exchanges (under NCCL on a card, here
    stood in for on the CPU), a batch's first exchange runs as it is and
    every later one copies its slabs into the batch's own buffers and
    replays it: every case is still the single-process mesh's and the
    numpy golden's bit for bit on every rank, and every rank replayed."""
    import json

    rc = run_gang(tmp_path, _GRAPHED + _WORKER, np_procs=np_procs,
                  devices_per_proc=per, CASES=CASES, HEAT=HEAT)
    out = capsys.readouterr().out
    assert rc == 0, out
    _check_cpu_gang(tmp_path, np_procs)
    for rank in range(np_procs):
        assert json.loads((tmp_path / f"replays-rank{rank}.json")
                          .read_text()) > 0, rank


#: run first in each rank: the host seems to have four cards
_FOUR_CARDS = """
import torch
torch.cuda.device_count = lambda: 4
"""


@pytest.mark.parametrize("asked", ["auto", "gloo"])
def test_cpu_gang_takes_gloo_on_a_four_card_host(tmp_path, capsys,
                                                 monkeypatch, asked):
    """On a host with four cards (the count patched in the launcher and in
    every rank) a 4-rank gang whose shards lie on the CPU still joins
    gloo: by its own choice under ``auto``, which the launcher leaves to
    the rank, and when the launcher asks for gloo; the results are the
    CPU gang's, bit for bit."""
    _cards(monkeypatch, 4)
    rc = run_gang(tmp_path, _FOUR_CARDS + _WORKER, np_procs=4,
                  devices_per_proc=1, backend=asked, CASES=CASES, HEAT=HEAT)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("torch.distributed backend gloo") == 4, out
    _check_cpu_gang(tmp_path, 4)
