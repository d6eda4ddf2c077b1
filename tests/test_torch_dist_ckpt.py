"""Epoch-committed distributed checkpoints in the port (``dist/ckpt.py``):
the commit protocol's crash windows, elastic resume across shard counts,
rank counts and decompositions, the supervised solvers' bitwise-recovery
contract, and the file format shared with the JAX package.

Ports every case of ``tests/test_dist_ckpt.py`` on single-process meshes of
virtual CPU shards, and adds: a commit written by
``cme213_tpu.dist.ckpt.commit_epoch`` loads in the port bit for bit and the
reverse; a 2-rank gang's commit resumes on a 1-process 4-shard mesh bit for
bit; the supervised heat solve's halving under ``oom:heat_chunk``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from cme213_tpu.dist import make_mesh_2d as j_mesh_2d
from cme213_tpu.dist.ckpt import commit_epoch as j_commit_epoch
from cme213_tpu.dist.ckpt import load_latest_commit as j_load_latest_commit
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.core import faults, trace, virtual_devices
from cme213_tpu_torch.dist import (make_mesh_1d, make_mesh_2d,
                                   run_distributed_heat,
                                   run_distributed_heat_supervised)
from cme213_tpu_torch.dist.ckpt import (CommitError, check_meta,
                                        commit_epoch, load_latest_commit)

from torch_gang import run_gang

CPU4 = virtual_devices(4, "cpu")


def mesh_1d(n):
    return make_mesh_1d(n, devices=CPU4)


def mesh_2d(py, px):
    return make_mesh_2d(py, px, devices=CPU4)


@pytest.fixture(autouse=True)
def _clean_slate():
    trace.clear_events()
    yield
    faults.reset()


P_SMALL = SimParams(nx=32, ny=32, order=4, iters=8)


def _ckpt(tmp_path, name="ckpt"):
    return str(tmp_path / name)


# ------------------------------------------------------- commit + resume

def test_supervised_equals_uninterrupted_bitwise(tmp_path):
    mesh = mesh_1d(2)
    ref = run_distributed_heat(P_SMALL, mesh)
    out = run_distributed_heat_supervised(P_SMALL, mesh, _ckpt(tmp_path),
                                          ckpt_every=2)
    np.testing.assert_array_equal(out, ref)
    commits = trace.events("epoch-commit")
    assert [c["epoch"] for c in commits] == [1, 2, 3, 4]
    assert commits[-1]["step"] == 8
    assert len(trace.events("solver-progress")) == 4


def test_resume_continues_from_commit_bitwise(tmp_path):
    """Stop after 4 of 8 iters (a committed mid-solve state), then resume
    the full solve: the recovered run is bitwise-equal to uninterrupted —
    deterministic chunking on the sync path."""
    mesh = mesh_1d(2)
    d = _ckpt(tmp_path)
    run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=2, iters=4)
    out = run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=2)
    np.testing.assert_array_equal(out, run_distributed_heat(P_SMALL, mesh))
    # the resumed leg only commits epochs 3 and 4
    assert [c["epoch"] for c in trace.events("epoch-commit")] == [1, 2, 3, 4]


def test_resume_off_ignores_existing_commit(tmp_path):
    mesh = mesh_1d(2)
    d = _ckpt(tmp_path)
    run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=2, iters=4)
    out = run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=4,
                                          resume=False)
    np.testing.assert_array_equal(out, run_distributed_heat(P_SMALL, mesh))


def test_retention_keeps_two_generations(tmp_path):
    mesh = mesh_1d(2)
    d = _ckpt(tmp_path)
    run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=2)
    names = sorted(n for n in os.listdir(d) if n.startswith("epoch_"))
    assert names == ["epoch_00000003", "epoch_00000004"]  # older GC'd
    assert json.load(open(os.path.join(d, "COMMIT")))["epoch"] == 4
    assert json.load(open(os.path.join(d, "COMMIT.prev")))["epoch"] == 3


def test_oom_halves_the_epoch_and_stays_bitwise(tmp_path):
    """An injected RESOURCE failure halves ``ckpt_every`` and retries from
    the last commit; the result stays bit for bit."""
    mesh = mesh_2d(2, 2)
    with faults.injected("oom:heat_chunk:2"):
        out = run_distributed_heat_supervised(P_SMALL, mesh, _ckpt(tmp_path),
                                              ckpt_every=4)
    np.testing.assert_array_equal(out, run_distributed_heat(P_SMALL, mesh))
    (shrunk,) = trace.events("chunk-shrunk")
    assert (shrunk["from_size"], shrunk["to_size"]) == (4, 2)


# ------------------------------------------------------- crash windows

def test_crash_between_shards_and_commit_resumes_prior_epoch(tmp_path):
    """The window the protocol exists for: epoch-2 shards are durable but
    the COMMIT publish never happened — resume must land on epoch 1,
    never the torn epoch 2."""
    mesh = mesh_1d(2)
    d = _ckpt(tmp_path)
    with faults.injected("ckpt:commit:2"):
        with pytest.raises(faults.InjectedFault):
            run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=2)
    manifest, _ = load_latest_commit(d)
    assert (manifest["epoch"], manifest["step"]) == (1, 2)
    # recovery recomputes the lost epoch; final grid is bitwise-clean
    out = run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=2)
    np.testing.assert_array_equal(out, run_distributed_heat(P_SMALL, mesh))


def test_torn_manifest_falls_back_a_generation(tmp_path):
    """ckpt:truncate tearing the COMMIT file itself: each epoch writes 2
    shards + 1 manifest, so the 6th checkpoint-file write is epoch 2's
    manifest; the torn COMMIT is skipped and COMMIT.prev (epoch 1)
    serves."""
    mesh = mesh_1d(2)
    d = _ckpt(tmp_path)
    with faults.injected("ckpt:truncate:6"):
        run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=2,
                                        iters=4)
    manifest, _ = load_latest_commit(d)
    assert (manifest["epoch"], manifest["step"]) == (1, 2)
    assert any(e["candidate"] == "COMMIT"
               for e in trace.events("commit-invalid"))


def test_torn_shard_write_aborts_commit_not_resume(tmp_path):
    """A shard torn at write time (ckpt:truncate on an epoch-2 shard) is
    caught by the pre-publish read-back validation — the commit aborts
    with the previous epoch intact."""
    mesh = mesh_1d(2)
    d = _ckpt(tmp_path)
    with faults.injected("ckpt:truncate:4"):  # 2nd shard of epoch 2
        with pytest.raises(CommitError):
            run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=2)
    manifest, _ = load_latest_commit(d)
    assert (manifest["epoch"], manifest["step"]) == (1, 2)


def test_shard_corrupted_after_publish_falls_back(tmp_path):
    """Bit-rot under a published commit: resume detects the checksum
    mismatch and falls back to the previous committed epoch."""
    mesh = mesh_1d(2)
    d = _ckpt(tmp_path)
    run_distributed_heat_supervised(P_SMALL, mesh, d, ckpt_every=2, iters=4)
    live = json.load(open(os.path.join(d, "COMMIT")))
    shard = os.path.join(d, live["epoch_dir"], live["shards"][0]["file"])
    size = os.path.getsize(shard)
    with open(shard, "r+b") as f:
        f.truncate(size // 2)
    manifest, _ = load_latest_commit(d)
    assert manifest["epoch"] == live["epoch"] - 1
    assert trace.events("commit-invalid")


def test_nothing_recoverable_returns_none(tmp_path):
    assert load_latest_commit(str(tmp_path)) is None


# ------------------------------------------------------- elastic resume

@pytest.mark.parametrize("mesh_a, mesh_b", [
    (lambda: mesh_1d(2), lambda: mesh_1d(4)),   # 2 -> 4 shards
    (lambda: mesh_1d(4), lambda: mesh_1d(2)),   # 4 -> 2 shards
    (lambda: mesh_1d(4), lambda: mesh_2d(2, 2)),  # stripes -> blocks
    (lambda: mesh_2d(2, 2), lambda: mesh_1d(2)),  # blocks -> stripes
])
def test_elastic_resume_bitwise(tmp_path, mesh_a, mesh_b):
    """A commit written under one decomposition resumes under another —
    different shard count, even a different GridMethod — and the final
    grid still bitwise-matches the single-decomposition reference."""
    d = _ckpt(tmp_path)
    run_distributed_heat_supervised(P_SMALL, mesh_a(), d, ckpt_every=2,
                                    iters=4)
    out = run_distributed_heat_supervised(P_SMALL, mesh_b(), d, ckpt_every=2)
    np.testing.assert_array_equal(
        out, run_distributed_heat(P_SMALL, mesh_1d(2)))


def test_elastic_resume_nondivisible_grid(tmp_path):
    """Ghost padding differs per mesh (30 rows over 4 shards pads to 32;
    over 2 it doesn't pad at all) — the commit stores the TRUE interior,
    so re-decomposition re-derives the padding."""
    p = SimParams(nx=30, ny=30, order=2, iters=6)
    d = _ckpt(tmp_path)
    run_distributed_heat_supervised(p, mesh_1d(4), d, ckpt_every=2, iters=2)
    out = run_distributed_heat_supervised(p, mesh_1d(2), d, ckpt_every=2)
    np.testing.assert_array_equal(out, run_distributed_heat(p, mesh_1d(2)))


def test_meta_mismatch_refuses_resume(tmp_path):
    d = _ckpt(tmp_path)
    run_distributed_heat_supervised(P_SMALL, mesh_1d(2), d, ckpt_every=2,
                                    iters=2)
    other = SimParams(nx=32, ny=32, order=2, iters=8)  # different order
    with pytest.raises(CommitError):
        run_distributed_heat_supervised(other, mesh_1d(2), d, ckpt_every=2)


def test_check_meta_reports_mismatched_keys(tmp_path):
    d = _ckpt(tmp_path)
    run_distributed_heat_supervised(P_SMALL, mesh_1d(2), d, ckpt_every=2,
                                    iters=2)
    manifest, _ = load_latest_commit(d)
    check_meta(manifest, ny=32, order=4)  # matching subset passes
    with pytest.raises(CommitError, match="order"):
        check_meta(manifest, ny=32, order=8)


# ------------------------------------------------------- sharded scan

def test_supervised_scan_matches_plain_and_single_device(tmp_path):
    from cme213_tpu_torch.apps import spmv_scan as sp

    prob = sp.generate_problem(512, 16, 15, iters=6, seed=0)
    mesh = mesh_1d(2)
    ref_dist = sp.run_spmv_scan_distributed(prob, mesh)
    out = sp.run_spmv_scan_distributed_supervised(prob, mesh,
                                                  _ckpt(tmp_path), every=2)
    np.testing.assert_array_equal(out, ref_dist)  # same mesh: bitwise
    np.testing.assert_allclose(out, sp.run_spmv_scan(prob, device="cpu"),
                               rtol=1e-5)


def test_supervised_scan_elastic_crash_resume(tmp_path):
    """Crash the scan solve in the commit window on 2 shards, resume on 4:
    the elastic path must still match the single-device reference."""
    from cme213_tpu_torch.apps import spmv_scan as sp

    prob = sp.generate_problem(512, 16, 15, iters=6, seed=1)
    d = _ckpt(tmp_path)
    with faults.injected("ckpt:commit:2"):
        with pytest.raises(faults.InjectedFault):
            sp.run_spmv_scan_distributed_supervised(prob, mesh_1d(2), d,
                                                    every=2)
    manifest, _ = load_latest_commit(d)
    assert manifest["step"] == 2  # prior epoch survived the torn commit
    out = sp.run_spmv_scan_distributed_supervised(prob, mesh_1d(4), d,
                                                  every=2)
    np.testing.assert_allclose(out, sp.run_spmv_scan(prob, device="cpu"),
                               rtol=1e-5)


def test_supervised_scan_refuses_foreign_problem(tmp_path):
    """The commit pins a CRC of the problem's defining arrays — resuming a
    DIFFERENT problem from it must refuse, not silently mix solves."""
    from cme213_tpu_torch.apps import spmv_scan as sp

    d = _ckpt(tmp_path)
    prob = sp.generate_problem(512, 16, 15, iters=6, seed=2)
    sp.run_spmv_scan_distributed_supervised(prob, mesh_1d(2), d, every=2)
    other = sp.generate_problem(512, 16, 15, iters=6, seed=3)
    with pytest.raises(CommitError):
        sp.run_spmv_scan_distributed_supervised(other, mesh_1d(2), d,
                                                every=2)


# ------------------------------------------- the format, both packages

def _array(seed=0, shape=(34, 36)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


META = {"kind": "heat2d", "ny": 33, "nx": 35, "dtype": "float32"}


def test_jax_commit_loads_in_the_port_bitwise(tmp_path):
    """A commit of a 2 x 2-sharded JAX array loads in the port: the same
    interior, bit for bit, as the JAX package's own loader returns."""
    arr = _array()
    sharded = jax.device_put(jnp.asarray(arr), NamedSharding(
        j_mesh_2d(2, 2), PartitionSpec("y", "x")))
    d = _ckpt(tmp_path)
    j_commit_epoch(d, 3, 12, sharded, true_shape=(33, 35), meta=META)
    manifest, got = load_latest_commit(d)
    j_manifest, want = j_load_latest_commit(d)
    np.testing.assert_array_equal(got, arr[:33, :35])
    np.testing.assert_array_equal(got, want)
    assert manifest == j_manifest
    assert manifest["dtype"] == "float32" and manifest["epoch"] == 3
    check_meta(manifest, **META)


def test_port_commit_loads_in_jax_bitwise(tmp_path):
    """The port's commit of a 2 x 2 mesh's blocks loads in the JAX
    package; its manifest is the one JAX writes for the same sharding
    (``dtype`` as numpy's name, the same shard files)."""
    arr = _array(1)
    blocks = [(((y0, y0 + 17), (x0, x0 + 18)),
               torch.from_numpy(arr[y0:y0 + 17, x0:x0 + 18]))
              for y0 in (0, 17) for x0 in (0, 18)]
    d, dj = _ckpt(tmp_path), _ckpt(tmp_path, "jax")
    manifest = commit_epoch(d, 3, 12, blocks, true_shape=(33, 35),
                            meta=META)
    j_manifest, got = j_load_latest_commit(d)
    np.testing.assert_array_equal(got, arr[:33, :35])
    assert j_manifest == manifest
    sharded = jax.device_put(jnp.asarray(arr), NamedSharding(
        j_mesh_2d(2, 2), PartitionSpec("y", "x")))
    written = j_commit_epoch(dj, 3, 12, sharded, true_shape=(33, 35),
                             meta=META)
    assert written == manifest


# ----------------------------------------------------------- across ranks

_COMMIT_WORKER = """
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.dist import mesh_for_method
from cme213_tpu_torch.dist import run_distributed_heat_supervised
from cme213_tpu_torch.dist.mesh import default_devices
from cme213_tpu_torch.dist.multihost import initialize_multihost

initialize_multihost(device="cpu")
p = SimParams(**HEAT, grid_method=GridMethod.BLOCKS_2D)
mesh = mesh_for_method(p.grid_method, devices=default_devices("cpu"))
run_distributed_heat_supervised(p, mesh, sys.argv[1] + "/ckpt",
                                ckpt_every=2, iters=4)
"""


def test_gang_commit_resumes_on_one_process_bitwise(tmp_path, capsys):
    """A 2-rank gang (2 x 2 mesh, 2 shards a rank) commits 4 of 8
    iterations, each rank writing its own shards; one process resumes it on
    a 4-shard 1-D mesh and finishes bit for bit the uninterrupted
    solve."""
    heat = dict(nx=32, ny=32, order=4, iters=8)
    rc = run_gang(tmp_path, _COMMIT_WORKER, HEAT=heat)
    assert rc == 0, capsys.readouterr().out
    d = str(tmp_path / "ckpt")
    manifest, _ = load_latest_commit(d)
    assert (manifest["world"], manifest["step"]) == (2, 4)
    assert len(manifest["shards"]) == 4
    p = SimParams(**heat, grid_method=GridMethod.BLOCKS_2D)
    out = run_distributed_heat_supervised(p, mesh_1d(4), d, ckpt_every=2)
    np.testing.assert_array_equal(out, run_distributed_heat(p, mesh_1d(4)))
