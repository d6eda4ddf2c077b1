"""Parity of the port's sharded segmented scan and distributed SpMV-scan
with the JAX package.

JAX runs on the test harness's 8 virtual CPU devices; the port on a mesh of
``virtual_devices(n, "cpu")``.  Tolerances: rel L2 ≤ 1e-5 on random values
(the conformance tolerance of the sharded scans: the per-shard scans and
the carry combine associate sums as JAX's do, but ``torch.cumsum`` in the
blocked per-shard scan does not), and bit for bit on integer-valued inputs,
whose sums are exact in any order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu.apps import spmv_scan as j_spmv
from cme213_tpu.dist import distributed_segmented_scan as j_dist_scan
from cme213_tpu.dist import make_iterated_sharded_scan as j_iterated
from cme213_tpu.dist import make_mesh_1d as j_mesh_1d
from cme213_tpu.dist import make_mesh_2d as j_mesh_2d
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.core import PhaseTimer, virtual_devices
from cme213_tpu_torch.dist import (distributed_segmented_scan,
                                   make_iterated_sharded_scan, make_mesh_1d,
                                   make_mesh_2d, shard_1d)
from cme213_tpu_torch.ops import segmented_scan
from cme213_tpu_torch.verify.checkers import relative_l2_error

CPU8 = virtual_devices(8, "cpu")


def _flags(n: int, starts) -> np.ndarray:
    f = np.zeros(n, np.int32)
    f[np.asarray(starts)] = 1
    return f


def _both(v: np.ndarray, f: np.ndarray, ndev: int, mode: str):
    ours = distributed_segmented_scan(
        torch.from_numpy(v), torch.from_numpy(f),
        make_mesh_1d(ndev, devices=CPU8), carry_mode=mode).numpy()
    ref = np.asarray(j_dist_scan(jnp.asarray(v), jnp.asarray(f),
                                 j_mesh_1d(ndev), carry_mode=mode))
    return ours, ref


@pytest.mark.parametrize("mode", ["ring", "gather"])
@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_scan_matches_reference(mode, ndev):
    rng = np.random.default_rng(ndev)
    n = 96 * ndev
    v = rng.standard_normal(n).astype(np.float32)
    starts = np.unique(np.concatenate([[0], rng.integers(1, n, 9)]))
    ours, ref = _both(v, _flags(n, starts), ndev, mode)
    assert relative_l2_error(ref, ours) <= 1e-5
    # against the port's single-device scan on the whole sequence
    whole = segmented_scan(torch.from_numpy(v),
                           torch.from_numpy(_flags(n, starts))).numpy()
    assert relative_l2_error(whole, ours) <= 1e-5


@pytest.mark.parametrize("mode", ["ring", "gather"])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_scan_bitwise_on_integer_values(mode, ndev):
    rng = np.random.default_rng(10 + ndev)
    n = 64 * ndev
    v = rng.integers(-8, 9, n).astype(np.float32)
    f = _flags(n, np.unique(np.concatenate([[0], rng.integers(1, n, 5)])))
    ours, ref = _both(v, f, ndev, mode)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["ring", "gather"])
def test_head_on_shard_boundary(mode):
    v = np.ones(64, np.float32)
    # heads exactly at shard boundaries (16, 32) and mid-shard (40)
    ours, ref = _both(v, _flags(64, [0, 16, 32, 40]), 4, mode)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[15:18], [16.0, 1.0, 2.0])


@pytest.mark.parametrize("mode", ["ring", "gather"])
def test_segment_spanning_every_shard(mode):
    n = 512
    v = np.ones(n, np.float32)
    ours, ref = _both(v, _flags(n, [0]), 8, mode)
    np.testing.assert_array_equal(ours, np.arange(1, n + 1, dtype=np.float32))
    np.testing.assert_array_equal(ours, ref)
    # no head at all: every shard's carry runs through
    ours, ref = _both(v, np.zeros(n, np.int32), 8, mode)
    np.testing.assert_array_equal(ours, ref)


def test_errors_match_reference():
    mesh = make_mesh_1d(8, devices=CPU8)
    with pytest.raises(ValueError, match="divide"):
        distributed_segmented_scan(torch.ones(100),
                                   torch.zeros(100, dtype=torch.int32), mesh)
    with pytest.raises(ValueError, match="divide"):
        j_dist_scan(jnp.ones(100), jnp.zeros(100, jnp.int32), j_mesh_1d(8))
    with pytest.raises(ValueError, match="carry_mode"):
        distributed_segmented_scan(torch.ones(16),
                                   torch.zeros(16, dtype=torch.int32), mesh,
                                   carry_mode="bogus")
    with pytest.raises(ValueError, match="carry_mode"):
        j_dist_scan(jnp.ones(16), jnp.zeros(16, jnp.int32), j_mesh_1d(8),
                    carry_mode="bogus")
    with pytest.raises(ValueError, match="carry_mode"):
        make_iterated_sharded_scan(mesh, carry_mode="bogus")


def test_scan_over_first_axis_of_a_2d_mesh():
    rng = np.random.default_rng(4)
    n = 128
    v = rng.standard_normal(n).astype(np.float32)
    f = _flags(n, [0, 5, 64, 100])
    ours = distributed_segmented_scan(
        torch.from_numpy(v), torch.from_numpy(f),
        make_mesh_2d(2, 4, devices=CPU8)).numpy()
    ref = np.asarray(j_dist_scan(jnp.asarray(v), jnp.asarray(f),
                                 j_mesh_2d(2, 4)))
    assert relative_l2_error(ref, ours) <= 1e-5


@pytest.mark.parametrize("mode", ["ring", "gather"])
def test_iterated_scan_matches_reference(mode):
    rng = np.random.default_rng(7)
    n, ndev, iters = 4 * 200, 4, 5
    a = rng.uniform(-1, 1, n).astype(np.float32)
    xx = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    f = _flags(n, np.unique(np.concatenate([[0], rng.integers(1, n, 20)])))
    mesh = make_mesh_1d(ndev, devices=CPU8)
    shards = [shard_1d(torch.from_numpy(x), mesh) for x in (a, xx, f)]
    keep = [s.clone() for s in shards[0]]
    out = make_iterated_sharded_scan(mesh, carry_mode=mode)(*shards, iters)
    assert all(torch.equal(s, k) for s, k in zip(shards[0], keep))
    ours = torch.cat(out).numpy()
    ref = np.asarray(j_iterated(j_mesh_1d(ndev), carry_mode=mode)(
        jnp.asarray(a), jnp.asarray(xx), jnp.asarray(f), iters))
    assert relative_l2_error(ref, ours) <= 1e-5


# ---------------------------------------------------------------- SpMV-scan


@pytest.mark.parametrize("n,ndev", [(1000, 2), (1000, 8), (999, 8),
                                    (999, 4)])
def test_run_spmv_scan_distributed_matches_reference(n, ndev):
    prob = spmv.generate_problem(n, 40, 64, iters=6, seed=11)
    jprob = j_spmv.generate_problem(n, 40, 64, iters=6, seed=11)
    timer = PhaseTimer()
    ours = spmv.run_spmv_scan_distributed(
        prob, make_mesh_1d(ndev, devices=CPU8), timer=timer)
    ref = j_spmv.run_spmv_scan_distributed(jprob, j_mesh_1d(ndev))
    assert ours.shape == ref.shape == (n,)
    assert relative_l2_error(ref, ours) <= 1e-5
    assert timer.last_ms("spmv_scan_distributed") >= 0
    # the single-device engine on the same problem
    single = spmv.run_spmv_scan(prob, kernel="flat", device="cpu")
    assert relative_l2_error(single, ours) <= 1e-5


@pytest.mark.parametrize("n,ndev", [(1000, 8), (999, 8), (37, 4)])
def test_shard_problem_matches_reference(n, ndev):
    prob = spmv.generate_problem(n, 9, 16, iters=3, seed=2)
    jprob = j_spmv.generate_problem(n, 9, 16, iters=3, seed=2)
    a, xx, fl, m = spmv._shard_problem(prob, make_mesh_1d(ndev, devices=CPU8),
                                       torch.float32)
    ja, jxx, jfl, jm = j_spmv._shard_problem(jprob, j_mesh_1d(ndev),
                                             jnp.float32)
    assert m == jm == n
    for ours, ref in ((a, ja), (xx, jxx), (fl, jfl)):
        assert len(ours) == ndev
        np.testing.assert_array_equal(torch.cat(ours).numpy(),
                                      np.asarray(ref))


def test_cli_distributed_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert spmv.main(["spmv_scan", "gen", "a.txt", "x.txt",
                      "2048", "32", "31", "5"]) == 0
    assert spmv.main(["spmv_scan", "a.txt", "x.txt", "cpu_check",
                      "--distributed", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "(1 devices)" in out and "Worked!" in out
    prob = spmv.load_problem("a.txt", "x.txt")
    b = np.loadtxt("b.txt", dtype=np.float32)
    expect = spmv.run_spmv_scan_distributed(
        prob, make_mesh_1d(devices=["cpu"]))
    np.testing.assert_array_equal(b, expect)
