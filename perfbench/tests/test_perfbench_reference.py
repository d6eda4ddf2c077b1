"""The plain references against the program's own results at tiny sizes
on the CPU, and the inputs the seed makes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.reference import compare, costs
from perfbench.reference import heat as heat_ref
from perfbench.reference import spmv as spmv_ref


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("seed", [1, 2 ** 40 + 9])
def test_heat_reference_equals_the_program_bit_for_bit(order, seed):
    from cme213_tpu_torch.config import SimParams
    from cme213_tpu_torch.grid import make_initial_grid
    from cme213_tpu_torch.ops import stencil_pipeline

    v = inputs.heat_variants(seed, 1, 0.0, 100.0)[0]
    top, left, bottom, right = v["bc"]
    p = SimParams(nx=36, ny=28, iters=12, order=order, alpha=0.4, ic=v["ic"],
                  bc_top=top, bc_left=left, bc_bottom=bottom, bc_right=right)
    u0 = heat_ref.initial_grid(36, 28, order, v["ic"], v["bc"])
    assert torch.equal(u0, make_initial_grid(p, device="cpu"))
    assert heat_ref.cfl(order, 36, 28, 1.0, 1.0, 0.4) == (p.xcfl, p.ycfl)
    got = stencil_pipeline.run_heat_resilient(u0, p.iters, order, p.xcfl,
                                              p.ycfl, p.bc, k=1).value
    expect = heat_ref.solve(36, 28, order, 12, v["ic"], v["bc"], alpha=0.4)
    assert compare.max_ulp(expect, got) == 0


def test_spmv_reference_agrees_with_the_program():
    from cme213_tpu_torch.apps import spmv_scan

    d = inputs.spmv_problem(20000, 300, 299, 10, seed=3, device="cpu")
    prob = spmv_scan.Problem(d["a"], d["s"], d["k"], d["x"], d["iters"])
    got = spmv_scan.run_spmv_scan(prob, device="cpu")
    expect = spmv_ref.solve(d["a"], d["s"], d["k"], d["x"], d["iters"])
    l2, linf = compare.relative_errors(expect, got)
    assert l2 < 1e-5 and linf < 1e-4
    # the program's own float64 checker reads the same
    ext = spmv_scan.external_check(prob, got)
    assert ext["rel_l2"] == pytest.approx(l2, rel=1e-6)


def test_spmv_scan_against_a_loop():
    rng = np.random.default_rng(0)
    s = np.array([0, 3, 4, 9, 12])
    v = torch.from_numpy(rng.uniform(-1, 1, 12))
    out = spmv_ref.segscan(v, torch.from_numpy(s))
    want = np.concatenate([np.cumsum(v.numpy()[a:b])
                           for a, b in zip(s[:-1], s[1:])])
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-12)


def test_spmv_problem_shape_and_determinism():
    a = inputs.spmv_problem(5000, 100, 99, 7, seed=2 ** 35 + 1, device="cpu")
    b = inputs.spmv_problem(5000, 100, 99, 7, seed=2 ** 35 + 1, device="cpu")
    c = inputs.spmv_problem(5000, 100, 99, 7, seed=4, device="cpu")
    for key in ("a", "s", "k", "x"):
        assert np.array_equal(a[key], b[key])
        assert a[key].shape == c[key].shape and a[key].dtype == c[key].dtype
    s = a["s"]
    assert s[0] == 0 and s[-1] == 5000 and len(s) == 100
    assert (np.diff(s) > 0).all()
    assert a["k"].min() >= 0 and a["k"].max() < 99
    assert np.abs(a["a"]).max() <= 1.0


def test_heat_variants_are_the_seed_s_and_in_range():
    assert inputs.heat_variants(9, 4, 0, 100) == inputs.heat_variants(9, 4, 0,
                                                                      100)
    vs = inputs.heat_variants(2 ** 31 + 5, 4, 0.0, 100.0)
    assert len(vs) == 4 and vs != inputs.heat_variants(10, 4, 0.0, 100.0)
    for v in vs:
        assert 0 <= v["ic"] <= 100 and all(0 <= b <= 100 for b in v["bc"])


def test_frozen_counts():
    assert costs.stencil_flops_per_point(8) == 38
    assert costs.heat_bytes(4000, 4000) == 128_000_000
    least, bound = costs.least_seconds(costs.heat_bytes(4000, 4000),
                                       costs.heat_flops(4000, 4000, 8, 1))
    assert bound == "bytes" and least == pytest.approx(38.209e-6, rel=1e-4)
    n, p, q = 11_634_424, 217_919, 217_918
    assert costs.spmv_scan_bytes(n, p, q) == 12 * n + 4 * q + 4 * (p + 1)
    least, bound = costs.least_seconds(costs.spmv_scan_bytes(n, p, q),
                                       costs.spmv_scan_flops(n, 25))
    assert bound == "bytes" and least == pytest.approx(42.2e-6, rel=1e-3)


def test_compare_reads_far_for_what_cannot_be_compared():
    e = torch.ones(4)
    assert compare.max_ulp(e, torch.tensor([1, 1, float("nan"), 1.0])) \
        >= 2 ** 32
    assert compare.relative_errors(e, torch.ones(3))[0] == compare.FAR
    assert compare.max_ulp(torch.tensor([0.0]), torch.tensor([-0.0])) == 0
    assert compare.max_ulp(torch.tensor([1.0]),
                           torch.tensor([np.nextafter(np.float32(1),
                                                      np.float32(2))])) == 1
