"""The port's CUDA kernel on the card (skips where there is none).

Run on a machine with a card, from the repository root, without the JAX
test harness in ``tests/conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX.  Each kernel is held bitwise against its
plain version on the same CUDA tensors (both round every operation alike,
in the same order).
"""

import numpy as np
import pytest
import torch

from cme213_tpu_torch.apps import heat2d
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import FrameworkError, ulp_distance
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import (LAUNCHES, run_heat, run_heat_pipeline,
                                  run_heat_pipeline2d,
                                  run_heat_pipeline_plain)
from cme213_tpu_torch.ops import _kernels
from cme213_tpu_torch.ops import segmented_pallas as segp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _grid(p, dtype, device, seed=0):
    u = make_initial_grid(p, dtype=torch.float64, device="cpu")
    b = p.border_size
    rng = np.random.default_rng(seed)
    u[b:-b, b:-b] += torch.from_numpy(rng.uniform(0, 1, (p.ny, p.nx)))
    return u.to(device=device, dtype=dtype)


@pytest.mark.parametrize("entry", [run_heat_pipeline, run_heat_pipeline2d])
@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_bitwise_vs_plain(cuda, entry, order, k, dtype):
    p = SimParams(nx=121, ny=257, order=order, bc_top=1.5, bc_left=0.5,
                  bc_bottom=2.0, bc_right=0.25)
    u = _grid(p, dtype, cuda, seed=order * k)
    args = (4 * k, order, p.xcfl, p.ycfl, p.bc)
    name = "pipeline" if entry is run_heat_pipeline else "pipeline2d"
    before = LAUNCHES[name]
    out = entry(u, *args, k=k)
    assert LAUNCHES[name] - before == 4
    ref = run_heat_pipeline_plain(u, *args, k=k)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_kernel_matches_run_heat(cuda):
    p = SimParams(nx=300, ny=200, order=8)
    u = make_initial_grid(p, device=cuda)
    out = run_heat_pipeline(u, 64, 8, p.xcfl, p.ycfl, p.bc, k=8)
    ref = run_heat(u, 64, 8, p.xcfl, p.ycfl)
    assert ulp_distance(out.cpu().numpy(), ref.cpu().numpy()).max() <= 10


def test_over_budget_tile_raises(cuda):
    p = SimParams(nx=300, ny=200, order=8)
    u = make_initial_grid(p, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        run_heat_pipeline2d(u, 8, 8, p.xcfl, p.ycfl, p.bc, k=8, tile_y=64,
                            tile_x=1024)


def test_run_single_on_card(cuda, tmp_path):
    p = SimParams(nx=100, ny=90, order=4, iters=20)
    before = LAUNCHES["pipeline"]
    res = heat2d.run_single(p, save_files=True, out_dir=str(tmp_path))
    assert res.ok
    assert LAUNCHES["pipeline"] - before == p.iters + 1  # + the warm-up
    assert (tmp_path / "grid_final_gpu_shared.txt").exists()


# ------------------------------------------------ segmented scan (B6, B7)

T = segp.TILE


def _flags(n: int, pattern: str, rng) -> np.ndarray:
    f = np.zeros(n, np.int32)
    if pattern == "one":
        f[0] = 1
    elif pattern == "every":
        f[:] = 1
    elif pattern == "tile-edges":
        f[::T] = 1
    else:  # random starts, about one in 40
        f[rng.random(n) < 0.025] = 1
        f[0] = 1
    return f


@pytest.mark.parametrize("pattern", ["one", "every", "tile-edges", "random"])
@pytest.mark.parametrize("n", [1, 31, T - 1, T, T + 1, 3 * T + 5, 100_003])
def test_segscan_kernel_bitwise_vs_plain(cuda, n, pattern):
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    xx = torch.from_numpy(rng.uniform(-1.2, 1.2, n).astype(np.float32)
                          ).to(cuda)
    f = torch.from_numpy(_flags(n, pattern, rng)).to(cuda)
    before = dict(segp.LAUNCHES)
    out = segp.segmented_scan_pallas(v, f)
    fused = {it: segp.spmv_scan_pallas(v, xx, f, it) for it in (1, 8)}
    torch.cuda.synchronize()
    assert segp.LAUNCHES["segscan"] - before["segscan"] == 1
    assert segp.LAUNCHES["spmv_fused"] - before["spmv_fused"] == 9
    bits = lambda t: t.view(torch.int32)  # noqa: E731 (+0 and -0 differ)
    assert torch.equal(bits(out),
                       bits(segp.segmented_scan_pallas_plain(v, f)))
    for it, got in fused.items():
        assert torch.equal(
            bits(got), bits(segp.spmv_scan_pallas_plain(v, xx, f, it)))


def test_segscan_leaves_input_and_refuses_f64(cuda):
    v = torch.arange(5000, dtype=torch.float32, device=cuda)
    f = torch.zeros(5000, dtype=torch.int32, device=cuda)
    keep = v.clone()
    segp.spmv_scan_pallas(v, v, f, 2)
    assert torch.equal(v, keep)
    with pytest.raises(TypeError, match="float32"):
        segp.segmented_scan_pallas(v.double(), f)


def test_segscan_refused_launch_raises(cuda):
    v = torch.ones(3 * T, dtype=torch.float32, device=cuda)
    f = torch.zeros(3 * T, dtype=torch.int32, device=cuda)
    short = torch.empty(2, dtype=torch.float32, device=cuda)  # needs 9 words
    with pytest.raises(FrameworkError, match="segmented_scan launch failed"):
        _kernels.segmented_scan(v, None, f, torch.empty_like(v), short)


def test_segscan_geometry_matches_plain(cuda):
    assert _kernels.segmented_scan_geometry() == (
        segp.TILE_ITEMS, segp.TILE_THREADS, segp.WARP, segp.CARRY_THREADS)


@pytest.mark.parametrize("kernel", ["pallas", "pallas-fused"])
def test_run_spmv_scan_on_card(cuda, kernel):
    prob = spmv.generate_problem(50_000, 700, 500, iters=6, seed=3)
    name = "segscan" if kernel == "pallas" else "spmv_fused"
    before = dict(segp.LAUNCHES)
    out = spmv.run_spmv_scan(prob, kernel=kernel)
    assert segp.LAUNCHES[name] - before[name] == prob.iters + 1
    other = "spmv_fused" if kernel == "pallas" else "segscan"
    assert segp.LAUNCHES[other] == before[other]
    errs = spmv.external_check(prob, out)
    assert errs["rel_l2"] <= 1e-5 and errs["rel_linf"] <= 1e-3
