"""The port's CUDA kernel on the card (skips where there is none).

Run on a machine with a card, from the repository root, without the JAX
test harness in ``tests/conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX.  The kernel is held bitwise against its
plain version on the same CUDA tensors (both round every operation alike).
"""

import numpy as np
import pytest
import torch

from cme213_tpu_torch.apps import heat2d
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import ulp_distance
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import (LAUNCHES, run_heat, run_heat_pipeline,
                                  run_heat_pipeline2d,
                                  run_heat_pipeline_plain)

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
