"""The port's CUDA kernel on the card (skips where there is none).

Run on a machine with a card, from the repository root, without the JAX
test harness in ``tests/conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX.  Each kernel is held bitwise against its
plain version on the same CUDA tensors (both round every operation alike,
in the same order), and the distributed solve on a mesh of virtual devices
against ``run_heat``.
"""

import numpy as np
import pytest
import torch

from cme213_tpu_torch.apps import heat2d
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import (FrameworkError, ulp_distance,
                                   virtual_devices)
from cme213_tpu_torch.dist import (make_mesh_1d, make_mesh_2d,
                                   run_distributed_heat)
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import (LAUNCHES, run_heat, run_heat_pipeline,
                                  run_heat_pipeline2d,
                                  run_heat_pipeline_plain,
                                  stencil_local_multistep,
                                  stencil_local_multistep_plain)
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


# ------------------------------------------------ shard kernel (B3)


def _shard_block(p, K, yi, xi, h, w, dtype, device, seed=0):
    """Shard (yi, xi) of an (h, w)-shard decomposition of ``p``'s seeded
    interior, ghost-padded to whole shards (top/right BCs), with K halo
    padded y first, then x, with the BC fills, as ``dist/heat`` assembles
    it; and its global offsets (gy0, gx0)."""
    b = p.border_size
    rng = np.random.default_rng(seed)
    ny_pad, nx_pad = -(-p.ny // h) * h, -(-p.nx // w) * w
    g = np.full((ny_pad, nx_pad), p.bc_top)
    g[:, p.nx:] = p.bc_right
    g[:p.ny, :p.nx] = p.ic + rng.uniform(0, 1, (p.ny, p.nx))
    g = np.pad(g, ((K, 0), (0, 0)), constant_values=p.bc_bottom)
    g = np.pad(g, ((0, K), (0, 0)), constant_values=p.bc_top)
    g = np.pad(g, ((0, 0), (K, 0)), constant_values=p.bc_left)
    g = np.pad(g, ((0, 0), (0, K)), constant_values=p.bc_right)
    blk = g[yi * h:(yi + 1) * h + 2 * K, xi * w:(xi + 1) * w + 2 * K]
    t = torch.from_numpy(np.ascontiguousarray(blk)).to(device, dtype)
    return t, yi * h + b - K, xi * w + b - K


@pytest.mark.parametrize("where", [(0, 0), (0, 1), (1, 1), (2, 2)],
                         ids=["corner", "edge", "interior", "ghost"])
@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_local_kernel_bitwise_vs_plain(cuda, where, order, k, dtype):
    # a 3x3 decomposition of 299x401: 100x134 shards, the last row and
    # column of shards ghost-padded
    p = SimParams(nx=401, ny=299, order=order, bc_top=1.5, bc_left=0.5,
                  bc_bottom=2.0, bc_right=0.25)
    K = k * p.border_size
    blk, gy0, gx0 = _shard_block(p, K, *where, 100, 134, dtype, cuda,
                                 seed=order * k)
    args = (gy0, gx0, p.ny, p.nx, order, p.xcfl, p.ycfl, p.bc)
    before = LAUNCHES["local"]
    out = stencil_local_multistep(blk, *args, k=k)
    torch.cuda.synchronize()
    assert LAUNCHES["local"] - before == 1
    ref = stencil_local_multistep_plain(blk, *args, k=k)
    torch.testing.assert_close(out[K:-K, K:-K], ref[K:-K, K:-K], rtol=0,
                               atol=0)


@pytest.mark.parametrize("kernel,k,overlap", [
    ("pallas", 1, False), ("pallas", 2, False), ("pallas", 4, False),
    ("xla", 1, False), ("xla", 1, True), ("xla", 2, False)])
def test_distributed_2x2_virtual_mesh_equals_run_heat(cuda, kernel, k,
                                                      overlap):
    p = SimParams(nx=300, ny=200, order=8, iters=16, bc_top=1.5,
                  bc_left=0.5, bc_bottom=2.0, bc_right=0.25)
    mesh = make_mesh_2d(2, 2, devices=virtual_devices(4))
    before = LAUNCHES["local"]
    out = run_distributed_heat(p, mesh, overlap=overlap,
                               steps_per_exchange=k, local_kernel=kernel)
    launched = LAUNCHES["local"] - before
    assert launched == (4 * p.iters // k if kernel == "pallas" else 0)
    ref = run_heat(make_initial_grid(p, device=cuda), p.iters, p.order,
                   p.xcfl, p.ycfl).cpu().numpy()
    np.testing.assert_array_equal(out, ref)


def test_distributed_pallas_failed_build_raises(cuda, monkeypatch,
                                                tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")
    monkeypatch.setattr(_kernels, "_libs", {})
    p = SimParams(nx=64, ny=64, order=4, iters=2)
    mesh = make_mesh_1d(2, devices=virtual_devices(2))
    with pytest.raises(FrameworkError, match="nvcc failed"):
        run_distributed_heat(p, mesh, local_kernel="pallas")


# ------------------------------------------------ band-staged stencil (B4, B5)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_band_kernel_bitwise_vs_plain(cuda, order, k, dtype):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    # 200 x 261: a ragged last strip; tile_y 40, a tile of the sweeps
    p = SimParams(nx=261, ny=200, order=order, bc_top=1.5, bc_left=0.5,
                  bc_bottom=2.0, bc_right=0.25)
    u = _grid(p, dtype, cuda, seed=order * k + 1)
    args = (2 * k, order, p.xcfl, p.ycfl)
    before = dict(spl.LAUNCHES)
    out = spl.run_heat_multistep(u, *args, p.bc, k=k, tile_y=40)
    b4 = spl.run_heat_pallas(u, *args, tile_y=40)
    torch.cuda.synchronize()
    assert spl.LAUNCHES["multistep"] - before["multistep"] == 2
    assert spl.LAUNCHES["stencil_full"] - before["stencil_full"] == 2 * k
    torch.testing.assert_close(
        out, spl.run_heat_multistep_plain(u, *args, p.bc, k=k), rtol=0,
        atol=0)
    torch.testing.assert_close(b4, spl.run_heat_pallas_plain(u, *args),
                               rtol=0, atol=0)


def test_band_kernel_keeps_a_foreign_halo(cuda):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    p = SimParams(nx=150, ny=120, order=8)
    u = _grid(p, torch.float32, cuda, seed=3)
    u[:4] = 7.0
    u[:, -4:] = -3.0
    out = spl.run_heat_pallas(u, 5, 8, p.xcfl, p.ycfl, tile_y=40)
    ref = spl.run_heat_pallas_plain(u, 5, 8, p.xcfl, p.ycfl)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    one = spl.stencil_interior_pallas(u, 8, p.xcfl, p.ycfl, tile_y=40)
    torch.testing.assert_close(
        one, spl.stencil_interior_pallas_plain(u, 8, p.xcfl, p.ycfl),
        rtol=0, atol=0)


@pytest.mark.parametrize("tile_y", [40, 80, 200, 400])
def test_band_kernel_at_the_sweeps_tiles(cuda, tile_y):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    p = SimParams(nx=2000, ny=2000, order=8)
    u = make_initial_grid(p, device=cuda)
    out = spl.run_heat_pallas(u, 4, 8, p.xcfl, p.ycfl, tile_y=tile_y)
    torch.testing.assert_close(out, run_heat(u, 4, 8, p.xcfl, p.ycfl),
                               rtol=0, atol=0)


def test_band_tile_that_fits_nowhere_raises(cuda):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    p = SimParams(nx=400, ny=400, order=8)
    u = make_initial_grid(p, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        spl.run_heat_multistep(u, 8, 8, p.xcfl, p.ycfl, p.bc, k=8,
                               tile_y=400)


def test_band_failed_build_raises(cuda, monkeypatch, tmp_path):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")
    monkeypatch.setattr(_kernels, "_libs", {})
    p = SimParams(nx=64, ny=64, order=4)
    u = make_initial_grid(p, device=cuda)
    with pytest.raises(FrameworkError, match="nvcc failed"):
        spl.run_heat_pallas(u, 2, 4, p.xcfl, p.ycfl, tile_y=32)


# ------------------------------------------------ tiled transpose (B8)


@pytest.mark.parametrize("shape", [(4096, 4096), (256, 512), (96, 160),
                                   (33, 70), (1, 3000)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                   torch.float32, torch.int32,
                                   torch.float64])
def test_transpose_kernel_bitwise(cuda, shape, dtype):
    from cme213_tpu_torch.ops import _kernels as kern
    from cme213_tpu_torch.ops import transpose as tp

    bits = torch.randint(0, 255, (shape[0], shape[1]
                                  * torch.empty(0, dtype=dtype)
                                  .element_size()),
                         dtype=torch.uint8, generator=torch.Generator()
                         .manual_seed(shape[0])).to(cuda)
    x = bits.view(dtype)
    if shape[0] % 32 == 0 and shape[1] % 32 == 0:
        before = tp.LAUNCHES["transpose"]
        out = tp.transpose_pallas(x, tile=32)
        assert tp.LAUNCHES["transpose"] - before == 1
    else:  # the kernel masks ragged edges; the wrapper keeps JAX's contract
        out = torch.empty(shape[::-1], dtype=dtype, device=cuda)
        kern.transpose_tiles(x, out)
    ref = x.t().contiguous()
    # flatten first: a (3000, 1) result is contiguous at stride 3000
    assert torch.equal(out.flatten().view(torch.uint8),
                       ref.flatten().view(torch.uint8))
