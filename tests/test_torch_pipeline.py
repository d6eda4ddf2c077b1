"""The port's temporally blocked heat stencil against the JAX package.

On the CPU ``run_heat_pipeline``/``run_heat_pipeline2d`` take their plain
version (``run_heat_pipeline_plain``); the JAX kernels run in Pallas
interpret mode, as the JAX package's own tests run them here.  Tolerance:
ULP-10, the hw2 checker, at ≤ 32 iterations (XLA:CPU contracts some
multiply-adds into FMAs; the measured gap is 1-4 ULP), and bitwise against
the numpy golden, which rounds as the port does.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Its tile decomposition — the staged window, the
validity region shrinking by one border a sub-step, the Dirichlet bands on
global coordinates, the tile written to a second grid — is modelled in
numpy below and held bitwise against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu.ops.stencil_pipeline import run_heat_pipeline as j_pipeline
from cme213_tpu.ops.stencil_pipeline import \
    run_heat_pipeline2d as j_pipeline2d
from cme213_tpu.verify.golden import host_heat
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import FrameworkError
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import (LAUNCHES, pick_pipeline_tile,
                                  run_heat_pipeline, run_heat_pipeline2d,
                                  run_heat_pipeline_plain)
from cme213_tpu_torch.ops import _kernels
from cme213_tpu_torch.ops import stencil_pipeline as sp
from cme213_tpu_torch.ops.stencil import BORDER_FOR_ORDER, STENCIL_COEFFS
from cme213_tpu_torch.verify import check_ulp

BC = (1.5, 0.5, 2.0, 0.25)


def _probe(order: int, ny: int = 40, nx: int = 44, seed: int = 0,
           dtype=np.float32):
    p = SimParams(nx=nx, ny=ny, order=order, iters=1, bc_top=BC[0],
                  bc_left=BC[1], bc_bottom=BC[2], bc_right=BC[3])
    u0 = make_initial_grid(p, dtype=torch.float64, device="cpu").numpy()
    b = p.border_size
    u0[b:-b, b:-b] += np.random.default_rng(seed).uniform(0.0, 1.0, (ny, nx))
    return p, u0.astype(dtype)


def _jax_tile_y(order: int, k: int) -> int:
    kpad = -(-k * BORDER_FOR_ORDER[order] // 8) * 8  # the TPU's ceil8 quantum
    return max(kpad, 16 // kpad * kpad)


@pytest.mark.parametrize("entry", ["pipeline", "pipeline2d"])
@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_pipeline_ulp10_vs_jax_and_bitwise_vs_golden(entry, order, k):
    iters = 4 * k  # ≤ 32
    p, u0 = _probe(order, seed=10 * order + k)
    args = (iters, order, p.xcfl, p.ycfl, p.bc)
    if entry == "pipeline":
        ref = j_pipeline(jnp.array(u0), *args, k=k,
                         tile_y=_jax_tile_y(order, k), interpret=True)
        out = run_heat_pipeline(torch.from_numpy(u0), *args, k=k)
    else:
        ref = j_pipeline2d(jnp.array(u0), *args, k=k,
                           tile_y=_jax_tile_y(order, k), tile_x=128,
                           interpret=True)
        out = run_heat_pipeline2d(torch.from_numpy(u0), *args, k=k)
    res = check_ulp(np.asarray(ref), out.numpy(), max_ulps=10)
    assert res, res.message
    np.testing.assert_array_equal(
        out.numpy(), host_heat(u0, iters, order, p.xcfl, p.ycfl))


@pytest.mark.parametrize("k", [1, 2])
def test_pipeline_awkward_shape_vs_jax(k):
    p, u0 = _probe(8, ny=257, nx=121, seed=k)
    args = (8 * k, 8, p.xcfl, p.ycfl, p.bc)
    ref = j_pipeline(jnp.array(u0), *args, k=k, tile_y=_jax_tile_y(8, k),
                     interpret=True)
    out = run_heat_pipeline(torch.from_numpy(u0), *args, k=k)
    res = check_ulp(np.asarray(ref), out.numpy(), max_ulps=10)
    assert res, res.message
    out2d = run_heat_pipeline2d(torch.from_numpy(u0), *args, k=k)
    np.testing.assert_array_equal(out2d.numpy(), out.numpy())


@pytest.mark.parametrize("order", [2, 8])
def test_pipeline_f64_bitwise_vs_golden(order):
    p, u0 = _probe(order, ny=33, nx=50, seed=4, dtype=np.float64)
    out = run_heat_pipeline(torch.from_numpy(u0), 16, order, p.xcfl, p.ycfl,
                            p.bc, k=4)
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(
        out.numpy(), host_heat(u0, 16, order, p.xcfl, p.ycfl))


def test_pipeline_leaves_input_and_checks_k():
    p, u0 = _probe(4)
    u = torch.from_numpy(u0.copy())
    run_heat_pipeline(u, 4, 4, p.xcfl, p.ycfl, p.bc, k=2)
    np.testing.assert_array_equal(u.numpy(), u0)
    with pytest.raises(ValueError, match="divide"):
        run_heat_pipeline(u, 6, 4, p.xcfl, p.ycfl, p.bc, k=4)
    with pytest.raises(ValueError, match="divide"):
        run_heat_pipeline2d(u, 3, 4, p.xcfl, p.ycfl, p.bc, k=2)
    with pytest.raises(TypeError):
        run_heat_pipeline(u.half(), 4, 4, p.xcfl, p.ycfl, p.bc)
    assert LAUNCHES == {"pipeline": 0, "pipeline2d": 0}


# ------------------------------------------------ tiles and shared memory


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype_bytes", [4, 8])
def test_pick_pipeline_tile_fits_shared_memory(order, k, dtype_bytes):
    for tile_x in (None, sp.PIPELINE2D_TILE_BYTES // dtype_bytes):
        ty = pick_pipeline_tile(4008, k, order, tile_x=tile_x,
                                dtype_bytes=dtype_bytes)
        tx = tile_x or sp.PIPELINE_TILE_BYTES // dtype_bytes
        assert 1 <= ty <= 64
        assert sp.smem_bytes(ty, tx, k, order, dtype_bytes) \
            <= sp.SMEM_BUDGET_BYTES
    assert pick_pipeline_tile(20, k, order, dtype_bytes=dtype_bytes) <= 20


def test_tile_sizes_worked_in_the_design_note():
    # k=1: one 40x136 f32 window; k=8: two 128x192 f32 windows
    assert sp.smem_bytes(32, 128, 1, 8) == 21_760
    assert sp.smem_bytes(64, 128, 8, 8) == 196_608
    assert pick_pipeline_tile(4008, 8, 8) == 64
    assert pick_pipeline_tile(4008, 8, 8, dtype_bytes=8) == 48


def test_kernel_wrapper_refuses_bad_arguments():
    u = torch.zeros(16, 16)
    kw = dict(order=2, k=1, tile_y=8, tile_x=8,
              smem_bytes=sp.smem_bytes(8, 8, 1, 2), ny=14, nx=14, xcfl=0.1,
              ycfl=0.1, bc=BC)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.heat_ksteps(u, torch.zeros(16, 16), **kw)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")
    with pytest.raises(FrameworkError, match="nvcc failed"):
        _kernels.build()
    lib = _kernels.library_path("heat_stencil")
    assert (tmp_path / lib.with_suffix(".log").name).exists()
    assert not lib.exists()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path))
    # every candidate root, /usr/local/cuda included, holds no nvcc
    monkeypatch.setattr(_kernels, "Path", lambda root: tmp_path / "none")
    with pytest.raises(FrameworkError, match="nvcc not found"):
        _kernels._nvcc()


def test_library_path_keys_on_source_and_flags(monkeypatch):
    a = _kernels.library_path("heat_stencil")
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-g",))
    assert _kernels.library_path("heat_stencil") != a
    assert a.parent == _kernels.BUILD_DIR


# ------------------------------------------------ the kernel's decomposition


def _kernel_model(u: np.ndarray, iters: int, order: int, xcfl, ycfl, bc,
                  k: int, tile_y: int, tile_x: int) -> np.ndarray:
    """numpy model of one ``csrc/heat_stencil.cu`` launch per k steps."""
    f = u.dtype.type
    b = BORDER_FOR_ORDER[order]
    K = k * b
    H, W = u.shape
    ny, nx = H - 2 * b, W - 2 * b
    coeffs = [f(c) for c in STENCIL_COEFFS[order]]
    top, left, bottom, right = (f(v) for v in bc)
    xcfl, ycfl = f(xcfl), f(ycfl)
    WY, WX = tile_y + 2 * K, tile_x + 2 * K
    src = u
    for _ in range(iters // k):
        dst = np.full_like(src, np.nan)
        for r0 in range(0, H, tile_y):
            for c0 in range(0, W, tile_x):
                win = np.zeros((WY, WX), u.dtype)  # 0 outside the grid
                rows = np.arange(r0 - K, r0 - K + WY)
                cols = np.arange(c0 - K, c0 - K + WX)
                ri = (rows >= 0) & (rows < H)
                ci = (cols >= 0) & (cols < W)
                win[np.ix_(ri, ci)] = src[np.ix_(rows[ri], cols[ci])]
                for s in range(1, k + 1):
                    lo = s * b
                    ys, xs = slice(lo, WY - lo), slice(lo, WX - lo)
                    accx = np.zeros((WY - 2 * lo, WX - 2 * lo), u.dtype)
                    accy = np.zeros_like(accx)
                    for kk, c in enumerate(coeffs):
                        accx = accx + c * win[ys, lo + kk - b:WX - lo + kk - b]
                        accy = accy + c * win[lo + kk - b:WY - lo + kk - b, xs]
                    new = win[ys, xs] + xcfl * accx + ycfl * accy
                    gr = rows[ys, None]
                    gc = cols[None, xs]
                    new = np.where(gr < b, bottom, new)
                    new = np.where(gr >= b + ny, top, new)
                    new = np.where(gc < b, left, new)
                    new = np.where(gc >= b + nx, right, new)
                    win = win.copy()
                    win[ys, xs] = new  # cells outside the region: stale
                h, w = min(tile_y, H - r0), min(tile_x, W - c0)
                dst[r0:r0 + h, c0:c0 + w] = win[K:K + h, K:K + w]
        src = dst
    return src


@pytest.mark.parametrize("order,k,tile_y,tile_x",
                         [(2, 1, 8, 16), (4, 2, 5, 7), (8, 2, 16, 8),
                          (8, 4, 8, 32), (2, 8, 3, 11)])
def test_kernel_decomposition_bitwise_vs_plain(order, k, tile_y, tile_x):
    p, u0 = _probe(order, ny=29, nx=37, seed=order + k)
    iters = 2 * k
    model = _kernel_model(u0, iters, order, p.xcfl, p.ycfl, p.bc, k, tile_y,
                          tile_x)
    plain = run_heat_pipeline_plain(torch.from_numpy(u0), iters, order,
                                    p.xcfl, p.ycfl, p.bc, k=k)
    np.testing.assert_array_equal(model, plain.numpy())
