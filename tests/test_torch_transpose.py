"""The port's tiled transpose (B8) against the JAX package.

The JAX kernel (``cme213_tpu/ops/transpose.py:transpose_pallas``) runs in
Pallas interpret mode; the port's wrapper on the CPU takes its plain
version, ``x.t().contiguous()``.  A transpose moves bits, so the contract is
exact.  The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); its 32 × 33 tile indexing is modelled in numpy below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu.ops.transpose import transpose_pallas as j_transpose
from cme213_tpu.ops.transpose import transpose_xla as j_transpose_xla
from cme213_tpu_torch.ops import transpose as tp
from cme213_tpu_torch.ops import transpose_pallas, transpose_xla


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(f"u{a.dtype.itemsize}")


# tests/test_spmv_transpose.py:58's shapes, and a non-square one
@pytest.mark.parametrize("shape,tile", [((64, 64), 32), ((128, 64), 32),
                                        ((96, 160), 32), ((256, 512), 256)])
def test_transpose_f32_exact_vs_jax(shape, tile):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    ref = np.asarray(j_transpose(jnp.asarray(x), tile=tile, interpret=True))
    out = transpose_pallas(torch.from_numpy(x), tile=tile)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
    np.testing.assert_array_equal(
        transpose_xla(torch.from_numpy(x)).numpy(),
        np.asarray(j_transpose_xla(jnp.asarray(x))))
    assert out.is_contiguous() and out.shape == shape[::-1]


def test_transpose_int32_exact_vs_jax():
    x = np.random.default_rng(3).integers(-2**31, 2**31, (64, 96),
                                          dtype=np.int64).astype(np.int32)
    ref = np.asarray(j_transpose(jnp.asarray(x), tile=32, interpret=True))
    np.testing.assert_array_equal(
        transpose_pallas(torch.from_numpy(x), tile=32).numpy(), ref)


def test_transpose_bf16_exact_vs_jax():
    bits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (32, 64)).astype(np.float32)).bfloat16().view(torch.int16)
    x = jnp.asarray(bits.numpy().view(jnp.bfloat16))
    ref = np.asarray(j_transpose(x, tile=32, interpret=True))
    out = transpose_pallas(bits.view(torch.bfloat16), tile=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                  ref.view(np.int16))


def test_transpose_f64_exact_vs_jax():
    x = np.random.default_rng(5).standard_normal((64, 32))
    jax.config.update("jax_enable_x64", True)
    try:
        ref = np.asarray(j_transpose(jnp.asarray(x), tile=32,
                                     interpret=True))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert ref.dtype == np.float64
    np.testing.assert_array_equal(
        transpose_pallas(torch.from_numpy(x), tile=32).numpy(), ref)


def test_transpose_refuses_what_the_jax_package_asserts():
    x = torch.zeros(64, 96)
    with pytest.raises(ValueError, match="tile"):
        transpose_pallas(x, tile=64)       # 96 does not divide by 64
    with pytest.raises(ValueError, match="tile"):
        transpose_pallas(torch.zeros(48, 64), tile=32)
    with pytest.raises(ValueError, match="2-D"):
        transpose_pallas(torch.zeros(4, 4, 4), tile=4)
    with pytest.raises(TypeError):
        transpose_pallas(torch.zeros(32, 32, dtype=torch.complex128), tile=32)
    with pytest.raises(ValueError, match="no kernel"):
        transpose_pallas(x.to("meta"), tile=32)
    assert tp.LAUNCHES == {"transpose": 0}


def test_wrapper_refuses_cpu_tensors():
    from cme213_tpu_torch.ops import _kernels

    with pytest.raises(ValueError, match="CUDA"):
        _kernels.transpose_tiles(torch.zeros(4, 8), torch.zeros(8, 4))


def _tile_model(x: np.ndarray) -> np.ndarray:
    """numpy model of ``csrc/transpose.cu``: blocks of 32 × 8 threads, each
    thread moving four elements through a 32 × 33 shared tile; ragged
    edges masked.  Returns the output and checks the write phase's banks."""
    T, R = 32, 8
    M, N = x.shape
    out = np.full((N, M), -1, x.dtype)
    flat_in, flat_out = x.reshape(-1), out.reshape(-1)
    tx, ty = np.meshgrid(np.arange(T), np.arange(R))  # (R, T): ty rows
    for by in range(-(-M // T)):
        for bx in range(-(-N // T)):
            tile = np.full(T * (T + 1), -1, x.dtype)
            for j in range(0, T, R):
                r, c = by * T + ty + j, bx * T + tx
                ok = (r < M) & (c < N)
                tile[((ty + j) * (T + 1) + tx)[ok]] = flat_in[(r * N + c)[ok]]
            for j in range(0, T, R):
                orow, oc = bx * T + ty + j, by * T + tx
                ok = (orow < N) & (oc < M)
                src = tx * (T + 1) + ty + j
                # one warp = one thread row: 32 distinct 4-byte banks
                for w in range(R):
                    assert len(set(src[w] % 32)) == 32
                flat_out[(orow * M + oc)[ok]] = tile[src[ok]]
    return out


@pytest.mark.parametrize("shape", [(64, 64), (96, 160), (33, 70), (1, 5),
                                   (100, 31)])
def test_tile_model_is_the_transpose(shape):
    x = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    np.testing.assert_array_equal(_tile_model(x), x.T)
    np.testing.assert_array_equal(
        _tile_model(x), tp.transpose_pallas_plain(torch.from_numpy(x)).numpy())
