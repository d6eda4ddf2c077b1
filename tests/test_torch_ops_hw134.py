"""Parity of the port's hw1, hw3 and hw4 ops with the JAX package, on the
CPU.

The same inputs, made with numpy from a seed, go through the JAX op and the
port's.  Tolerances: exact for bytes, ints, histograms, sorts and sort
pairs (every radix width and bitonic length), and for the packed cipher in
every carry case; PageRank bitwise against the numpy golden
(``host_graph_iterate``) and within ULP-10 of JAX's ``pagerank_iterate``;
``saxpy`` bitwise against numpy float32 and within 1 ULP of the product and
1 of the sum from JAX (XLA:CPU may contract it into an FMA; where the sum
does not cancel, within 1 ULP); ``parallel_sum`` within 1e-6 relative of JAX
on positive data; ``csr_spmv`` bitwise against ``np.add.reduceat`` of the
products (rows of up to 129 nonzeros) and, like ``ell_spmv``, within
2·(k−1)·ε·Σ|terms| of JAX for a row of k terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu import ops as j_ops
from cme213_tpu.apps import pagerank as j_pagerank
from cme213_tpu.core import roofline as j_roofline
from cme213_tpu.ops import gather as j_gather
from cme213_tpu.verify import golden as j_golden
from cme213_tpu_torch import ops
from cme213_tpu_torch.core import roofline, ulp_distance
from cme213_tpu_torch.ops import gather
from cme213_tpu_torch.ops.sort import sort_auto
from cme213_tpu_torch.verify import golden

EPS32 = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return np.asarray(a)


# ------------------------------------------------------------ elementwise

@pytest.fixture
def text():
    rng = np.random.default_rng(0)
    return rng.integers(32, 127, size=1 << 16, dtype=np.uint8)


@pytest.mark.parametrize("shift", [0, 17, 42, 255, 256 - 42])
def test_shift_cipher_exact(text, shift):
    out = ops.shift_cipher(_t(text), shift).numpy()
    np.testing.assert_array_equal(out, golden.host_shift_cipher(text, shift))
    np.testing.assert_array_equal(
        out, _j(j_ops.shift_cipher(jnp.asarray(text), shift)))


def test_wrapping_and_round_trip(text):
    data = np.array([250, 251, 255, 0], dtype=np.uint8)
    out = ops.shift_cipher(_t(data), 10).numpy()
    assert out[2] == 9 and (out == golden.host_shift_cipher(data, 10)).all()
    enc = ops.shift_cipher(_t(text), 42)
    np.testing.assert_array_equal(ops.shift_cipher(enc, 256 - 42).numpy(),
                                  text)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("shift,lo", [(13, 32), (17, 0), (255, 0),
                                      (255, 1), (200, 128)],
                         ids=["ascii", "bytes", "carry-all", "carry-ge1",
                              "carry-high"])
def test_packed_cipher_bitwise_with_carries(width, shift, lo):
    """Bytes ≥ 256 − shift overflow into the next byte of their word: the
    port's int32 add gives the reference's uint32 bits."""
    data = np.random.default_rng(shift + lo).integers(
        lo, 256, size=1 << 14, dtype=np.uint8)
    out = ops.shift_cipher_packed(_t(data), shift, width=width).numpy()
    ref = _j(j_ops.shift_cipher_packed(jnp.asarray(data), shift,
                                       width=width))
    np.testing.assert_array_equal(out, ref)
    if int(data.max()) + shift < 256:  # no byte overflows: the golden too
        np.testing.assert_array_equal(
            out, golden.host_shift_cipher(data, shift))


@pytest.mark.parametrize("width", [4, 8])
def test_packed_cipher_rejects_ragged_lengths(width):
    with pytest.raises(ValueError):
        ops.shift_cipher_packed(torch.zeros(width + 2, dtype=torch.uint8),
                                1, width)


def test_batched_ciphers_equal_the_reference():
    from cme213_tpu.ops import elementwise as j_el
    from cme213_tpu_torch.ops import elementwise as el

    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (5, 1 << 12), dtype=np.uint8)
    shifts = np.array([0, 1, 17, 200, 255], dtype=np.int32)
    np.testing.assert_array_equal(
        el.shift_cipher_batched(_t(data), _t(shifts)).numpy(),
        _j(j_el.shift_cipher_batched(jnp.asarray(data),
                                     jnp.asarray(shifts))))
    for width in (4, 8):
        out = el.shift_cipher_packed_batched(_t(data), _t(shifts), width)
        np.testing.assert_array_equal(
            out.numpy(), _j(j_el.shift_cipher_packed_batched(
                jnp.asarray(data), jnp.asarray(shifts), width=width)))
        for lane in range(5):
            np.testing.assert_array_equal(
                out[lane].numpy(),
                ops.shift_cipher_packed(_t(data[lane]), int(shifts[lane]),
                                        width).numpy())


def test_saxpy_bitwise_numpy_and_within_one_ulp_of_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(1 << 16).astype(np.float32)
    y = rng.standard_normal(1 << 16).astype(np.float32)
    out = ops.saxpy(2.5, _t(x), _t(y)).numpy()
    prod = np.float32(2.5) * x
    np.testing.assert_array_equal(out, prod + y)
    # an FMA skips the product's rounding: 1 ULP of the product, plus the
    # sum's own rounding (where the sum cancels, many ULPs of the sum)
    ref = _j(j_ops.saxpy(2.5, jnp.asarray(x), jnp.asarray(y)))
    assert (np.abs(out - ref) <= np.spacing(np.abs(prod))
            + np.spacing(np.abs(out))).all()
    big = np.abs(out) >= np.abs(prod)  # no cancellation
    assert int(ulp_distance(out[big], ref[big]).max()) <= 1


def test_parallel_sum_within_tolerance():
    x = np.random.default_rng(5).random(1 << 16).astype(np.float32)
    got = float(ops.parallel_sum(_t(x)))
    want = float(j_ops.parallel_sum(jnp.asarray(x)))
    assert abs(got - want) <= 1e-6 * want
    assert abs(got - float(x.astype(np.float64).sum())) <= 1e-6 * want


@pytest.mark.parametrize("period", [1, 3, 7, 26])
def test_vigenere_shift_unshift_exact(period):
    rng = np.random.default_rng(period)
    txt = (rng.integers(0, 26, 5000) + ord("a")).astype(np.uint8)
    shifts = rng.integers(1, 27, period).astype(np.int32)
    enc = ops.vigenere_shift(_t(txt), _t(shifts))
    np.testing.assert_array_equal(
        enc.numpy(), _j(j_ops.vigenere_shift(jnp.asarray(txt),
                                             jnp.asarray(shifts))))
    dec = ops.vigenere_unshift(enc, _t(shifts))
    np.testing.assert_array_equal(
        dec.numpy(), _j(j_ops.vigenere_unshift(jnp.asarray(enc.numpy()),
                                               jnp.asarray(shifts))))
    np.testing.assert_array_equal(dec.numpy(), txt)


# ------------------------------------------------------------ gather

@pytest.mark.parametrize("n,avg", [(256, 3), (1000, 8), (4096, 20)])
def test_pagerank_bitwise_golden_ulp10_jax(n, avg):
    g = j_pagerank.build_graph(n, avg, seed=avg)
    iters = 6
    indices = _t(g.indices.astype(np.int64))
    rows = ops.csr_row_ids(indices, g.edges.shape[0])
    np.testing.assert_array_equal(
        rows.numpy(), _j(j_gather.csr_row_ids(jnp.asarray(g.indices),
                                              g.edges.shape[0])))
    out = ops.pagerank_iterate(rows, _t(g.edges.astype(np.int64)),
                               _t(g.rank0), _t(g.inv_deg), n, iters).numpy()
    ref = j_golden.host_graph_iterate(g.indices, g.edges, g.rank0,
                                      g.inv_deg, iters)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, golden.host_graph_iterate(g.indices, g.edges, g.rank0,
                                       g.inv_deg, iters))
    jax_out = _j(j_pagerank.run_pagerank(g, iters))
    assert int(ulp_distance(out, jax_out).max()) <= 10
    one = ops.pagerank_propagate(rows, _t(g.edges.astype(np.int64)),
                                 _t(g.rank0), _t(g.inv_deg), n).numpy()
    np.testing.assert_array_equal(
        one, j_golden.host_graph_propagate(g.indices, g.edges, g.rank0,
                                           g.inv_deg))


def test_pagerank_iterate_rejects_odd_counts():
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="even"):
        ops.pagerank_iterate(torch.zeros(4, dtype=torch.int64),
                             torch.zeros(4, dtype=torch.int64), z, z, 4, 3)


@pytest.mark.parametrize("max_len", [1, 9, 17, 129, 300],
                         ids=["singletons", "one-block", "blocks",
                              "largest-exact", "past-129"])
def test_segment_sum_is_reduceat(max_len):
    """Rows of up to 129 values sum bit for bit as ``np.add.reduceat``;
    longer rows agree within the bound of two summation orders; empty rows
    sum to 0, as JAX's segment_sum."""
    rng = np.random.default_rng(max_len)
    lens = rng.integers(0, max_len + 1, 400)
    lens[0] = max_len
    indptr = np.concatenate([[0], np.cumsum(lens)])
    vals = (rng.random(indptr[-1]) * rng.random(indptr[-1])).astype(
        np.float32)
    out = gather.segment_sum(gather.segment_plan(_t(indptr)),
                             _t(vals)).numpy()
    full = lens > 0
    ref = np.add.reduceat(vals, indptr[:-1][full])
    exact = lens[full] <= 129
    np.testing.assert_array_equal(out[full][exact], ref[exact])
    bound = 2 * lens[full] * EPS32 * np.add.reduceat(np.abs(vals),
                                                     indptr[:-1][full])
    assert (np.abs(out[full] - ref) <= bound).all()
    assert (out[~full] == 0).all()


# ------------------------------------------------------------ spmv

def _csr(seed, rows=300, cols=200, max_len=40):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len, rows)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    col = rng.integers(0, cols, indptr[-1]).astype(np.int32)
    val = rng.standard_normal(indptr[-1]).astype(np.float32)
    x = rng.standard_normal(cols).astype(np.float32)
    return indptr, col, val, x, lens


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_spmv_reduceat_bitwise_and_jax_bound(seed):
    from cme213_tpu.ops import spmv as j_spmv

    indptr, col, val, x, lens = _csr(seed)
    rows = ops.csr_row_ids(_t(indptr), indptr[-1])
    out = ops.csr_spmv(rows, _t(col), _t(val), _t(x), lens.size).numpy()
    prod = (val * x[col]).astype(np.float32)
    np.testing.assert_array_equal(out, np.add.reduceat(prod, indptr[:-1]))
    ref = _j(j_spmv.csr_spmv(jnp.asarray(rows.numpy().astype(np.int32)),
                             jnp.asarray(col), jnp.asarray(val),
                             jnp.asarray(x), lens.size))
    bound = 2 * (lens - 1) * EPS32 * np.add.reduceat(np.abs(prod),
                                                     indptr[:-1])
    assert (np.abs(out - ref) <= bound).all()


def test_ell_spmv_and_conversion():
    from cme213_tpu.ops import spmv as j_spmv

    indptr, col, val, x, lens = _csr(2)
    ell_cols, ell_vals = ops.csr_to_ell(indptr, col, val)
    j_cols, j_vals = j_spmv.csr_to_ell(indptr, col, val)
    np.testing.assert_array_equal(ell_cols, j_cols)
    np.testing.assert_array_equal(ell_vals, j_vals)
    assert ell_cols.dtype == j_cols.dtype and ell_vals.dtype == j_vals.dtype
    out = ops.ell_spmv(_t(ell_cols), _t(ell_vals), _t(x)).numpy()
    ref = _j(j_spmv.ell_spmv(jnp.asarray(j_cols), jnp.asarray(j_vals),
                             jnp.asarray(x)))
    prod = (val * x[col]).astype(np.float32)
    bound = 2 * (lens - 1) * EPS32 * np.add.reduceat(np.abs(prod),
                                                     indptr[:-1])
    assert (np.abs(out - ref) <= bound + 1e-30).all()


# ------------------------------------------------------------ histograms

@pytest.mark.parametrize("fn", ["histogram_sort", "histogram_onehot",
                                "histogram_segment"])
@pytest.mark.parametrize("lo,hi", [(0, 26), (-3, 30)],
                         ids=["in-range", "outside"])
def test_histograms_exact(fn, lo, hi):
    x = np.random.default_rng(6).integers(lo, hi, 5000).astype(np.int32)
    out = getattr(ops, fn)(_t(x), 26).numpy()
    ref = _j(getattr(j_ops, fn)(jnp.asarray(x), 26))
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == np.int32
    if lo == 0:
        np.testing.assert_array_equal(out, np.bincount(x, minlength=26))


# ------------------------------------------------------------ sorts

def _keys(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 32, n,
                                                dtype=np.uint64).astype(
        np.uint32)


def test_library_sort_wrappers():
    x = np.random.default_rng(7).integers(0, 2**31, 1000).astype(np.uint32)
    out = ops.sort(_t(x))
    assert out.dtype == torch.uint32
    np.testing.assert_array_equal(out.numpy(), np.sort(x))
    np.testing.assert_array_equal(out.numpy(),
                                  _j(j_ops.sort(jnp.asarray(x))))
    k, v = ops.sort_pairs(_t(x), torch.arange(1000))
    np.testing.assert_array_equal(k.numpy(), np.sort(x))
    np.testing.assert_array_equal(x[v.numpy()], np.sort(x))
    jk, _ = j_ops.sort_pairs(jnp.asarray(x), jnp.arange(1000))
    np.testing.assert_array_equal(k.numpy(), _j(jk))


@pytest.mark.parametrize("n,num_bits,block_size", [
    (100, 8, 2048), (8192, 8, 2048), (10000, 8, 2048), (3000, 4, 512),
    (1 << 16, 8, 8192), (5000, 11, 1024)])
def test_radix_sort_exact(n, num_bits, block_size):
    x = _keys(n, seed=n + num_bits)
    x[:7] = 0xFFFFFFFF  # real keys equal to the padding
    out = ops.radix_sort(_t(x), num_bits=num_bits, block_size=block_size)
    assert out.dtype == torch.uint32
    np.testing.assert_array_equal(out.numpy(), np.sort(x))
    np.testing.assert_array_equal(
        out.numpy(), _j(j_ops.radix_sort(jnp.asarray(x), num_bits=num_bits,
                                         block_size=block_size)))


def test_radix_sort_takes_only_uint32():
    with pytest.raises(TypeError):
        ops.radix_sort(torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("n", [1, 2, 3, 100, 1000, 1024, 1025])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_bitonic_sort_exact(n, dtype):
    rng = np.random.default_rng(n)
    if dtype == np.float32:
        x = rng.standard_normal(n).astype(np.float32)
    elif dtype == np.int32:
        x = rng.integers(-2**31, 2**31, n).astype(np.int32)
    else:
        x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    out = ops.bitonic_sort(_t(x)).numpy()
    np.testing.assert_array_equal(out, np.sort(x))
    np.testing.assert_array_equal(out, _j(j_ops.bitonic_sort(
        jnp.asarray(x))))


def test_sort_auto_defaults_to_the_library_sort(monkeypatch, tmp_path):
    from cme213_tpu_torch.core import trace, tune

    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "t.json"))
    tune.reset()
    trace.clear_events()
    x = _keys(3000, seed=9)
    np.testing.assert_array_equal(sort_auto(_t(x)).numpy(),
                                  np.sort(x))
    assert trace.events("tune-default")[-1]["op"] == "sort"
    tune.reset()


# ------------------------------------------------------------ goldens, costs

def test_goldens_equal_the_reference():
    x = np.random.default_rng(8).integers(0, 256, 999, dtype=np.uint8)
    np.testing.assert_array_equal(golden.host_shift_cipher(x, 200),
                                  j_golden.host_shift_cipher(x, 200))
    k = _keys(777)
    np.testing.assert_array_equal(golden.host_sort(k), j_golden.host_sort(k))
    with pytest.raises(ValueError):
        golden.host_graph_iterate(None, None, None, None, 3)


def test_segmented_scan_golden_is_the_serial_loop():
    """The vectorised golden makes the reference loop's additions in its
    order (long segments by cumsum, short ones position by position)."""
    rng = np.random.default_rng(10)
    n = 30000
    starts = np.concatenate([[0], [10], np.sort(rng.choice(
        np.arange(12000, n), 300, replace=False))]).astype(np.int32)
    for dtype in (np.float32, np.float64):
        v = rng.standard_normal(n).astype(dtype)
        np.testing.assert_array_equal(golden.host_segmented_scan(v, starts),
                                      j_golden.host_segmented_scan(v, starts))


def test_cost_models_are_the_reference():
    assert set(roofline.COST_MODELS) == set(j_roofline.COST_MODELS)
    cases = {"pagerank": ((1 << 21, 16_777_215, 20), {}),
             "cipher": ((20_004_128,), {}), "sort": ((1 << 20,), {}),
             "heat": ((4000,), {"order": 8, "iters": 3}),
             "spmv_scan": ((11_634_424, 25), {}), "scan": ((1 << 20,), {}),
             "transpose": ((4096, 4096), {}), "transfer": ((123,), {})}
    def pair(c):
        return c.nbytes, c.flops

    for name, (args, kw) in cases.items():
        assert pair(roofline.COST_MODELS[name](*args, **kw)) == \
            pair(j_roofline.COST_MODELS[name](*args, **kw)), name
    for kind in ("merge", "radix"):
        assert pair(roofline.sort_cost(1000, kind)) == \
            pair(j_roofline.sort_cost(1000, kind))
