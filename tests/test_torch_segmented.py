"""Parity of the port's segmented scans with the JAX package, on the CPU.

The same inputs, made with numpy, go through the JAX function and its
counterpart in the port.  Tolerances:
- bitwise for the flat scan, the iterated flat engine loop, head flags,
  segment ids and the goldens: the port repeats the reference's arithmetic;
- rel L2 ≤ 1e-5 (the conformance tolerance of ``apps/spmv_scan.py``) for
  the blocked and dense scans and for the kernel's plain versions against
  JAX's Pallas kernels (interpret mode): ``torch.cumsum`` and the kernel's
  tile decomposition associate the sums differently from XLA and from the
  TPU kernel.  On integer-valued inputs every sum is exact, so there they
  are held bitwise.
The kernel's plain versions are also held bitwise to a scalar transcription
of ``csrc/segmented_scan.cu`` (``_kernel_model``), which is what lets the
card hold the kernel bitwise to them.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu.apps import spmv_scan as j_spmv
from cme213_tpu.ops import scan as j_scan
from cme213_tpu.ops import segmented as j_seg
from cme213_tpu.ops.segmented_pallas import (
    segmented_scan_pallas as j_segscan_pallas,
    spmv_scan_pallas as j_spmv_scan_pallas)
from cme213_tpu.verify import golden as j_golden
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.ops import scan, segmented
from cme213_tpu_torch.ops import segmented_pallas as segp
from cme213_tpu_torch.verify import golden
from cme213_tpu_torch.verify.checkers import relative_l2_error

#: (items, threads, warp, carry_threads): small tiles so that n ≤ 20k
#: covers many tiles and several carry chunks, and the kernel's own
GEOMETRIES = [dict(items=2, threads=8, warp=4, carry_threads=8),
              dict(items=3, threads=12, warp=4, carry_threads=16),
              dict(items=4, threads=64, warp=32, carry_threads=64),
              dict()]
GEO_IDS = ["2x8w4c8", "3x12w4c16", "4x64w32c64", "kernel"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _flags(n: int, starts) -> np.ndarray:
    f = np.zeros(n, np.int32)
    f[np.asarray(starts)] = 1
    return f


def _random_case(n: int, p: int, seed: int, integer: bool = False):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(np.arange(1, n), size=min(p, n) - 1,
                                replace=False)) if n > 1 else []
    s = np.concatenate([[0], starts]).astype(np.int32)
    v = (rng.integers(-4, 5, n) if integer
         else rng.standard_normal(n)).astype(np.float32)
    return v, s


# ------------------------------------------------------------- flat, blocked


@pytest.mark.parametrize("n", [1, 2, 3, 100, 2048, 3000, 20000])
def test_flat_bitwise_vs_jax(n):
    v, s = _random_case(n, max(1, n // 30), seed=n)
    f = _flags(n, s)
    ref = np.asarray(j_seg.segmented_scan_flat(jnp.asarray(v),
                                               jnp.asarray(f)))
    got = segmented.segmented_scan_flat(_t(v), _t(f)).numpy()
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("n,p,q,iters", [(2048, 48, 47, 3), (3000, 80, 64, 5),
                                         (20000, 300, 200, 10)])
def test_iterate_flat_bitwise_vs_jax(n, p, q, iters):
    prob = j_spmv.generate_problem(n, p, q, iters=iters, seed=7)
    f = _flags(n, prob.s[:-1])
    ref = np.asarray(j_spmv._iterate(jnp.asarray(prob.a),
                                     jnp.asarray(prob.xx), jnp.asarray(f),
                                     iters, scan="flat"))
    got = spmv._iterate(_t(prob.a), _t(prob.xx), _t(f), iters,
                        scan="flat").numpy()
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("n,block", [(1000, 64), (4096, 256), (5000, 256),
                                     (20000, 4096), (3, 4096)])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
def test_blocked_vs_jax(n, block, integer):
    v, s = _random_case(n, max(1, n // 50), seed=block, integer=integer)
    f = _flags(n, s)
    ref = np.asarray(j_seg.segmented_scan_blocked(jnp.asarray(v),
                                                  jnp.asarray(f), block))
    got = segmented.segmented_scan_blocked(_t(v), _t(f), block).numpy()
    if integer:
        assert np.array_equal(got, ref)
    else:
        assert relative_l2_error(ref, got) <= 1e-5


def test_auto_dispatch_crossover():
    assert segmented.scan_threshold() == j_seg.BLOCKED_SCAN_THRESHOLD
    assert segmented.DEFAULT_SCAN_BLOCK == j_seg.DEFAULT_SCAN_BLOCK
    for n in (segmented.BLOCKED_SCAN_THRESHOLD - 1,
              segmented.BLOCKED_SCAN_THRESHOLD + 5):
        v, s = _random_case(n, n // 100, seed=n)
        f = _flags(n, s)
        small = n < segmented.BLOCKED_SCAN_THRESHOLD
        form = (segmented.segmented_scan_flat if small
                else segmented.segmented_scan_blocked)
        got = segmented.segmented_scan(_t(v), _t(f))
        assert torch.equal(got, form(_t(v), _t(f)))
        ref = np.asarray(j_seg.segmented_scan(jnp.asarray(v),
                                              jnp.asarray(f)))
        assert relative_l2_error(ref, got.numpy()) <= 1e-5
        from_starts = segmented.segmented_scan_from_starts(
            _t(v), _t(s.astype(np.int64)))
        assert torch.equal(from_starts, got)


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
def test_dense_vs_jax(integer):
    n = 3000
    v, s = _random_case(n, 60, seed=5, integer=integer)
    max_len = int(np.diff(np.concatenate([s, [n]])).max())
    ref = np.asarray(j_seg.segmented_scan_dense(jnp.asarray(v),
                                                jnp.asarray(s), max_len))
    got = segmented.segmented_scan_dense(_t(v), _t(s), max_len).numpy()
    if integer:
        assert np.array_equal(got, ref)
    else:
        assert relative_l2_error(ref, got) <= 1e-5


def test_head_flags_and_segment_ids_match_jax():
    n = 500
    s = np.array([0, 3, 4, 100, 499], np.int32)
    for fn_j, fn_p in ((j_seg.head_flags_from_starts,
                        segmented.head_flags_from_starts),
                       (j_seg.segment_ids_from_starts,
                        segmented.segment_ids_from_starts)):
        ref = np.asarray(fn_j(jnp.asarray(s), n))
        got = fn_p(_t(s), n)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref)
    # starts past the end are dropped, as the reference's mode="drop"
    ref = np.asarray(j_seg.head_flags_from_starts(jnp.asarray([0, 7, 9]), 8))
    assert np.array_equal(
        segmented.head_flags_from_starts(_t([0, 7, 9]), 8).numpy(), ref)


@pytest.mark.parametrize("starts,n", [([0, 2, 5], 6), ([1, 2], 6),
                                      ([0, 3, 3], 6), ([0, 6], 6), ([], 6)])
def test_validate_segments_like_reference(starts, n):
    def outcome(fn):
        try:
            fn(np.asarray(starts, np.int32), n)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(segmented.validate_segments) == outcome(
        j_seg.validate_segments)


def test_scan_ops_match_jax():
    x = np.random.default_rng(0).integers(-9, 10, 4096).astype(np.float32)
    for fn_j, fn_p in ((j_scan.inclusive_scan, scan.inclusive_scan),
                       (j_scan.exclusive_scan, scan.exclusive_scan)):
        assert np.array_equal(fn_p(_t(x)).numpy(),
                              np.asarray(fn_j(jnp.asarray(x))))
    got = scan.blocked_inclusive_scan(_t(x), 256).numpy()
    assert np.array_equal(got, np.asarray(
        j_scan.blocked_inclusive_scan(jnp.asarray(x), 256)))
    with pytest.raises(ValueError, match="multiple"):
        scan.blocked_inclusive_scan(_t(x[:100]), 64)


def test_goldens_bitwise_vs_jax():
    prob = j_spmv.generate_problem(3000, 80, 64, iters=4, seed=2)
    s = prob.s[:-1]
    assert np.array_equal(golden.host_segmented_scan(prob.a, s),
                          j_golden.host_segmented_scan(prob.a, s))
    for dtype in (None, np.float64):
        assert np.array_equal(
            golden.host_spmv_scan(prob.a, s, prob.xx, 4, dtype=dtype),
            j_golden.host_spmv_scan(prob.a, s, prob.xx, 4, dtype=dtype))


# ---------------------------------------------- the kernel's plain versions


@functools.lru_cache(maxsize=None)
def _pallas_case(name: str):
    """(values, flags, JAX Pallas output) for the edge cases of
    ``tests/test_segmented_pallas.py``; the reference kernel runs once per
    case (interpret mode, (8×128) tiles)."""
    block = 8 * 128
    if name == "one-tile":
        v, s = _random_case(block, 10, seed=1)
    elif name == "many-tiles":
        v, s = _random_case(3 * block, 50, seed=2)
    elif name == "padding":
        v, s = _random_case(5000, 37, seed=3)
    elif name == "long-segment":
        v, s = np.ones(4 * block, np.float32), np.array([0], np.int32)
    elif name == "tile-edges":
        v = np.ones(3 * block, np.float32)
        s = np.array([0, block, 2 * block + 1], np.int32)
    elif name == "every":
        v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
        s = np.arange(1000, dtype=np.int32)
    elif name == "integer":
        v, s = _random_case(20000, 400, seed=4, integer=True)
    f = _flags(v.shape[0], s)
    out = np.asarray(j_segscan_pallas(jnp.asarray(v), jnp.asarray(f),
                                      rows=8, interpret=True))
    return v, f, out


PALLAS_CASES = ["one-tile", "many-tiles", "padding", "long-segment",
                "tile-edges", "every", "integer"]


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("case", PALLAS_CASES)
def test_segscan_plain_vs_jax_pallas(case, geo):
    v, f, ref = _pallas_case(case)
    got = segp.segmented_scan_pallas_plain(_t(v), _t(f), **geo).numpy()
    assert relative_l2_error(ref, got) <= 1e-5
    if case in ("integer", "long-segment", "tile-edges", "every"):
        # integer-valued sums, or no sums at all: exact in every order
        assert np.array_equal(got, ref)
        assert np.array_equal(
            got, golden.host_segmented_scan(v, np.flatnonzero(f)))


@functools.lru_cache(maxsize=None)
def _fused_case(integer: bool):
    n, iters = 3000, 5
    rng = np.random.default_rng(11)
    prob = j_spmv.generate_problem(n, 80, 64, iters=iters, seed=21)
    a, xx = prob.a, prob.xx
    if integer:  # small integers stay exact through 3 iterations
        a = rng.integers(-3, 4, n).astype(np.float32)
        xx = rng.integers(-1, 2, n).astype(np.float32)
        iters = 3
    f = _flags(n, prob.s[:-1])
    out = np.asarray(j_spmv_scan_pallas(jnp.asarray(a), jnp.asarray(xx),
                                        jnp.asarray(f), iters, rows=8,
                                        interpret=True))
    return a, xx, f, iters, out


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
def test_spmv_plain_vs_jax_pallas(integer, geo):
    a, xx, f, iters, ref = _fused_case(integer)
    got = segp.spmv_scan_pallas_plain(_t(a), _t(xx), _t(f), iters,
                                      **geo).numpy()
    if integer:
        assert np.array_equal(got, ref)
    else:
        assert relative_l2_error(ref, got) <= 1e-5


def _kernel_model(w: np.ndarray, heads: np.ndarray, items: int, threads: int,
                  warp: int, carry_threads: int) -> np.ndarray:
    """Scalar transcription of ``csrc/segmented_scan.cu``: the three passes
    lane by lane, shuffles as reads of the lanes' old values, every add
    rounded to f32 on its own."""
    f32 = np.float32
    n = w.shape[0]
    tile = items * threads
    ntiles = max(1, -(-n // tile))
    nw, cw = threads // warp, carry_threads // warp

    def warp_scan(v, f):  # kernel's warp_scan: strides 1 .. < warp
        v, f = list(v), list(f)
        d = 1
        while d < warp:
            pv, pf = v[:], f[:]
            for lane in range(d, warp):
                v[lane] = v[lane] if f[lane] else f32(pv[lane - d] + v[lane])
                f[lane] = f[lane] | pf[lane - d]
            d *= 2
        return v, f

    def scan_summaries(sv, sf):  # warp 0 over the padded summaries
        m = len(sv)
        v, f = warp_scan(sv + [f32(0)] * (warp - m), sf + [0] * (warp - m))
        return v[:m], f[:m]

    def chunk(t, tid):
        base = t * tile + tid * items
        ww = [f32(w[i]) if i < n else f32(0) for i in range(base, base + items)]
        ff = [int(heads[i] != 0) if i < n else 0
              for i in range(base, base + items)]
        loc, seen = [ww[0]], [ff[0]]
        for j in range(1, items):
            loc.append(ww[j] if ff[j] else f32(loc[-1] + ww[j]))
            seen.append(seen[-1] | ff[j])
        return loc, seen

    def tile_warps(t):
        chunks = [chunk(t, tid) for tid in range(threads)]
        lanes = []
        for wi in range(nw):
            c = chunks[wi * warp:(wi + 1) * warp]
            lanes.append(warp_scan([x[0][-1] for x in c],
                                   [x[1][-1] for x in c]))
        sv, sf = scan_summaries([x[0][-1] for x in lanes],
                                [x[1][-1] for x in lanes])
        return chunks, lanes, sv, sf

    # pass 1: tile summaries
    tile_v, tile_f = [], []
    for t in range(ntiles):
        _, _, sv, sf = tile_warps(t)
        tile_v.append(sv[-1])
        tile_f.append(sf[-1])
    # pass 2: carries
    carry = [f32(0)] * ntiles
    run = f32(0)
    for c0 in range(0, ntiles - 1, carry_threads):
        vals = [(tile_v[i], tile_f[i]) if i < ntiles else (f32(0), 0)
                for i in range(c0, c0 + carry_threads)]
        lanes = [warp_scan([x[0] for x in vals[k * warp:(k + 1) * warp]],
                           [x[1] for x in vals[k * warp:(k + 1) * warp]])
                 for k in range(cw)]
        gv, gf = scan_summaries([x[0][-1] for x in lanes],
                                [x[1][-1] for x in lanes])
        incl = []
        for k in range(cw):
            win = run if k == 0 else (gv[k - 1] if gf[k - 1]
                                      else f32(run + gv[k - 1]))
            for lane in range(warp):
                v, f = lanes[k][0][lane], lanes[k][1][lane]
                incl.append(v if f else f32(win + v))
        for tid in range(carry_threads):
            if c0 + tid + 1 < ntiles:
                carry[c0 + tid + 1] = incl[tid]
        run = incl[-1]
    # pass 3: down-sweep
    out = np.zeros(ntiles * tile, np.float32)
    for t in range(ntiles):
        chunks, lanes, sv, sf = tile_warps(t)
        for wi in range(nw):
            win = carry[t] if wi == 0 else (
                sv[wi - 1] if sf[wi - 1] else f32(carry[t] + sv[wi - 1]))
            tv, tf = lanes[wi]
            for lane in range(warp):
                tin = win if lane == 0 else (
                    tv[lane - 1] if tf[lane - 1] else f32(win + tv[lane - 1]))
                loc, seen = chunks[wi * warp + lane]
                base = t * tile + (wi * warp + lane) * items
                for j in range(items):
                    out[base + j] = loc[j] if seen[j] else f32(tin + loc[j])
    return out[:n]


@pytest.mark.parametrize("geo", GEOMETRIES[:2], ids=GEO_IDS[:2])
@pytest.mark.parametrize("n,pattern", [(1, "random"), (15, "random"),
                                       (16, "one"), (17, "every"),
                                       (700, "random"), (700, "one"),
                                       (613, "tile-edges")])
def test_plain_bitwise_vs_kernel_model(n, pattern, geo):
    rng = np.random.default_rng(n)
    w = rng.standard_normal(n).astype(np.float32)
    tile = geo["items"] * geo["threads"]
    f = np.zeros(n, np.int32)
    if pattern == "one":
        f[0] = 1
    elif pattern == "every":
        f[:] = 1
    elif pattern == "tile-edges":
        f[::tile] = 1
    else:
        f[rng.random(n) < 0.05] = 1
    got = segp.segmented_scan_pallas_plain(_t(w), _t(f), **geo).numpy()
    ref = _kernel_model(w, f, **geo)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_plain_takes_float64():
    prob = j_spmv.generate_problem(5000, 60, 50, iters=4, seed=9)
    f = _flags(prob.n, prob.s[:-1])
    got = segp.spmv_scan_pallas_plain(_t(prob.a).double(),
                                      _t(prob.xx).double(), _t(f), 4,
                                      items=2, threads=8, warp=4,
                                      carry_threads=8)
    assert got.dtype == torch.float64
    ref = golden.host_spmv_scan(prob.a, prob.s[:-1], prob.xx, 4,
                                dtype=np.float64)
    assert relative_l2_error(ref, got.numpy()) <= 1e-12


def test_cpu_tensors_take_the_plain_versions():
    v, s = _random_case(5000, 80, seed=6)
    f = _t(_flags(5000, s))
    a = _t(v)
    keep = a.clone()
    xx = torch.linspace(-1, 1, 5000)
    before = dict(segp.LAUNCHES)
    assert torch.equal(segp.segmented_scan_pallas(a, f),
                       segp.segmented_scan_pallas_plain(a, f))
    assert torch.equal(segp.spmv_scan_pallas(a, xx, f, 3),
                       segp.spmv_scan_pallas_plain(a, xx, f, 3))
    assert segp.LAUNCHES == before  # no kernel ran
    assert torch.equal(a, keep)     # the caller's values are not modified


def test_wrappers_refuse_bad_arguments():
    f = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        segp.segmented_scan_pallas(torch.zeros(8, dtype=torch.int32), f)
    with pytest.raises(TypeError):
        segp.segmented_scan_pallas(torch.zeros(2, 4), f)
    with pytest.raises(ValueError, match="one shape"):
        segp.segmented_scan_pallas(torch.zeros(9), f)
    with pytest.raises(TypeError, match="xx"):
        segp.spmv_scan_pallas(torch.zeros(8), torch.zeros(8).double(), f, 1)
    with pytest.raises(ValueError, match="no kernel"):
        segp.segmented_scan_pallas(torch.zeros(8, device="meta"),
                                   f.to("meta"))
    with pytest.raises(ValueError, match="geometry"):
        segp.segmented_scan_pallas_plain(torch.zeros(8), f, threads=12,
                                         warp=8)


def test_blocked_cancellation_is_the_reference_s():
    """The blocked scan's local sums are a cumsum over the block minus the
    cumsum before the segment's head; on pwtk's short segments (53
    elements on average) that cancellation leaves it much further from
    the f64 answer than the flat scan — in the reference as in the port."""
    prob = spmv.suite_problem("pwtk", scale=0.003)  # 34,903 values, N = 25
    f = _flags(prob.n, prob.s[:-1])
    ref = golden.host_spmv_scan(prob.a, prob.s[:-1], prob.xx, prob.iters,
                                dtype=np.float64)
    errs = {}
    for scan_kind in ("blocked", "flat"):
        ours = spmv._iterate(_t(prob.a), _t(prob.xx), _t(f), prob.iters,
                             scan=scan_kind).numpy()
        theirs = np.asarray(j_spmv._iterate(
            jnp.asarray(prob.a), jnp.asarray(prob.xx), jnp.asarray(f),
            prob.iters, scan=scan_kind))
        errs[scan_kind] = (relative_l2_error(ref, ours),
                           relative_l2_error(ref, theirs))
    assert errs["flat"][0] == errs["flat"][1]
    for ours_or_theirs in (0, 1):
        assert errs["blocked"][ours_or_theirs] \
            > 5 * errs["flat"][ours_or_theirs]
