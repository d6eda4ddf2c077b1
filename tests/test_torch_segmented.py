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

#: (items, threads, warp): small tiles so that n ≤ 20k covers many tiles
#: and long carry folds, and the kernel's own
GEOMETRIES = [dict(items=2, threads=8, warp=4),
              dict(items=3, threads=12, warp=4),
              dict(items=4, threads=64, warp=32),
              dict()]
GEO_IDS = ["2x8w4", "3x12w4", "4x64w32", "kernel"]


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
                  warp: int) -> np.ndarray:
    """Scalar transcription of ``csrc/segmented_scan.cu``: each tile's
    local scan lane by lane (shuffles as reads of the lanes' old values),
    its summary, the look-back's carry as the serial fold of the summaries
    in tile order, then the down-sweep; every add rounded to f32 on its
    own."""
    f32 = np.float32
    n = w.shape[0]
    tile = items * threads
    ntiles = max(1, -(-n // tile))
    nw = threads // warp

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

    out = np.zeros(ntiles * tile, np.float32)
    e = f32(0)  # E[t] = P[t-1], P[-1] = 0
    for t in range(ntiles):
        chunks = [chunk(t, tid) for tid in range(threads)]
        lanes = []
        for wi in range(nw):
            c = chunks[wi * warp:(wi + 1) * warp]
            lanes.append(warp_scan([x[0][-1] for x in c],
                                   [x[1][-1] for x in c]))
        # warp 0 over the warp summaries, padded to a warp; the last is A[t]
        sv, sf = warp_scan([x[0][-1] for x in lanes] + [f32(0)] * (warp - nw),
                           [x[1][-1] for x in lanes] + [0] * (warp - nw))
        av, af = sv[nw - 1], sf[nw - 1]
        for wi in range(nw):
            win = e if wi == 0 else (
                sv[wi - 1] if sf[wi - 1] else f32(e + sv[wi - 1]))
            tv, tf = lanes[wi]
            for lane in range(warp):
                tin = win if lane == 0 else (
                    tv[lane - 1] if tf[lane - 1] else f32(win + tv[lane - 1]))
                loc, seen = chunks[wi * warp + lane]
                base = t * tile + (wi * warp + lane) * items
                for j in range(items):
                    out[base + j] = loc[j] if seen[j] else f32(tin + loc[j])
        e = av if af else f32(e + av)  # P[t], published for tile t + 1
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


# ------------------------------------------- the look-back's carry, simulated


def _fold_loop(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """The serial fold's carries by a scalar loop: carry[t] = P[t-1]."""
    e, out = v.dtype.type(0), []
    for x, h in zip(v, f):
        out.append(e)
        e = x if h else v.dtype.type(e + x)
    return np.array(out, v.dtype)


def _summaries(ntiles: int, pattern: str, seed: int):
    """Tile summaries (f32 values, head bits) of a pattern: ``random``
    heads, ``one-segment`` (a head in tile 0 only: the longest walks),
    ``no-head`` (the first run folds from P[-1] = 0), ``tile-edges``
    (every tile a head)."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(ntiles) * 10.0 ** rng.integers(-3, 4, ntiles)
         ).astype(np.float32)
    f = {"random": rng.random(ntiles) < 0.15,
         "one-segment": np.arange(ntiles) == 0,
         "no-head": np.zeros(ntiles, bool),
         "tile-edges": np.ones(ntiles, bool)}[pattern]
    return v, f


def _fold_window(words, e, hi):
    """The kernel's fold_window over lanes hi .. 0: a stop (P, or a head)
    restarts the fold from its value, any other word adds to it."""
    for lane in range(hi, -1, -1):
        inclusive, head, value = words[lane]
        e = value if inclusive or head else np.float32(e + value)
    return e


def _look_back(read, t: int, window: int):
    """The kernel's look_back for tile t with windows of ``window`` lanes,
    as a generator: it yields where the warp would poll again (a word up to
    the nearest stop is not yet published) and between the forward
    re-reads, and returns E[t].  ``read(i)`` is tile i's word now:
    ``(inclusive, head, value)``, or None before it is published."""
    top = t - 1
    while True:
        while True:
            words = [read(top - lane) if top - lane >= 0
                     else (True, False, np.float32(0))
                     for lane in range(window)]
            stops = [wd is not None and (wd[0] or wd[1]) for wd in words]
            stop = next((lane for lane in range(window) if stops[lane]),
                        None)
            upto = window if stop is None else stop + 1
            if all(wd is not None for wd in words[:upto]):
                break
            yield
        if stop is not None:
            break
        top -= window
    e = _fold_window(words, np.float32(0), stop)
    while top < t - 1:
        top += window
        yield
        words = [read(top - lane) for lane in range(window)]
        assert all(wd is not None for wd in words)
        e = _fold_window(words, e, window - 1)
    return e


@pytest.mark.parametrize("window", [4, 32])
@pytest.mark.parametrize("pattern", ["random", "one-segment", "no-head",
                                     "tile-edges"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_look_back_any_completion_order_gives_serial_fold(seed, pattern,
                                                          window):
    """Tiles publish A, walk and publish P in a random interleaving (a walk
    advances one poll or one re-read at a time); every tile's carry and
    every published P are the serial fold's bits."""
    ntiles = 150
    v, f = _summaries(ntiles, pattern, seed)
    ref = _fold_loop(v, f)
    ref_p = np.append(ref[1:], v[-1] if f[-1] else np.float32(ref[-1] + v[-1]))
    rng = np.random.default_rng(100 + seed)
    status = [None] * ntiles
    carry = [None] * ntiles
    walks, ready_p = {}, {}
    unstarted = list(range(ntiles))
    while unstarted or walks or ready_p:
        kinds = [k for k, live in (("start", unstarted), ("step", walks),
                                   ("publish", ready_p)) if live]
        kind = kinds[rng.integers(len(kinds))]
        if kind == "start":  # a block publishes A[t] and starts its walk
            t = unstarted.pop(rng.integers(len(unstarted)))
            status[t] = (False, bool(f[t]), v[t])
            walks[t] = _look_back(status.__getitem__, t, window)
        elif kind == "step":
            t = list(walks)[rng.integers(len(walks))]
            try:
                next(walks[t])
            except StopIteration as done:
                del walks[t]
                carry[t] = done.value
                ready_p[t] = v[t] if f[t] else np.float32(done.value + v[t])
        else:
            t = list(ready_p)[rng.integers(len(ready_p))]
            status[t] = (True, bool(f[t]), ready_p.pop(t))
    got = np.array(carry, np.float32)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    got_p = np.array([wd[2] for wd in status], np.float32)
    assert np.array_equal(got_p.view(np.uint32), ref_p.view(np.uint32))


@pytest.mark.parametrize("window", [4, 32])
@pytest.mark.parametrize("pattern", ["random", "one-segment", "no-head",
                                     "tile-edges"])
def test_look_back_every_stop_gives_serial_fold(pattern, window):
    """Every tile t, with every predecessor j (and none) the one that has
    published P[j]: the walk stops at j or at a nearer head, and its carry
    is the serial fold's bits."""
    ntiles = 70
    v, f = _summaries(ntiles, pattern, seed=7)
    ref = _fold_loop(v, f)
    for t in range(ntiles):
        for j in range(-1, t):
            status = [(False, bool(f[i]), v[i]) for i in range(t)]
            if j >= 0:
                p = v[j] if f[j] else np.float32(ref[j] + v[j])
                status[j] = (True, bool(f[j]), p)
            walk = _look_back(status.__getitem__, t, window)
            try:
                while True:
                    next(walk)
            except StopIteration as done:
                e = np.float32(done.value)
            assert e.view(np.uint32) == ref[t].view(np.uint32), (t, j)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pattern", ["random", "one-segment", "no-head",
                                     "tile-edges"])
def test_serial_fold_equals_scalar_loop(pattern, dtype):
    v, f = _summaries(5000, pattern, seed=3)
    v = v.astype(dtype)
    v[0] = -0.0  # P[0] = 0 + -0 = +0 where tile 0 holds no head
    got = segp.serial_fold(v, f)
    ref = _fold_loop(v, f)
    assert got.dtype == dtype
    assert np.array_equal(got.view(f"u{got.itemsize}"),
                          ref.view(f"u{ref.itemsize}"))


def test_plain_takes_float64():
    prob = j_spmv.generate_problem(5000, 60, 50, iters=4, seed=9)
    f = _flags(prob.n, prob.s[:-1])
    got = segp.spmv_scan_pallas_plain(_t(prob.a).double(),
                                      _t(prob.xx).double(), _t(f), 4,
                                      items=2, threads=8, warp=4)
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


def test_source_geometry_is_the_plain_versions():
    """The tile compiled into the kernel's source is the one the plain
    version assumes (checked again against the library before a launch)."""
    import re

    from cme213_tpu_torch.ops import _kernels

    src = _kernels.SOURCES["segmented_scan"].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kTileItems"), const("kTileThreads"), const("kWarp")) \
        == segp._GEOMETRY == (segp.TILE_ITEMS, segp.TILE_THREADS, segp.WARP)
