"""The port's SpMV-scan against the benchmark's plain reference, on the CPU.

``run_spmv_scan``'s default ``auto`` path at n ≥ 2^16, where it takes the
blocked scan, against ``perfbench/reference/spmv.solve`` (float64) on
problems drawn by ``perfbench/inputs.spmv_problem``, the benchmark's own
generator; a segment that starts deep in a scan block, the case that a
float32 running sum less its value before the head loses; the count of
scans by form and the span's tag; the upload's gather of ``xx`` on the
device, the check of the gather indices, the chunk plan of its staged
copies and its plain copies on the CPU.  Imports no JAX.

Tolerances: rel L2 ≤ 1e-5 for the solves, the conformance tolerance of
``apps/spmv_scan.py`` (float32 rounding over 6 iterations reads ~1e-7);
rel L2 ≤ 1e-6 for the planted segment, whose own sums are ~1 and whose
rounding in float32 is ~1e-7 (a float32 block sum of ~4e7 less its value
before the head leaves none of its digits: error 5.9).
"""

import numpy as np
import pytest
import torch

from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.core import conformance, faults, trace
from cme213_tpu_torch.ops import segmented
from perfbench import inputs
from perfbench.reference import spmv as ref

CPU = "cpu"
#: n ≥ 2^16, so that ``auto`` takes the blocked scan; p and q keep pwtk's
#: ratio of ~53 values a segment
SHAPE = dict(n=70_000, p=1_300, q=1_299, iters=6)


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in ("CME213_FAULTS", "CME213_TUNE_CACHE",
                "CME213_CONFORMANCE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    conformance.reset()
    trace.clear_events()  # the program cache too
    yield
    conformance.reset()
    trace.clear_events()


def _problem(seed: int, **shape) -> spmv.Problem:
    d = inputs.spmv_problem(seed=seed, device=CPU, **{**SHAPE, **shape})
    return spmv.Problem(d["a"], d["s"], d["k"], d["x"], d["iters"])


def _rel_l2(want: torch.Tensor, got) -> float:
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _solve(prob: spmv.Problem, kernel: str = "auto") -> np.ndarray:
    return spmv.run_spmv_scan(prob, kernel=kernel, device=CPU)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7, 3_100_000_005])
def test_auto_solve_agrees_with_the_plain_reference(seed):
    prob = _problem(seed)
    assert segmented.scan_form(prob.n) == "blocked"
    want = ref.solve(prob.a, prob.s, prob.k, prob.x, prob.iters)
    assert _rel_l2(want, _solve(prob)) <= 1e-5


def _planted(n: int = 1 << 17, head: int = 4000, block: int = 4096):
    """Values ~1e4 before a head at ``head``, deep in the first block;
    values ~1e-2 in the segment from there to the block's end."""
    rng = np.random.default_rng(0)
    v = rng.uniform(0.5, 1.5, n).astype(np.float32)
    v[:head] *= np.float32(1e4)
    end = block
    v[head:end] *= np.float32(1e-2)
    starts = np.array([0, head, end], np.int64)
    return v, starts, (head, end)


@pytest.mark.parametrize("form", ["auto", "blocked"])
def test_a_segment_deep_in_a_block_keeps_its_digits(form):
    v, starts, (lo, hi) = _planted()
    n = v.shape[0]
    flags = segmented.head_flags_from_starts(torch.from_numpy(starts), n)
    scan = (segmented.segmented_scan if form == "auto"
            else segmented.segmented_scan_blocked)
    got = scan(torch.from_numpy(v), flags)
    want = ref.segscan(torch.from_numpy(v).double(),
                       torch.from_numpy(np.append(starts, n)))
    assert _rel_l2(want, got) <= 1e-6
    assert _rel_l2(want[lo:hi], got[lo:hi]) <= 1e-6


def test_float64_and_integer_values_keep_their_sums():
    """Float64 values sum in their own width; integer-valued float32 values
    stay exact through the float64 sums and the rounding back."""
    rng = np.random.default_rng(1)
    n = 20_000
    starts = np.sort(rng.choice(np.arange(1, n), 300, replace=False))
    starts = np.concatenate([[0], starts]).astype(np.int64)
    flags = segmented.head_flags_from_starts(torch.from_numpy(starts), n)
    ints = rng.integers(-4, 5, n).astype(np.float32)
    got = segmented.segmented_scan_blocked(torch.from_numpy(ints), flags, 512)
    exact = ref.segscan(torch.from_numpy(ints).double(),
                        torch.from_numpy(np.append(starts, n)))
    assert got.dtype == torch.float32
    assert torch.equal(got.double(), exact)
    wide = torch.from_numpy(rng.standard_normal(n))
    got64 = segmented.segmented_scan_blocked(wide, flags, 512)
    assert got64.dtype == torch.float64
    assert _rel_l2(ref.segscan(wide, torch.from_numpy(np.append(starts, n))),
                   got64) <= 1e-12


def _delta(before: dict) -> dict:
    return {k: segmented.SCANS[k] - before[k] for k in segmented.SCANS}


def test_an_auto_solve_counts_its_scans_by_form():
    """Cold, the gate's probe (``_PROBE_SHAPE``: 3 iterations through the
    blocked rung and through ``flat``, each with a program's warm-up
    iteration) and the solve's warm-up add to the counts; warm, an
    ``auto`` solve at n ≥ 2^16 adds exactly its iterations to
    ``blocked`` and nothing to ``flat``."""
    prob = _problem(5)
    probe = spmv._PROBE_SHAPE["iters"]
    before = dict(segmented.SCANS)
    _solve(prob)
    assert _delta(before) == {"flat": 1 + probe,
                              "blocked": 1 + probe + 1 + prob.iters}
    before = dict(segmented.SCANS)
    _solve(prob)
    assert _delta(before) == {"flat": 0, "blocked": prob.iters}


def test_below_the_threshold_auto_counts_flat():
    prob = _problem(5, n=20_000, p=400, q=399)
    assert segmented.scan_form(prob.n) == "flat"
    _solve(prob)  # warms the program
    before = dict(segmented.SCANS)
    _solve(prob)
    assert _delta(before) == {"flat": prob.iters, "blocked": 0}


@pytest.mark.parametrize("device,dtype,rung", [
    ("cpu", torch.float32, "auto"), ("cpu", torch.float64, "auto"),
    ("cuda", torch.float64, "auto"), ("cuda", torch.float32, "pallas-fused")])
def test_auto_keeps_the_torch_dispatch_but_in_float32_on_a_card(
        monkeypatch, device, dtype, rung):
    """``auto`` serves the torch dispatch on the CPU in either precision
    and on a CUDA device in float64 (the kernel takes float32 only): warm,
    a solve at n ≥ 2^16 adds its iterations to ``blocked``.  In float32 on
    a CUDA device it serves the fused kernel and scans nothing in torch.
    The ladder is decided as on ``device``, over CPU tensors (the kernel
    rungs run their plain versions)."""
    real = spmv.ladder
    monkeypatch.setattr(
        spmv, "ladder", lambda kernel, _dev, plain_fallback=False,
        dtype=torch.float32: real(kernel, torch.device(device),
                                  plain_fallback, dtype))
    prob = _problem(5)
    spmv.run_spmv_scan(prob, dtype=dtype, device=CPU)  # warms the program
    before = dict(segmented.SCANS)
    spmv.run_spmv_scan(prob, dtype=dtype, device=CPU)
    blocked = prob.iters if rung == "auto" else 0
    assert _delta(before) == {"flat": 0, "blocked": blocked}
    assert trace.events("served")[-1]["rung"] == rung


@pytest.mark.parametrize("kernel,n,form", [
    ("auto", 70_000, "blocked"), ("auto", 20_000, "flat"),
    ("flat", 70_000, "flat"), ("blocked", 20_000, "blocked")])
def test_the_run_span_names_the_scan_form(kernel, n, form):
    prob = _problem(9, n=n, p=n // 50, q=n // 50 - 1)
    _solve(prob, kernel)
    (end,) = [e for e in trace.events("span-end")
              if e["span"] == "spmv_scan.run"]
    assert end["kernel"] == kernel and end["scan"] == form


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_upload_gathers_xx_bit_for_bit(dtype):
    prob = _problem(4, n=20_000, p=400, q=399)
    a, xx, flags, starts = spmv.problem_tensors(prob, dtype, CPU)
    assert torch.equal(xx, torch.from_numpy(prob.xx).to(dtype))
    assert torch.equal(a, torch.from_numpy(prob.a).to(dtype))


CHUNK = spmv.STAGE_CHUNK_BYTES // 4


@pytest.mark.parametrize("numel", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1,
                                   5 * CHUNK + 12_345])
def test_the_staging_chunk_plan_covers_every_element_once(numel):
    plan = spmv.chunk_plan(numel, CHUNK)
    assert len(plan) == -(-numel // CHUNK)
    assert all(0 < hi - lo <= CHUNK for lo, hi in plan)
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in plan]
                             + [np.arange(0)])
    np.testing.assert_array_equal(covered, np.arange(numel))


@pytest.mark.parametrize("host,dtype", [(np.float32, torch.float32),
                                        (np.float64, torch.float32),
                                        (np.float32, torch.float64),
                                        (np.float64, torch.float64)])
def test_the_cpu_upload_is_the_plain_copy_bit_for_bit(host, dtype):
    """On the CPU ``problem_tensors`` is ``torch.from_numpy(...).to``, bit
    for bit, a float64 host array solved in float32 included, and every
    array takes the pageable path whatever its size."""
    prob = _problem(4, n=2 * CHUNK, p=400, q=399)
    rng = np.random.default_rng(5)
    prob.a = rng.uniform(-1, 1, prob.n).astype(host)
    prob.x = rng.uniform(-1, 1, prob.q).astype(host)
    before = dict(spmv.UPLOADS)
    got = spmv.problem_tensors(prob, dtype, CPU)
    starts = torch.from_numpy(prob.s[:-1].astype(np.int64))
    x = torch.from_numpy(prob.x).to(CPU, dtype)
    k = torch.from_numpy(prob.k)
    want = (torch.from_numpy(prob.a).to(CPU, dtype),
            torch.index_select(x, 0, k),
            segmented.head_flags_from_starts(starts, prob.n), starts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.numpy().tobytes() == w.numpy().tobytes()
    assert spmv.UPLOADS["pageable"] - before["pageable"] == 4
    assert spmv.UPLOADS["staged"] == before["staged"]
    assert spmv.UPLOADS["staged_bytes"] == before["staged_bytes"]


@pytest.mark.parametrize("bad", [-1, 399])
def test_validate_refuses_a_gather_index_out_of_range(bad):
    prob = _problem(4, n=20_000, p=400, q=399)
    prob.validate()
    prob.k[1234] = bad
    with pytest.raises(ValueError, match="gather index"):
        prob.validate()
    prob.validate(gather=False)  # the upload checks k
    with pytest.raises(ValueError, match="gather index"):
        spmv.problem_tensors(prob, device=CPU)


@pytest.mark.parametrize("bad", [-1, 399])
def test_a_solve_refuses_a_gather_index_out_of_range(bad):
    """``run_spmv_scan`` leaves ``k`` to the upload's check, on the
    device, and raises as the loader's check does, before any rung."""
    prob = _problem(4, n=20_000, p=400, q=399)
    prob.k[0] = bad
    with pytest.raises(ValueError, match="gather index"):
        spmv.run_spmv_scan(prob, device=CPU)
    assert not [e for e in trace.events("span-begin")
                if e["span"] == "spmv_scan.run"]
