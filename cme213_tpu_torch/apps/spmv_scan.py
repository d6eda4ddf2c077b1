"""hw_final workload: iterated gather-multiply-segmented-scan "SpMV" engine.

Counterpart of ``cme213_tpu/apps/spmv_scan.py``: one device, or a mesh of
them (``run_spmv_scan_distributed``).  N iterations of

    a ← segmented_inclusive_scan(a · xx)        (xx[l] = x[k[l]], precomputed)

over segments delimited by ``s`` (p entries, ``s[0]=0``, strictly
increasing, ``s[p-1]=n`` — the end-sentinel convention of the validating
loader ``aux/mp1-util.h:81-169``), the reference's ``fp.cu``.  The scan is
one of the plain torch scans of ``ops/segmented.py`` or the hand-written
CUDA kernel of ``ops/segmented_pallas.py`` (``--kernel=pallas`` /
``pallas-fused``, the reference's names).

Problem file formats match the reference loader (fp.cu:91-107):
``a.txt`` = ``n p q N`` then ``a`` (n floats), ``s`` (p ints), ``k`` (n
ints); ``x.txt`` = q floats — whitespace separated.

The synthetic generator mirrors ``aux/readMM.py``'s construction (random
sorted segment starts, random gather indices, uniform(−1,1) x, N ∈ [5,100]),
parameterized by (n, p, q) so problems shaped like the Bell/Garland 2008
SuiteSparse suite can be produced without the matrix files.

Runs on ``cuda`` unless the caller passes ``device="cpu"``
(``--device=cpu``); with no device and no CUDA it raises.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..core import PhaseTimer, check_op, resolve_device, span
from ..core.tune import dtype_name
from ..ops.segmented import (head_flags_from_starts, scan_form,
                             scan_peak_bytes, segmented_scan,
                             segmented_scan_blocked,
                             segmented_scan_dense, segmented_scan_flat,
                             validate_segments)
from ..ops.segmented_pallas import segmented_scan_pallas, spmv_scan_pallas
from ..verify import golden
from ..verify.checkers import (l2_distance, relative_l2_error,
                               relative_linf_error)

#: kernel names accepted by ``run_spmv_scan`` / the CLI ``--kernel=`` flag
KERNELS = ("auto", "flat", "blocked", "pallas", "pallas-fused", "dense")


@dataclass
class Problem:
    a: np.ndarray        # (n,) float values
    s: np.ndarray        # (p,) int segment starts, with end sentinel n
    k: np.ndarray        # (n,) int gather indices into x
    x: np.ndarray        # (q,) float
    iters: int

    @property
    def n(self) -> int:
        return self.a.shape[0]

    @property
    def p(self) -> int:
        return self.s.shape[0]

    @property
    def q(self) -> int:
        return self.x.shape[0]

    def validate(self) -> None:
        """Loader invariants (aux/mp1-util.h:128-148); the gather indices
        by their extremes, two passes that make no temporaries."""
        if self.s[-1] != self.n:
            raise ValueError("last segment entry must equal n (end sentinel)")
        validate_segments(self.s[:-1], self.n)
        if self.k.size and (self.k.min() < 0 or self.k.max() >= self.q):
            raise ValueError("gather index out of range")

    @property
    def xx(self) -> np.ndarray:
        """Gather-flattened x (the fp.cu:124-125 coalescing precompute)."""
        return self.x[self.k]


# ------------------------------------------------------------------ io

def load_problem(a_path: str, x_path: str,
                 use_native: bool = True) -> Problem:
    """Parse the reference's a.txt/x.txt problem format (fp.cu:81-107).

    With ``use_native``, the native C++ tokenizer (``native.spmv_read``,
    ``native.read_floats``) parses; where the native library cannot be
    built or loaded, or cannot open a file, the pure-Python tokenizer
    serves instead, as in the JAX package: both give the same arrays.  Each
    attempt is a ``spmv_scan.load`` span whose ``tokenizer`` tag
    (``native`` or ``python``) says which parsed; a native attempt that
    fell back ends with an ``error`` tag."""
    if use_native:
        from ..core.errors import FrameworkError

        try:
            with span("spmv_scan.load", tokenizer="native"):
                from .. import native

                a, s, k, q, iters = native.spmv_read(a_path)
                x = native.read_floats(x_path, q)
                prob = Problem(a, s, k, x, iters)
                prob.validate()
                return prob
        except (OSError, FrameworkError):
            pass  # no or broken toolchain, or unreadable natively
    with span("spmv_scan.load", tokenizer="python"):
        with open(a_path) as f:
            tok_a = f.read().split()
        n, p, q, iters = (int(v) for v in tok_a[:4])
        rest = tok_a[4:]
        a = np.array(rest[:n], dtype=np.float32)
        s = np.array(rest[n:n + p], dtype=np.int32)
        k = np.array(rest[n + p:n + p + n], dtype=np.int32)
        x = np.loadtxt(x_path, dtype=np.float32).reshape(-1)[:q]
        prob = Problem(a, s, k, x, iters)
        prob.validate()
        return prob


def save_problem(prob: Problem, a_path: str, x_path: str) -> None:
    with open(a_path, "w") as f:
        f.write(f"{prob.n} {prob.p} {prob.q} {prob.iters}\n")
        for arr in (prob.a, prob.s, prob.k):
            f.write(" ".join(str(v) for v in arr.tolist()) + "\n")
    with open(x_path, "w") as f:
        f.write(" ".join(str(v) for v in prob.x.tolist()) + "\n")


def generate_problem(n: int, p: int, q: int, iters: int | None = None,
                     seed: int = 0) -> Problem:
    """readMM.py-style synthetic instance: sorted random segment starts with
    0/n sentinels, random gather indices, uniform(−1,1) values.

    ``x`` is scaled by the map's growth so that the iteration stays finite
    in f32 over up to 100 iterations: each step applies the fixed linear map
    b → segscan(b·xx), and unit-scale draws overflow within tens of
    iterations on long segments.  The growth comes from a short f64 power
    iteration; segment structure, op counts and timings are untouched.
    """
    rng = np.random.default_rng(seed)
    interior = np.sort(rng.choice(np.arange(1, n), size=p - 2, replace=False))
    s = np.concatenate([[0], interior, [n]]).astype(np.int32)
    k = rng.integers(0, q, size=n, dtype=np.int32)
    a = rng.uniform(-1, 1, size=n).astype(np.float32)
    x = rng.uniform(-1, 1, size=q).astype(np.float32)
    if iters is None:
        iters = int(rng.integers(5, 101))
    seg_lens = np.diff(s)  # s carries the end sentinel n as its last entry

    def segscan64(v):
        cs = np.cumsum(v)
        offsets = np.concatenate([[0.0], cs[s[1:-1] - 1]])
        return cs - np.repeat(offsets, seg_lens)

    xx64 = x.astype(np.float64)[k]
    b = a.astype(np.float64)
    growth = 1.0
    for _ in range(min(8, iters)):
        prev = np.abs(b).max()
        b = segscan64(b * xx64)
        cur = np.abs(b).max()
        if prev > 0 and cur > 0:
            growth = cur / prev  # last-step ratio: the aligned radius
            b /= cur             # keep the power iteration itself finite
    if np.isfinite(growth) and growth > 0:
        x = (x / growth).astype(np.float32)
    return Problem(a, s, k, x, iters)


def pad_problem(prob: Problem, n_to: int) -> Problem:
    """Zero-pad a problem to ``n_to`` values with the tail quarantined in
    its own segment: padded values are 0·x[0] and never combine into a
    real segment, so the first ``n`` outputs equal the unpadded solve."""
    n = prob.n
    if n_to < n:
        raise ValueError(f"cannot pad n={n} down to {n_to}")
    if n_to == n:
        return prob
    a = np.zeros(n_to, dtype=prob.a.dtype)
    a[:n] = prob.a
    k = np.zeros(n_to, dtype=prob.k.dtype)
    k[:n] = prob.k
    s = np.concatenate([prob.s[:-1], [n, n_to]]).astype(prob.s.dtype)
    return Problem(a, s, k, prob.x, prob.iters)


# ------------------------------------------------------------------ engine

_SCAN_KERNELS = {
    "auto": segmented_scan,             # size-threshold dispatch
    "flat": segmented_scan_flat,        # O(n·log n) log-sweep
    "blocked": segmented_scan_blocked,  # O(n) 3-phase block decomposition
}


def _scan_fn(scan: str, block_size: int | None):
    """The scan callable for a kernel name, with the blocked form's block
    size pinned when the caller chose one."""
    if block_size is None or scan == "flat":
        return _SCAN_KERNELS[scan]
    if scan == "blocked":
        return lambda v, f: segmented_scan_blocked(v, f, block_size)
    return lambda v, f: segmented_scan(v, f, block_size=block_size)


def _scan_tag(rung: str, n: int) -> dict:
    """``{"scan": form}`` for a rung that runs a plain torch scan: the form
    ``auto`` dispatches at ``n``, or the one asked for; ``{}`` else."""
    if rung == "auto":
        return {"scan": scan_form(n)}
    return {"scan": rung} if rung in ("flat", "blocked") else {}


def _iterate(a, xx, flags, iters: int, scan: str = "auto",
             block_size: int | None = None):
    """``iters`` × ``a ← scan(a·xx)`` with a plain torch scan, along the
    last dimension (leading dimensions are independent lanes)."""
    scan_fn = _scan_fn(scan, block_size)
    for _ in range(iters):
        a = scan_fn(a * xx, flags)
    return a


def _iterate_pallas_unfused(a, xx, flags, iters: int):
    """Per-iteration kernel scan (B6) with the multiply left to torch — one
    extra round trip through device memory per iteration against the fused
    kernel (B7); kept as the point that isolates what the fusion buys."""
    for _ in range(iters):
        a = segmented_scan_pallas(a * xx, flags)
    return a


def _iterate_dense(a, xx, starts, iters: int, max_len: int):
    """Dense strawman loop (``ops.segmented.segmented_scan_dense``)."""
    for _ in range(iters):
        a = segmented_scan_dense(a * xx, starts, max_len)
    return a


def bytes_moved(n: int, iters: int, elem: int = 4) -> int:
    """Useful bytes of a solve (``core/roofline.spmv_scan_cost``): per
    iteration read the value vector, the gathered ``xx`` vector and the
    int32 head flags, write the value vector — ``(3·elem + 4)·n``.  Every
    kernel is quoted against this count, so their GB/s compare."""
    from ..core.roofline import spmv_scan_cost

    dtype = {1: "u8", 2: "f16", 4: "f32", 8: "f64"}[elem]
    return spmv_scan_cost(n, iters, dtype=dtype).nbytes


def _build_runner(kernel: str, iters: int, max_len: int | None = None,
                  block_size: int | None = None):
    """Runner ``fn(a, xx, flags, starts)`` executing all ``iters``
    iterations with the named kernel; kernels that do not need ``starts``
    (everything but ``dense``) ignore it.  No runner modifies ``a``."""
    if kernel == "pallas-fused":
        return lambda a, xx, flags, starts: spmv_scan_pallas(
            a, xx, flags, iters)
    if kernel == "pallas":
        return lambda a, xx, flags, starts: _iterate_pallas_unfused(
            a, xx, flags, iters)
    if kernel in _SCAN_KERNELS:
        return lambda a, xx, flags, starts: _iterate(
            a, xx, flags, iters, scan=kernel, block_size=block_size)
    if kernel == "dense":
        return lambda a, xx, flags, starts: _iterate_dense(
            a, xx, starts, iters, max_len)
    raise ValueError(f"unknown kernel {kernel!r} ({'|'.join(KERNELS)})")


def problem_tensors(prob: Problem, dtype=torch.float32, device=None):
    """``(a, xx, flags, starts)`` of ``prob`` on ``device`` (``None``
    means ``cuda``): the values and ``xx`` in ``dtype``, int32 head flags,
    int64 segment starts.  ``xx`` is gathered on the device from ``x`` and
    ``k`` (``Problem.xx``'s values, bit for bit): the upload moves ``k``
    in place of ``xx``, as many bytes, and the host does no gather."""
    dev = resolve_device(device)
    starts = torch.from_numpy(prob.s[:-1].astype(np.int64)).to(dev)
    x = torch.from_numpy(prob.x).to(dev, dtype)
    return (torch.from_numpy(prob.a).to(dev, dtype),
            torch.index_select(x, 0, torch.from_numpy(prob.k).to(dev)),
            head_flags_from_starts(starts, prob.n), starts)


#: demotion ladder per requested kernel, the JAX package's: the kernel
#: rungs degrade to the blocked O(n) torch scan, then to the flat
#: log-sweep; the torch rungs degrade straight to flat
FALLBACK_LADDERS = {
    "pallas-fused": ("pallas-fused", "blocked", "flat"),
    "pallas": ("pallas", "blocked", "flat"),
    "auto": ("auto", "flat"),
    "blocked": ("blocked", "flat"),
    "dense": ("dense", "flat"),
    "flat": ("flat",),
}

#: a kernel's ladder on a CUDA device: kernel rungs only, B7 demoting to
#: B6 (``core/resilience.allows_plain_rungs``)
KERNEL_LADDERS = {
    "pallas-fused": ("pallas-fused", "pallas"),
    "pallas": ("pallas",),
}


def ladder(kernel: str, device, plain_fallback: bool = False) -> tuple:
    """The rungs ``run_spmv_scan`` tries for ``kernel`` on ``device``.

    On the CPU, and for a torch scan asked for by name, they are
    ``FALLBACK_LADDERS[kernel]``.  A kernel on a CUDA device demotes only
    to the other kernel (``KERNEL_LADDERS``) and, when the caller asks for
    a plain rung (``plain_fallback``), then to ``flat``, the gate's
    reference.  Not to ``blocked``, though it does not cancel (it sums
    float32 blocks in float64, ``ops/segmented.segmented_scan_blocked``):
    one plain rung behind the kernels is enough, and ``flat`` is the one
    the gate holds every other rung to, so a demoted kernel serves what it
    served before."""
    from ..core.resilience import allows_plain_rungs

    if kernel not in KERNEL_LADDERS or allows_plain_rungs(device):
        return FALLBACK_LADDERS[kernel]
    rungs = KERNEL_LADDERS[kernel]
    return rungs + ("flat",) if plain_fallback else rungs

#: conformance tolerance per rung against the ``flat`` reference scan
#: (probe rel-L2).  Every other kernel associates the segment sums
#: differently (the blocked decomposition, the kernel's tile carries, the
#: dense rows), so bitwise is not its contract; a wrong kernel lands
#: orders of magnitude out.
CONFORMANCE_REL_L2 = {
    "flat": 0.0,
    "blocked": 1e-5,
    "pallas": 1e-5,
    "pallas-fused": 1e-5,
    "dense": 1e-5,
}

#: canonical probe instance for the conformance gate: large enough to
#: cross tiles and blocks in every kernel, small enough to be negligible
_PROBE_SHAPE = dict(n=2048, p=48, q=47, iters=3, seed=1234)
_PROBE_PROBLEM: "Problem | None" = None


def _probe_problem() -> Problem:
    global _PROBE_PROBLEM
    if _PROBE_PROBLEM is None:
        _PROBE_PROBLEM = generate_problem(**_PROBE_SHAPE)
    return _PROBE_PROBLEM


def _program(rung: str, n: int, iters: int, dtype, device, *, warm_args,
             p: int | None = None, max_len: int | None = None,
             block_size: int | None = None):
    """The cached program of ``rung`` for ``(n{n}/i{iters}, dtype,
    device)`` (``core/programs.get``): ``fn(a, xx, flags, starts)`` runs
    all ``iters`` iterations.

    On a miss the build loads the scan kernel's library for a kernel rung
    on a CUDA device, and the warm-up runs one iteration on
    ``warm_args()`` (the caller's tensors) behind a rung-named
    ``check_op`` barrier, so a build or launch failure surfaces there.  A
    kernel rung's runner carries ``staged_cost`` for the attribution
    check: its launches' reads of values, ``xx`` (fused) and flags, writes
    of the values, and the look-back's workspace words."""
    from ..core import check_op, programs, roofline
    from ..core.platform import resolve_device
    from ..ops import _kernels
    from ..ops import segmented_pallas as segp

    dev = resolve_device(device)
    static = {"iters": iters}
    if rung not in ("auto", "blocked"):
        block_size = None  # a block size only shapes the torch scans
    if block_size is not None:
        static["block_size"] = block_size
    if rung == "dense":
        static.update(p=p, max_len=max_len)

    def build():
        if rung in ("pallas", "pallas-fused") and dev.type == "cuda":
            _kernels.library("segmented_scan")
        fn = _build_runner(rung, iters, max_len=max_len,
                           block_size=block_size)
        if rung in ("pallas", "pallas-fused"):
            fused = rung == "pallas-fused"

            def staged(a, xx, flags, starts):
                elem = a.element_size()
                tiles = -(-n // segp.TILE)
                # fused: read a, xx, flags, write a; unfused: the multiply
                # is a torch op (read a, xx, write w), then the kernel
                # reads w and flags and writes a
                per_it = n * ((3 * elem + 4) if fused else (5 * elem + 4))
                per_it += tiles * 4 * 4  # workspace words, written and read
                return roofline.Cost(per_it * iters, 2 * n * iters)
            fn.staged_cost = staged
        return fn

    def warm(fn):
        check_op(f"spmv_scan.{rung}",
                 _build_runner(rung, 1, max_len=max_len,
                               block_size=block_size)(*warm_args()))

    return programs.get(
        "spmv_scan", rung, f"n{n}/i{iters}", build, dtype=dtype_name(dtype),
        device=dev, warm=warm,
        cost=roofline.spmv_scan_cost(n, iters, dtype=dtype),
        probe=warm_args, **static)


def _conformance_gate(n: int, dtype, device):
    """``gate(rung) -> bool`` for ``with_fallback``: the first use of a
    non-reference rung (per process × dtype × device) runs the canonical
    probe through that rung and through ``flat``, compares to the rung's
    declared tolerance and caches the verdict (``core/conformance.py``).
    ``auto`` is resolved to the scan the size dispatch picks for ``n``
    (``ops.segmented.scan_form``), so the probed kernel is the serving
    kernel."""
    from ..core import conformance
    from ..core.platform import build_identity, resolve_device

    dev = resolve_device(device)

    def gate(rung: str) -> bool:
        kernel = scan_form(n) if rung == "auto" else rung
        if kernel == "flat":
            return True  # the reference rung needs no probe
        prob = _probe_problem()
        probe = {}  # the probe's tensors, uploaded only on a verdict miss

        def probe_args():
            if not probe:
                probe["args"] = problem_tensors(prob, dtype, dev)
            return probe["args"]

        def run(k):
            return lambda: _program(
                k, prob.n, prob.iters, dtype, dev, p=prob.p,
                max_len=int(np.diff(prob.s).max()),
                warm_args=probe_args)(*probe_args())

        return conformance.check(
            "spmv_scan", kernel,
            shape_class=f"{dtype_name(dtype)}/{build_identity(dev)}",
            candidate=run(kernel), reference=run("flat"),
            rel_l2=CONFORMANCE_REL_L2[kernel]).ok

    return gate


def _bucket_gate(n_to: int, kernel: str, dtype, device) -> bool:
    """One verdict per (bucket, kernel, dtype, device): prove pad-and-mask
    exact before serving from the bucket.  A probe problem inside the
    bucket is solved padded-then-sliced and unpadded; the two must be
    bitwise equal (``pad_problem``'s quarantined tail).  A failing probe
    keeps the caller on its exact shape."""
    from ..core import conformance
    from ..core.platform import build_identity, resolve_device

    dev = resolve_device(device)
    n_from = max(2, (3 * n_to) // 4)
    if n_from >= n_to:
        return False  # bucket too small to pad into
    made: dict = {}

    def probe() -> Problem:
        # made on a verdict miss only: the probe is three quarters of the
        # bucket, seconds of host work at pwtk's 2^24, which a serving
        # batch would otherwise pay on every cached verdict
        if not made:
            made["p"] = generate_problem(n_from, p=max(3, min(9, n_from // 2)),
                                         q=7, iters=2, seed=99)
        return made["p"]

    def solve(pr: Problem):
        args = problem_tensors(pr, dtype, dev)
        fn = _program(kernel, pr.n, pr.iters, dtype, dev, p=pr.p,
                      max_len=int(np.diff(pr.s).max()),
                      warm_args=lambda: args)
        return fn(*args)

    return conformance.check(
        "spmv_scan.pad", kernel,
        shape_class=f"n{n_to}/{dtype_name(dtype)}/{build_identity(dev)}",
        candidate=lambda: solve(pad_problem(probe(), n_to))[:n_from],
        reference=lambda: solve(probe()), rel_l2=0.0).ok


def run_spmv_scan(prob: Problem, timer: PhaseTimer | None = None,
                  dtype=torch.float32, kernel: str = "auto",
                  fallback: bool = True, canonical: bool = False,
                  plain_fallback: bool = False,
                  device=None) -> np.ndarray:
    """Device pipeline (fp.cu:154-190): upload, N × (multiply + segmented
    scan), download; prints the spec-mandated timing line (Final.pdf §4.2
    format, fp.cu:190).

    ``kernel``:

    - "auto" (default): the flat log-sweep below ``scan_threshold()``
      elements, the blocked O(n) scan above;
    - "flat"/"blocked": force the respective torch scan;
    - "pallas-fused": the hand-written kernel with the multiply fused into
      the scan's load (B7, ``ops/segmented_pallas.spmv_scan_pallas``);
    - "pallas": the same kernel per iteration with the multiply left to
      torch (B6, ``segmented_scan_pallas``);
    - "dense": the per-segment dense-matrix strawman.

    With ``fallback`` (default) the rungs of ``ladder(kernel, device,
    plain_fallback)`` run behind ``core/resilience.with_fallback`` and the
    conformance gate (``_conformance_gate``): an injected fault
    (``fail:spmv_scan.<rung>``) or a diverging probe demotes the rung.  On
    a CUDA device a kernel demotes only to the other kernel, and to
    ``flat`` when ``plain_fallback`` asks for it; a ladder whose rungs are
    all refused raises.  A kernel that cannot build or launch raises
    (``KernelError``) and never demotes.  ``fallback=False`` runs the
    requested kernel alone, ungated (bench rows are data).

    Each rung's program comes from the process-wide cache: a miss builds
    it and runs one untimed iteration (the kernel's build and the device's
    set-up stay out of the timed phase); a hit does neither.

    With ``canonical``, the problem is snapped to its power-of-two bucket
    first (``core/programs.canonical_size``): zero-padded with a
    quarantined tail segment (``pad_problem``) and the output sliced back.
    Each (bucket, kernel, dtype, device) is probed once (``_bucket_gate``:
    padded-then-sliced bitwise equal to unpadded); a failing probe keeps
    the exact shape.

    The call is a ``spmv_scan.solve`` host range on the profiler's clock
    (``core/trace.host_range``), holding the ranges ``spmv_scan.validate``,
    ``spmv_scan.upload`` (``problem_tensors``) and ``spmv_scan.download``
    (the copy of the answer to the host) and each attempt's
    ``spmv_scan.run`` span (tagged ``scan=`` with the form a torch rung
    runs, ``ops/segmented.scan_form``), so that the Chrome trace of a
    profiled sweep (``bench/run_all`` under ``CME213_PROFILE_DIR``) names
    a solve's host work on the card's timeline.
    """
    from ..core import programs, roofline, span, with_fallback
    from ..core.trace import host_range

    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} ({'|'.join(KERNELS)})")
    with host_range("spmv_scan.solve"):
        with host_range("spmv_scan.validate"):
            prob.validate()
        dev = resolve_device(device)
        if canonical:
            n_to = programs.canonical_size(prob.n)
            if n_to != prob.n and _bucket_gate(n_to, kernel, dtype, dev):
                out = run_spmv_scan(pad_problem(prob, n_to), timer=timer,
                                    dtype=dtype, kernel=kernel,
                                    fallback=fallback,
                                    plain_fallback=plain_fallback,
                                    device=dev)
                return out[:prob.n]
        with host_range("spmv_scan.upload"):
            args = problem_tensors(prob, dtype, dev)
        max_len = int(np.diff(prob.s).max())
        timer = timer or PhaseTimer()
        shape_class = f"n{prob.n}/i{prob.iters}"
        cost = roofline.spmv_scan_cost(prob.n, prob.iters, dtype=dtype)

        def attempt(rung: str):
            def thunk():
                runner = _program(rung, prob.n, prob.iters, dtype, dev,
                                  p=prob.p, max_len=max_len,
                                  warm_args=lambda: args)
                with span("spmv_scan.run", kernel=rung, n=prob.n,
                          iters=prob.iters, shape_class=shape_class,
                          **_scan_tag(rung, prob.n)) as sp:
                    sp.roofline(cost.nbytes, cost.flops)
                    with timer.phase("spmv_scan") as ph:
                        out = runner(*args)
                        ph.block(out)
                return out
            return thunk

        rungs = ladder(kernel, dev, plain_fallback) if fallback else (kernel,)
        gate = _conformance_gate(prob.n, dtype, dev) if fallback else None
        res = with_fallback("spmv_scan", [(r, attempt(r)) for r in rungs],
                            gate=gate)
        if res.demoted:
            print(f"spmv_scan: kernel {kernel!r} demoted to {res.rung!r} "
                  f"(failed: {', '.join(f.rung for f in res.failures)})")
        ms = timer.last_ms("spmv_scan")
        print(f"The running time of my code for {prob.iters} iterations "
              f"is: {ms} milliseconds.")
        with host_range("spmv_scan.download"):
            return res.value.cpu().numpy()


def run_spmv_scan_batched(probs: list[Problem], kernel: str = "flat",
                          dtype=torch.float32,
                          device=None) -> list[np.ndarray]:
    """Serve B same-class problems (equal ``n`` and ``iters``) as one
    stacked solve on ``device`` (default ``cuda``), the path the serving
    layer batches same-shape requests through: ``_iterate`` on (B, n)
    stacks (the JAX package's ``_iterate_batched``), the scan along the
    last dimension, so lanes never mix and the blocked scan's blocks stay
    where a lane's own solve puts them.  Segment structure may differ
    between lanes.  Only the torch scans batch (``flat``, ``blocked``,
    ``auto``), at the scans' default block size; each result equals its
    serial ``_iterate`` solve bit for bit.  The program comes from
    ``core/programs`` (its warm-up, one iteration on zeros, behind
    ``check_op``), and the solve runs under the ``spmv_scan_batched.run``
    span."""
    from ..core import programs, span

    if kernel not in _SCAN_KERNELS:
        raise ValueError(f"batched serving uses the torch scans "
                         f"{tuple(_SCAN_KERNELS)}, not {kernel!r}")
    if not probs:
        return []
    n, iters = probs[0].n, probs[0].iters
    for p in probs:
        p.validate()
        if (p.n, p.iters) != (n, iters):
            raise ValueError(
                f"batch mixes shape classes: n{p.n}/i{p.iters} vs "
                f"n{n}/i{iters}")
    dev = resolve_device(device)
    b = len(probs)
    a = torch.from_numpy(np.stack([p.a for p in probs])).to(dev, dtype)
    xx = torch.from_numpy(np.stack([p.xx for p in probs])).to(dev, dtype)
    # head flags in one scatter on the device: the lanes' starts, offset
    # by lane into the flat (B·n) flags, go up as one int64 vector
    heads = np.concatenate([np.asarray(p.s[:-1], np.int64) + i * n
                            for i, p in enumerate(probs)])
    flags = torch.zeros(b * n, dtype=torch.int32, device=dev)
    flags[torch.from_numpy(heads).to(dev)] = 1
    flags = flags.view(b, n)
    # the batch width shapes the program, so it rides in the shape class
    shape_class = f"n{n}/i{iters}/b{b}"

    def build():
        return lambda a, xx, flags: _iterate(a, xx, flags, iters,
                                             scan=kernel)

    def warm(fn):
        z = torch.zeros(b, n, dtype=dtype, device=dev)
        check_op(f"spmv_scan_batched.{kernel}", _iterate(
            z, z, torch.zeros(b, n, dtype=torch.int32, device=dev), 1,
            scan=kernel))

    runner = programs.get("spmv_scan_batched", kernel, shape_class, build,
                          dtype=dtype_name(dtype), device=dev, warm=warm,
                          iters=iters, batch=b)
    with span("spmv_scan_batched.run", kernel=kernel,
              shape_class=shape_class) as sp:
        out = runner(a, xx, flags)
        sp.block(out)
    out = out.cpu().numpy()
    return [out[i] for i in range(b)]


def spmv_chunk_bytes(n: int, p: int, elem: int = 4,
                     kernel: str = "auto") -> int:
    """Device bytes of a chunk of ``run_spmv_scan_checkpointed`` with the
    torch scan ``kernel``, counted from ``_iterate``: the chunk's input
    values, the previous iteration's (alive beside them from the second
    iteration on), ``xx`` and the product (``elem`` bytes each), the int32
    head flags, the int64 segment starts (``p - 1`` of them) and the
    scan's own peak (``ops/segmented.scan_peak_bytes``, the new values
    included)."""
    return (4 * n * elem + 4 * n + 8 * (p - 1)
            + scan_peak_bytes(n, elem, kernel))


def run_spmv_scan_checkpointed(prob: Problem, path: str, every: int = 0,
                               kernel: str = "auto", dtype=torch.float32,
                               max_retries: int = 1,
                               device=None) -> np.ndarray:
    """Long-solve form of the engine: the N iterations run on ``device``
    (default ``cuda``) in checkpointed chunks of ``every``, with a
    finiteness guard on each chunk.  ``kernel`` is one of the torch scans
    (``auto``, ``flat``, ``blocked``).

    A NaN blow-up (``CME213_FAULTS=nan:spmv_scan`` or real) rolls back to
    the last good checkpoint and retries the chunk; a killed process
    resumes from ``path``.  Chunking is deterministic, so an interrupted
    and resumed solve equals an uninterrupted one with the same scan bit
    for bit.  The first chunk is preflighted (``core/admission.admit``)
    at ``spmv_chunk_bytes``, and a problem over the budget is refused
    with ``AdmissionError`` before any allocation; a chunk that dies
    RESOURCE (``CME213_FAULTS=oom:spmv_scan_chunk``) is halved and retried
    from the last checkpoint.  Each chunk length's program comes
    from ``_program`` (cached: a resumed or retried chunk of a length seen
    before is a lookup).  Returns the final values on the host.
    """
    from ..core import admission
    from ..core.checkpoint import run_with_checkpoints
    from ..core.numerics import ConvergenceTracker, host_array
    from ..core.resilience import all_finite

    if kernel not in _SCAN_KERNELS:
        raise ValueError(f"checkpointed runs use the torch scans "
                         f"{tuple(_SCAN_KERNELS)}, not {kernel!r}")
    prob.validate()
    dev = resolve_device(device)
    admission.admit("spmv_scan", spmv_chunk_bytes(
        prob.n, prob.p, torch.finfo(dtype).bits // 8, kernel), dev)
    a0, xx, flags, starts = problem_tensors(prob, dtype, dev)

    def step(state, k):
        a = torch.as_tensor(state).to(dev, dtype)
        fn = _program(kernel, prob.n, k, dtype, dev, p=prob.p,
                      warm_args=lambda: (a, xx, flags, starts))
        return fn(a, xx, flags, starts)

    # the iterated gather·multiply is not a decaying solve and may plateau,
    # so only a residual flat across many chunks reads as STALLED
    out = run_with_checkpoints(step, a0, prob.iters, path,
                               every=every or prob.iters, guard=all_finite,
                               op="spmv_scan", max_retries=max_retries,
                               tracker=ConvergenceTracker(
                                   "spmv_scan", stall_epochs=8))
    return host_array(out)


def run_spmv_scan_distributed(prob: Problem, mesh, dtype=torch.float32,
                              timer: PhaseTimer | None = None) -> np.ndarray:
    """Mesh-parallel pipeline: the value sequence is cut over the mesh's
    first axis and each iteration runs the multi-device segmented scan
    (``dist/scan.py``).  The carry combine is conformance-gated
    (``dist/scan.make_iterated_sharded_scan_gated``): ``ring`` demotes to
    ``gather`` if its probe diverges.  The per-shard scan keeps the
    flat/blocked size dispatch.  Pads to a shard multiple with
    zero-valued, own-segment tail elements (they never touch a real
    segment).  One untimed iteration runs first; the timed phase is
    "spmv_scan_distributed"."""
    from ..dist.scan import make_iterated_sharded_scan_gated, unshard_1d

    prob.validate()
    a, xx, flags, n = _shard_problem(prob, mesh, dtype)
    iterate, _ = make_iterated_sharded_scan_gated(mesh)
    timer = timer or PhaseTimer()
    for s in _own(iterate(a, xx, flags, 1)):
        check_op("spmv_scan.distributed", s)
    with timer.phase("spmv_scan_distributed") as ph:
        out = iterate(a, xx, flags, prob.iters)
        ph.block(*_own(out))
    return unshard_1d(out, mesh).cpu().numpy()[:n]


def _own(shards: list) -> list:
    """The shards this process holds (another rank's are ``None``)."""
    return [s for s in shards if s is not None]


def _shard_problem(prob: Problem, mesh, dtype, values: np.ndarray | None = None):
    """Pad and cut the problem state over the mesh's first axis: returns
    ``(a, xx, flags, n)``, the first three lists of shards on the mesh's
    devices (``None`` for a shard another rank of the gang holds).
    ``values`` replaces the value vector (a resume re-cuts a committed
    mid-solve state)."""
    from ..dist.scan import shard_1d

    nshards = mesh.devices.shape[0]
    n = prob.n
    padded = -(-n // nshards) * nshards
    a = np.zeros(padded, dtype=np.float32)
    a[:n] = prob.a if values is None else values
    xx = np.zeros(padded, dtype=np.float32)
    xx[:n] = prob.xx
    flags = np.zeros(padded, dtype=np.int32)
    flags[prob.s[:-1]] = 1
    if padded > n:
        flags[n] = 1  # quarantine the tail in its own segment
    return (shard_1d(torch.from_numpy(a).to(dtype), mesh),
            shard_1d(torch.from_numpy(xx).to(dtype), mesh),
            shard_1d(torch.from_numpy(flags), mesh), n)


def _problem_crc(prob: Problem) -> int:
    """CRC32 over the problem's defining arrays — pins a commit to ITS
    problem instance so a resume can't silently mix solves."""
    import zlib

    crc = 0
    for arr in (prob.a, prob.s, prob.k, prob.x):
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return crc & 0xFFFFFFFF


def run_spmv_scan_distributed_supervised(prob: Problem, mesh, ckpt_dir: str,
                                         every: int = 0, dtype=torch.float32,
                                         resume: bool = True,
                                         heartbeat=None) -> np.ndarray:
    """Supervised form of the mesh-parallel pipeline: the sharded value
    vector is epoch-committed (``dist/ckpt.py``) every ``every``
    iterations with a heartbeat per epoch, and ``resume`` reloads the
    newest valid commit — **elastically**: the commit stores the true
    (n,)-length state plus its shard map, so a solve committed on 2 shards
    (or 2 ranks) resumes on 4, re-padded and re-cut for the new axis.
    ``faults.maybe_kill_rank`` guards each epoch boundary, as in the
    supervised heat solve.

    Same-mesh resume is bitwise; across shard counts the carry-combine
    order changes, so results match the single-device reference to the
    usual scan tolerance instead.

    An epoch that dies RESOURCE-classified (``CME213_FAULTS=
    oom:spmv_scan_chunk``) halves ``every``, re-cuts the last committed
    state and retries; the allocator's own ``torch.cuda.OutOfMemoryError``
    re-raises.  Returns the result on the host, on every rank of a gang.
    """
    from ..core import metrics
    from ..core.faults import maybe_kill_rank, maybe_oom
    from ..core.resilience import FailureKind, classify_failure
    from ..core.trace import record_event
    from ..dist.ckpt import check_meta, commit_epoch, load_latest_commit
    from ..dist.multihost import process_info
    from ..dist.scan import make_iterated_sharded_scan_gated, unshard_1d

    prob.validate()
    meta = {"kind": "spmv_scan", "n": prob.n, "iters": prob.iters,
            "problem_crc": _problem_crc(prob),
            "dtype": dtype_name(dtype)}
    every = every or prob.iters
    process_id, process_count = process_info()

    def load_state(force: bool = False):
        # the halving retry always reloads (its own commits from this run
        # are durable even when the solve started with resume=False)
        loaded = load_latest_commit(ckpt_dir) if (resume or force) else None
        if loaded is None:
            return 0, 0, None
        manifest, committed = loaded
        check_meta(manifest, **meta)
        return manifest["step"], manifest["epoch"], np.asarray(committed)

    def shard_map(shards):
        # each shard's global index range in the padded vector
        size = len(_own(shards)[0])
        return [(((i * size, (i + 1) * size),), s)
                for i, s in enumerate(shards)]

    start, epoch, values = load_state()
    a, xx, flags, n = _shard_problem(prob, mesh, dtype, values=values)
    iterate, _ = make_iterated_sharded_scan_gated(mesh)
    if heartbeat is not None:
        heartbeat.beat(start)
    it = start
    while it < prob.iters:
        maybe_kill_rank(step=epoch)
        k = min(every, prob.iters - it)
        try:
            maybe_oom("spmv_scan_chunk")
            a_new = iterate(a, xx, flags, k)
            check_op("spmv_scan.distributed", *_own(a_new))
        except Exception as e:  # noqa: BLE001 — classify, then decide
            if (isinstance(e, torch.cuda.OutOfMemoryError)
                    or classify_failure(e) is not FailureKind.RESOURCE
                    or k <= 1):
                raise
            every = max(1, k // 2)
            metrics.counter("admission.chunk_shrunk").inc()
            record_event("chunk-shrunk", op="spmv_scan", from_size=k,
                         to_size=every, reason=type(e).__name__)
            it, epoch, values = load_state(force=True)
            a, xx, flags, n = _shard_problem(prob, mesh, dtype,
                                             values=values)
            continue
        a = a_new
        it += k
        epoch += 1
        commit_epoch(ckpt_dir, epoch, it, shard_map(a), true_shape=(n,),
                     meta=meta, process_id=process_id,
                     process_count=process_count)
        if heartbeat is not None:
            heartbeat.beat(it)
    return unshard_1d(a, mesh).cpu().numpy()[:n]


# ------------------------------------------------------------------ checking

def external_check(prob: Problem, result: np.ndarray) -> dict:
    """Double-precision serial checker — the reference's external grader
    (``aux/reference_spMVscan-released.cu:38-54,65-144``): recompute in f64
    and report absolute+relative L2 and L∞ errors."""
    ref = golden.host_spmv_scan(prob.a, prob.s[:-1], prob.xx, prob.iters,
                                dtype=np.float64)
    return {
        "l2": l2_distance(ref, result),
        "rel_l2": relative_l2_error(ref, result),
        "rel_linf": relative_linf_error(ref, result),
    }


# ------------------------------------------------------------------ suite

# Problems shaped like the Bell/Garland 2008 SuiteSparse suite the reference
# benchmarks (names and the reference's per-matrix iteration counts from
# ``paper/Final_Report_DongBang_Tsai.tex:236-251``; n = nnz-scale, p = row
# count, approximated — generated synthetically the way readMM.py generated
# instances from the real matrix files).
BELL_GARLAND_SUITE = {
    # name: (n, p, q, iters)
    "cant": (4_007_383, 62_452, 62_451, 50),
    "consph": (6_010_480, 83_335, 83_334, 20),
    "cop20k_A": (2_624_331, 121_193, 121_192, 73),
    "dense2": (4_000_000, 2_001, 2_000, 10),
    "jonheart": (127_224, 1_780, 1_779, 60),
    "mac_econ_fwd500": (1_273_389, 206_501, 206_500, 12),
    "mc2depi": (2_100_225, 525_826, 525_825, 70),
    "pdb1HYS": (4_344_765, 36_418, 36_417, 30),
    "pwtk": (11_634_424, 217_919, 217_918, 25),
    "qcd5_4": (1_916_928, 49_153, 49_152, 63),
    "rail4284": (11_279_748, 4_285, 4_284, 10),
    "rma10": (2_374_001, 46_836, 46_835, 74),
    "scircuit": (958_936, 170_999, 170_998, 30),
    "shipsec1": (7_813_404, 140_875, 140_874, 10),
    "webbase-1M": (3_105_536, 1_000_006, 1_000_005, 77),
}


def suite_problem(name: str, seed: int = 0, scale: float = 1.0) -> Problem:
    """Generate the named suite instance (``scale`` < 1 shrinks dims
    proportionally for quick runs)."""
    n, p, q, iters = BELL_GARLAND_SUITE[name]
    n = max(16, int(n * scale))
    p = max(3, min(int(p * scale), n - 1))
    q = max(2, int(q * scale))
    return generate_problem(n, p, q, iters, seed=seed)


# ------------------------------------------------------------------ CLI

def _write_floats(path: str, values) -> None:
    """One value a line (``%.9g``), by the native writer where the native
    library builds, else by Python: the same text either way."""
    from ..core.errors import FrameworkError

    try:
        from .. import native

        native.write_floats(path, values)
        return
    except FrameworkError:
        pass  # no or broken toolchain: the Python writer serves
    with open(path, "w") as f:
        for v in np.asarray(values, np.float32):
            f.write(f"{v:.9g}\n")


def main(argv: list[str]) -> int:
    """Command line mirroring the reference's fp binary (fp.cu:74-216) plus a
    readMM-style ``gen`` subcommand:

        spmv_scan a.txt x.txt [cpu_check]
                  [--kernel=auto|flat|blocked|pallas|pallas-fused|dense]
                  [--device=cuda|cpu] [--distributed] [--canonical]
        spmv_scan gen a.txt x.txt [n p q [iters]] [--seed=S]
        spmv_scan mtx matrix.mtx|dense2 [cpu_check] [--kernel=...]
                  [--seed=S] [--device=...]

    The run form loads the problem, executes the device pipeline (printing
    the spec-mandated timing line), writes ``b.txt`` (one value per line)
    into the working directory, and with ``cpu_check`` also writes
    ``b_cpu.txt`` and checks the result against the f64 golden (rel L2 ≤
    1e-4 and rel L∞ ≤ 1e-3, exit 1 otherwise).  ``--distributed`` runs
    ``run_spmv_scan_distributed`` with one shard on each physical device
    (every CUDA device, or the CPU with ``--device=cpu``) in place of
    ``--kernel``.  ``--canonical`` pads the problem to its power-of-two
    bucket behind the bucket gate (``run_spmv_scan``).
    """
    args = [a for a in argv[1:] if not a.startswith("--")]
    kernel = "auto"
    seed = 0
    device = None
    distributed = False
    canonical = False
    for a in argv[1:]:
        if a.startswith("--kernel="):
            kernel = a.split("=", 1)[1]
        elif a.startswith("--seed="):
            seed = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a == "--distributed":
            distributed = True
        elif a == "--canonical":
            canonical = True
        elif a.startswith("--"):
            print(f"error: unknown option {a!r} (flags use --name=value)")
            return 2
    if kernel not in KERNELS:
        print(f"error: unknown kernel {kernel!r} ({'|'.join(KERNELS)})")
        return 2

    if args and args[0] == "gen":
        if len(args) not in (3, 6, 7):
            print("usage: spmv_scan gen a.txt x.txt [n p q [iters]] "
                  "[--seed=S]")
            return 2
        a_path, x_path = args[1], args[2]
        if len(args) >= 6:
            n, p, q = int(args[3]), int(args[4]), int(args[5])
            iters = int(args[6]) if len(args) > 6 else None
        else:
            n, p, q, iters = 100_000, 1_000, 999, None
        prob = generate_problem(n, p, q, iters, seed=seed)
        save_problem(prob, a_path, x_path)
        print(f"wrote {a_path} (n={prob.n} p={prob.p} q={prob.q} "
              f"N={prob.iters}) and {x_path}")
        return 0

    cpu_check = len(args) > 2 and args[2] not in ("0", "false")
    if args and args[0] == "mtx":
        # readMM.py parity path: the instance straight from a MatrixMarket
        # file (aux/readMM.py:16-63), or the built-in dense2 reconstruction
        if len(args) < 2:
            print("usage: spmv_scan mtx matrix.mtx [cpu_check] "
                  "[--kernel=...] [--seed=S]")
            return 2
        from .matrix_market import dense2_problem, problem_from_mtx

        try:
            if args[1] == "dense2":
                prob = dense2_problem(iters=None, seed=seed)
            else:
                prob = problem_from_mtx(args[1], seed=seed)
        except (OSError, ValueError, IndexError) as e:
            print(f"error: cannot load matrix: {e}")
            return 2
        print(f"loaded {args[1]}: n={prob.n} p={prob.p} q={prob.q} "
              f"N={prob.iters}")
    else:
        if len(args) < 2:
            print(__doc__)
            print(main.__doc__)
            return 2
        try:
            prob = load_problem(args[0], args[1])
        except (OSError, ValueError, IndexError) as e:
            print(f"error: cannot load problem: {e}")
            return 2
    if distributed:
        from ..dist.mesh import default_devices, make_mesh_1d

        devices = default_devices(device)
        timer = PhaseTimer()
        out = run_spmv_scan_distributed(prob, make_mesh_1d(devices=devices),
                                        timer=timer)
        ms = timer.last_ms("spmv_scan_distributed")
        print(f"The running time of my code for {prob.iters} iterations "
              f"is: {ms} milliseconds. ({len(devices)} devices)")
    else:
        out = run_spmv_scan(prob, kernel=kernel, device=device,
                            canonical=canonical)

    _write_floats("b.txt", out)
    rc = 0
    if cpu_check:
        # one f64 golden run serves both the b_cpu.txt dump and the checker
        ref = golden.host_spmv_scan(prob.a, prob.s[:-1], prob.xx,
                                    prob.iters, dtype=np.float64)
        _write_floats("b_cpu.txt", ref.astype(np.float32))
        # pass/fail on the norm-relative metrics of the reference's external
        # double-precision checker (iterated scans grow magnitudes, so only
        # normwise error is meaningful)
        errs = {"l2": l2_distance(ref, out),
                "rel_l2": relative_l2_error(ref, out),
                "rel_linf": relative_linf_error(ref, out)}
        print(f"abs L2 {errs['l2']:.3e}  rel L2 {errs['rel_l2']:.3e}  "
              f"rel Linf {errs['rel_linf']:.3e}")
        if errs["rel_l2"] <= 1e-4 and errs["rel_linf"] <= 1e-3:
            print("Worked! device and reference output match.")
        else:
            print("MISMATCH: normwise error exceeds tolerance "
                  "(rel L2 > 1e-4 or rel Linf > 1e-3)")
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
