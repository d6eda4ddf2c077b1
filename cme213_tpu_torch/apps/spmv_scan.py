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

from ..core import PhaseTimer, check_op, resolve_device
from ..ops.segmented import (head_flags_from_starts, segmented_scan,
                             segmented_scan_blocked, segmented_scan_dense,
                             segmented_scan_flat, validate_segments)
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
        """Loader invariants (aux/mp1-util.h:128-148)."""
        if self.s[-1] != self.n:
            raise ValueError("last segment entry must equal n (end sentinel)")
        validate_segments(self.s[:-1], self.n)
        if ((self.k < 0) | (self.k >= self.q)).any():
            raise ValueError("gather index out of range")

    @property
    def xx(self) -> np.ndarray:
        """Gather-flattened x (the fp.cu:124-125 coalescing precompute)."""
        return self.x[self.k]


# ------------------------------------------------------------------ io

def load_problem(a_path: str, x_path: str) -> Problem:
    """Parse the reference's a.txt/x.txt problem format (fp.cu:81-107)
    with the pure-Python tokenizer."""
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


def _iterate(a, xx, flags, iters: int, scan: str = "auto",
             block_size: int | None = None):
    """``iters`` × ``a ← scan(a·xx)`` with a plain torch scan."""
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
    int64 segment starts."""
    dev = resolve_device(device)
    starts = torch.from_numpy(prob.s[:-1].astype(np.int64)).to(dev)
    return (torch.from_numpy(prob.a).to(dev, dtype),
            torch.from_numpy(prob.xx).to(dev, dtype),
            head_flags_from_starts(starts, prob.n), starts)


def run_spmv_scan(prob: Problem, timer: PhaseTimer | None = None,
                  dtype=torch.float32, kernel: str = "auto",
                  device=None) -> np.ndarray:
    """Device pipeline (fp.cu:154-190): upload, N × (multiply + segmented
    scan), download; prints the spec-mandated timing line (Final.pdf §4.2
    format, fp.cu:190).

    ``kernel``:

    - "auto" (default): the flat log-sweep below
      ``ops.BLOCKED_SCAN_THRESHOLD`` elements, the blocked O(n) scan above;
    - "flat"/"blocked": force the respective torch scan;
    - "pallas-fused": the hand-written kernel with the multiply fused into
      the scan's load (B7, ``ops/segmented_pallas.spmv_scan_pallas``);
    - "pallas": the same kernel per iteration with the multiply left to
      torch (B6, ``segmented_scan_pallas``);
    - "dense": the per-segment dense-matrix strawman.

    The upload happens outside the timed phase, and one untimed iteration
    runs first, so the kernel's build and the device's lazy set-up stay out
    of it; a failed build or launch raises there.  Nothing falls back to
    another kernel.
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} ({'|'.join(KERNELS)})")
    prob.validate()
    a, xx, flags, starts = problem_tensors(prob, dtype, device)
    max_len = int(np.diff(prob.s).max())
    timer = timer or PhaseTimer()
    check_op(f"spmv_scan.{kernel}",
             _build_runner(kernel, 1, max_len)(a, xx, flags, starts))
    runner = _build_runner(kernel, prob.iters, max_len)
    with timer.phase("spmv_scan") as ph:
        out = runner(a, xx, flags, starts)
        ph.block(out)
    ms = timer.last_ms("spmv_scan")
    print(f"The running time of my code for {prob.iters} iterations is: "
          f"{ms} milliseconds.")
    return out.cpu().numpy()


def run_spmv_scan_distributed(prob: Problem, mesh, dtype=torch.float32,
                              timer: PhaseTimer | None = None) -> np.ndarray:
    """Mesh-parallel pipeline: the value sequence is cut over the mesh's
    first axis and each iteration runs the multi-device segmented scan
    (``dist/scan.py``) with the ``ring`` carry combine, the rung the JAX
    package's gate serves when its probe passes.  The per-shard scan keeps
    the flat/blocked size dispatch.  Pads to a shard multiple with
    zero-valued, own-segment tail elements (they never touch a real
    segment).  One untimed iteration runs first; the timed phase is
    "spmv_scan_distributed"."""
    from ..dist.scan import make_iterated_sharded_scan

    prob.validate()
    a, xx, flags, n = _shard_problem(prob, mesh, dtype)
    iterate = make_iterated_sharded_scan(mesh, carry_mode="ring")
    timer = timer or PhaseTimer()
    for s in iterate(a, xx, flags, 1):
        check_op("spmv_scan.distributed", s)
    with timer.phase("spmv_scan_distributed") as ph:
        out = iterate(a, xx, flags, prob.iters)
        ph.block(*out)
    return torch.cat([s.cpu() for s in out]).numpy()[:n]


def _shard_problem(prob: Problem, mesh, dtype):
    """Pad and cut the problem state over the mesh's first axis: returns
    ``(a, xx, flags, n)``, the first three lists of shards on the mesh's
    devices."""
    from ..dist.scan import shard_1d

    nshards = mesh.devices.shape[0]
    n = prob.n
    padded = -(-n // nshards) * nshards
    a = np.zeros(padded, dtype=np.float32)
    a[:n] = prob.a
    xx = np.zeros(padded, dtype=np.float32)
    xx[:n] = prob.xx
    flags = np.zeros(padded, dtype=np.int32)
    flags[prob.s[:-1]] = 1
    if padded > n:
        flags[n] = 1  # quarantine the tail in its own segment
    return (shard_1d(torch.from_numpy(a).to(dtype), mesh),
            shard_1d(torch.from_numpy(xx).to(dtype), mesh),
            shard_1d(torch.from_numpy(flags), mesh), n)


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
    with open(path, "w") as f:
        for v in np.asarray(values, np.float32):
            f.write(f"{v:.9g}\n")


def main(argv: list[str]) -> int:
    """Command line mirroring the reference's fp binary (fp.cu:74-216) plus a
    readMM-style ``gen`` subcommand:

        spmv_scan a.txt x.txt [cpu_check]
                  [--kernel=auto|flat|blocked|pallas|pallas-fused|dense]
                  [--device=cuda|cpu] [--distributed]
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
    ``--kernel``.
    """
    args = [a for a in argv[1:] if not a.startswith("--")]
    kernel = "auto"
    seed = 0
    device = None
    distributed = False
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
            raise NotImplementedError(
                "--canonical needs the program cache and the bucket gate, "
                "not ported yet (ROADMAP.md, queue A: resilience ladder)")
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
        out = run_spmv_scan(prob, kernel=kernel, device=device)

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
