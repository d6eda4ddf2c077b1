"""Measured autotuning of dispatch statics.

Counterpart of ``cme213_tpu/core/tune.py``.  The reference hand-tuned its
performance constants (hw2's shared-memory tile shapes, hw_final's block
sizes) by sweeping them offline.  Here those statics (the heat
``tile_y``, the SpMV-scan block size and kernel, the flat/blocked scan
crossover) are knobs an empirical tuner turns: a small registered
candidate space per op, searched, with the measured winner persisted.

The search protocol, per candidate:

1. **conformance gate** (``core/conformance.py``) BEFORE any timing: a
   candidate whose probe diverges from the op's reference (including a
   ``wrong:<op>``-faulted probe) is excluded and can never win;
2. **build + warm** (through ``core/programs.py`` where the op has a
   program), so builds and first launches stay out of the timed region;
3. **median of k** measured runs, each under a ``tune.trial`` span whose
   cost (``core/roofline.py``) puts the achieved rate on the span record.
   Every clock read comes after a synchronise of the space's device: a
   host clock around an asynchronous launch measures the enqueue, not the
   kernel.

Winners persist to a JSON disk cache (``CME213_TUNE_CACHE``) keyed
``device_kind|op|shape_class|dtype`` (``device_kind`` is the card's name
and a digest of the kernel sources, or ``cpu``), and the heat ladder
(``ops/stencil_pipeline.run_heat_resilient``) resolves its ``tile_y`` as
tuned-or-default through :func:`resolve`; ``CME213_TUNE=0`` restores the
built-in default.  Ties go to the first-registered candidate, and the
clock is injectable so that is testable.

Spaces: ``heat`` (``tile_y``), ``spmv_scan`` (the torch scan and its
block size), ``segmented_scan`` (the flat/blocked crossover) and ``sort``
(the library sort, the radix sort or the bitonic network, which
``ops.sort.sort_auto`` serves).  ``spmv_scan`` and ``segmented_scan`` are
measurements only: no dispatch site reads their winners until a card's
measurements say what to serve (ROADMAP.md).  ``serve.<mix-op>`` (for
example ``serve.spmv``) searches the serve batcher's batch width per
bucket, which ``serve.server.tuned_batch_cap`` reads.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from . import metrics, roofline
from .errors import KernelError
from .resilience import Clock
from .trace import record_event, span

#: on-disk winner cache (JSON) shared across processes
CACHE_ENV = "CME213_TUNE_CACHE"
#: kill switch: ``CME213_TUNE=0`` makes every dispatch use its defaults
KILL_ENV = "CME213_TUNE"

#: measured runs per candidate (median taken)
TRIAL_RUNS = 5


class TuneError(RuntimeError):
    """No conformant candidate survived the gate, or the op has no space."""


@dataclass(frozen=True)
class Candidate:
    """One point in an op's search space.

    ``gate`` is a zero-argument callable, truthy when the candidate's
    conformance probe passes (run BEFORE timing; ``None`` marks the op's
    reference configuration).  ``build`` returns the zero-argument
    measured runner, already warmed.  ``scale`` divides the measured time
    for scoring."""

    label: str
    statics: dict
    build: object
    gate: object = None
    cost: roofline.Cost | None = None
    scale: float = 1.0


@dataclass(frozen=True)
class TuneSpace:
    """An op's registered candidate space for one shape class, on one
    ``device`` (``"cpu"`` or a CUDA device string), whose work the trials
    synchronise before every clock read."""

    op: str
    shape_class: str
    dtype: str
    candidates: tuple
    cost: roofline.Cost | None = None
    device: str = "cpu"


# key string -> winner record — the steady-state dict lookup
_WINNERS: dict[str, dict] = {}
_DISK_LOADED = False


def reset() -> None:
    """Forget every cached winner (tests); the disk cache is re-read."""
    global _DISK_LOADED
    _WINNERS.clear()
    _DISK_LOADED = False


def enabled() -> bool:
    """The kill switch: ``CME213_TUNE=0`` disables all tuned lookups."""
    return os.environ.get(KILL_ENV, "1") != "0"


def cache_path() -> str | None:
    """The on-disk winner cache location, if one is configured."""
    return os.environ.get(CACHE_ENV) or None


def dtype_name(dtype) -> str:
    """The dtype part of a key: ``"float32"`` for ``torch.float32``."""
    return str(dtype).removeprefix("torch.")


def device_kind(device=None) -> str:
    """The device part of a key: ``core/platform.build_identity`` of a
    CUDA ``device`` (the card's name and a digest of the kernel sources, so
    a winner measured on another card or before a kernel was edited is not
    replayed), else ``cpu``; with no device, the card the roofline
    detects."""
    import torch

    from .platform import build_identity

    if device is None:
        return roofline.detect_device()
    return build_identity(torch.device(device))


def _cache_key(op: str, shape_class: str, dtype: str, device=None) -> str:
    return f"{device_kind(device)}|{op}|{shape_class}|{dtype}"


def _load_disk_cache() -> None:
    """Merge persisted winners (in-process winners win)."""
    global _DISK_LOADED
    _DISK_LOADED = True
    path = os.environ.get(CACHE_ENV)
    if not path or not os.path.exists(path):
        return
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return  # a corrupt cache must never break dispatch; defaults serve
    if not isinstance(data, dict):
        return
    for key, rec in data.items():
        if (len(key.split("|")) != 4 or not isinstance(rec, dict)
                or not isinstance(rec.get("statics"), dict)):
            continue
        _WINNERS.setdefault(key, dict(rec))


def _persist(key: str, rec: dict) -> None:
    path = os.environ.get(CACHE_ENV)
    if not path:
        return
    try:
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        if not isinstance(data, dict):
            data = {}
    except (OSError, ValueError):
        data = {}
    data[key] = rec
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(data, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only cache directory must never block dispatch


def store(op: str, shape_class: str, dtype: str, *, statics: dict,
          candidate: str, ms: float, gbs: float, device=None) -> dict:
    """Record (and persist) the measured winner for a tuning key."""
    rec = {"statics": dict(statics), "candidate": candidate,
           "ms": round(float(ms), 6), "gbs": round(float(gbs), 3)}
    key = _cache_key(op, shape_class, dtype, device)
    _WINNERS[key] = rec
    _persist(key, rec)
    return rec


def lookup(op: str, shape_class: str, dtype: str = "float32",
           device=None) -> dict | None:
    """The winner record for a key, or None (also None when the kill
    switch is set).  Pure: no events; dispatch sites go through
    :func:`resolve`."""
    if not enabled():
        return None
    if not _DISK_LOADED:
        _load_disk_cache()
    return _WINNERS.get(_cache_key(op, shape_class, dtype, device))


def resolve(op: str, shape_class: str, dtype: str = "float32", *,
            device=None, **defaults) -> dict:
    """Tuned-or-default statics for a dispatch site on ``device``.

    Returns ``defaults`` updated with the winning statics for the key,
    restricted to the keys the call site declares, so a stale cache entry
    never injects statics dispatch does not understand.  Counts every
    consult (``tune.hits``/``tune.defaults``) and records a
    ``tune-hit``/``tune-default`` event."""
    rec = lookup(op, shape_class, dtype, device)
    if rec is None:
        metrics.counter("tune.defaults").inc()
        record_event("tune-default", op=op, shape_class=shape_class)
        return dict(defaults)
    tuned = {k: v for k, v in rec["statics"].items() if k in defaults}
    metrics.counter("tune.hits").inc()
    record_event("tune-hit", op=op, shape_class=shape_class,
                 statics=json.dumps(tuned, sort_keys=True))
    return {**defaults, **tuned}


def entries() -> dict:
    """Merged snapshot (disk + in-process) of every winner record."""
    if not _DISK_LOADED:
        _load_disk_cache()
    return dict(_WINNERS)


def clear() -> int:
    """Drop every winner, in-process and on disk; returns the count."""
    global _DISK_LOADED
    if not _DISK_LOADED:
        _load_disk_cache()
    n = len(_WINNERS)
    reset()
    _DISK_LOADED = True  # do not resurrect the file being cleared
    path = os.environ.get(CACHE_ENV)
    if path and os.path.exists(path):
        try:
            os.remove(path)
        except OSError:
            pass
    return n


# ------------------------------------------------------------------ search

def _median(xs: list[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def synchronize(device: str) -> None:
    """Wait for every queued launch on ``device`` (no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _measure(space: TuneSpace, cand: Candidate, runner, clock: Clock,
             runs: int) -> float:
    """Median of ``runs`` scored milliseconds for one warmed candidate,
    each run under a ``tune.trial`` span carrying roofline attribution.
    The device is synchronised before each clock read."""
    times = []
    for _ in range(max(1, runs)):
        synchronize(space.device)
        t0 = clock.now()
        with span("tune.trial", op=space.op, shape_class=space.shape_class,
                  candidate=cand.label) as sp:
            if cand.cost is not None:
                sp.roofline(cand.cost.nbytes, cand.cost.flops)
            out = runner()
            sp.block(out)
            synchronize(space.device)
            t1 = clock.now()
        times.append((t1 - t0) * 1e3 / cand.scale)
    return _median(times)


def _reject(space: TuneSpace, trials: list, label: str, error: str) -> None:
    metrics.counter("tune.rejected").inc()
    record_event("tune-trial", op=space.op, shape_class=space.shape_class,
                 candidate=label, ok=False, ms=-1.0, gbs=-1.0)
    trials.append({"candidate": label, "ok": False, "ms": -1.0,
                   "gbs": -1.0, "error": error})


def run_space(space: TuneSpace, *, clock: Clock | None = None,
              runs: int = TRIAL_RUNS, persist: bool = True) -> dict:
    """Gate, warm and time every candidate; pick and record the winner.

    Candidates are visited in registration order and only a STRICTLY
    faster median displaces the incumbent, so exact ties go to the earlier
    candidate.  A candidate whose gate fails or raises, or that cannot be
    built or run, is excluded, not fatal; a ``KernelError`` (a kernel
    that cannot build or launch) raises, as it does out of a ladder.  The
    clock is injectable (``core/resilience.Clock``)."""
    clock = clock or Clock()
    trials: list = []
    best = None
    for cand in space.candidates:
        cost = cand.cost or space.cost
        c = Candidate(cand.label, cand.statics, cand.build, cand.gate,
                      cost, cand.scale)
        try:
            ok = True if cand.gate is None else bool(cand.gate())
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — a dying probe is a veto
            _reject(space, trials, cand.label, f"{type(e).__name__}: {e}")
            continue
        if not ok:
            _reject(space, trials, cand.label, "conformance probe failed")
            continue
        try:
            runner = cand.build()
            ms = _measure(space, c, runner, clock, runs)
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — a candidate that cannot
            # build or run is excluded; the search keeps what it measured
            _reject(space, trials, cand.label, f"{type(e).__name__}: {e}")
            continue
        gbs = cost.gbs(ms * cand.scale) if (cost and ms > 0) else 0.0
        metrics.counter("tune.trials").inc()
        record_event("tune-trial", op=space.op,
                     shape_class=space.shape_class, candidate=cand.label,
                     ok=True, ms=round(ms, 6), gbs=round(gbs, 3))
        trials.append({"candidate": cand.label, "ok": True,
                       "ms": round(ms, 6), "gbs": round(gbs, 3),
                       "statics": dict(cand.statics)})
        if best is None or ms < best["ms"]:
            best = {"candidate": cand.label, "ms": ms, "gbs": gbs,
                    "statics": dict(cand.statics)}
    if best is None:
        raise TuneError(
            f"tune: no conformant candidate for {space.op} "
            f"[{space.shape_class}/{space.dtype}] "
            f"({len(space.candidates)} gated out)")
    metrics.counter("tune.winners").inc()
    record_event("tune-winner", op=space.op, shape_class=space.shape_class,
                 dtype=space.dtype, candidate=best["candidate"],
                 statics=json.dumps(best["statics"], sort_keys=True),
                 gbs=round(best["gbs"], 3))
    if persist:
        store(space.op, space.shape_class, space.dtype,
              statics=best["statics"], candidate=best["candidate"],
              ms=best["ms"], gbs=best["gbs"], device=space.device)
    return {"op": space.op, "shape_class": space.shape_class,
            "dtype": space.dtype, "device": device_kind(space.device),
            "winner": {"candidate": best["candidate"],
                       "statics": best["statics"],
                       "ms": round(best["ms"], 6),
                       "gbs": round(best["gbs"], 3)},
            "trials": trials}


# ------------------------------------------------------- candidate spaces

#: blocked-scan block sizes searched for spmv_scan
SPMV_BLOCK_SIZES = (1024, 2048, 4096, 8192, 16384)
#: flat/blocked crossover thresholds searched for segmented_scan's auto
#: dispatch (the built-in default: 2^16)
SCAN_THRESHOLDS = (1 << 14, 1 << 16, 1 << 18)


def _spmv_space(n: int = 1 << 20, iters: int = 8, dtype: str = "float32",
                block_sizes=SPMV_BLOCK_SIZES, device=None) -> TuneSpace:
    """spmv_scan: the flat log-sweep against the blocked O(n) scan at each
    block size, at the canonical size of ``n``.  The winner's statics are
    ``kernel`` and, for blocked, ``block_size``; ``run_spmv_scan`` does not
    read them yet.  Each blocked candidate is gated against ``flat`` on the
    engine's probe problem."""
    import torch

    from ..apps import spmv_scan as app
    from ..core import conformance, programs
    from .platform import build_identity, resolve_device

    dev = resolve_device(device)
    tdt = getattr(torch, dtype)
    nc = programs.canonical_size(n)
    prob = app.generate_problem(nc, p=max(2, nc // 64), q=max(2, nc // 2),
                                iters=iters, seed=0)
    cost = roofline.spmv_scan_cost(nc, iters, dtype=dtype)
    probe = app._probe_problem()
    probe_args = app.problem_tensors(probe, tdt, dev)
    args = app.problem_tensors(prob, tdt, dev)

    def program(pr, pr_args, kernel, block_size=None):
        return app._program(kernel, pr.n, pr.iters, tdt, dev, p=pr.p,
                            block_size=block_size, warm_args=lambda: pr_args)

    def gate(label, kernel, block_size=None):
        return lambda: conformance.check(
            "spmv_scan", label,
            shape_class=f"{dtype}/{build_identity(dev)}",
            candidate=lambda: program(probe, probe_args, kernel,
                                      block_size)(*probe_args),
            reference=lambda: program(probe, probe_args, "flat")(
                *probe_args),
            rel_l2=app.CONFORMANCE_REL_L2[kernel]).ok

    def build(kernel, block_size=None):
        def make_runner():
            fn = program(prob, args, kernel, block_size)
            return lambda: fn(*args)
        return make_runner

    cands = [Candidate("flat", {"kernel": "flat"}, build("flat"))]
    for bs in block_sizes:
        cands.append(Candidate(
            f"blocked/bs{bs}", {"kernel": "blocked", "block_size": bs},
            build("blocked", bs), gate(f"blocked/bs{bs}", "blocked", bs)))
    return TuneSpace("spmv_scan", f"n{nc}", dtype, tuple(cands), cost,
                     str(dev))


def _crossover_space(n: int | None = None, dtype: str = "float32",
                     thresholds=SCAN_THRESHOLDS, device=None) -> TuneSpace:
    """segmented_scan: the flat/blocked crossover threshold, measured at
    the contested size (the default threshold itself).  Each candidate is
    a threshold; what is timed is the scan that threshold selects at that
    size, so the measurement answers "which side of the boundary should
    this size fall on".  ``ops/segmented.scan_threshold`` does not read the
    winner yet."""
    import torch

    from ..core import conformance, programs
    from ..ops import segmented
    from .platform import build_identity, resolve_device

    dev = resolve_device(device)
    tdt = getattr(torch, dtype)
    n0 = programs.canonical_size(n or segmented.BLOCKED_SCAN_THRESHOLD)
    rng = np.random.default_rng(0)
    v_host = rng.uniform(-1, 1, n0).astype(dtype)
    f_host = (rng.uniform(size=n0) < (1 / 64)).astype(np.int32)
    f_host[0] = 1
    v = torch.from_numpy(v_host).to(dev)
    f = torch.from_numpy(f_host).to(dev)
    cost = roofline.Cost(n0 * (2 * np.dtype(dtype).itemsize + 4), 0)
    pn = 4096
    pv = torch.from_numpy(v_host[:pn]).to(dev)
    pf_host = f_host[:pn].copy()
    pf_host[0] = 1
    pf = torch.from_numpy(pf_host).to(dev)
    scans = {"flat": segmented.segmented_scan_flat,
             "blocked": segmented.segmented_scan_blocked}

    def program(kernel):
        def warm(fn):
            fn(torch.zeros(n0, dtype=tdt, device=dev),
               torch.zeros(n0, dtype=torch.int32, device=dev))
        return programs.get("segmented_scan", kernel, f"n{n0}",
                            lambda: scans[kernel], dtype=dtype, device=dev,
                            warm=warm)

    def gate(label, kernel):
        if kernel == "flat":
            return None  # the reference form
        return lambda: conformance.check(
            "segmented_scan", label,
            shape_class=f"n{pn}/{build_identity(dev)}",
            candidate=lambda: segmented.segmented_scan_blocked(pv, pf),
            reference=lambda: segmented.segmented_scan_flat(pv, pf),
            rel_l2=1e-5).ok

    def build(kernel):
        def make_runner():
            fn = program(kernel)
            return lambda: fn(v, f)
        return make_runner

    cands = []
    for thr in thresholds:
        kernel = "blocked" if n0 >= thr else "flat"
        label = f"thr{thr}/{kernel}"
        cands.append(Candidate(label, {"threshold": thr}, build(kernel),
                               gate(label, kernel)))
    return TuneSpace("segmented_scan", "crossover", dtype, tuple(cands),
                     cost, str(dev))


def _heat_space(gy: int = 64, gx: int = 64, order: int = 2, k: int = 1,
                iters: int = 4, dtype: str = "float32",
                device=None) -> TuneSpace:
    """heat: the pipeline's ``tile_y`` per (grid, order, k) class, against
    the ``xla`` rung (the torch ``run_heat``).  ``gy`` × ``gx`` is the
    interior; the space's shape class names the halo grid, as
    ``run_heat_resilient``'s lookup does.  The tiles: ``pick_pipeline_tile``'s
    ``tile_y``, its half and its double (those within the grid whose
    windows fit a block's shared memory).  The width
    is no knob: every entry point runs the k class's one design
    (``stencil_pipeline.design``).  On the CPU the kernel rungs run their
    plain versions, so the timings there say nothing about the card."""
    import torch

    from ..config import SimParams
    from ..grid import make_initial_grid
    from ..ops import stencil_pipeline as sp_mod
    from ..ops.stencil import run_heat
    from .platform import resolve_device

    dev = resolve_device(device)
    tdt = getattr(torch, dtype)
    p = SimParams(nx=gx, ny=gy, order=order, iters=iters)
    u0 = make_initial_grid(p, dtype=tdt, device=dev)
    elem = u0.element_size()
    picked = sp_mod.pick_pipeline_tile(p.gy, k, order, dtype_bytes=elem)
    tile_ys = sorted({t for t in (picked // 2, picked, picked * 2)
                      if 0 < t <= p.gy and sp_mod.smem_bytes(
                          t, k, order, elem) <= sp_mod.SMEM_BUDGET_BYTES})
    cost = roofline.heat_cost(p.gy, p.gx, order=order, iters=iters,
                              dtype=dtype)
    shape_class = f"{p.gy}x{p.gx}/order{order}/k{k}"

    def build_xla():
        run_heat(u0, 1, order, p.xcfl, p.ycfl)  # warm: set-up out of timing
        return lambda: run_heat(u0, iters, order, p.xcfl, p.ycfl)

    def build_pipeline(ty):
        def make_runner():
            def runner():
                # the tile pinned, so run_heat_resilient never consults
                # the cache this search is filling
                return sp_mod.run_heat_resilient(
                    u0, iters, order, p.xcfl, p.ycfl, p.bc, k=k,
                    tile_y=ty).value
            runner()  # warm: program build, first launch and probe
            return runner
        return make_runner

    # the ladder's own gate (pipeline against run_heat, bitwise), one
    # verdict per order × k, so a wrong: fault on the probe vetoes every
    # pipeline candidate at once
    gate = sp_mod._heat_conformance_gate(order, k, tdt, dev)
    cands = [Candidate("xla", {}, build_xla)]
    for ty in tile_ys:
        cands.append(Candidate(
            f"pipeline/ty{ty}", {"tile_y": int(ty)},
            build_pipeline(int(ty)), lambda: gate("pipeline")))
    return TuneSpace("heat", shape_class, dtype, tuple(cands), cost,
                     str(dev))


def _sort_space(n: int = 1 << 20, kernels=("lax", "radix", "bitonic"),
                device=None) -> TuneSpace:
    """sort: the library sort (``lax``, the JAX package's name) against the
    radix sort and the bitonic network on ``uint32`` keys at the canonical
    size of ``n``; ``ops.sort.sort_auto`` serves the winner.  Each
    candidate but ``lax`` is gated against ``np.sort`` on the keys' first
    4096, exactly."""
    import torch

    from ..core import conformance, programs
    # not ``from ..ops import sort``: the package re-exports the sort
    # function under that name, shadowing the submodule
    from ..ops.sort import bitonic_sort, radix_sort
    from ..ops.sort import sort as lib_sort
    from .platform import build_identity, resolve_device

    dev = resolve_device(device)
    nc = programs.canonical_size(n)
    rng = np.random.default_rng(0)
    keys_host = rng.integers(0, 2 ** 32, nc, dtype=np.uint32)
    keys = torch.from_numpy(keys_host).to(dev)
    pn = min(nc, 4096)
    probe = keys[:pn]
    probe_ref = np.sort(keys_host[:pn])
    fns = {"lax": lib_sort, "radix": radix_sort, "bitonic": bitonic_sort}

    def program(kernel):
        def warm(fn):
            fn(torch.zeros(nc, dtype=torch.uint32, device=dev))
        return programs.get("sort", kernel, f"n{nc}", lambda: fns[kernel],
                            dtype="uint32", device=dev, warm=warm)

    def gate(kernel):
        if kernel == "lax":
            return None  # the reference rung
        return lambda: conformance.check(
            "sort", kernel, shape_class=f"n{pn}/{build_identity(dev)}",
            candidate=lambda: fns[kernel](probe),
            reference=lambda: probe_ref).ok

    def build(kernel):
        def make_runner():
            fn = program(kernel)
            return lambda: fn(keys)
        return make_runner

    cands = tuple(Candidate(k, {"kernel": k}, build(k), gate(k),
                            cost=roofline.sort_cost(
                                nc, kind="radix" if k == "radix"
                                else "merge"))
                  for k in kernels)
    return TuneSpace("sort", f"n{nc}", "uint32", cands, None, str(dev))


#: serve batch widths searched per bucket
SERVE_WIDTHS = (1, 2, 4, 8)


def _serve_space(mix_op: str = "spmv", widths=SERVE_WIDTHS,
                 max_batch: int = 8, seed: int = 0,
                 device=None) -> TuneSpace:
    """serve: batch width per bucket on ``device``.  Each width w runs a
    w-wide batch through the op's adapter (scored a request), gated on
    lane 0 being bitwise the width-1 solve (the batching contract)."""
    from ..core import conformance
    from ..serve import loadgen
    from ..serve.workloads import ADAPTERS, serving_device
    from .platform import build_identity

    dev = serving_device(device)
    spec = loadgen.build_mix(mix_op, requests=1, seed=seed)[0]
    adapter = ADAPTERS[spec.op]
    payload = spec.payload
    shape_class = adapter.shape_class(payload)
    rung = adapter.rungs()[0]
    op = f"serve.{adapter.op}"

    def gate(w):
        if w == 1:
            return None  # the reference width
        return lambda: conformance.check(
            op, f"b{w}", shape_class=f"{shape_class}/{build_identity(dev)}",
            candidate=lambda: np.asarray(
                adapter.run_batch([payload] * w, rung, device=dev)[0]),
            reference=lambda: np.asarray(
                adapter.run_batch([payload], rung, device=dev)[0])).ok

    def build(w):
        def builder():
            batch = [payload] * w
            # the adapters return host arrays, copied off the device, so
            # a run is complete when it returns
            runner = lambda: adapter.run_batch(batch, rung, device=dev)[0]
            runner()  # warm: the batch program builds outside timing
            return runner
        return builder

    cands = [Candidate(f"b{w}", {"max_batch": int(w)}, build(w), gate(w),
                       scale=float(w))
             for w in widths if 1 <= w <= max_batch]
    return TuneSpace(op, shape_class, "float32", tuple(cands), None,
                     str(dev))


#: op name -> the function that makes its space; ``run`` routes here.
#: ``serve.<mix-op>`` names route through the serve space (for example
#: ``serve.spmv``).
SPACES = {
    "spmv_scan": _spmv_space,
    "segmented_scan": _crossover_space,
    "heat": _heat_space,
    "sort": _sort_space,
}

def build_space(op: str, **kw) -> TuneSpace:
    """The registered candidate space for ``op`` (``serve.<mix-op>``
    routes to the serve-width space)."""
    if op.startswith("serve."):
        return _serve_space(op.split(".", 1)[1], **kw)
    if op not in SPACES:
        raise TuneError(f"no candidate space registered for {op!r} "
                        f"(have {sorted(SPACES)} + serve.<op>)")
    return SPACES[op](**kw)


def run(op: str, *, clock: Clock | None = None, runs: int = TRIAL_RUNS,
        persist: bool = True, **kw) -> dict:
    """Search ``op``'s candidate space and persist the winner."""
    return run_space(build_space(op, **kw), clock=clock, runs=runs,
                     persist=persist)
