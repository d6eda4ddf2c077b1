"""Kernel conformance gating: probe a rung before it serves.

Counterpart of ``cme213_tpu/core/conformance.py``.  The resilience ladder
(``core/resilience.with_fallback``) demotes a rung that raises, but a
kernel can also return a wrong, finite grid that every later guard
serves.  The reference's defence was to diff every kernel against a
golden before trusting it (hw2's ``grid_final_*`` comparisons, the
hw_final external checker), once, by hand.  This module runs that check
in the serving path:

- On the **first use** of a non-reference rung (per process × op × shape
  class), :func:`check` runs a small canonical probe through the candidate
  rung and through the op's reference rung (``flat`` scan, the torch
  ``run_heat`` stencil) and compares them: bitwise by default, or to the
  rung's declared tolerance (``max_ulps`` / ``rel_l2``) where its
  accumulation order differs by design.
- A diverging rung records a ``conformance-failed`` event and the caller
  demotes it like a rung that raised (``FailureKind.WRONG_ANSWER``).
- Verdicts are **cached** in the process (steady state: one dict lookup)
  and, with ``CME213_CONFORMANCE_CACHE=<json path>``, on disk; a verdict
  reached while a fault plan is installed stays in its process, so an
  injected ``wrong:`` never pins a later process to a demoted rung.

The probe outputs may be tensors on any device: the candidate passes
through ``faults.maybe_perturb`` as returned (so ``wrong:<op>`` clauses
perturb it on its own device), then both are copied to the host
(``.cpu()``, which waits for the device) and compared in numpy.  Callers
put ``core/platform.build_identity`` of the device in the shape class
(``cpu``, or the card's name and a digest of the kernel sources), so a
verdict on the CPU's plain version never stands for a CUDA kernel, nor
one on another card or an earlier kernel source for this one.  The probe
is sampling, not proof: a rung can match on the probe and diverge on
another shape.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

from . import metrics
from .trace import record_event

#: optional on-disk verdict cache (JSON) shared across processes
CACHE_ENV = "CME213_CONFORMANCE_CACHE"


@dataclass(frozen=True)
class Verdict:
    """Outcome of one conformance probe (or its cached replay)."""

    ok: bool
    detail: str          # "bitwise" / "rel_l2=1.2e-07 (tol 1e-05)" / mismatch
    cached: bool = False


# (op, rung, shape_class) -> Verdict — the steady-state dict lookup
_VERDICTS: dict[tuple[str, str, str], Verdict] = {}
_DISK_LOADED = False


def reset() -> None:
    """Forget every cached verdict (tests); the disk cache is re-read."""
    global _DISK_LOADED
    _VERDICTS.clear()
    _DISK_LOADED = False


def _cache_key(op: str, rung: str, shape_class: str) -> str:
    return f"{op}|{rung}|{shape_class}"


def _load_disk_cache() -> None:
    """Merge persisted verdicts (in-process verdicts win)."""
    global _DISK_LOADED
    _DISK_LOADED = True
    path = os.environ.get(CACHE_ENV)
    if not path or not os.path.exists(path):
        return
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return  # a corrupt cache must never block serving; probes re-run
    if not isinstance(data, dict):
        return
    for key, v in data.items():
        parts = key.split("|")
        if len(parts) != 3 or not isinstance(v, dict) or "ok" not in v:
            continue
        _VERDICTS.setdefault((parts[0], parts[1], parts[2]), Verdict(
            ok=bool(v["ok"]), detail=str(v.get("detail", "disk-cache")),
            cached=True))


def _persist(op: str, rung: str, shape_class: str, verdict: Verdict) -> None:
    from .faults import active

    path = os.environ.get(CACHE_ENV)
    if not path or active() is not None:
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
    data[_cache_key(op, rung, shape_class)] = {
        "ok": verdict.ok, "detail": verdict.detail}
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(data, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only cache directory must never block serving


def _host(value) -> np.ndarray:
    """A probe output as a numpy array; a tensor is copied to the host,
    which waits for its device."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _compare(out, ref, rel_l2: float, max_ulps: int) -> tuple[bool, str]:
    """(ok, detail) for candidate against reference probe outputs (numpy
    arrays or what ``np.asarray`` takes): shape and dtype must match and
    the candidate be finite; then ULPs (``max_ulps`` wins), rel-L2, or bit
    for bit."""
    out = np.asarray(out)
    ref = np.asarray(ref)
    if out.shape != ref.shape or out.dtype != ref.dtype:
        return False, (f"shape/dtype mismatch: {out.dtype}{out.shape} vs "
                       f"{ref.dtype}{ref.shape}")
    if not np.isfinite(out).all():
        return False, "non-finite candidate output"
    if max_ulps:
        from .compare import ulp_distance

        d = int(np.max(ulp_distance(ref, out))) if out.size else 0
        return d <= max_ulps, f"ulps={d} (tol {max_ulps})"
    if rel_l2:
        denom = float(np.linalg.norm(ref.astype(np.float64)))
        err = (float(np.linalg.norm((out - ref).astype(np.float64)))
               / max(denom, np.finfo(np.float64).tiny))
        return err <= rel_l2, f"rel_l2={err:.3e} (tol {rel_l2:g})"
    n_bad = int(np.count_nonzero(out != ref))
    return n_bad == 0, ("bitwise" if n_bad == 0
                        else f"bitwise mismatch ({n_bad}/{out.size} elems)")


def check(op: str, rung: str, shape_class: str, candidate, reference,
          rel_l2: float = 0.0, max_ulps: int = 0) -> Verdict:
    """Probe ``rung`` against the op's reference rung; cached per (op,
    rung, shape_class).

    ``candidate``/``reference`` are zero-argument callables returning the
    probe outputs (tensors or arrays); they run only on a cache miss.  The
    comparison is bitwise unless the rung declares a tolerance
    (``max_ulps`` wins over ``rel_l2``).  The candidate output passes
    through ``faults.maybe_perturb(op, ...)``, so ``wrong:<op>`` clauses
    perturb exactly one probe.  The verdict goes to the disk cache only
    when no fault plan is installed.  Divergence records a
    ``conformance-failed`` event; every probe that runs records
    ``conformance-probe`` with its milliseconds (both outputs computed and
    copied to the host).
    """
    if not _DISK_LOADED:
        _load_disk_cache()
    key = (op, rung, shape_class)
    hit = _VERDICTS.get(key)
    if hit is not None:
        metrics.counter("conformance.cache_hits").inc()
        return Verdict(hit.ok, hit.detail, cached=True)

    from .faults import maybe_fail_stage, maybe_perturb

    # staged forensics: a `stage:<op>.<rung>:conformance` clause kills the
    # probe here, pre-tagged, so gate-path attribution is injectable
    maybe_fail_stage(f"{op}.{rung}", "conformance")
    start = time.perf_counter()
    out = _host(maybe_perturb(op, candidate()))
    ref = _host(reference())
    ok, detail = _compare(out, ref, rel_l2, max_ulps)
    ms = round((time.perf_counter() - start) * 1e3, 3)
    verdict = Verdict(ok, detail)
    _VERDICTS[key] = verdict
    metrics.counter("conformance.probes").inc()
    record_event("conformance-probe", op=op, rung=rung,
                 shape_class=shape_class, ok=ok, ms=ms)
    if not ok:
        metrics.counter("conformance.failed").inc()
        record_event("conformance-failed", op=op, rung=rung,
                     shape_class=shape_class, detail=detail)
    _persist(op, rung, shape_class, verdict)
    return verdict


def cached(op: str, rung: str, shape_class: str) -> bool:
    """Whether ``check`` would replay a verdict for this probe (the disk
    cache included) instead of running it."""
    if not _DISK_LOADED:
        _load_disk_cache()
    return (op, rung, shape_class) in _VERDICTS


def forget(op: str, rung: str, shape_class: str) -> None:
    """Drop one cached verdict, so the next ``check`` runs its probe."""
    _VERDICTS.pop((op, rung, shape_class), None)


def verdicts() -> dict:
    """Snapshot of cached verdicts (introspection, tests)."""
    return {_cache_key(*k): v for k, v in _VERDICTS.items()}
