"""Process-wide program cache: build once per shape class, serve hits.

Counterpart of ``cme213_tpu/core/programs.py``.  The reference's CUDA
workloads load their module once and serve every launch from it.  Here a
"program" is a warmed runner: its build loads the kernel's library
(``ops/_kernels.library``) and fixes its launch plan
(``stencil_pipeline.launch_plan``), and its warm-up makes one launch
behind the caller's ``check_op`` barrier, so a build or launch failure
surfaces there, named, before any timed phase.  Runners are cached by

    (op, rung, shape_class, dtype, device, static params)

The device is part of the key (``cuda:0`` against ``cpu``), so a program
built for one device never serves the other.  Dispatch (``apps/
spmv_scan.py``, ``ops/stencil_pipeline.py``) and the conformance probes
fetch their programs through :func:`get`:

- **hit**: one dict lookup returns the warmed runner (``program-cache-hit``
  event, ``programs.hits`` counter); no build, no warm-up launch;
- **miss**: ``build()`` runs inside an ``<op>.compile`` span under the
  ``lower`` forensics stage, ``warm(fn)`` under ``compile``, and the entry
  is published only if both succeed (``program-cache-miss``,
  ``programs.misses``).  A build or warm-up that raises caches nothing.

Cached runners take every per-problem tensor as an **argument** (values,
gathered x, head flags, grids): closing over request data would serve one
caller's inputs to another.  What changes the program (iteration count,
tile, CFL constants) goes into the key through ``**static``.

:func:`canonical_size` is the pad-and-mask companion: it snaps request
sizes to power-of-two buckets so heterogeneous traffic lands on a small
set of shape classes.  ``reset()`` clears the cache; ``trace.clear_events``
calls it, so a fresh telemetry slate means a cold cache.
"""

from __future__ import annotations

import threading

from . import diag, metrics
from .faults import maybe_fail_stage
from .trace import record_event, span

_LOCK = threading.RLock()
_CACHE: dict[tuple, object] = {}


def canonical_size(n: int, floor: int = 1) -> int:
    """The canonical shape bucket of a size-``n`` request: the next power
    of two (at least ``floor``)."""
    n = max(int(n), int(floor))
    return 1 << max(0, (n - 1)).bit_length()


def device_key(device) -> str:
    """The device part of a key: ``"cpu"``, ``"cuda:<index>"`` (an
    unindexed ``cuda`` resolves to the current device), or ``"host"`` for
    a program that holds no device work."""
    if device is None:
        return "host"
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _key(op: str, rung: str, shape_class: str, dtype, device,
         static: dict) -> tuple:
    return (op, str(rung), str(shape_class), str(dtype), device_key(device),
            tuple(sorted((k, repr(v)) for k, v in static.items())))


def get(op: str, rung: str, shape_class: str, build, *, dtype="f32",
        device=None, warm=None, cost=None, probe=None, **static):
    """The process-wide program for ``(op, rung, shape_class, dtype,
    device, static)``: built, warmed and cached on first use, a dict lookup
    after.

    ``build()`` returns the runner; ``warm(fn)`` (optional) launches it
    once behind a named barrier.  Both run inside the ``<op>.compile``
    span on a miss, ``build`` under the ``lower`` forensics stage and
    ``warm`` under ``compile``, so an exception out of a miss carries the
    phase it died in.  With ``CME213_DIAG_ATTRIBUTION`` on, a fresh
    program with a roofline ``cost`` and a zero-argument ``probe``
    (returning example arguments) is checked against what it stages
    (``diag.maybe_check_attribution``) right after it is cached.
    """
    key = _key(op, rung, shape_class, dtype, device, static)
    with _LOCK:
        fn = _CACHE.get(key)
    if fn is not None:
        record_event("program-cache-hit", op=op, rung=rung,
                     shape_class=shape_class)
        metrics.counter("programs.hits").inc()
        return fn
    record_event("program-cache-miss", op=op, rung=rung,
                 shape_class=shape_class)
    metrics.counter("programs.misses").inc()
    with span(f"{op}.compile", kernel=rung, shape_class=shape_class):
        maybe_fail_stage(f"{op}.{rung}", "lower")
        with diag.stage_scope(f"{op}.{rung}", "lower"):
            fn = build()
        if warm is not None:
            maybe_fail_stage(f"{op}.{rung}", "compile")
            with diag.stage_scope(f"{op}.{rung}", "compile"):
                warm(fn)
    with _LOCK:
        _CACHE[key] = fn
    diag.maybe_check_attribution(op, rung, shape_class, fn, probe, cost)
    return fn


def size() -> int:
    """Number of cached programs."""
    with _LOCK:
        return len(_CACHE)


def keys() -> list[tuple]:
    """Snapshot of the cache keys (introspection, tests)."""
    with _LOCK:
        return sorted(_CACHE)


def reset() -> None:
    """Forget every cached program (tests; ``trace.clear_events`` calls it
    so a fresh telemetry slate means a cold cache)."""
    with _LOCK:
        _CACHE.clear()
