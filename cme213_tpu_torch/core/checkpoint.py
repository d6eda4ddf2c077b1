"""State snapshotting and checkpoint/resume.

Counterpart of ``cme213_tpu/core/checkpoint.py``.  The reference's only
persistence is debug snapshotting: text grid dumps at init and final
(``Grid::saveStateToFile``, ``hw/hw2/programming/2dHeat.cu:350-359``).
This module keeps that text path (``grid/grid.py``) and adds a binary
checkpoint/resume layer:

- **Checksummed payload**: every ``.npz`` carries a CRC32 over the step
  and the arrays' names, dtypes, shapes and bytes (``__crc``); a mismatch
  is treated like a torn file.
- **Last-good retention**: a save first rotates the previous checkpoint
  to ``<path>.prev``, so one corrupted write never destroys the only
  resume point.
- **Corrupt-file quarantine**: a truncated, foreign or checksum-failing
  file is moved to ``<candidate>.corrupt`` (kept as evidence) with a
  warning and a ``checkpoint-quarantine`` event, and the loader falls
  back to ``.prev``.
- **Nested states**: ``run_with_checkpoints`` accepts nested dicts, lists
  and tuples of arrays or tensors, flattened into per-leaf entries plus
  the tree's skeleton.
- **Abort to last good**: an optional ``guard`` (``resilience.
  all_finite``) runs on each chunk's result; a tripped guard rolls back to
  the last good checkpoint and retries the chunk (bounded).

The file layout is the JAX package's, byte for byte (``__step``,
``__crc``, then ``state`` for a bare array or ``__leaf<i>`` per leaf), and
:func:`_payload_crc` gives the same CRC for the same arrays, so a
bare-array checkpoint written by either package loads in the other.  The
one difference is the tree's skeleton under ``__treedef``: the JAX package
pickles a JAX ``PyTreeDef``, which cannot be loaded without JAX; this
package writes the skeleton of its dicts, lists and tuples as JSON bytes.
A file whose skeleton is not that JSON raises a ``FrameworkError`` naming
the foreign layout; it is not quarantined, since the file is sound.

Leaves are saved from the host (``.detach().cpu()``); a restored state
comes back as numpy arrays, and a solver's step moves it to its device.
"""

from __future__ import annotations

import json
import os
import warnings
import zipfile
import zlib

import numpy as np

from . import metrics
from .errors import FrameworkError
from .numerics import host_array
from .trace import record_event, span

#: suffix of quarantined (corrupt) checkpoint files
CORRUPT_SUFFIX = ".corrupt"
#: suffix of the retained previous-good checkpoint
PREV_SUFFIX = ".prev"

_TREE_KEY = "__treedef"
#: the ``format`` tag of this package's JSON tree skeleton
TREE_FORMAT = "cme213_tpu_torch/tree-json-1"


class CheckpointCorrupt(RuntimeError):
    """The file exists but fails structural or checksum validation."""


def _payload_crc(step: int, arrays: dict) -> int:
    """CRC32 over the step and the sorted (name, dtype, shape, bytes): the
    torn-write detector, the JAX package's function."""
    crc = zlib.crc32(str(int(step)).encode())
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(str(a.dtype).encode(), crc)
        crc = zlib.crc32(str(a.shape).encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def save_checkpoint(path: str, step: int, **arrays) -> int:
    """Atomic write of named arrays (tensors are copied to the host), the
    step counter and the payload checksum, rotating an existing checkpoint
    to ``<path>.prev``.  Returns the payload CRC32."""
    from .faults import maybe_truncate_file

    arrays = {k: host_array(v) for k, v in arrays.items()}
    crc = _payload_crc(step, arrays)
    tmp = path + ".tmp"
    np.savez(tmp, __step=np.int64(step), __crc=np.uint32(crc), **arrays)
    # np.savez appends .npz to names without that extension
    if not tmp.endswith(".npz") and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    maybe_truncate_file(tmp)  # an injected torn write (no-op without faults)
    if os.path.exists(path):
        os.replace(path, path + PREV_SUFFIX)
    os.replace(tmp, path)
    return crc


def read_checkpoint(path: str, expect_crc: int | None = None):
    """(step, arrays, crc) from one candidate file; raises
    ``CheckpointCorrupt`` (or a zip/npz parse error) on anything invalid,
    with no quarantine.  ``expect_crc`` also pins the payload to a
    recorded checksum."""
    with np.load(path, allow_pickle=False) as z:
        if "__step" not in z.files:
            raise CheckpointCorrupt("missing __step (foreign npz?)")
        step = int(z["__step"])
        arrays = {k: z[k] for k in z.files if k not in ("__step", "__crc")}
        crc = int(z["__crc"]) if "__crc" in z.files else None
        if crc is not None:  # files without a checksum stay loadable
            if crc != _payload_crc(step, arrays):
                raise CheckpointCorrupt("payload checksum mismatch")
    if expect_crc is not None and crc != expect_crc:
        raise CheckpointCorrupt(
            f"payload crc {crc} != recorded {expect_crc}")
    return step, arrays, crc


def load_checkpoint(path: str):
    """(step, {name: array}), or None if absent or unrecoverable.

    A corrupt, truncated or foreign candidate is quarantined to
    ``<candidate>.corrupt`` with a warning instead of raising, and the
    loader falls back to ``<path>.prev``.
    """
    for candidate in (path, path + PREV_SUFFIX):
        if not os.path.exists(candidate):
            continue
        try:
            step, arrays, _ = read_checkpoint(candidate)
            return step, arrays
        except (zipfile.BadZipFile, CheckpointCorrupt, KeyError, ValueError,
                OSError, EOFError) as e:
            quarantine = candidate + CORRUPT_SUFFIX
            os.replace(candidate, quarantine)
            metrics.counter("checkpoint.quarantines").inc()
            record_event("checkpoint-quarantine", path=candidate,
                         quarantined_to=quarantine,
                         error=type(e).__name__, message=str(e)[:200])
            warnings.warn(
                f"quarantined corrupt checkpoint {candidate} -> "
                f"{quarantine} ({type(e).__name__}: {e})", stacklevel=2)
    return None


# --------------------------------------------------------- nested states

def _skeleton(tree, leaves: list) -> dict:
    """The JSON skeleton of ``tree``, appending its leaves to ``leaves``
    in ``core/resilience._leaves`` order (dicts by sorted key, as JAX's
    tree flatten orders them)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"checkpointed dict keys must be str: {keys}")
        return {"dict": keys, "of": [_skeleton(tree[k], leaves)
                                     for k in keys]}
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return {kind: [_skeleton(v, leaves) for v in tree]}
    leaves.append(host_array(tree))
    return {"leaf": len(leaves) - 1}


def _rebuild(skel: dict, leaves: list):
    if "dict" in skel:
        return {k: _rebuild(s, leaves) for k, s in zip(skel["dict"],
                                                       skel["of"])}
    if "list" in skel:
        return [_rebuild(s, leaves) for s in skel["list"]]
    if "tuple" in skel:
        return tuple(_rebuild(s, leaves) for s in skel["tuple"])
    return leaves[skel["leaf"]]


def _flatten_state(state) -> dict:
    """A state as named host arrays: a bare array or tensor keeps the
    single-``state`` layout (readable by both packages); a nested state
    gets per-leaf entries and its JSON skeleton."""
    if not isinstance(state, (dict, list, tuple)):
        return {"state": host_array(state)}
    leaves: list = []
    skel = _skeleton(state, leaves)
    arrays = {f"__leaf{i}": v for i, v in enumerate(leaves)}
    doc = json.dumps({"format": TREE_FORMAT, "tree": skel},
                     sort_keys=True).encode()
    arrays[_TREE_KEY] = np.frombuffer(doc, dtype=np.uint8)
    return arrays


def _unflatten_state(arrays: dict):
    """The state saved by :func:`_flatten_state`, its leaves numpy
    arrays.  A skeleton in another layout (the JAX package's pickled
    ``PyTreeDef``) raises ``FrameworkError``."""
    if _TREE_KEY not in arrays:
        return arrays["state"]
    raw = arrays[_TREE_KEY].tobytes()
    try:
        doc = json.loads(raw.decode())
        ok = isinstance(doc, dict) and doc.get("format") == TREE_FORMAT
    except (UnicodeDecodeError, ValueError):
        ok = False
    if not ok:
        raise FrameworkError(
            f"checkpoint tree skeleton '{_TREE_KEY}' is in a foreign layout "
            f"(a pickled JAX PyTreeDef, as the JAX package writes), not "
            f"{TREE_FORMAT}: load it with the package that wrote it; only "
            f"bare-array checkpoints are shared")
    leaves = [arrays[f"__leaf{i}"] for i in range(len(arrays) - 1)]
    return _rebuild(doc["tree"], leaves)


def save_state_checkpoint(path: str, step: int, state) -> None:
    """``save_checkpoint`` of a bare or nested state."""
    save_checkpoint(path, step, **_flatten_state(state))


def _host_state(state):
    """A host copy of ``state`` with the same structure, numpy leaves that
    share no memory with the caller's: a device tensor costs its one
    transfer to the host, a host leaf one copy."""
    import torch

    if isinstance(state, dict):
        return {k: _host_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_host_state(v) for v in state)
    if torch.is_tensor(state) and state.device.type != "cpu":
        return state.detach().cpu().numpy()
    return np.array(host_array(state))


def run_with_checkpoints(step_fn, state, total_iters: int, path: str,
                         every: int = 0, guard=None, op: str = "run",
                         max_retries: int = 1, chunk_op: str | None = None,
                         tracker=None):
    """Drive ``state = step_fn(state, k_iters)`` in checkpointed chunks,
    resuming from ``path`` if a checkpoint exists.

    ``step_fn(state, k)`` advances the state by k iterations without
    writing its input in place; ``state`` is an array, a tensor or a
    nested dict/list/tuple of them, and a restored state is numpy arrays
    of the same structure, which ``step_fn`` moves to its device.  Each
    accepted chunk's state is copied to the host once: that copy is saved,
    measures the chunk's residual and is the next chunk's old state.  ``guard`` is an optional host-side predicate on a chunk's
    result (``resilience.all_finite``): when it returns False the result is
    discarded, the state rolls back to the last good checkpoint and the
    chunk is retried, up to ``max_retries`` times before ``NonFiniteError``
    (the guard runs inside the chunk's ``checkpoint.chunk`` span, and the
    abort dumps the flight recorder, when armed, while that span is open).
    ``op`` names the solve for fault injection (``nan:<op>:<nth>`` poisons
    the Nth chunk) and for events.  Every accepted chunk feeds a
    ``core.numerics.ConvergenceTracker`` (one ``solver-progress`` event a
    chunk); pass ``tracker`` to set the stall policy or read the STALLED
    verdict after the solve.

    A chunk that dies RESOURCE-classified (``oom:<chunk_op>``, ``chunk_op``
    defaulting to ``<op>_chunk``) halves the chunk length and retries from
    the last good checkpoint, a ``chunk-shrunk`` event each halving;
    chunking is arithmetic-neutral, so the result stays bit for bit the
    uninterrupted solve's.  A RESOURCE failure at chunk length 1 re-raises.
    The allocator's own ``torch.cuda.OutOfMemoryError`` re-raises at once:
    an eager chunk holds the same buffers whatever its length, so a
    shorter chunk cannot fit where a longer one did not.
    """
    import time

    import torch

    from . import flight
    from .faults import maybe_oom, maybe_poison
    from .numerics import ConvergenceTracker, progress_from_states
    from .resilience import FailureKind, NonFiniteError, classify_failure

    # a checkpointed solve is a long solve: arm the flight recorder (only
    # when CME213_FLIGHT_DIR opts in, this being a library path)
    flight.install_from_env()
    chunk_op = chunk_op or f"{op}_chunk"
    start = 0
    loaded = load_checkpoint(path)
    if loaded is not None:
        start, arrays = loaded
        # ``host`` is the host copy of ``state``, the old state each
        # chunk's residual is measured against
        state = host = _unflatten_state(arrays)
    else:
        host = _host_state(state)
        if guard is not None:
            # a guarded solve needs a step-0 resume point: a blow-up in
            # the first chunk rolls back to the initial state
            save_state_checkpoint(path, 0, host)
    every = every or total_iters
    it = start
    retries = 0
    if tracker is None:
        tracker = ConvergenceTracker(op)
    while it < total_iters:
        k = min(every, total_iters - it)
        t0 = time.perf_counter()
        try:
            maybe_oom(chunk_op)
            with span("checkpoint.chunk", op=op, start=it, iters=k):
                new_state = maybe_poison(op, step_fn(state, k))
                # the guard's verdict waits for the chunk's device work,
                # so the span times the chunk, not its dispatch
                ok = guard is None or guard(new_state)
                if not ok:
                    record_event("numeric-abort", op=op, step=it + k,
                                 retries=retries)
                    if retries >= max_retries:
                        err = NonFiniteError(
                            f"{op}: non-finite state at step {it + k} "
                            f"(after {retries} rollback retries)")
                        # the black box of the abort, taken while the
                        # failing chunk's span is still open
                        flight.dump("numeric-abort", exc=err)
                        raise err
        except Exception as e:  # noqa: BLE001 — classify, then decide
            if (isinstance(e, torch.cuda.OutOfMemoryError)
                    or classify_failure(e) is not FailureKind.RESOURCE
                    or k <= 1):
                raise
            every = max(1, k // 2)
            metrics.counter("admission.chunk_shrunk").inc()
            record_event("chunk-shrunk", op=op, from_size=k, to_size=every,
                         reason=type(e).__name__)
            # restart the chunk from the last durable state
            loaded = load_checkpoint(path)
            if loaded is not None:
                it, arrays = loaded
                state = host = _unflatten_state(arrays)
            continue
        if not ok:
            retries += 1
            loaded = load_checkpoint(path)
            if loaded is None:
                raise NonFiniteError(
                    f"{op}: non-finite state at step {it + k} and no good "
                    f"checkpoint to roll back to")
            it, arrays = loaded
            state = host = _unflatten_state(arrays)
            metrics.counter("checkpoint.rollbacks").inc()
            record_event("checkpoint-rollback", op=op, resumed_step=it,
                         retries=retries)
            continue
        elapsed = time.perf_counter() - t0
        prev = host
        with span("checkpoint.save", op=op, step=it + k):
            host = _host_state(new_state)
            save_state_checkpoint(path, it + k, host)
        progress_from_states(tracker, it + k, prev, host, k, elapsed)
        state = new_state
        it += k
    return state
