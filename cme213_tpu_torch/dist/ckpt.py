"""Epoch-committed distributed checkpoints — the cross-rank resume layer.

Counterpart of ``cme213_tpu/dist/ckpt.py``, in its file format: a commit
written by either package loads in the other.  ``core/checkpoint.py``
hardens a *single-process* solve; this module extends it across a gang:
every rank writes its own shards for epoch E (the CRC32-checksummed
``.npz`` payload of ``core/checkpoint.save_checkpoint``), the ranks agree
the writes finished, then rank 0 atomically publishes a ``COMMIT`` manifest
recording epoch, world size, the shard map and per-shard checksums.  The
commit point is the single ``os.replace`` of the manifest: a crash
*anywhere* in the window — mid-shard-write, between shard write and publish
(``CME213_FAULTS=ckpt:commit``), or mid-manifest-write (``ckpt:truncate``) —
leaves the previous ``COMMIT`` in place, so resume always lands on a
globally consistent epoch, never a torn one.

Layout under the checkpoint directory::

    <dir>/epoch_00000002/shard_0_0.npz     per-shard checksummed payloads
    <dir>/epoch_00000002/shard_32_0.npz    (named by global start offsets)
    <dir>/COMMIT                           JSON manifest of the live epoch
    <dir>/COMMIT.prev                      previous committed epoch

A shard is given as ``(index, block)``: its global index range
``((lo, hi), ...)`` in the (padded) global array, from the mesh layout,
and its tensor or array on the rank that holds it (``None`` elsewhere).
The manifest's ``dtype`` is numpy's name (``"float32"``).

Write-completion agreement is file-based: rank 0 reads back and
checksum-validates *every* shard file — its own included, so a torn local
write is caught **before** publish, not at resume — and the other ranks
wait until the manifest for their epoch appears.  A barrier of the process
group would subsume the polling; the file protocol is what the crash-window
tests pin, and it keeps working when the group is wedged.

Elastic resume: ``load_latest_commit`` reassembles the *global* array from
the manifest's shard map, so a commit written on a 2-rank gang restores
onto a 4-shard mesh in one process (or 2-D blocks onto 1-D stripes) —
callers re-cut the returned global array for whatever mesh they now hold.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from ..core import metrics
from ..core.checkpoint import CheckpointCorrupt, read_checkpoint, save_checkpoint
from ..core.faults import maybe_fail_commit, maybe_truncate_file
from ..core.numerics import host_array
from ..core.trace import record_event, span

#: manifest filename of the live committed epoch (atomic-replace published)
COMMIT_NAME = "COMMIT"
#: retained previous committed manifest (same rotation as checkpoint .prev)
PREV_SUFFIX = ".prev"

_FORMAT = 1


class CommitError(RuntimeError):
    """The commit protocol cannot proceed (torn shard, lost peer, bad meta)."""


def epoch_dirname(epoch: int) -> str:
    return f"epoch_{int(epoch):08d}"


def _norm_index(index) -> tuple[tuple[int, int], ...]:
    return tuple((int(lo), int(hi)) for lo, hi in index)


def shard_filename(index: tuple[tuple[int, int], ...]) -> str:
    """Deterministic shard filename from the global start offsets."""
    return "shard_" + "_".join(str(lo) for lo, _ in index) + ".npz"


def global_shard_map(shards) -> list[tuple[tuple[int, int], ...]]:
    """Every shard's global index range, deduplicated and sorted —
    identical on every rank (it derives from the mesh layout, not from
    which shards a rank holds)."""
    return sorted({_norm_index(index) for index, _ in shards})


def _global_shape(shards) -> list[int]:
    """The global array's shape: the largest stop of each dimension."""
    return [max(hi for _, hi in dims)
            for dims in zip(*global_shard_map(shards))]


def write_epoch_shards(ckpt_dir: str, epoch: int, step: int, shards) -> dict:
    """Write the shards this rank holds into the epoch directory
    (checksummed payload format).  Returns ``{filename: crc}`` of the
    shards written here."""
    edir = os.path.join(ckpt_dir, epoch_dirname(epoch))
    os.makedirs(edir, exist_ok=True)
    written = {}
    for index, block in shards:
        if block is None:
            continue
        fname = shard_filename(_norm_index(index))
        written[fname] = save_checkpoint(os.path.join(edir, fname), step,
                                         shard=host_array(block))
    return written


def _validate_shard(path: str, step: int, deadline: float) -> tuple[int, str]:
    """Wait for ``path`` to exist (a peer may still be writing), then
    checksum-validate it; returns its CRC and dtype name.  Shard writes
    land by atomic rename, so an *existing* file that fails validation is
    torn for good — fail at once rather than burn the deadline."""
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise CommitError(f"shard never appeared: {path} "
                              f"(peer dead or stalled?)")
        time.sleep(0.02)
    try:
        got_step, arrays, crc = read_checkpoint(path)
    except Exception as e:
        raise CommitError(f"torn shard {path}: {type(e).__name__}: {e}") from e
    if got_step != step:
        raise CommitError(f"shard {path} carries step {got_step}, "
                          f"expected {step} (stale epoch dir?)")
    return crc, arrays["shard"].dtype.name


def commit_epoch(ckpt_dir: str, epoch: int, step: int, shards,
                 true_shape: tuple[int, ...], meta: dict | None = None,
                 process_id: int = 0, process_count: int = 1,
                 timeout: float = 120.0) -> dict | None:
    """Run one round of the commit protocol for the sharded state
    ``shards`` (every shard's ``(index, block)``, ``block`` ``None`` where
    another rank holds it) at iteration ``step``.

    Every rank writes its shards; rank 0 then validates the complete
    shard set (checksums + step stamp — the write-finished agreement) and
    atomically publishes the ``COMMIT`` manifest, rotating the previous one
    to ``COMMIT.prev``; the other ranks wait until the manifest for this
    epoch is visible, so the gang leaves the protocol in lockstep.  Returns
    the manifest on rank 0, None elsewhere.

    ``true_shape`` records the unpadded logical extent (e.g. the heat
    solve's (ny, nx) under ghost padding) so elastic resume can trim before
    re-decomposing.  ``meta`` rides in the manifest verbatim for caller
    sanity checks (``check_meta``).

    The round runs inside a ``ckpt.commit`` span (per rank: on the other
    ranks it measures shard write + manifest wait); rank 0's
    ``epoch-commit`` event and the ``commit.ms`` histogram carry the
    write→validate→publish latency.
    """
    t0 = time.perf_counter()
    with span("ckpt.commit", epoch=int(epoch), step=int(step)):
        deadline = time.monotonic() + timeout
        write_epoch_shards(ckpt_dir, epoch, step, shards)
        if process_id != 0:
            _wait_for_commit(ckpt_dir, epoch, deadline)
            return None

        edir = os.path.join(ckpt_dir, epoch_dirname(epoch))
        entries = []
        dtype = None
        for index in global_shard_map(shards):
            fname = shard_filename(index)
            # validate every file by read-back — own shards included, so a
            # torn local write aborts the commit here, not poisons resume
            crc, dtype = _validate_shard(os.path.join(edir, fname), step,
                                         deadline)
            entries.append({"file": fname, "index": [list(r) for r in index],
                            "crc": crc})
        manifest = {
            "format": _FORMAT,
            "epoch": int(epoch),
            "step": int(step),
            "world": int(process_count),
            "epoch_dir": epoch_dirname(epoch),
            "global_shape": _global_shape(shards),
            "true_shape": [int(d) for d in true_shape],
            "dtype": dtype,
            "meta": dict(meta or {}),
            "shards": entries,
        }
        # the crash window under test: shards durable, manifest not yet live
        maybe_fail_commit()
        _publish(ckpt_dir, manifest)
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        metrics.counter("commit.epochs").inc()
        metrics.histogram("commit.ms").observe(ms)
        record_event("epoch-commit", epoch=int(epoch), step=int(step),
                     world=int(process_count), shards=len(entries), ms=ms)
        _gc_epochs(ckpt_dir)
        return manifest


def _publish(ckpt_dir: str, manifest: dict) -> None:
    """The commit point: tmp-write the manifest, rotate, atomic replace."""
    path = os.path.join(ckpt_dir, COMMIT_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    maybe_truncate_file(tmp)  # injected torn manifest (no-op without faults)
    if os.path.exists(path):
        os.replace(path, path + PREV_SUFFIX)
    os.replace(tmp, path)


def _wait_for_commit(ckpt_dir: str, epoch: int, deadline: float) -> None:
    path = os.path.join(ckpt_dir, COMMIT_NAME)
    while True:
        try:
            with open(path) as f:
                if json.load(f).get("epoch", -1) >= epoch:
                    return
        except (OSError, ValueError):
            pass  # not published yet (or mid-rotation); keep waiting
        if time.monotonic() > deadline:
            raise CommitError(
                f"COMMIT for epoch {epoch} never published (rank 0 dead?)")
        time.sleep(0.02)


def _gc_epochs(ckpt_dir: str) -> None:
    """Drop epoch directories older than the two committed generations
    (COMMIT + COMMIT.prev) — never a newer one a peer may be writing."""
    keep = set()
    floor = None
    for name in (COMMIT_NAME, COMMIT_NAME + PREV_SUFFIX):
        try:
            with open(os.path.join(ckpt_dir, name)) as f:
                m = json.load(f)
            keep.add(m["epoch_dir"])
            floor = m["epoch"] if floor is None else min(floor, m["epoch"])
        except (OSError, ValueError, KeyError):
            continue
    if floor is None:
        return
    for name in os.listdir(ckpt_dir):
        if not name.startswith("epoch_") or name in keep:
            continue
        try:
            num = int(name.split("_", 1)[1])
        except ValueError:
            continue
        if num < floor:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


# ---------------------------------------------------------------- resume

def _load_manifest(path: str) -> dict:
    with open(path) as f:
        m = json.load(f)
    if m.get("format") != _FORMAT:
        raise CheckpointCorrupt(f"unknown manifest format {m.get('format')!r}")
    for key in ("epoch", "step", "epoch_dir", "global_shape", "true_shape",
                "dtype", "shards"):
        if key not in m:
            raise CheckpointCorrupt(f"manifest missing {key!r}")
    return m


def _assemble(ckpt_dir: str, manifest: dict) -> np.ndarray:
    """Reassemble the global array from the manifest's shard map,
    checksum-pinning every shard to the manifest, and trim ghost padding
    to ``true_shape``."""
    out = np.empty(tuple(manifest["global_shape"]),
                   dtype=np.dtype(manifest["dtype"]))
    covered = 0
    edir = os.path.join(ckpt_dir, manifest["epoch_dir"])
    for entry in manifest["shards"]:
        step, arrays, _ = read_checkpoint(os.path.join(edir, entry["file"]),
                                          expect_crc=entry["crc"])
        if step != manifest["step"]:
            raise CheckpointCorrupt(
                f"shard {entry['file']} step {step} != "
                f"manifest step {manifest['step']}")
        index = tuple(slice(lo, hi) for lo, hi in entry["index"])
        block = arrays["shard"]
        want = tuple(hi - lo for lo, hi in entry["index"])
        if block.shape != want:
            raise CheckpointCorrupt(
                f"shard {entry['file']} shape {block.shape} != index {want}")
        out[index] = block
        covered += block.size
    if covered != out.size:
        raise CheckpointCorrupt(
            f"shard map covers {covered} of {out.size} elements")
    return out[tuple(slice(0, d) for d in manifest["true_shape"])]


def load_latest_commit(ckpt_dir: str):
    """Resume point: ``(manifest, global_array)`` from the newest *valid*
    committed epoch, or None when nothing is recoverable.

    Tries ``COMMIT`` then ``COMMIT.prev``; a torn manifest or any
    checksum-failing / missing / misshapen shard invalidates the whole
    candidate epoch (commits are all-or-nothing) with a structured
    ``commit-invalid`` event, and the previous generation is tried.
    """
    for name in (COMMIT_NAME, COMMIT_NAME + PREV_SUFFIX):
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path):
            continue
        try:
            manifest = _load_manifest(path)
            restored = _assemble(ckpt_dir, manifest)
        except Exception as e:  # torn manifest/shard: fall back a generation
            metrics.counter("commit.invalid").inc()
            record_event("commit-invalid", candidate=name,
                         error=type(e).__name__, message=str(e)[:200])
            continue
        record_event("commit-loaded", epoch=manifest["epoch"],
                     step=manifest["step"], candidate=name)
        return manifest, restored
    return None


def check_meta(manifest: dict, **expected) -> None:
    """Pin resume to a compatible solve: every ``expected`` key must match
    the manifest's ``meta`` verbatim.  World size and mesh shape are
    deliberately NOT pinned — that is the elastic axis."""
    meta = manifest.get("meta", {})
    bad = {k: (meta.get(k), v) for k, v in expected.items()
           if meta.get(k) != v}
    if bad:
        detail = ", ".join(f"{k}: committed {got!r} != current {want!r}"
                           for k, (got, want) in bad.items())
        raise CommitError(f"commit incompatible with this solve ({detail})")
