"""Blockwise segmented scan: the hand-written Hopper kernel's wrappers.

Counterpart of ``cme213_tpu/ops/segmented_pallas.py``.  Both entry points
launch ``csrc/segmented_scan.cu``: ``segmented_scan_pallas`` (B6) scans
values with head flags; ``spmv_scan_pallas`` (B7) runs the hw_final
iteration ``a ← segscan(a·xx)`` N times with the multiply fused into the
scan's load.  One call of the C entry is one scan and one launch (a
single-pass look-back; see the source's note), and ``LAUNCHES`` counts
those calls.

Dispatch is on the tensor's device: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel, and a failed build or launch raises.  The
kernel takes float32 only, as the TPU kernel does; the plain versions also
take float64.

The plain versions follow the kernel's decomposition in PyTorch, in the same
order of additions: tiles of ``threads × items`` elements, a thread-serial
scan of each thread's ``items``, a segmented Hillis–Steele over each warp's
thread summaries (strides 1, 2, … < ``warp``), the same over each tile's
warp summaries, the serial left fold of the tile summaries in tile order
(the carry the kernel's look-back finds), and the incoming carries added
level by level (tile → warp → thread → element).  So on the card the kernel
equals them bit for bit.  Their geometry is an argument, so tests on the
CPU can use small tiles; the defaults are the kernel's, checked against the
built library before every solve on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.errors import FrameworkError
from . import _kernels

#: calls of the C entry (one scan, one launch each) per entry point
LAUNCHES = {"segscan": 0, "spmv_fused": 0}

#: the kernel's geometry (``csrc/segmented_scan.cu``)
TILE_ITEMS = 8
TILE_THREADS = 256
WARP = 32
TILE = TILE_ITEMS * TILE_THREADS

_GEOMETRY = (TILE_ITEMS, TILE_THREADS, WARP)

#: the largest epoch the status words hold (30 bits)
MAX_EPOCH = 2 ** 30 - 1

#: (device index, stream) -> [workspace, last epoch]: the kernel's ticket
#: counter and status words, zeroed once and reused by every later call on
#: that stream, each with the next epoch
_WORKSPACES: dict[tuple[int, int], list] = {}


def _hillis_steele(v: torch.Tensor, f: torch.Tensor):
    """Inclusive segmented Hillis–Steele along the last axis, strides 1, 2,
    … < its length: ``v[l] = f[l] ? v[l] : v[l-d] + v[l]``,
    ``f[l] |= f[l-d]`` for ``l ≥ d``, every lane from the old values."""
    d, length = 1, v.shape[-1]
    while d < length:
        nv, nf = v.clone(), f.clone()
        nv[..., d:] = torch.where(f[..., d:], v[..., d:],
                                  v[..., :-d] + v[..., d:])
        nf[..., d:] = f[..., d:] | f[..., :-d]
        v, f = nv, nf
        d *= 2
    return v, f


def _exclusive_carry(inc_v, inc_f, carry):
    """Incoming value of each entry along the last axis: ``carry`` for the
    first, else the inclusive ``(v, f)`` of the entry before, combined with
    ``carry`` (``f ? v : carry + v``).  ``carry`` broadcasts against
    ``inc_v[..., :1]``."""
    prev_v, prev_f = inc_v[..., :-1], inc_f[..., :-1]
    rest = torch.where(prev_f, prev_v, carry + prev_v)
    return torch.cat([carry.expand_as(inc_v[..., :1]), rest], dim=-1)


def serial_fold(tile_v: np.ndarray, tile_f: np.ndarray) -> np.ndarray:
    """The incoming carry of each tile: ``carry[t] = P[t−1]`` with
    ``P[−1] = 0`` and ``P[t] = f[t] ? v[t] : P[t−1] + v[t]``, the serial
    left fold of the tile summaries in tile order, one add at a time in
    their dtype.  ``np.add.accumulate`` over each run that a head starts
    (the first from 0) adds left to right."""
    p = np.empty_like(tile_v)
    heads = np.flatnonzero(tile_f)
    starts = np.union1d([0], heads)
    for s, e in zip(starts, np.append(starts[1:], len(tile_v))):
        if tile_f[s]:
            p[s:e] = np.add.accumulate(tile_v[s:e])
        else:
            run = np.concatenate([np.zeros(1, tile_v.dtype), tile_v[s:e]])
            p[s:e] = np.add.accumulate(run)[1:]
    return np.concatenate([np.zeros(1, tile_v.dtype), p[:-1]])


def _segscan_plain(w: torch.Tensor, head_flags: torch.Tensor, items: int,
                   threads: int, warp: int) -> torch.Tensor:
    n = w.shape[0]
    if threads % warp or threads // warp > warp:
        raise ValueError(f"geometry threads={threads} warp={warp}: each "
                         f"block is whole warps, at most warp² threads")
    tile = items * threads
    ntiles = max(1, -(-n // tile))
    pad = ntiles * tile - n
    wp = torch.nn.functional.pad(w, (0, pad)).view(ntiles * threads, items)
    fp = torch.nn.functional.pad(head_flags != 0, (0, pad)) \
        .view(ntiles * threads, items)
    # thread-serial scan; seen[:, j]: a head at or before j in the chunk
    loc = torch.empty_like(wp)
    seen = torch.empty_like(fp)
    loc[:, 0], seen[:, 0] = wp[:, 0], fp[:, 0]
    for j in range(1, items):
        loc[:, j] = torch.where(fp[:, j], wp[:, j], loc[:, j - 1] + wp[:, j])
        seen[:, j] = seen[:, j - 1] | fp[:, j]
    nw = threads // warp
    # warp scan of the thread summaries, then the tile's warp summaries
    tv, tf = _hillis_steele(loc[:, -1].reshape(ntiles, nw, warp),
                            seen[:, -1].reshape(ntiles, nw, warp))
    wv, wf = _hillis_steele(tv[:, :, -1], tf[:, :, -1])
    # the tile summaries' fold on the host (a few ms at pwtk's 5681 tiles)
    carry = torch.from_numpy(serial_fold(
        wv[:, -1].cpu().numpy(), wf[:, -1].cpu().numpy())).to(w.device)
    # incoming carries, level by level: tile -> warp -> thread -> element
    win = _exclusive_carry(wv, wf, carry[:, None])          # (ntiles, nw)
    tin = _exclusive_carry(tv, tf, win[:, :, None])         # (.., warp)
    tin = tin.reshape(ntiles * threads, 1)
    out = torch.where(seen, loc, tin + loc)
    return out.reshape(-1)[:n]


def _check_args(values: torch.Tensor, head_flags: torch.Tensor,
                xx: torch.Tensor | None = None) -> None:
    if values.dim() != 1 or values.dtype not in (torch.float32,
                                                 torch.float64):
        raise TypeError(f"expected 1-D float32/float64 values, got "
                        f"{values.dim()}-D {values.dtype}")
    others = [head_flags] + ([] if xx is None else [xx])
    if any(t.shape != values.shape or t.device != values.device
           for t in others):
        raise ValueError("values, xx and head flags must have one shape "
                         "and one device")
    if xx is not None and xx.dtype != values.dtype:
        raise TypeError(f"xx is {xx.dtype}, values {values.dtype}")


def segmented_scan_pallas_plain(values: torch.Tensor,
                                head_flags: torch.Tensor, *,
                                items: int = TILE_ITEMS,
                                threads: int = TILE_THREADS,
                                warp: int = WARP) -> torch.Tensor:
    """B6's plain PyTorch version: the inclusive segmented sum scan in the
    kernel's order of additions, at the given geometry."""
    _check_args(values, head_flags)
    return _segscan_plain(values, head_flags, items, threads, warp)


def spmv_scan_pallas_plain(a: torch.Tensor, xx: torch.Tensor,
                           head_flags: torch.Tensor, iters: int, *,
                           items: int = TILE_ITEMS,
                           threads: int = TILE_THREADS, warp: int = WARP
                           ) -> torch.Tensor:
    """B7's plain PyTorch version: ``iters`` × ``a ← segscan(a·xx)`` in the
    kernel's order of additions, at the given geometry."""
    _check_args(a, head_flags, xx)
    for _ in range(iters):
        a = _segscan_plain(a * xx, head_flags, items, threads, warp)
    return a


def _cuda_args(values: torch.Tensor, head_flags: torch.Tensor):
    """Checks for a launch; the int32 flags."""
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"the segmented-scan kernel takes float32, got "
                        f"{values.dtype}")
    built = _kernels.segmented_scan_geometry()
    if built != _GEOMETRY:
        raise FrameworkError(
            f"csrc/segmented_scan.cu is built with geometry {built}, the "
            f"plain version assumes {_GEOMETRY}")
    return head_flags.to(torch.int32).contiguous()


def _scan(values, xx, flags, out) -> None:
    """One launch: ``out = segscan(values[·xx])`` with the current stream's
    workspace (zeroed when it is first made, grown or out of epochs) and
    its next epoch."""
    device = values.device
    stream = torch.cuda.current_stream(device).cuda_stream
    words = 2 + 2 * -(-values.shape[0] // TILE)
    entry = _WORKSPACES.get((device.index, stream))
    if entry is None or entry[0].shape[0] < words or entry[1] >= MAX_EPOCH:
        entry = _WORKSPACES[(device.index, stream)] = [
            torch.zeros(words, dtype=torch.int32, device=device), 0]
    entry[1] += 1
    _kernels.segmented_scan(values, xx, flags, out, entry[0], entry[1],
                            stream)


def segmented_scan_pallas(values: torch.Tensor,
                          head_flags: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum scan of 1-D ``values`` with head flags
    (nonzero = a segment starts here) — B6.

    A CUDA tensor launches ``csrc/segmented_scan.cu`` once (float32 only);
    a CPU tensor takes ``segmented_scan_pallas_plain``.  Returns a new
    tensor.
    """
    _check_args(values, head_flags)
    if values.device.type == "cpu":
        return segmented_scan_pallas_plain(values, head_flags)
    flags = _cuda_args(values, head_flags)
    out = torch.empty_like(values, memory_format=torch.contiguous_format)
    if values.shape[0] == 0:
        return out
    _scan(values.contiguous(), None, flags, out)
    LAUNCHES["segscan"] += 1
    return out


def spmv_scan_pallas(a: torch.Tensor, xx: torch.Tensor,
                     head_flags: torch.Tensor, iters: int) -> torch.Tensor:
    """The hw_final iteration with the multiply fused into the scan:
    ``iters`` × ``a ← segscan(a·xx)`` — B7.

    A CUDA tensor launches ``csrc/segmented_scan.cu`` once an iteration, in
    place on one work buffer (float32 only); a CPU tensor takes
    ``spmv_scan_pallas_plain``.  The caller's ``a`` is not modified.
    """
    _check_args(a, head_flags, xx)
    if a.device.type == "cpu":
        return spmv_scan_pallas_plain(a, xx, head_flags, iters)
    flags = _cuda_args(a, head_flags)
    work = a.clone(memory_format=torch.contiguous_format)
    if a.shape[0] == 0:
        return work
    xx = xx.contiguous()
    for _ in range(iters):
        _scan(work, xx, flags, work)
        LAUNCHES["spmv_fused"] += 1
    return work


# ---------------------------------------------------- PageRank's pull

#: launches of the pull and of the update after it
#: (``kernel.launches.pr_pull`` / ``.pr_update`` in the exit snapshot)
PULL_LAUNCHES = {"pr_pull": 0, "pr_update": 0}

#: the pull's geometry (``csrc/segmented_scan.cu``: slots a thread,
#: threads a tile, the update's most blocks)
PULL_GEOMETRY = (8, 256, 1024)
PULL_TILE = PULL_GEOMETRY[0] * PULL_GEOMETRY[1]


def _check_pull_geometry() -> None:
    built = _kernels.pagerank_pull_geometry()
    if built != PULL_GEOMETRY:
        raise FrameworkError(
            f"csrc/segmented_scan.cu's pull is built with geometry {built}, "
            f"the plan assumes {PULL_GEOMETRY}")


def pagerank_pull(plan, contrib: torch.Tensor) -> None:
    """One launch of the pull into ``plan.sums`` (``ops/gather.pull_sums``
    on a card): the plan's workspace is made zeroed at its first launch
    and each launch takes its next epoch."""
    if plan.workspace is None or plan.epoch >= MAX_EPOCH:
        _check_pull_geometry()
        words = 2 + 4 * (plan.tile_row.shape[0] - 1)
        plan.workspace = torch.zeros(words, dtype=torch.int32,
                                     device=contrib.device)
        plan.epoch = 0
    plan.epoch += 1
    _kernels.pagerank_pull(plan.nbrs, contrib, plan.off, plan.rowmap,
                           plan.tile_row, plan.sums, plan.workspace,
                           plan.epoch)
    PULL_LAUNCHES["pr_pull"] += 1


def pagerank_update(plan, sums, deg, score, contrib, base: float,
                    damping: float) -> torch.Tensor:
    """One launch of the per-vertex update (``ops/gather.pull_update`` on a
    card); returns its float64 error scalar on the device, which the next
    launch on the plan overwrites."""
    if plan.update is None:
        dev = score.device
        plan.update = (
            torch.empty(PULL_GEOMETRY[2], dtype=torch.float64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.float64, device=dev))
    partials, counter, err = plan.update
    _kernels.pagerank_update(sums, deg, score, contrib, base, damping,
                             partials, counter, err)
    PULL_LAUNCHES["pr_update"] += 1
    return err[0]
