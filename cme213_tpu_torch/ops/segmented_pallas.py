"""Blockwise segmented scan: the hand-written Hopper kernel's wrappers.

Counterpart of ``cme213_tpu/ops/segmented_pallas.py``.  Both entry points
launch ``csrc/segmented_scan.cu``: ``segmented_scan_pallas`` (B6) scans
values with head flags; ``spmv_scan_pallas`` (B7) runs the hw_final
iteration ``a ← segscan(a·xx)`` N times with the multiply fused into the
scan's load.  One call of the C entry is one scan (three launches: tile
reduce, carry scan, tile down-sweep; see the source's note), and
``LAUNCHES`` counts those calls.

Dispatch is on the tensor's device: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel, and a failed build or launch raises.  The
kernel takes float32 only, as the TPU kernel does; the plain versions also
take float64.

The plain versions follow the kernel's decomposition in PyTorch, in the same
order of additions: tiles of ``threads × items`` elements, a thread-serial
scan of each thread's ``items``, a segmented Hillis–Steele over each warp's
thread summaries (strides 1, 2, … < ``warp``), the same over each tile's
warp summaries, a scan of the tile summaries in chunks of
``carry_threads``, and the incoming carries added level by level (tile →
warp → thread → element).  So on the card the kernel equals them bit for
bit.  Their geometry is an argument, so tests on the CPU can use small
tiles; the defaults are the kernel's, checked against the built library
before every solve on the card.
"""

from __future__ import annotations

import torch

from ..core.errors import FrameworkError
from . import _kernels

#: calls of the C entry (one scan each) per entry point
LAUNCHES = {"segscan": 0, "spmv_fused": 0}

#: the kernel's geometry (``csrc/segmented_scan.cu``)
TILE_ITEMS = 8
TILE_THREADS = 256
WARP = 32
CARRY_THREADS = 1024
TILE = TILE_ITEMS * TILE_THREADS

_GEOMETRY = (TILE_ITEMS, TILE_THREADS, WARP, CARRY_THREADS)


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


def _scan_carries(tile_v, tile_f, warp: int, carry_threads: int):
    """The carry pass: ``carry[t]`` = the tile summaries scanned through tile
    t−1, ``carry[0] = 0``, in chunks of ``carry_threads`` with a running
    carry between chunks."""
    ntiles = tile_v.shape[0]
    carry = tile_v.new_zeros(ntiles)
    run = tile_v.new_zeros(1)
    nw = carry_threads // warp
    for c0 in range(0, ntiles - 1, carry_threads):
        m = min(carry_threads, ntiles - c0)
        v = tile_v.new_zeros(carry_threads)
        f = tile_f.new_zeros(carry_threads)
        v[:m], f[:m] = tile_v[c0:c0 + m], tile_f[c0:c0 + m]
        v, f = _hillis_steele(v.view(nw, warp), f.view(nw, warp))
        gv, gf = _hillis_steele(v[:, -1], f[:, -1])
        win = _exclusive_carry(gv, gf, run)           # (nw,)
        incl = torch.where(f, v, win[:, None] + v).reshape(-1)
        k = min(carry_threads, ntiles - 1 - c0)
        carry[c0 + 1:c0 + 1 + k] = incl[:k]
        run = incl[-1:]
    return carry


def _segscan_plain(w: torch.Tensor, head_flags: torch.Tensor, items: int,
                   threads: int, warp: int,
                   carry_threads: int) -> torch.Tensor:
    n = w.shape[0]
    if threads % warp or carry_threads % warp or threads // warp > warp \
            or carry_threads // warp > warp:
        raise ValueError(f"geometry threads={threads} warp={warp} "
                         f"carry_threads={carry_threads}: each block is whole "
                         f"warps, at most warp² threads")
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
    carry = _scan_carries(wv[:, -1], wf[:, -1], warp, carry_threads)
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
                                warp: int = WARP,
                                carry_threads: int = CARRY_THREADS
                                ) -> torch.Tensor:
    """B6's plain PyTorch version: the inclusive segmented sum scan in the
    kernel's order of additions, at the given geometry."""
    _check_args(values, head_flags)
    return _segscan_plain(values, head_flags, items, threads, warp,
                          carry_threads)


def spmv_scan_pallas_plain(a: torch.Tensor, xx: torch.Tensor,
                           head_flags: torch.Tensor, iters: int, *,
                           items: int = TILE_ITEMS,
                           threads: int = TILE_THREADS, warp: int = WARP,
                           carry_threads: int = CARRY_THREADS
                           ) -> torch.Tensor:
    """B7's plain PyTorch version: ``iters`` × ``a ← segscan(a·xx)`` in the
    kernel's order of additions, at the given geometry."""
    _check_args(a, head_flags, xx)
    for _ in range(iters):
        a = _segscan_plain(a * xx, head_flags, items, threads, warp,
                           carry_threads)
    return a


def _cuda_args(values: torch.Tensor, head_flags: torch.Tensor):
    """Checks for a launch; the int32 flags and a workspace of 3 words per
    tile, allocated once for the solve."""
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
    flags = head_flags.to(torch.int32).contiguous()
    ntiles = -(-values.shape[0] // TILE)
    workspace = torch.empty(3 * ntiles, dtype=torch.float32,
                          device=values.device)
    return flags, workspace


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
    flags, workspace = _cuda_args(values, head_flags)
    out = torch.empty_like(values, memory_format=torch.contiguous_format)
    if values.shape[0] == 0:
        return out
    _kernels.segmented_scan(values.contiguous(), None, flags, out, workspace)
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
    flags, workspace = _cuda_args(a, head_flags)
    work = a.clone(memory_format=torch.contiguous_format)
    if a.shape[0] == 0:
        return work
    xx = xx.contiguous()
    for _ in range(iters):
        _kernels.segmented_scan(work, xx, flags, work, workspace)
        LAUNCHES["spmv_fused"] += 1
    return work
