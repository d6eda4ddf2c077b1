"""Segmented inclusive scan in plain PyTorch — the hw_final engine primitive.

Counterpart of ``cme213_tpu/ops/segmented.py``, which the JAX package left
to XLA; the port leaves it to plain torch ops.  The scan runs over pairs
``(value, head_flag)`` with the segmented operator

    (va, fa) ⊕ (vb, fb) = (vb + (fb ? 0 : va), fa | fb)

in two forms behind the size-dispatching ``segmented_scan``: the flat
Hillis–Steele log-sweep (``segmented_scan_flat``, O(n·log n) work) and the
blocked 3-phase decomposition (``segmented_scan_blocked``, O(n) work).
The flat form repeats the reference's arithmetic exactly and equals it bit
for bit; the blocked and dense forms use ``torch.cumsum``, which associates
differently from XLA's, so they agree with the reference to rounding (and
exactly on integer-valued inputs).  The port's blocked form sums float32
blocks in float64, so a segment that starts deep in a block keeps its
digits, where the reference's cancels them.

``SCANS`` counts the calls of each form (one a call, whatever its length
or lanes; the blocked form's carry scan is not counted); the exit
snapshot publishes it as ``kernel.scans.<form>``.

Segment descriptors match the reference's: ``s`` = sorted segment start
indices with ``s[0] == 0``; ``segment_ids`` is the ``key[i]`` precompute of
``hw/hw_final/programming/fp.cu:111-125``.
"""

from __future__ import annotations

import numpy as np
import torch

#: below this length the auto dispatch runs the flat log-sweep, at or above
#: it the blocked O(n) form (the reference's default crossover)
BLOCKED_SCAN_THRESHOLD = 1 << 16
#: per-block extent of the blocked decomposition
DEFAULT_SCAN_BLOCK = 4096
#: calls of each scan form in this process, one a call
SCANS = {"flat": 0, "blocked": 0}


def head_flags_from_starts(seg_starts: torch.Tensor, n: int) -> torch.Tensor:
    """int32 {0,1} vector with 1 at each segment head; starts outside
    [-n, n) are dropped."""
    s = torch.as_tensor(seg_starts).to(torch.int64)
    flags = torch.zeros(n, dtype=torch.int32, device=s.device)
    flags[s[(s >= -n) & (s < n)]] = 1
    return flags


def segment_ids_from_starts(seg_starts: torch.Tensor, n: int) -> torch.Tensor:
    """``key[i] = segment id``: cumulative sum of the head flags minus one."""
    return torch.cumsum(head_flags_from_starts(seg_starts, n), dim=0,
                        dtype=torch.int32) - 1


def scan_threshold() -> int:
    """The flat/blocked crossover of the auto dispatch: the built-in
    ``BLOCKED_SCAN_THRESHOLD``.  The tuner's ``segmented_scan`` space
    measures the crossover (``core/tune.py``); the dispatch reads no
    winner until a measurement on the card says which to serve."""
    return BLOCKED_SCAN_THRESHOLD


def scan_form(n: int) -> str:
    """The form ``segmented_scan`` dispatches at length ``n``."""
    return "blocked" if n >= scan_threshold() else "flat"


def segmented_scan_flat(values: torch.Tensor,
                        head_flags: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum scan — flat Hillis–Steele log-sweep: at
    stride d, ``v[i] += f[i] ? 0 : v[i-d]`` and ``f[i] |= f[i-d]`` for
    ``i ≥ d``, strides 1, 2, … up to n−1.  Adds 0 where the reference adds
    0, so it equals ``cme213_tpu``'s flat scan bit for bit.  The scan runs
    along the last dimension; leading dimensions are independent lanes,
    each equal to its own 1-D scan bit for bit (elementwise ops only)."""
    SCANS["flat"] += 1
    return _flat(values, head_flags)


def _flat(values: torch.Tensor, head_flags: torch.Tensor) -> torch.Tensor:
    n = values.shape[-1]
    steps = max(1, (n - 1).bit_length())
    idx = torch.arange(n, device=values.device)
    v, f = values, head_flags.to(torch.int32)
    for i in range(steps):
        d = 1 << i
        pv, pf = torch.roll(v, d, -1), torch.roll(f, d, -1)
        valid = idx >= d
        add = torch.where(valid & (f == 0), pv, torch.zeros_like(v))
        f = torch.where(valid, f | pf, f)
        v = v + add
    return v


def segmented_scan_blocked(values: torch.Tensor, head_flags: torch.Tensor,
                           block_size: int = DEFAULT_SCAN_BLOCK
                           ) -> torch.Tensor:
    """Inclusive segmented sum scan — blocked O(n) form:

    1. per-block local scans as ``cumsum(v) − cumsum[last head − 1]``
       (reset by subtraction: one cumsum, one gather), float32 blocks
       summed and subtracted in float64 and rounded once to float32, so
       that a segment starting deep in a block is not its difference of
       two large float32 sums;
    2. a flat segmented scan of the per-block carries ``(last local value,
       block holds a head)``;
    3. each block's incoming carry added to its elements before its first
       head.

    Pads to a block multiple (the pad isolated in its own segment and
    dropped on return).  The scan runs along the last dimension; leading
    dimensions are independent lanes, each equal to its own 1-D scan bit
    for bit (``_lane_cumsum``).
    """
    SCANS["blocked"] += 1
    n = values.shape[-1]
    lead = values.shape[:-1]
    flags = head_flags.to(torch.int32)
    nblk = max(1, -(-n // block_size))
    padded = nblk * block_size
    if padded != n:
        v = values.new_zeros(*lead, padded)
        v[..., :n] = values
        f = flags.new_zeros(*lead, padded)
        f[..., :n] = flags
        f[..., n] = 1  # quarantine the pad in its own segment
    else:
        v, f = values, flags
    v2 = v.reshape(*lead, nblk, block_size)
    f2 = f.reshape(*lead, nblk, block_size)

    wide = torch.float64 if v.dtype == torch.float32 else None
    cs = _lane_cumsum(v2, wide)
    lane = torch.arange(block_size, device=v.device).expand(v2.shape)
    # index of the last head at or before each position (-1: none yet)
    hp = torch.cummax(torch.where(f2 > 0, lane, -1), dim=-1).values
    base = torch.where(hp >= 1,
                       torch.gather(cs, -1, (hp - 1).clamp(min=0)),
                       torch.zeros_like(cs))
    local = cs - base
    if wide is not None:
        local = local.to(v.dtype)

    carry_v = local[..., -1]
    carry_f = (hp[..., -1] >= 0).to(torch.int32)
    inc_v = _flat(carry_v, carry_f)
    incoming = torch.cat([inc_v.new_zeros(*lead, 1), inc_v[..., :-1]], -1)

    out = local + torch.where(hp < 0, incoming[..., None],
                              torch.zeros_like(local))
    return out.reshape(*lead, padded)[..., :n]


def _lane_cumsum(v2: torch.Tensor, dtype=None) -> torch.Tensor:
    """``torch.cumsum`` of (..., nblk, block) blocks along the last
    dimension, accumulated and returned in ``dtype`` (torch's default
    where ``None``), one call per lane of the leading dimensions.  On a
    CUDA tensor torch picks the cumsum's association from the shape: a
    single row goes to CUB, several rows to a row kernel whose thread
    layout depends on the row count (``get_log_num_threads_x_inner_scan``).
    So a lane's blocks must be summed at the 1-D scan's own (nblk, block)
    shape to equal it bit for bit: B calls, not one over B·nblk rows."""
    if v2.dim() == 2:
        return torch.cumsum(v2, dim=1, dtype=dtype)
    out = torch.empty(v2.shape, dtype=dtype or v2.dtype, device=v2.device)
    for src, dst in zip(v2.reshape(-1, *v2.shape[-2:]),
                        out.view(-1, *v2.shape[-2:])):
        torch.cumsum(src, dim=1, dtype=dtype, out=dst)
    return out


def segmented_scan(values: torch.Tensor, head_flags: torch.Tensor, *,
                   block_size: int | None = None) -> torch.Tensor:
    """Inclusive segmented sum scan — the auto dispatch: the flat log-sweep
    below ``scan_threshold()`` elements, the blocked form (at
    ``block_size``, default ``DEFAULT_SCAN_BLOCK``) at or above it, along
    the last dimension (leading dimensions are lanes)."""
    if scan_form(values.shape[-1]) == "blocked":
        return segmented_scan_blocked(values, head_flags,
                                      block_size or DEFAULT_SCAN_BLOCK)
    return segmented_scan_flat(values, head_flags)


def scan_peak_bytes(n: int, elem: int, scan: str = "auto",
                    block_size: int = DEFAULT_SCAN_BLOCK) -> int:
    """Peak device bytes one scan of ``n`` ``elem``-byte values holds
    beyond its two inputs, its output included, counted from the code
    above (eager torch frees a temporary with its last reference):

    - ``flat``, at the birth of each stride's ``add``: ``v``, ``pv``, the
      previous stride's ``add``, the zeros and the new ``add`` (values),
      ``idx`` (int64), ``f`` and ``pf`` (int32), ``valid`` and the mask
      (bool);
    - ``blocked``, over the padded length, with ``cs`` and ``base`` in
      the running sums' width (8 bytes for 4-byte values, which sum in
      float64), ``hp`` (int64) and a mask (bool), at the larger of two
      births: ``base``'s ``where`` (``cs``, the gathered values, the zeros
      and the ``where``, all four wide) and ``out`` (``cs`` and ``base``,
      then ``local``, the zeros, the ``where`` and ``out`` in the values'
      width); plus the padded copies of the values and flags when ``n`` is
      not a block multiple; the carries' scan over one value a block is
      left out;
    - ``auto``: the form ``segmented_scan`` dispatches at ``n``."""
    if scan == "auto":
        scan = scan_form(n)
    if scan == "flat":
        return n * (5 * elem + 8 + 2 * 4 + 2)
    padded = max(1, -(-n // block_size)) * block_size
    pad = (elem + 4) * padded if padded != n else 0
    wide = 8 if elem == 4 else elem
    return padded * (2 * wide + max(2 * wide, 4 * elem) + 8 + 1) + pad


def segmented_scan_from_starts(values: torch.Tensor,
                               seg_starts: torch.Tensor) -> torch.Tensor:
    flags = head_flags_from_starts(seg_starts.to(values.device),
                                   values.shape[0])
    return segmented_scan(values, flags)


def segmented_scan_dense(values: torch.Tensor, seg_starts: torch.Tensor,
                         max_seg_len: int) -> torch.Tensor:
    """Dense per-segment formulation (the role of the reference's naive
    ``fp_old.cu:30-58``): scatter each segment into a row of a
    (p, max_seg_len) matrix, cumsum along the rows, gather back.
    O(p·max_seg_len) work."""
    n = values.shape[0]
    starts = seg_starts.to(device=values.device, dtype=torch.int64)
    ids = segment_ids_from_starts(starts, n).to(torch.int64)
    offs = torch.arange(n, device=values.device) - starts[ids]
    dense = values.new_zeros(starts.shape[0], max_seg_len)
    keep = offs < max_seg_len
    dense[ids[keep], offs[keep]] = values[keep]
    # a gather past the row reads its last column, as XLA clamps it
    return torch.cumsum(dense, dim=1)[ids, offs.clamp(max=max_seg_len - 1)]


def validate_segments(seg_starts, n: int,
                      num_segments: int | None = None) -> None:
    """Host-side invariant checks, as the reference ``load()`` asserts
    (aux/mp1-util.h:128-148): strictly increasing, s[0]==0, all < n."""
    s = np.asarray(seg_starts)
    if num_segments is not None and s.shape[0] != num_segments:
        raise ValueError(f"expected {num_segments} segments, got {s.shape[0]}")
    if s.shape[0] == 0 or s[0] != 0:
        raise ValueError("first segment must start at 0")
    if (np.diff(s) <= 0).any():
        raise ValueError("segment starts must be strictly increasing")
    if s[-1] >= n:
        raise ValueError("segment start beyond array end")
