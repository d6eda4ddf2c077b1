"""Sorts on the device.

Counterpart of ``cme213_tpu/ops/sort.py``.  The reference's hw4 sorts are
host OpenMP programs (their port is ``cme213_tpu_torch/native``); these are
the device redesigns:

- ``radix_sort``   — LSD radix sort with the reference's 4-phase pass
  (``hw/hw4/programming/radixsort.cpp:22-121``): (1) per-block digit
  histograms, (2+3) an exclusive scan over ``(digit, block)`` giving each
  block's scatter bases, (4) a stable scatter.  Phases 1 and 4 work on a
  ``(blocks, block_size, 2^num_bits)`` boolean one-hot, whose int32 running
  count (``cumsum``) ranks each key among its block's equal digits: 1 byte
  and 4 bytes a key and bucket, so 1.25 GiB at 2^20 keys and 8-bit digits,
  allocated a pass.  ``num_bits`` and ``block_size`` are the reference
  CLI's knobs (``radixsort.cpp:163-179``).
- ``bitonic_sort`` — a merge network, the data-parallel analog of hw4's
  merge sort (``mergesort.cpp:31-144``): log² stages of compare-exchange
  over reshaped views.
- ``radix_sort_batched`` / ``bitonic_sort_batched`` — the same two on a
  (B, n) stack, one pass sequence for all rows (the serving batcher's
  ``sort`` lanes, ``serve/workloads.SortAdapter``; the JAX package
  ``vmap``s its 1-D sorts there); the 1-D sorts are their one-row case.
- ``sort`` / ``sort_pairs`` — the library sort (``torch.sort``, stable).
- ``sort_auto`` — the tuned winner (``core/tune.py``, op ``sort``).

torch's ``uint32`` has few operations (no shifts, adds, ``minimum`` or
``flip`` on the CPU; no indexing and no ``arange`` on CUDA), so ``uint32``
keys are carried as int64 inside and returned as ``uint32``; the keys'
order is the same.
"""

from __future__ import annotations

import torch

from .scan import exclusive_scan

#: the largest ``uint32``: the radix sort's padding, which sorts last
U32_MAX = 0xFFFFFFFF


def _carry(keys: torch.Tensor) -> torch.Tensor:
    """``keys`` in a dtype torch sorts and compares on every device."""
    return keys.to(torch.int64) if keys.dtype == torch.uint32 else keys


def sort(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(_carry(keys), stable=True).values.to(keys.dtype)


def sort_pairs(keys: torch.Tensor, values: torch.Tensor):
    """Keys in order and the values beside them (a stable sort by key)."""
    carried = _carry(keys)
    order = torch.argsort(carried, stable=True)
    return carried[order].to(keys.dtype), values[order]


def sort_auto(keys: torch.Tensor) -> torch.Tensor:
    """Sort by the measured winner for this device and size.

    Resolves ``kernel`` through the tuning cache (``core/tune.py``, op
    ``sort``, shape class ``n<canonical>``, the keys' dtype, the keys'
    device), which a ``tune run --op sort`` fills, with a ``tune-hit`` or
    ``tune-default`` event; ``lax`` (the library sort) without a winner or
    with ``CME213_TUNE=0``.  ``radix`` serves ``uint32`` keys only, as in
    the JAX package."""
    from ..core import programs, tune

    kernel = str(tune.resolve(
        "sort", f"n{programs.canonical_size(keys.shape[0])}",
        tune.dtype_name(keys.dtype), device=keys.device,
        kernel="lax")["kernel"])
    if kernel == "radix" and keys.dtype == torch.uint32:
        return radix_sort(keys)
    if kernel == "bitonic":
        return bitonic_sort(keys)
    return sort(keys)


def radix_sort(keys: torch.Tensor, num_bits: int = 8, block_size: int = 8192,
               key_bits: int = 32) -> torch.Tensor:
    """LSD radix sort of uint32 keys, 4-phase block-decomposed passes.

    Pads to a block multiple with ``0xFFFFFFFF`` (dropped on return)."""
    if keys.dtype != torch.uint32:
        raise TypeError(f"radix_sort takes uint32 keys, got {keys.dtype}")
    return radix_sort_batched(keys[None], num_bits, block_size, key_bits)[0]


def radix_sort_batched(keys: torch.Tensor, num_bits: int = 8,
                       block_size: int = 8192,
                       key_bits: int = 32) -> torch.Tensor:
    """:func:`radix_sort` of each row of a (B, n) uint32 stack, all rows in
    one pass sequence: the one-hot gains a leading lane dimension, so its
    peak is B times a row's (:func:`radix_peak_bytes`).  Each row equals
    its 1-D sort bit for bit (sorted keys are unique)."""
    if keys.dtype != torch.uint32 or keys.dim() != 2:
        raise TypeError(f"radix_sort_batched takes a (B, n) uint32 stack, "
                        f"got {tuple(keys.shape)} {keys.dtype}")
    dev = keys.device
    lanes, n = keys.shape
    nbuckets = 1 << num_bits
    nblocks = max(1, -(-n // block_size))
    data = torch.full((lanes, nblocks * block_size), U32_MAX,
                      dtype=torch.int64, device=dev)
    data[:, :n] = keys.to(torch.int64)
    buckets = torch.arange(nbuckets, device=dev)
    lane_ids = torch.arange(lanes, device=dev)[:, None, None]
    block_ids = torch.arange(nblocks, device=dev)[None, :, None]
    for shift in range(0, key_bits, num_bits):
        digits = ((data.view(lanes, nblocks, block_size) >> shift)
                  & (nbuckets - 1))
        onehot = digits[..., None] == buckets             # (L, B, S, K)
        # (1) per-block histograms: the one-hot summed over the block
        hist = onehot.sum(dim=2, dtype=torch.int32)        # (L, B, K)
        # (2)+(3) exclusive scan in (digit-major, block-minor) order, a
        # lane at a time: bases[l, d, b] = where digit d's run from block
        # b starts (radixsort.cpp:75-108)
        bases = exclusive_scan(hist.transpose(1, 2).reshape(lanes, -1),
                               axis=1).view(lanes, nbuckets, nblocks)
        # (4) stable scatter: each key's rank among its block's equal digits
        ranks = torch.cumsum(onehot, dim=2, dtype=torch.int32)
        mine = ranks.gather(3, digits[..., None])[..., 0] - 1
        pos = (bases[lane_ids, digits, block_ids] + mine).view(lanes, -1)
        # the pass's (key, bucket) tensors go before the next pass makes
        # its own, so the peak is one pass's, not two passes' overlap
        del onehot, ranks, mine
        out = torch.empty_like(data)
        out.scatter_(1, pos, data)
        data = out
    return data[:, :n].to(torch.uint32)


def radix_peak_bytes(n: int, num_bits: int = 8, block_size: int = 8192,
                     lanes: int = 1) -> int:
    """Device bytes a :func:`radix_sort_batched` pass holds at its peak,
    counted from the code: per (key, bucket) of the padded keys the bool
    one-hot, the int32 copy ``cumsum`` makes of it and the int32 running
    count (9 bytes; the pass frees them before the next pass begins); per
    padded key the int64 data, digits, positions, scatter output and the
    int32 ranks' gather (44 bytes)."""
    padded = max(1, -(-n // block_size)) * block_size
    return lanes * padded * (9 * (1 << num_bits) + 44)


def _bitonic_merge(x: torch.Tensor, stage_size: int) -> torch.Tensor:
    """Merge bitonic runs of length ``stage_size`` into sorted runs, along
    the last dimension of a (B, m) stack."""
    shape = x.shape
    k = stage_size
    while k >= 2:
        half = k // 2
        v = x.view(shape[0], -1, k)
        lo, hi = v[..., :half], v[..., half:]
        x = torch.cat([torch.minimum(lo, hi), torch.maximum(lo, hi)],
                      dim=-1).view(shape)
        k = half
    return x


def bitonic_sort(keys: torch.Tensor) -> torch.Tensor:
    """Bitonic sorting network over a power-of-2-padded array.

    Each outer stage doubles the sorted-run length (the merge tree of
    ``mergesort.cpp:76-144`` flattened into compare-exchange sweeps)."""
    return bitonic_sort_batched(keys[None])[0]


def bitonic_sort_batched(keys: torch.Tensor) -> torch.Tensor:
    """:func:`bitonic_sort` of each row of a (B, n) stack, every
    compare-exchange sweep over all rows at once; each row equals its 1-D
    sort bit for bit."""
    lanes, n = keys.shape
    m = 1 << max(1, (n - 1).bit_length())
    x = _carry(keys)
    if keys.dtype == torch.uint32:
        pad = U32_MAX
    elif keys.dtype.is_floating_point:
        pad = float("inf")
    else:
        pad = torch.iinfo(keys.dtype).max
    x = torch.cat([x, torch.full((lanes, m - n), pad, dtype=x.dtype,
                                 device=x.device)], dim=1)
    size = 2
    while size <= m:
        # make runs of `size` bitonic: reverse every second half-run
        v = x.view(lanes, -1, size)
        x = torch.cat([v[..., :size // 2], v[..., size // 2:].flip(-1)],
                      dim=-1).view(lanes, m)
        x = _bitonic_merge(x, size)
        size *= 2
    return x[:, :n].to(keys.dtype)
