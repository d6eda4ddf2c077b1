"""Prefix scans in plain PyTorch.

Counterpart of ``cme213_tpu/ops/scan.py``: the flat scans and the 3-phase
block decomposition (per-block partials → scan of block totals →
per-block bases) of the reference's radix pass
(``hw/hw4/programming/radixsort.cpp:44-108``).
"""

from __future__ import annotations

import torch


def inclusive_scan(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim=axis)


def exclusive_scan(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Exclusive sum scan (identity first), as the radix bucket scan
    (radixsort.cpp:75-83)."""
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    shifted = torch.cat([zero, x.narrow(axis, 0, x.shape[axis] - 1)],
                        dim=axis)
    return torch.cumsum(shifted, dim=axis)


def blocked_inclusive_scan(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Inclusive scan via the 3-phase block decomposition: (1) per-block
    local scans, (2) scan of block totals, (3) broadcast-add of block
    bases.  Requires ``len(x) % block_size == 0`` (callers pad)."""
    n = x.shape[0]
    if n % block_size:
        raise ValueError(f"pad to a multiple of block_size={block_size}")
    local = torch.cumsum(x.reshape(n // block_size, block_size), dim=1)
    bases = exclusive_scan(local[:, -1])
    return (local + bases[:, None]).reshape(n)
