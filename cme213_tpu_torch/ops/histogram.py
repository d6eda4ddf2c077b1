"""Histograms, three formulations.

Counterpart of ``cme213_tpu/ops/histogram.py``.  The reference builds dense
histograms by sort + ``upper_bound`` (``hw/hw3/programming/
solve_cipher.cu:131-154``) and by ``reduce_by_key`` over sorted data
(``hw/hw3/solution/solve_cipher_solution.cu:118-127``):

- ``histogram_sort``    — sort, then ``searchsorted`` upper bounds;
- ``histogram_onehot``  — a one-hot comparison summed over the values (the
  radix sort's per-block histograms);
- ``histogram_segment`` — a scatter-add of ones (``bincount``).

Each returns int32 counts of bins ``0 … nbins-1``.  Values above that range
count nowhere; values below it count in bin 0 in ``histogram_sort`` and
nowhere in the other two, as in the JAX package.  Integer counts are exact
in any order, on any device.
"""

from __future__ import annotations

import torch


def histogram_sort(x: torch.Tensor, nbins: int) -> torch.Tensor:
    """Sort, then count each bin by searchsorted upper bounds."""
    xs = torch.sort(x.reshape(-1).to(torch.int64)).values
    bins = torch.arange(nbins, dtype=torch.int64, device=x.device)
    bounds = torch.searchsorted(xs, bins, right=True)
    lower = torch.cat([bounds.new_zeros(1), bounds[:-1]])
    return (bounds - lower).to(torch.int32)


def histogram_onehot(x: torch.Tensor, nbins: int) -> torch.Tensor:
    """Sum of one-hot rows (a comparison with the bins, summed)."""
    bins = torch.arange(nbins, dtype=torch.int64, device=x.device)
    oh = x.reshape(-1).to(torch.int64)[:, None] == bins
    return oh.sum(dim=0, dtype=torch.int32)


def histogram_segment(x: torch.Tensor, nbins: int) -> torch.Tensor:
    """Scatter-add formulation (Thrust ``reduce_by_key`` analog)."""
    x = x.reshape(-1).to(torch.int64)
    keep = x[(x >= 0) & (x < nbins)]
    return torch.bincount(keep, minlength=nbins).to(torch.int32)
