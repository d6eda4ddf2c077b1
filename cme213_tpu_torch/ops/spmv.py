"""Sparse matrix-vector products in CSR and ELL formats (Bell/Garland 2008).

Counterpart of ``cme213_tpu/ops/spmv.py``:

- ``csr_spmv``: the products along the nonzeros, then each row summed by
  ``ops.gather.segment_sum`` (the order of ``np.add.reduceat``, bit for bit
  for rows of up to 129 nonzeros; the same bits in every run, no atomics);
- ``ell_spmv``: the ELLPACK formulation, a dense ``(rows, max_nnz)``
  layout reduced over the nonzero axis by ``torch.sum`` (deterministic for
  a shape);
- ``csr_to_ell``: format conversion with zero padding (host, once a
  matrix).

Against the JAX package, whose reductions associate as XLA chooses, a row of
k terms agrees within the bound of two summation orders, 2·(k−1)·ε·Σ|terms|
(ε the float32 epsilon).
"""

from __future__ import annotations

import numpy as np
import torch

from .gather import indptr_from_row_ids, segment_plan, segment_sum


def csr_spmv(row_ids: torch.Tensor, col_idx: torch.Tensor,
             values: torch.Tensor, x: torch.Tensor,
             num_rows: int) -> torch.Tensor:
    """y = A·x with A given as flat (row_ids, col_idx, values) triplets,
    ``row_ids`` non-decreasing (CSR order; ``ops.gather.csr_row_ids``)."""
    contrib = values * x[col_idx.to(torch.int64)]
    plan = segment_plan(indptr_from_row_ids(row_ids, num_rows))
    return segment_sum(plan, contrib)


def ell_spmv(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A·x with A in ELL format: ``ell_cols``/``ell_vals`` of shape
    (rows, max_nnz), padded entries having value 0."""
    return torch.sum(ell_vals * x[ell_cols.to(torch.int64)], dim=1)


def csr_to_ell(indices: np.ndarray, col_idx: np.ndarray,
               values: np.ndarray):
    """CSR → ELL conversion (host, once a matrix): int32 columns, values
    of ``values``' dtype, zero padded to the longest row."""
    indices = np.asarray(indices, dtype=np.int64)
    counts = np.diff(indices)
    rows = counts.shape[0]
    width = int(counts.max()) if rows else 0
    ell_cols = np.zeros((rows, width), dtype=np.int32)
    ell_vals = np.zeros((rows, width), dtype=values.dtype)
    row = np.repeat(np.arange(rows), counts)
    pos = np.arange(indices[-1]) - np.repeat(indices[:-1], counts)
    ell_cols[row, pos] = col_idx[indices[0]:indices[-1]]
    ell_vals[row, pos] = values[indices[0]:indices[-1]]
    return ell_cols, ell_vals
