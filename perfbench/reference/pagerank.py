"""The plain reference of GAP ``pr`` (``pr_spmv``): plain PyTorch on the
card, independent of the program.

The adjacency is built here from the edge list: both directions of every
edge, self-loops and duplicates dropped (GAP's squish), kept as int32
(row, neighbour) pairs in chunks of rows.  A sweep is Jacobi's update in
float64: ``contrib[v] = score[v] / deg(v)``, ``score[u] = (1−d)/n + d ·
Σ_{v∈N(u)} contrib[v]``, each chunk's pairs added by ``index_add_``; the
solve stops when the sweep's L1 change falls below the tolerance.  GAP's
verifier residual of a given score vector is the same sum.
"""

from __future__ import annotations

import torch

#: directed pairs a chunk of the adjacency holds
CHUNK_PAIRS = 1 << 27


class Adjacency:
    """The symmetric squished adjacency: ``chunks`` of int32 ``(rows,
    cols)`` pairs and the int64 degree of every vertex."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int,
                 chunk_pairs: int = CHUNK_PAIRS):
        self.n = n
        self.chunks = []
        self.deg = torch.zeros(n, dtype=torch.int64, device=src.device)
        pieces = max(1, -(-2 * src.shape[0] // chunk_pairs))
        width = -(-n // pieces)
        for lo in range(0, n, width):
            hi = min(n, lo + width)
            rows, cols = [], []
            for a, b in ((src, dst), (dst, src)):
                pick = (a >= lo) & (a < hi) & (a != b)
                rows.append(a[pick].to(torch.int64))
                cols.append(b[pick].to(torch.int64))
            key = torch.unique(torch.cat(rows) * n + torch.cat(cols))
            r = torch.div(key, n, rounding_mode="floor")
            self.deg += torch.bincount(r, minlength=n)
            self.chunks.append((r.to(torch.int32),
                                (key - r * n).to(torch.int32)))

    @property
    def entries(self) -> int:
        return sum(r.shape[0] for r, _ in self.chunks)

    def pull(self, contrib: torch.Tensor) -> torch.Tensor:
        """Each vertex's ``Σ contrib[v]`` over its neighbours, in
        ``contrib``'s dtype."""
        total = torch.zeros_like(contrib)
        for rows, cols in self.chunks:
            total.index_add_(0, rows.to(torch.int64),
                             contrib[cols.to(torch.int64)])
        return total


def _contrib(adj: Adjacency, score: torch.Tensor) -> torch.Tensor:
    deg = adj.deg.to(score.dtype)
    return torch.where(adj.deg > 0, score / deg, torch.zeros_like(score))


def solve(adj: Adjacency, damping: float, tolerance: float, max_iters: int,
          keep=()) -> tuple[int, dict]:
    """Jacobi sweeps in float64 from uniform ``1/n``, GAP's loop: returns
    the sweep at which it stops (the first whose L1 change is below
    ``tolerance``, else ``max_iters``) and the scores after each sweep
    named in ``keep``, running on past the stop until the last of them."""
    n = adj.n
    score = torch.full((n,), 1.0 / n, dtype=torch.float64,
                       device=adj.deg.device)
    stop, kept, k = None, {}, 0
    last = max(keep, default=0)
    while stop is None or k < last:
        new = (1.0 - damping) / n + damping * adj.pull(_contrib(adj, score))
        change = float((new - score).abs().sum())
        score, k = new, k + 1
        if k in keep:
            kept[k] = score
        if stop is None and (change < tolerance or k >= max_iters):
            stop = k
    return stop, kept


def residual(adj: Adjacency, score, damping: float) -> float:
    """GAP's ``PRVerifier`` error of ``score``: ``Σ_u |(1−d)/n + d ·
    Σ_{v∈N(u)} score[v]/deg(v) − score[u]|`` in float64."""
    s = torch.as_tensor(score).to(device=adj.deg.device,
                                  dtype=torch.float64)
    if s.shape != (adj.n,) or not bool(torch.isfinite(s).all()):
        return float("inf")
    pred = (1.0 - damping) / adj.n + damping * adj.pull(_contrib(adj, s))
    return float((pred - s).abs().sum())


def solve_lowered(adj: Adjacency, damping: float, count: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """The control: ``count`` sweeps with the scores and contributions held
    in ``dtype`` (bfloat16 for the configuration's float32) and each row
    summed in float32."""
    n = adj.n
    score = torch.full((n,), 1.0 / n, dtype=torch.float32,
                       device=adj.deg.device).to(dtype)
    for _ in range(count):
        contrib = _contrib(adj, score.to(torch.float32)).to(dtype)
        total = adj.pull(contrib.to(torch.float32))
        score = ((1.0 - damping) / n + damping * total).to(dtype)
    return score


def relative_errors(expected: torch.Tensor, got) -> tuple[float, float]:
    """(relative L1, relative L-infinity) of ``got`` against ``expected``
    in float64; a non-finite value or another length reads as 1e30."""
    e = expected.to(torch.float64)
    g = torch.as_tensor(got).to(device=e.device, dtype=torch.float64)
    if e.shape != g.shape or not bool(torch.isfinite(g).all()):
        return 1e30, 1e30
    d = (g - e).abs()
    return float(d.sum() / e.abs().sum()), float(d.max() / e.abs().max())
