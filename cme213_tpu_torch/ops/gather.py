"""Irregular gather ops: CSR neighbour propagation (PageRank) and the
ordered segment sum they share with ``ops/spmv.py``.

Counterpart of ``cme213_tpu/ops/gather.py`` (the reference's PageRank kernel,
one thread a destination walking its CSR row,
``hw/hw1/programming/pagerank.cu:70-83``).  The JAX package gathers along
the edges and reduces back to rows with a sorted ``segment_sum``.  The port
gathers into a fixed slot layout a row (:func:`segment_plan`) and adds the
slots column by column, in the order of the host golden's
``np.add.reduceat`` (``cme213_tpu/verify/golden.py:47-60``).  That order is
not a left fold: numpy adds a segment's first value to the pairwise sum of
the rest, which for fewer than 8 values is a serial sum from zero and for 8
to 128 values sums eight interleaved lanes, then combines the lanes as a
tree and adds the tail serially.  So a row of up to 129 values sums bit for
bit as the golden does, on any device and in any run (no atomics); a longer
row keeps the eight lanes where numpy would split it in halves.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: numpy's pairwise sum adds this many interleaved lanes
LANES = 8


def csr_row_ids(indices: torch.Tensor, num_edges: int) -> torch.Tensor:
    """Destination row of each CSR edge slot (int64, computed once a graph,
    as the reference uploads its graph once)."""
    slots = torch.arange(num_edges, dtype=indices.dtype,
                         device=indices.device)
    return torch.searchsorted(indices, slots, right=True).to(torch.int64) - 1


def indptr_from_row_ids(row_ids: torch.Tensor,
                        num_rows: int) -> torch.Tensor:
    """CSR offsets (``num_rows + 1``, int64) of non-decreasing row ids."""
    counts = torch.bincount(row_ids.to(torch.int64), minlength=num_rows)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts[:num_rows],
                                                        0)])


@dataclass(frozen=True)
class SegmentPlan:
    """Where each row's values sit for :func:`segment_sum`.

    ``slots`` is ``(1 + LANES·blocks + tail, rows)``: row 0 the segment's
    first value; then ``blocks`` blocks of ``LANES`` lanes, lane j of block
    b the rest's value ``LANES·b + j`` for the blocks the row fills; then
    the rest's tail, serially.  An empty place holds ``total``, the index
    of a zero appended to the values."""

    slots: torch.Tensor
    blocks: int
    tail: int
    total: int


def segment_plan(indptr: torch.Tensor) -> SegmentPlan:
    """The slot layout of the segments ``[indptr[i], indptr[i+1])``."""
    indptr = indptr.to(torch.int64)
    dev = indptr.device
    start = indptr[:-1]
    deg = indptr[1:] - start
    total = int(indptr[-1]) if indptr.numel() else 0
    rest = torch.clamp(deg - 1, min=0)
    full = rest // LANES  # blocks numpy's lanes fill, for ≤ 128 values
    blocks = int(full.max()) if deg.numel() else 0
    tail_len = rest - LANES * full
    tail = int(tail_len.max()) if deg.numel() else 0
    pad = torch.full_like(start, total)
    first = torch.where(deg >= 1, start, pad)[None]
    b = torch.arange(blocks, device=dev)[:, None, None]
    j = torch.arange(LANES, device=dev)[None, :, None]
    lanes = torch.where(b < full, start + 1 + LANES * b + j,
                        total).reshape(blocks * LANES, start.numel())
    t = torch.arange(tail, device=dev)[:, None]
    tails = torch.where(t < tail_len, start + 1 + LANES * full + t, total)
    slots = torch.cat([first, lanes, tails])
    if total < 2**31 - 1:
        slots = slots.to(torch.int32)
    return SegmentPlan(slots, blocks, tail, total)


def fold(plan: SegmentPlan, c: torch.Tensor) -> torch.Tensor:
    """Sum each row of ``c`` (the values laid out as ``plan.slots``, zeros
    in the empty places) in ``np.add.reduceat``'s order."""
    if plan.blocks:
        lanes = c[1:1 + LANES]
        for b in range(1, plan.blocks):
            lanes = lanes + c[1 + LANES * b:1 + LANES * (b + 1)]
        pairs = lanes[0::2] + lanes[1::2]
        quads = pairs[0::2] + pairs[1::2]
        rest = quads[0] + quads[1]
    else:
        rest = torch.zeros_like(c[0])
    for t in range(plan.tail):
        rest = rest + c[1 + LANES * plan.blocks + t]
    return c[0] + rest


def segment_sum(plan: SegmentPlan, values: torch.Tensor) -> torch.Tensor:
    """Sum of each segment of ``values`` (``plan.total`` of them), in
    ``np.add.reduceat``'s order; an empty segment sums to 0."""
    ext = torch.cat([values, values.new_zeros(1)])
    c = ext.index_select(0, plan.slots.reshape(-1))
    return fold(plan, c.view(plan.slots.shape))


@dataclass(frozen=True)
class PageRankPlan:
    """A graph's rows as :func:`segment_plan` lays them out: ``src`` the
    neighbour in each slot (node 0 in an empty one) and ``weight`` its
    ``inv_deg`` (0 in an empty one), so a slot contributes
    ``rank[src]·weight``, the reference's product, or +0."""

    segments: SegmentPlan
    src: torch.Tensor
    weight: torch.Tensor
    num_nodes: int


def pagerank_plan(row_ids: torch.Tensor, edges: torch.Tensor,
                  inv_deg: torch.Tensor, num_nodes: int) -> PageRankPlan:
    """Lay a graph out once for :func:`pagerank_propagate` (``row_ids``
    non-decreasing, as :func:`csr_row_ids` makes them)."""
    seg = segment_plan(indptr_from_row_ids(row_ids, num_nodes))
    slots = seg.slots.to(torch.int64)
    empty = slots == seg.total
    src = torch.cat([edges.to(torch.int64), edges.new_zeros(1).to(
        torch.int64)])[slots]
    weight = torch.where(empty, torch.zeros_like(inv_deg[0]), inv_deg[src])
    return PageRankPlan(seg, src.to(seg.slots.dtype), weight, num_nodes)


def _propagate(plan: PageRankPlan, rank: torch.Tensor) -> torch.Tensor:
    # 0.5/n rounded in float32 first, as the reference and the golden
    return slot_sweep(plan, rank, 0.5)


def pagerank_propagate(row_ids, edges, rank_in, inv_deg, num_nodes: int,
                       plan: PageRankPlan | None = None) -> torch.Tensor:
    """One sweep: ``out[i] = 0.5/n + 0.5 · Σ_{j∈row i} rank[e_j]·inv_deg[e_j]``
    (``pagerank.cu:45-56``), each row summed as the golden sums it.
    ``plan`` (from :func:`pagerank_plan`) saves laying the graph out."""
    if plan is None:
        plan = pagerank_plan(row_ids, edges, inv_deg, num_nodes)
    return _propagate(plan, rank_in)


def pagerank_iterate(row_ids, edges, rank0, inv_deg, num_nodes: int,
                     nr_iterations: int,
                     plan: PageRankPlan | None = None) -> torch.Tensor:
    """The even-iteration ping-pong loop (``pagerank.cu:59-67``)."""
    if nr_iterations % 2:
        raise ValueError(f"nr_iterations must be even, got {nr_iterations}")
    if plan is None:
        plan = pagerank_plan(row_ids, edges, inv_deg, num_nodes)
    rank = rank0
    for _ in range(nr_iterations):
        rank = _propagate(plan, rank)
    return rank


# ------------------------------------------------------- the pull (GAP pr)

@dataclass
class PullPlan:
    """A CSR graph laid out for :func:`pull_sums`, once a graph.

    The empty rows are compacted away: ``off`` (int64) holds the offsets of
    the ``rows`` non-empty rows and ``rowmap`` (int32) the vertex of each,
    so a row's total lands at ``sums[rowmap[r]]`` and an isolated vertex's
    stays 0.  ``tile_row`` (int32) is the compacted row holding the first
    slot of each kernel tile; on the card ``workspace`` holds the
    look-back's ticket and status words with their last ``epoch`` and
    ``update`` the update's buffers, on the CPU ``edge_rows`` (int64) each
    slot's vertex."""

    nbrs: torch.Tensor
    off: torch.Tensor
    rowmap: torch.Tensor
    sums: torch.Tensor
    num_nodes: int
    tile_row: torch.Tensor | None = None
    edge_rows: torch.Tensor | None = None
    workspace: torch.Tensor | None = None
    epoch: int = 0
    update: tuple | None = None


def pull_plan(offsets: torch.Tensor, nbrs: torch.Tensor,
              num_nodes: int) -> PullPlan:
    """Lay out the CSR graph (``offsets`` n + 1 int64, ``nbrs`` int32) for
    :func:`pull_sums`."""
    from . import segmented_pallas as segp

    dev = nbrs.device
    offsets = offsets.to(torch.int64)
    deg = offsets[1:] - offsets[:-1]
    rowmap = torch.nonzero(deg > 0).flatten()
    off = torch.cat([offsets[:-1][rowmap], offsets[-1:]])
    sums = torch.zeros(num_nodes, dtype=torch.float32, device=dev)
    plan = PullPlan(nbrs, off, rowmap.to(torch.int32), sums, num_nodes)
    if rowmap.numel():
        starts = torch.arange(0, nbrs.shape[0], segp.PULL_TILE,
                              dtype=torch.int64, device=dev)
        first = torch.searchsorted(off, starts, right=True) - 1
        plan.tile_row = torch.cat([first, first.new_full(
            (1,), rowmap.numel() - 1)]).to(torch.int32)
    if dev.type == "cpu":
        plan.edge_rows = torch.repeat_interleave(rowmap, deg[rowmap])
    return plan


def pull_sums_plain(plan: PullPlan, contrib: torch.Tensor) -> torch.Tensor:
    """The pull in plain PyTorch: each row's ``Σ contrib[nbr]`` in float64,
    rounded to float32 once (an isolated vertex's is 0)."""
    vals = contrib.index_select(0, plan.nbrs.to(torch.int64)).double()
    total = torch.zeros(plan.num_nodes, dtype=torch.float64,
                        device=contrib.device)
    total.index_add_(0, plan.edge_rows, vals)
    return total.to(torch.float32)


def pull_sums(plan: PullPlan, contrib: torch.Tensor) -> torch.Tensor:
    """Each row's ``Σ contrib[nbr]`` over its neighbours, summed in float64
    and rounded to float32 once: on a CUDA tensor one launch of the pull
    kernel into ``plan.sums``, on the CPU :func:`pull_sums_plain`."""
    if contrib.device.type == "cpu":
        return pull_sums_plain(plan, contrib)
    from . import segmented_pallas as segp

    if plan.rowmap.numel():
        segp.pagerank_pull(plan, contrib)
    return plan.sums


def pull_update_plain(sums: torch.Tensor, deg: torch.Tensor,
                      score: torch.Tensor, contrib: torch.Tensor, base: float,
                      damping: float) -> torch.Tensor:
    """:func:`pull_update` in plain PyTorch, on any device."""
    new = (base + damping * sums.double()).to(torch.float32)
    err = (new.double() - score.double()).abs().sum()
    score.copy_(new)
    contrib.copy_(torch.where(deg > 0, new / deg.to(torch.float32),
                              torch.zeros_like(new)))
    return err


def pull_update(plan: PullPlan, sums: torch.Tensor, deg: torch.Tensor,
                score: torch.Tensor, contrib: torch.Tensor, base: float,
                damping: float):
    """GAP's per-vertex step after the pull: ``score = float32(base +
    damping·sums)`` in place, ``contrib = score / deg`` (0 where ``deg`` is
    0) in place; returns ``Σ |score − old|`` in float64 as a 0-d device
    tensor.  One kernel launch on a card."""
    if score.device.type == "cpu":
        return pull_update_plain(sums, deg, score, contrib, base, damping)
    from . import segmented_pallas as segp

    return segp.pagerank_update(plan, sums, deg, score, contrib, base,
                                damping)


def slot_sweep(plan: PageRankPlan, rank: torch.Tensor,
               damping: float) -> torch.Tensor:
    """One sweep of the slot layout with damping ``damping``: ``(1−d)/n``
    rounded in float32, plus ``d`` times each row's sum of
    ``rank[src]·inv_deg[src]`` in ``np.add.reduceat``'s order.  At
    ``damping`` 0.5 it is :func:`pagerank_propagate` bit for bit."""
    c = rank.index_select(0, plan.src.view(-1)).view(plan.src.shape) \
        * plan.weight
    sums = fold(plan.segments, c)
    base = float(np.float32(1.0 - damping) / np.float32(plan.num_nodes))
    return base + damping * sums
