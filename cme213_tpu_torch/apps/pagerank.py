"""PageRank workload driver: CSR gather propagation (the reference's hw1).

Counterpart of ``cme213_tpu/apps/pagerank.py``
(``hw/hw1/programming/pagerank.cu:146-249``): builds the same synthetic CSR
graph (cyclic out-degrees ``i % (2·avg−1) + 1``, uniformly random
neighbours, ``pagerank.cu:185-204``), runs the propagate for an even number
of iterations on the device, and checks the result against the host golden.
The device sums each row in the golden's order (``ops/gather.py``), so the
result equals the golden bit for bit; ``main`` still holds it to the
reference's ULP-10 check.  The graph's uint32 offsets and neighbours become
int64 once, at upload.  Runs on ``cuda`` unless the caller passes
``device="cpu"`` (``--device=cpu``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import PhaseTimer, resolve_device
from ..ops.gather import (PageRankPlan, csr_row_ids, pagerank_iterate,
                          pagerank_plan, pagerank_propagate)
from ..verify import check_ulp, golden


@dataclass
class Graph:
    indices: np.ndarray   # (n+1,) uint32 CSR row offsets
    edges: np.ndarray     # (E,) uint32 neighbour ids
    inv_deg: np.ndarray   # (n,) float32 1/out-degree
    rank0: np.ndarray     # (n,) float32 uniform 1/n
    num_nodes: int
    avg_edges: int


def build_graph(num_nodes: int, avg_edges: int, seed: int = 0) -> Graph:
    """Synthetic graph with the reference's degree pattern
    (pagerank.cu:185-204)."""
    rng = np.random.default_rng(seed)
    degs = (np.arange(num_nodes) % (2 * avg_edges - 1) + 1).astype(np.uint32)
    indices = np.zeros(num_nodes + 1, dtype=np.uint32)
    np.cumsum(degs, out=indices[1:])
    total = int(indices[-1])
    if total >= num_nodes * avg_edges + avg_edges:
        raise ValueError("more edges than we have space for")
    edges = rng.integers(0, num_nodes, size=total, dtype=np.uint32)
    inv_deg = (1.0 / degs.astype(np.float32)).astype(np.float32)
    rank0 = np.full(num_nodes, np.float32(1.0) / np.float32(num_nodes),
                    np.float32)
    return Graph(indices, edges, inv_deg, rank0, num_nodes, avg_edges)


@dataclass
class DeviceGraph:
    """A graph on the device: int64 row ids and neighbours, the inverse
    degrees and the propagate's slot layout (``ops.gather.pagerank_plan``),
    built once."""

    row_ids: torch.Tensor
    edges: torch.Tensor
    inv_deg: torch.Tensor
    plan: PageRankPlan
    num_nodes: int


def upload(graph: Graph, device=None) -> DeviceGraph:
    """Copy ``graph`` to ``device`` (default ``cuda``) and lay it out."""
    dev = resolve_device(device)
    indices = torch.from_numpy(graph.indices.astype(np.int64)).to(dev)
    edges = torch.from_numpy(graph.edges.astype(np.int64)).to(dev)
    row_ids = csr_row_ids(indices, graph.edges.shape[0])
    inv_deg = torch.from_numpy(graph.inv_deg).to(dev)
    plan = pagerank_plan(row_ids, edges, inv_deg, graph.num_nodes)
    return DeviceGraph(row_ids, edges, inv_deg, plan, graph.num_nodes)


def iterate(dg: DeviceGraph, rank0: torch.Tensor,
            nr_iterations: int) -> torch.Tensor:
    """``nr_iterations`` (even) sweeps of an uploaded graph."""
    return pagerank_iterate(dg.row_ids, dg.edges, rank0, dg.inv_deg,
                            dg.num_nodes, nr_iterations, plan=dg.plan)


def run_pagerank(graph: Graph, nr_iterations: int,
                 timer: PhaseTimer | None = None,
                 device=None) -> torch.Tensor:
    """Device PageRank: returns the final rank vector on the device.  The
    upload and layout stay outside the timed phase, as the reference's
    graph upload does."""
    if nr_iterations % 2:  # pagerank.cu:61,127
        raise ValueError(f"nr_iterations must be even, got {nr_iterations}")
    dg = upload(graph, device)
    rank0 = torch.from_numpy(graph.rank0).to(dg.edges.device)
    timer = timer or PhaseTimer()
    with timer.phase("gpu graph propagate") as ph:
        out = iterate(dg, rank0, nr_iterations)
        ph.block(out)
    return out


def pagerank_step(graph: Graph, device=None):
    """``(state0, step_fn)`` for the checkpointed lane: ``step_fn(rank, k)``
    advances the rank vector by ``k`` propagate sweeps.  Even ``k`` runs
    the fused even-iteration loop (pagerank.cu:61,127); odd ``k``, possible
    only after a RESOURCE chunk-halving, runs ``k`` single sweeps, the same
    arithmetic one iteration at a time."""
    dg = upload(graph, device)
    dev = dg.edges.device

    def step_fn(state, k):
        rank = torch.as_tensor(state).to(dev)
        k = int(k)
        if k >= 2 and k % 2 == 0:
            return iterate(dg, rank, k)
        for _ in range(k):
            rank = pagerank_propagate(dg.row_ids, dg.edges, rank, dg.inv_deg,
                                      dg.num_nodes, plan=dg.plan)
        return rank

    return graph.rank0, step_fn


def run_pagerank_checkpointed(graph: Graph, nr_iterations: int, path: str,
                              every: int = 0, tracker=None,
                              stall_epochs: int = 25,
                              device=None) -> np.ndarray:
    """Checkpointed PageRank: the power iteration in epoch-sized chunks
    through ``core.checkpoint.run_with_checkpoints``, resuming from
    ``path`` when a checkpoint exists.  Each accepted chunk feeds a
    ``core.numerics.ConvergenceTracker`` (one ``solver-progress`` event an
    epoch), with ``stall_epochs`` registered so a flatlined solve is called
    STALLED.  Chunking is arithmetic-neutral, so the final ranks equal an
    uninterrupted :func:`run_pagerank` of the same even count bit for
    bit."""
    from ..core.checkpoint import run_with_checkpoints
    from ..core.numerics import ConvergenceTracker, host_array

    if tracker is None:
        tracker = ConvergenceTracker("pagerank", stall_epochs=stall_epochs)
    state0, step_fn = pagerank_step(graph, device)
    out = run_with_checkpoints(step_fn, state0, nr_iterations, path,
                               every=every, op="pagerank", tracker=tracker)
    return host_array(out)


def bytes_moved(graph: Graph, nr_iterations: int) -> int:
    """Bytes of the reference's bandwidth accounting
    (``core/roofline.pagerank_cost``,
    ``hw/hw1/programming/analysis/pagerank.cu:47-62``)."""
    from ..core.roofline import pagerank_cost

    return pagerank_cost(graph.num_nodes, graph.edges.shape[0],
                         nr_iterations).nbytes


def main(num_nodes: int = 1 << 21, avg_edges: int = 8, iterations: int = 20,
         seed: int = 0, device=None) -> bool:
    """Full driver: build → device iterate → host golden → ULP check (the
    reference main, pagerank.cu:146-249)."""
    timer = PhaseTimer(verbose=True)
    graph = build_graph(num_nodes, avg_edges, seed)
    out = run_pagerank(graph, iterations, timer, device=device).cpu().numpy()
    with timer.phase("host graph propagate"):
        ref = golden.host_graph_iterate(graph.indices, graph.edges,
                                        graph.rank0, graph.inv_deg,
                                        iterations)
    res = check_ulp(ref, out, max_ulps=10, label="pagerank")
    print("Worked! device and reference output match." if res
          else f"Output of device version and normal version didn't match! "
               f"{res.message}")
    return bool(res)
