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

GAP's ``pr`` (Beamer, Asanović, Patterson 2015) on a power-law graph takes
the same entry at any size: :func:`build_csr` squishes an edge list into a
symmetric CSR on the device (chunked, so that a Kronecker graph of scale 26
fits one card), and :func:`solve_to_tolerance` runs GAP's Jacobi update
behind ``core/admission.admit`` until the sweep's L1 change falls below
the tolerance, reading it once a sweep.  hw1's uploaded graph keeps the
slot layout; every CSR graph takes the pull (``ops/gather.pull_sums``),
whose work is balanced over edges and whose memory is O(edges).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import PhaseTimer, metrics, resolve_device
from ..core.admission import admit
from ..core.roofline import pagerank_pull_cost
from ..core.trace import host_range, span
from ..ops.gather import (PageRankPlan, csr_row_ids, pagerank_iterate,
                          pagerank_plan, pagerank_propagate, pull_plan,
                          pull_sums, pull_update, slot_sweep)
from ..ops.segmented_pallas import PULL_TILE
from ..verify import check_ulp, golden

#: sweeps and solves of :func:`solve_to_tolerance` in this process (also
#: the ``pagerank.sweeps`` / ``pagerank.solves`` counters of the metrics
#: registry, so the exit snapshot holds them)
SWEEPS = {"sweeps": 0, "solves": 0}

#: directed pairs one bucket of :func:`build_csr` sorts at once (1 GiB of
#: int64 keys)
BUILD_CHUNK_PAIRS = 1 << 27


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


@dataclass
class CSRGraph:
    """A symmetric graph on the device, squished as GAP's builder squishes
    it (no self-loops, no duplicate neighbours): int64 row ``offsets`` (n +
    1), int32 neighbour ids ``nbrs`` (``offsets[-1]`` of them, sorted in
    each row) and int32 out-degrees ``deg``.  ``build_peak_bytes`` is the
    device memory the build held at its peak, above what was allocated
    before it.  The sweep's layout is made at the first solve and kept."""

    offsets: torch.Tensor
    nbrs: torch.Tensor
    deg: torch.Tensor
    num_nodes: int
    build_peak_bytes: int = 0
    layout: object = None

    @property
    def num_edges(self) -> int:
        return int(self.offsets[-1]) if self.num_nodes else 0

    @property
    def nbytes(self) -> int:
        """Device bytes the graph holds (``nbrs`` keeps the storage it was
        filled in, sized for every directed pair before the squish)."""
        return sum(t.untyped_storage().nbytes()
                   for t in (self.offsets, self.nbrs, self.deg))


def kronecker_edges(scale: int, edge_factor: int = 16, seed: int = 0,
                    device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """GAP's Kronecker generator (Graph500's R-MAT): ``edge_factor·2^scale``
    edges, each placed by ``scale`` uniform draws in the quadrants A (0.57),
    B (0.19), C (0.19) and D (0.05), then the vertex ids permuted at
    random.  Returns int32 ``(src,
    dst)`` on ``device``, drawn in chunks of 2^24 edges from one generator
    seeded from ``seed`` (any whole number).

    The CLI's copy of the benchmark's generator (``perfbench/kron.
    kron_edges``): for a seed both draw the same edges, so ``--graph=kron
    --scale=26 --seed=N`` builds the cell's graph, and
    ``tests/test_torch_pagerank_gap.py`` holds them to it."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(np.random.default_rng([abs(int(seed)), 4])
                      .integers(0, 2 ** 62)))
    a, b, c = 0.57, 0.19, 0.19
    n, m = 1 << scale, edge_factor << scale
    perm = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    src = torch.empty(m, dtype=torch.int32, device=dev)
    dst = torch.empty(m, dtype=torch.int32, device=dev)
    chunk = 1 << 24
    for lo in range(0, m, chunk):
        k = min(chunk, m - lo)
        s = torch.zeros(k, dtype=torch.int64, device=dev)
        d = torch.zeros(k, dtype=torch.int64, device=dev)
        for _ in range(scale):
            u = torch.rand(k, generator=g, device=dev)
            low = u < a + b
            s = 2 * s + ~low
            d = 2 * d + torch.where(low, u > a, u > a + b + c)
        src[lo:lo + k] = perm[s]
        dst[lo:lo + k] = perm[d]
    return src, dst


def build_csr(src: torch.Tensor, dst: torch.Tensor, num_nodes: int,
              device=None) -> CSRGraph:
    """The symmetric, squished CSR of the edge list ``(src, dst)`` on
    ``device`` (default: the edges' own, else ``cuda``).

    Both directions of every edge, less self-loops and duplicates, in
    buckets of source ids holding about ``BUILD_CHUNK_PAIRS`` directed pairs
    each: a bucket's pairs are keyed ``(row − first row)·n + neighbour``,
    sorted and made unique, so at most one bucket's keys are held at once
    besides the edge list and the neighbour ids.  A ``pagerank.build``
    host range."""
    dev = resolve_device(device) if device is not None else src.device
    cuda = dev.type == "cuda"
    with host_range("pagerank.build"):
        if cuda:
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        src, dst = src.to(dev), dst.to(dev)
        m = src.shape[0]
        buckets = max(1, -(-2 * m // BUILD_CHUNK_PAIRS))
        per = -(-num_nodes // buckets)
        degs = torch.zeros(num_nodes, dtype=torch.int64, device=dev)
        nbrs = torch.empty(2 * m, dtype=torch.int32, device=dev)
        fill = 0
        for lo in range(0, num_nodes, per):
            hi = min(num_nodes, lo + per)
            out = (src >= lo) & (src < hi)
            back = (dst >= lo) & (dst < hi)
            rows = torch.cat([src[out], dst[back]]).to(torch.int64)
            cols = torch.cat([dst[out], src[back]]).to(torch.int64)
            del out, back
            keep = rows != cols
            keys = torch.unique((rows[keep] - lo) * num_nodes + cols[keep])
            del rows, cols, keep
            degs[lo:hi] = torch.bincount(keys // num_nodes,
                                         minlength=hi - lo)
            nbrs[fill:fill + keys.shape[0]] = keys % num_nodes
            fill += keys.shape[0]
            del keys
        offsets = torch.cat([degs.new_zeros(1), torch.cumsum(degs, 0)])
        peak = torch.cuda.max_memory_allocated(dev) - before if cuda else 0
    return CSRGraph(offsets, nbrs[:fill], degs.to(torch.int32), num_nodes,
                    int(peak))


def _layout(g) -> tuple[str, object]:
    """``("slots", PageRankPlan)`` for hw1's uploaded graph, ``("pull",
    PullPlan)`` for a CSR graph (made at its first solve and kept)."""
    if isinstance(g, DeviceGraph):
        return "slots", g.plan
    if g.layout is None:
        g.layout = pull_plan(g.offsets, g.nbrs, g.num_nodes)
    return "pull", g.layout


def _graph_device(g) -> torch.device:
    return g.edges.device if isinstance(g, DeviceGraph) else g.nbrs.device


def solve_bytes(g) -> int:
    """Device bytes of a solve of ``g`` beside the graph itself: the score,
    contribution and degree vectors and the layout's (the pull's compacted
    offsets, row map, sums and tile table; the slot layout's slots)."""
    n = g.num_nodes
    if isinstance(g, DeviceGraph):
        layout = g.plan.src.numel() * (g.plan.src.element_size() + 4)
        return 12 * n + layout
    tiles = g.num_edges // PULL_TILE + 2
    # score, contrib and sums; off and rowmap at most a vertex each; the
    # tile table and the look-back's status words
    return 12 * n + 12 * n + 8 + 20 * tiles


def solve_to_tolerance(g, damping: float = 0.85, tolerance: float = 1e-4,
                       max_iters: int = 1000) -> tuple[torch.Tensor, int]:
    """GAP's ``pr`` (``pr_spmv``): from uniform ``1/n`` scores, sweeps of
    ``score[u] = (1−d)/n + d·Σ_{v∈N(u)} score[v]/deg(v)`` until the sweep's
    L1 change ``Σ|Δscore|`` falls below ``tolerance`` or ``max_iters``
    sweeps have run.  Returns the float32 scores on the graph's device and
    the number of sweeps.

    ``g`` is a :func:`build_csr` graph or hw1's graph from :func:`upload`.
    hw1's graph sums its slots as hw1's golden does
    (``ops/gather.slot_sweep``); a CSR graph takes the pull
    (``ops/gather.pull_sums`` then ``pull_update``: two launches a sweep on
    a card, each row summed in float64).  Runs behind
    ``core/admission.admit`` with the graph's and the solve's bytes; the
    host reads the change once a sweep (``pagerank.converged``), inside a
    ``pagerank.sweeps`` span tagged with the layout, the graph's size and
    the sweeps and rated by ``core/roofline.pagerank_pull_cost``; the
    whole is a ``pagerank.solve`` host range."""
    dev = _graph_device(g)
    n = g.num_nodes
    with host_range("pagerank.solve"):
        graph_bytes = g.nbytes if isinstance(g, CSRGraph) else sum(
            t.numel() * t.element_size()
            for t in (g.row_ids, g.edges, g.inv_deg))
        admit("pagerank.solve", graph_bytes + solve_bytes(g), device=dev)
        kind, layout = _layout(g)
        score = torch.full((n,), float(np.float32(1) / np.float32(n)),
                           dtype=torch.float32, device=dev)
        edges = g.num_edges if isinstance(g, CSRGraph) else g.edges.numel()
        sweeps = 0
        with span("pagerank.sweeps", kernel=kind, nodes=n,
                  edges=edges) as sp:
            if kind == "pull":
                deg = g.deg
                contrib = torch.where(deg > 0,
                                      score / deg.to(torch.float32),
                                      torch.zeros_like(score))
                base = (1.0 - damping) / n
            for _ in range(max_iters):
                if kind == "pull":
                    err = pull_update(layout, pull_sums(layout, contrib),
                                      deg, score, contrib, base, damping)
                else:
                    new = slot_sweep(layout, score, damping)
                    err = (new.double() - score.double()).abs().sum()
                    score = new
                sweeps += 1
                with host_range("pagerank.converged"):
                    change = float(err)
                if change < tolerance:
                    break
            sp.tag(sweeps=sweeps)
            cost = pagerank_pull_cost(n, edges, sweeps)
            sp.roofline(cost.nbytes, cost.flops)
        SWEEPS["sweeps"] += sweeps
        SWEEPS["solves"] += 1
        metrics.counter("pagerank.sweeps").inc(sweeps)
        metrics.counter("pagerank.solves").inc()
    return score, sweeps


def verifier_residual(g: CSRGraph, score: torch.Tensor,
                      damping: float = 0.85) -> float:
    """GAP's ``PRVerifier`` residual of ``score``: ``Σ_u |(1−d)/n +
    d·Σ_{v∈N(u)} score[v]/deg(v) − score[u]|`` in float64."""
    n = g.num_nodes
    s = score.to(torch.float64)
    deg = g.deg.to(torch.float64)
    contrib = torch.where(deg > 0, s / deg, torch.zeros_like(s))
    rows = torch.repeat_interleave(
        torch.arange(n, device=s.device), g.deg.to(torch.int64))
    total = torch.zeros_like(s).index_add_(
        0, rows, contrib.index_select(0, g.nbrs.to(torch.int64)))
    return float(((1.0 - damping) / n + damping * total - s).abs().sum())


def bytes_moved(graph: Graph, nr_iterations: int) -> int:
    """Bytes of the reference's bandwidth accounting
    (``core/roofline.pagerank_cost``,
    ``hw/hw1/programming/analysis/pagerank.cu:47-62``)."""
    from ..core.roofline import pagerank_cost

    return pagerank_cost(graph.num_nodes, graph.edges.shape[0],
                         nr_iterations).nbytes


def main_gap(scale: int = 16, edge_factor: int = 16, seed: int = 0,
             damping: float = 0.85, tolerance: float = 1e-4,
             max_iters: int = 1000, device=None) -> bool:
    """GAP ``pr`` on ``kron``: draw the Kronecker edges, build the CSR,
    solve to the tolerance, and hold the scores to GAP's verifier (its
    residual below the tolerance)."""
    timer = PhaseTimer(verbose=True)
    with timer.phase("generate and build"):
        src, dst = kronecker_edges(scale, edge_factor, seed, device)
        g = build_csr(src, dst, 1 << scale)
        del src, dst
    with timer.phase("solve") as ph:
        score, sweeps = solve_to_tolerance(g, damping, tolerance, max_iters)
        ph.block(score)
    residual = verifier_residual(g, score, damping)
    print(f"kron scale {scale}: {g.num_nodes} nodes, {g.num_edges} directed "
          f"edges, {sweeps} sweeps, verifier residual {residual:.3e}")
    ok = residual < tolerance
    print("Worked! the scores pass GAP's verifier." if ok
          else f"GAP's verifier failed: residual {residual} >= {tolerance}")
    return ok


def main(num_nodes: int = 1 << 21, avg_edges: int = 8, iterations: int = 20,
         seed: int = 0, device=None, graph: str = "hw1", **gap) -> bool:
    """Full driver: build → device iterate → host golden → ULP check (the
    reference main, pagerank.cu:146-249); ``graph="kron"`` runs
    :func:`main_gap` with ``gap``'s options (``scale``, ``edge_factor``,
    ``damping``, ``tolerance``, ``max_iters``)."""
    if graph == "kron":
        return main_gap(seed=seed, device=device, **gap)
    if graph != "hw1" or gap:
        raise ValueError(f"graph {graph!r} with options {sorted(gap)}: "
                         f"hw1 takes none, kron takes scale, edge_factor, "
                         f"damping, tolerance, max_iters")
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
