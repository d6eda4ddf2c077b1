"""GAP ``pr`` on Kronecker graphs through ``apps/pagerank``'s normal entry,
on the CPU, against the benchmark's plain reference
(``perfbench/reference/pagerank.py``, plain torch): the squished CSR, the
pull's plan and sums, the solve to the tolerance, the layout's dispatch
(every CSR graph pulls; hw1's graph keeps its slots, still bit for bit with
the golden), the spans and the counters."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cme213_tpu_torch.apps import pagerank as pr
from cme213_tpu_torch.core import trace
from cme213_tpu_torch.ops import gather
from cme213_tpu_torch.ops import segmented_pallas as segp
from cme213_tpu_torch.verify import golden
from perfbench import kron
from perfbench.reference import pagerank as ref


def _graph(scale, seed):
    src, dst = kron.kron_edges(scale, 16, seed, "cpu")
    return src, dst, pr.build_csr(src, dst, 1 << scale)


@pytest.mark.parametrize("scale,seed", [(10, 1), (11, 2 ** 31 + 9),
                                        (12, 2 ** 35 + 3)])
def test_solve_matches_the_float64_reference(scale, seed):
    src, dst, g = _graph(scale, seed)
    score, sweeps = pr.solve_to_tolerance(g)
    adj = ref.Adjacency(src, dst, 1 << scale)
    stop, kept = ref.solve(adj, 0.85, 1e-4, 1000, keep=(sweeps,))
    assert sweeps == stop
    l1, linf = ref.relative_errors(kept[sweeps], score)
    assert l1 < 1e-6 and linf < 1e-6, (l1, linf)
    assert ref.residual(adj, score, 0.85) < 1e-4
    assert pr.verifier_residual(g, score) == pytest.approx(
        ref.residual(adj, score, 0.85), rel=1e-9)


@pytest.mark.parametrize("chunk_pairs", [1 << 27, 4096, 777])
def test_build_csr_is_the_squished_symmetric_graph(chunk_pairs, monkeypatch):
    monkeypatch.setattr(pr, "BUILD_CHUNK_PAIRS", chunk_pairs)
    src, dst, g = _graph(10, 17)
    adj = ref.Adjacency(src, dst, 1 << 10)
    assert torch.equal(g.deg.to(torch.int64), adj.deg)
    assert g.offsets.dtype == torch.int64 and g.nbrs.dtype == torch.int32
    rows = torch.repeat_interleave(torch.arange(1 << 10),
                                   g.deg.to(torch.int64))
    cols = g.nbrs.to(torch.int64)
    assert not bool((rows == cols).any())                    # no self-loops
    keys = rows * (1 << 10) + cols
    assert bool((keys[1:] > keys[:-1]).all())     # sorted, no duplicates
    assert torch.equal(torch.sort(cols * (1 << 10) + rows).values, keys)
    want = torch.cat([r.to(torch.int64) * (1 << 10) + c.to(torch.int64)
                      for r, c in adj.chunks])
    assert torch.equal(torch.sort(want).values, keys)


def _hub_graph(hub_len: int, n: int = 12000, seed: int = 0):
    """A hub joined to ``hub_len`` others (many tiles of the pull), a chain
    of short rows, and the last 100 vertices isolated, as an undirected
    edge list."""
    rng = np.random.default_rng(seed)
    others = rng.choice(np.arange(1, n - 100), size=hub_len, replace=False)
    chain = np.arange(n // 2, n - 100)
    s = np.concatenate([np.zeros(hub_len, np.int64), chain[:-1]])
    d = np.concatenate([others, chain[1:]])
    return (torch.from_numpy(s).to(torch.int32),
            torch.from_numpy(d).to(torch.int32), n)


def _circulant(n: int, half: int):
    """Each vertex joined to the ``half`` after it: every row ``2·half``
    long."""
    s = torch.arange(n).repeat_interleave(half)
    d = (s + torch.arange(1, half + 1).repeat(n)) % n
    return s.to(torch.int32), d.to(torch.int32), n


@pytest.mark.parametrize("hub_len", [1, 2 * segp.PULL_TILE - 1,
                                     2 * segp.PULL_TILE + 1,
                                     5 * segp.PULL_TILE + 7])
def test_a_hub_over_many_tiles_and_empty_rows(hub_len):
    s, d, n = _hub_graph(hub_len)
    g = pr.build_csr(s, d, n)
    plan = gather.pull_plan(g.offsets, g.nbrs, n)
    assert int(g.deg[0]) == hub_len and int((g.deg == 0).sum()) > 0
    # every compacted row is non-empty; a tile holds at most a tile + 1
    assert bool((plan.off[1:] > plan.off[:-1]).all())
    assert int((plan.tile_row[1:] - plan.tile_row[:-1]).max()) \
        <= segp.PULL_TILE
    starts = torch.arange(plan.tile_row.shape[0] - 1) * segp.PULL_TILE
    first = plan.off[plan.tile_row[:-1].to(torch.int64)]
    assert bool((first <= starts).all())
    nxt = plan.off[plan.tile_row[:-1].to(torch.int64) + 1]
    assert bool((nxt > starts).all())
    rng = np.random.default_rng(hub_len)
    contrib = torch.from_numpy(rng.uniform(0, 1e-3, n).astype(np.float32))
    got = gather.pull_sums(plan, contrib)
    dense = torch.zeros(n, n, dtype=torch.float64)
    dense[g.offsets.new_tensor(np.repeat(np.arange(n), g.deg.numpy())),
          g.nbrs.to(torch.int64)] = 1.0
    exact = dense @ contrib.to(torch.float64)
    assert torch.equal(got, exact.to(torch.float32))
    score, sweeps = pr.solve_to_tolerance(g)
    adj = ref.Adjacency(s, d, n)
    stop, kept = ref.solve(adj, 0.85, 1e-4, 1000, keep=(sweeps,))
    assert abs(sweeps - stop) <= 1
    assert ref.relative_errors(kept[sweeps], score)[0] < 1e-6
    isolated = score[-100:].to(torch.float64)
    assert torch.allclose(isolated, torch.full_like(isolated, 0.15 / n),
                          rtol=1e-6, atol=0)


@pytest.mark.parametrize("graph", ["short rows", "rows of 128", "a hub"])
def test_every_csr_graph_takes_the_pull(graph):
    s, d, n = {"short rows": lambda: _circulant(700, 3),
               "rows of 128": lambda: _circulant(700, 64),
               "a hub": lambda: _hub_graph(129, n=3000)}[graph]()
    g = pr.build_csr(s, d, n)
    score, sweeps = pr.solve_to_tolerance(g, tolerance=1e-6)
    stop, kept = ref.solve(ref.Adjacency(s, d, n), 0.85, 1e-6, 1000,
                           keep=(sweeps,))
    assert pr._layout(g)[0] == "pull" and abs(sweeps - stop) <= 1
    assert ref.relative_errors(kept[sweeps], score)[0] < 1e-6


@pytest.mark.parametrize("iters", [2, 6])
def test_hw1_graph_is_bit_for_bit_the_golden(iters):
    graph = pr.build_graph(4096, 8, seed=3)
    dg = pr.upload(graph, "cpu")
    got, sweeps = pr.solve_to_tolerance(dg, damping=0.5, tolerance=0.0,
                                        max_iters=iters)
    want = golden.host_graph_iterate(graph.indices, graph.edges, graph.rank0,
                                     graph.inv_deg, iters)
    assert sweeps == iters and pr._layout(dg)[0] == "slots"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pr.iterate(dg, torch.from_numpy(graph.rank0), iters).numpy(), want)


def test_the_generators_repeat_for_a_seed():
    for make in (lambda s: kron.kron_edges(9, 16, s, "cpu"),
                 lambda s: pr.kronecker_edges(9, 16, s, "cpu")):
        a, b, c = make(2 ** 33 + 1), make(2 ** 33 + 1), make(5)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not torch.equal(a[0], c[0])
        assert a[0].dtype == torch.int32 and int(a[0].max()) < 512


@pytest.mark.parametrize("scale,seed", [(5, 0), (9, 2 ** 40 + 7),
                                        (11, 3811000001)])
def test_the_cli_generator_draws_the_benchmarks_edges(scale, seed):
    want = kron.kron_edges(scale, 16, seed, "cpu")
    got = pr.kronecker_edges(scale, 16, seed, "cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_spans_and_counters():
    _, _, g = _graph(10, 4)
    trace.clear_events()
    before = dict(pr.SWEEPS)
    _, sweeps = pr.solve_to_tolerance(g)
    assert pr.SWEEPS == {"sweeps": before["sweeps"] + sweeps,
                         "solves": before["solves"] + 1}
    ends = [e for e in trace.events("span-end")
            if e["span"] == "pagerank.sweeps"]
    assert len(ends) == 1
    assert {k: ends[0][k] for k in ("kernel", "nodes", "edges", "sweeps")} \
        == {"kernel": "pull", "nodes": 1 << 10, "edges": g.num_edges,
            "sweeps": sweeps}
    assert ends[0]["achieved_gbs"] > 0
    from cme213_tpu_torch.core import metrics

    assert metrics.counter("pagerank.sweeps").value >= sweeps


def test_admission_refuses_a_graph_over_the_budget(monkeypatch):
    from cme213_tpu_torch.core.admission import AdmissionError

    _, _, g = _graph(9, 4)
    monkeypatch.setenv("CME213_MEMORY_BUDGET", str(g.nbytes))
    with pytest.raises(AdmissionError):
        pr.solve_to_tolerance(g)


def test_the_cli_runs_gap_on_kron(capsys):
    from cme213_tpu_torch import models

    rc = models.WORKLOADS["pagerank"].run(
        ["--graph=kron", "--scale=9", "--damping=0.85", "--tolerance=1e-4",
         "--device=cpu"])
    assert rc == 0 and "GAP's verifier" in capsys.readouterr().out
