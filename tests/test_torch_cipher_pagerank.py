"""Parity of the port's hw1 drivers (``apps/cipher.py``, ``apps/pagerank.py``)
with the JAX package, on the CPU.

Tolerances: byte for byte for the corpora and the ciphers; the graph
builders array for array; PageRank bitwise against the numpy golden and
within ULP-10 of JAX's ``run_pagerank``; a checkpointed PageRank bitwise
its uninterrupted solve.
"""

import numpy as np
import pytest
import torch

from cme213_tpu.apps import cipher as j_cipher
from cme213_tpu.apps import pagerank as j_pagerank
from cme213_tpu_torch import models
from cme213_tpu_torch.apps import cipher, pagerank
from cme213_tpu_torch.core import PhaseTimer, trace, ulp_distance
from cme213_tpu_torch.verify import golden


# ------------------------------------------------------------ cipher

@pytest.mark.parametrize("length,seed", [(1 << 12, 1), (5000, 7)])
def test_make_corpus_is_the_reference(length, seed):
    np.testing.assert_array_equal(cipher.make_corpus(length, seed),
                                  j_cipher.make_corpus(length, seed))


@pytest.mark.parametrize("shift,replicate,ok", [(5, 2, True),
                                               (17, 16, True),
                                               (255, 4, False)])
def test_run_cipher_variants_byte_exact(shift, replicate, ok):
    """Every variant equals the byte golden where no byte overflows; at
    shift 255 a letter carries into its neighbour in the packed variants,
    and both packages report the mismatch."""
    timer = PhaseTimer()
    text = cipher.make_corpus(1 << 12, seed=1)
    assert cipher.run_cipher(text, shift=shift, replicate=replicate,
                             timer=timer, device="cpu") is ok
    assert j_cipher.run_cipher(text, shift=shift, replicate=replicate) is ok
    labels = {r.label for r in timer.records}
    assert {name for name, _ in cipher.VARIANTS} <= labels


def test_cipher_cli_writes_the_reference_file(tmp_path, capsys):
    src = tmp_path / "book.txt"
    cipher.make_corpus(4096, seed=3).tofile(src)
    assert cipher.main(["cipher", str(src), "9", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "gpu shift cypher uint2:" in out and "wrote" in out
    port = (tmp_path / "book_enciphered.txt").read_bytes()
    (tmp_path / "book_enciphered.txt").unlink()
    assert j_cipher.main(["cipher", str(src), "9"]) == 0
    assert port == (tmp_path / "book_enciphered.txt").read_bytes()
    assert cipher.main(["cipher", "--bogus"]) == 2


def test_cipher_workload_needs_a_card_or_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.dispatch(["cipher"])
    assert models.dispatch(["cipher", "--device=cpu"]) == 0
    assert "gpu shift cypher uint:" in capsys.readouterr().out


# ------------------------------------------------------------ pagerank

@pytest.mark.parametrize("n,avg,seed", [(128, 4, 0), (1000, 8, 5)])
def test_graph_builder_is_the_reference(n, avg, seed):
    g = pagerank.build_graph(n, avg, seed)
    r = j_pagerank.build_graph(n, avg, seed)
    for name in ("indices", "edges", "inv_deg", "rank0"):
        a, b = getattr(g, name), getattr(r, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    degs = np.diff(g.indices)
    np.testing.assert_array_equal(degs, np.arange(n) % (2 * avg - 1) + 1)


@pytest.mark.parametrize("n,avg,iters", [(256, 3, 6), (2048, 8, 20)])
def test_run_pagerank_bitwise_golden_ulp10_jax(n, avg, iters):
    g = pagerank.build_graph(n, avg, seed=1)
    out = pagerank.run_pagerank(g, iters, device="cpu").numpy()
    np.testing.assert_array_equal(out, golden.host_graph_iterate(
        g.indices, g.edges, g.rank0, g.inv_deg, iters))
    ref = np.asarray(j_pagerank.run_pagerank(g, iters))
    assert int(ulp_distance(out, ref).max()) <= 10
    assert np.isfinite(out).all() and (out >= 0.5 / n - 1e-9).all()
    assert pagerank.bytes_moved(g, iters) == j_pagerank.bytes_moved(g, iters)


def test_run_pagerank_rejects_odd_iterations():
    g = pagerank.build_graph(64, 2, seed=3)
    with pytest.raises(ValueError, match="even"):
        pagerank.run_pagerank(g, 3, device="cpu")


def test_pagerank_step_odd_chunks_equal_the_loop():
    g = pagerank.build_graph(500, 5, seed=4)
    state0, step = pagerank.pagerank_step(g, device="cpu")
    a = step(step(state0, 3), 3).numpy()
    np.testing.assert_array_equal(
        a, pagerank.run_pagerank(g, 6, device="cpu").numpy())


def test_checkpointed_pagerank_bitwise_and_traced(tmp_path):
    g = pagerank.build_graph(1000, 4, seed=2)
    trace.clear_events()
    out = pagerank.run_pagerank_checkpointed(g, 12, str(tmp_path / "p.npz"),
                                             every=4, device="cpu")
    np.testing.assert_array_equal(
        out, pagerank.run_pagerank(g, 12, device="cpu").numpy())
    progress = [e for e in trace.events("solver-progress")
                if e["op"] == "pagerank"]
    assert len(progress) == 3
    j_out = j_pagerank.run_pagerank_checkpointed(
        g, 12, str(tmp_path / "j.npz"), every=4)
    assert int(ulp_distance(out, j_out).max()) <= 10


def test_pagerank_main_and_workload(capsys):
    assert pagerank.main(2048, 4, 4, device="cpu")
    assert "Worked! device and reference output match." in \
        capsys.readouterr().out
    assert models.dispatch(["pagerank", "--num_nodes=1024", "--iterations=2",
                            "--device=cpu"]) == 0
    assert models.dispatch(["pagerank", "--bogus=1"]) == 2
    assert models.dispatch(["pagerank", "stray"]) == 2
