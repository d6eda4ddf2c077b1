"""The yardstick of GAP ``pr``'s sweep, frozen here so that a change to the
program cannot move it (``costs.py`` holds the peaks it is divided by)."""

from __future__ import annotations


def pagerank_sweep_bytes(n: int, e: int) -> int:
    """Bytes a sweep of the pull needs on a graph of ``n`` vertices and
    ``e`` directed CSR entries: the 4-byte neighbour ids once, the ``n +
    1`` int64 offsets once, and a vertex's float32 contribution read once,
    its degree read and its score read and written.  The count is the same
    whatever implements the pull."""
    return 4 * e + 8 * (n + 1) + 16 * n


def pagerank_sweep_flops(e: int) -> int:
    """One add an entry."""
    return e
