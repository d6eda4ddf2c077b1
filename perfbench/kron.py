"""GAP's Kronecker graph (``kron``), drawn from ``--seed`` on the device:
the benchmark's own input code, as ``inputs.spmv_problem`` is for the
SpMV-scan.

Graph500's generator as GAP's ``builder.h`` runs it: ``edge_factor ·
2^scale`` edges, each placed by ``scale`` uniform float32 draws among the
quadrants A (0.57), B (0.19), C (0.19) and D (0.05) of the adjacency
matrix, then every vertex id mapped through one random permutation.  The
draws come in chunks of a fixed length from one seeded generator, so the
same seed gives the same edges in every process on the same card type;
nothing is derived from a float64 running sum.
"""

from __future__ import annotations

import torch

from . import inputs

#: edges drawn a chunk
CHUNK = 1 << 24


def kron_edges(scale: int, edge_factor: int, seed: int, device,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(src, dst)``, int32 tensors of ``edge_factor · 2^scale`` vertex ids
    in ``[0, 2^scale)`` on ``device``."""
    g = inputs.torch_generator(seed, 4, device)
    n, m = 1 << scale, edge_factor << scale
    perm = torch.randperm(n, generator=g, device=device).to(torch.int32)
    src = torch.empty(m, dtype=torch.int32, device=device)
    dst = torch.empty(m, dtype=torch.int32, device=device)
    for lo in range(0, m, CHUNK):
        k = min(CHUNK, m - lo)
        s = torch.zeros(k, dtype=torch.int64, device=device)
        d = torch.zeros(k, dtype=torch.int64, device=device)
        for _ in range(scale):
            u = torch.rand(k, generator=g, device=device)
            top = u < a + b          # A or B: the source's bit stays 0
            s = 2 * s + ~top
            d = 2 * d + torch.where(top, u > a, u > a + b + c)
        src[lo:lo + k] = perm[s]
        dst[lo:lo + k] = perm[d]
    return src, dst
