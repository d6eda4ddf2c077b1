"""Inputs made from ``--seed``: the same seed gives the same inputs, and
every seed gives the same sizes, so a seed changes values and never the
amount of work."""

from __future__ import annotations

import numpy as np
import torch

from .reference import spmv as spmv_ref


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of ``seed`` (any whole
    number, 64 bits or more)."""
    return np.random.default_rng([abs(int(seed)), stream])


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(0, 2 ** 62)))
    return g


def heat_variants(seed: int, count: int, lo: float, hi: float) -> list[dict]:
    """``count`` sets of the initial value and the four Dirichlet values
    (top, left, bottom, right), each uniform in [lo, hi] to two
    decimals."""
    r = rng(seed, 1)
    out = []
    for _ in range(count):
        v = np.round(r.uniform(lo, hi, size=5), 2)
        out.append({"ic": float(v[0]), "bc": tuple(float(b) for b in v[1:])})
    return out


def spmv_problem(n: int, p: int, q: int, iters: int, seed: int,
                 device) -> dict:
    """A readMM.py-style instance of the hw_final engine, drawn on
    ``device`` (the construction of ``aux/readMM.py`` as the program's
    generator makes it): ``p - 2`` distinct sorted segment starts in
    [1, n) between the sentinels 0 and n, gather indices uniform in [0, q),
    values and ``x`` uniform in [-1, 1).  ``x`` is divided by the map's
    growth, read from a short float64 power iteration, so that ``iters``
    iterations stay finite in float32.  Returns numpy arrays ``a`` (f32),
    ``s`` (int32, p entries), ``k`` (int32), ``x`` (f32) and ``iters``."""
    g = torch_generator(seed, 2, device)
    heads = torch.randperm(n - 1, generator=g, device=device)[:p - 2] + 1
    s = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                   torch.sort(heads).values,
                   torch.full((1,), n, dtype=torch.int64, device=device)])
    k = torch.randint(0, q, (n,), generator=g, device=device,
                      dtype=torch.int64)
    a = torch.rand(n, generator=g, device=device) * 2 - 1
    x = torch.rand(q, generator=g, device=device) * 2 - 1
    xx = x.to(torch.float64)[k]
    b = a.to(torch.float64)
    growth = 1.0
    for _ in range(min(8, iters)):
        prev = float(b.abs().max())
        b = spmv_ref.segscan(b * xx, s)
        cur = float(b.abs().max())
        if prev > 0 and cur > 0:
            growth = cur / prev
            b = b / cur
    if np.isfinite(growth) and growth > 0:
        x = (x.to(torch.float64) / growth).to(torch.float32)
    return {"a": a.cpu().numpy(), "s": s.to(torch.int32).cpu().numpy(),
            "k": k.to(torch.int32).cpu().numpy(), "x": x.cpu().numpy(),
            "iters": iters}
