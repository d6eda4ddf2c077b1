"""The numbers that decide ``correct``: how far a program's answer lies
from the reference's."""

from __future__ import annotations

import torch

#: the reading of an answer that cannot be compared (a finite number, so
#: that the result line stays JSON)
FAR = 1e30


def max_ulp(expected: torch.Tensor, got: torch.Tensor) -> int:
    """Largest distance in float32 units in the last place between two
    grids of one shape, over every element (0 where they are equal bit
    for bit; +0 and -0 are equal).  A NaN anywhere, or a shape that
    differs, reads as the largest distance there is."""
    if expected.shape != got.shape:
        return 2 ** 32
    e = expected.to(torch.float32).contiguous()
    g = got.to(device=e.device, dtype=torch.float32).contiguous()
    if bool(torch.isnan(e).any()) or bool(torch.isnan(g).any()):
        return 2 ** 32

    def ordered(t):
        i = t.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(2 ** 31) - i, i)

    return int((ordered(e) - ordered(g)).abs().max())


def relative_errors(expected: torch.Tensor, got) -> tuple[float, float]:
    """(relative L2, relative L-infinity) of ``got`` against ``expected``:
    ``||got - expected|| / ||expected||`` in each norm, in float64.  A
    non-finite value or a length that differs reads as ``FAR``."""
    e = expected.to(torch.float64)
    g = torch.as_tensor(got).to(device=e.device, dtype=torch.float64)
    if e.shape != g.shape or not bool(torch.isfinite(g).all()):
        return FAR, FAR
    d = g - e
    l2 = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(e))
    linf = float(d.abs().max() / e.abs().max())
    return l2, linf
