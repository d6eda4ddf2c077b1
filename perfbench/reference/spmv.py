"""Plain reference of the hw_final SpMV-scan (``fp.cu``): ``iters`` times
``a <- segmented_inclusive_scan(a * x[k])`` over the segments that start
at ``s`` (``s[0] = 0``, the last entry the end sentinel ``n``).

The scan is one running sum over the whole vector less the running sum
just before each segment's start, in float64, so its rounding lies far
below float32's.  ``solve_lowered`` is the same iteration with the state,
the products and the scanned values stored in a lower precision (each
segment accumulated in float32 and rounded on output), the control that a
program in that precision would read.  Nothing here imports the program.
"""

from __future__ import annotations

import torch


def _segment_ids(s: torch.Tensor, n: int) -> torch.Tensor:
    lens = (s[1:] - s[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(lens.numel(), device=s.device), lens, output_size=n)


def segscan(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum of ``v`` (float64)."""
    n = v.numel()
    cs = torch.cumsum(v, 0)
    before = torch.zeros(s.numel() - 1, dtype=cs.dtype, device=cs.device)
    heads = s[1:-1].to(torch.int64)
    before[1:] = cs[heads - 1]
    return cs - before[_segment_ids(s, n)]


def solve(a, s, k, x, iters: int, device="cpu") -> torch.Tensor:
    """The final values in float64."""
    s = torch.as_tensor(s, device=device)
    xx = torch.as_tensor(x, device=device).to(torch.float64)[
        torch.as_tensor(k, device=device).to(torch.int64)]
    v = torch.as_tensor(a, device=device).to(torch.float64)
    for _ in range(iters):
        v = segscan(v * xx, s)
    return v


def solve_lowered(a, s, k, x, iters: int, dtype=torch.bfloat16,
                  device="cpu") -> torch.Tensor:
    """The iteration with values, ``xx`` and every product and scan
    output stored in ``dtype``; each segment's sum runs in float32 from
    its own head (no running sum across segments), as a kernel in that
    precision would carry it."""
    s = torch.as_tensor(s, device=device)
    seg = _segment_ids(s, int(s[-1]))
    xx = torch.as_tensor(x, device=device).to(dtype)[
        torch.as_tensor(k, device=device).to(torch.int64)]
    v = torch.as_tensor(a, device=device).to(dtype)
    heads = s[:-1].to(torch.int64)
    for _ in range(iters):
        w = (v * xx).to(torch.float32)
        cs = torch.cumsum(w.to(torch.float64), 0)
        before = torch.zeros(heads.numel(), dtype=cs.dtype, device=cs.device)
        before[1:] = cs[heads[1:] - 1]
        # the float64 running sum less its value before the head is the
        # segment's own sum; rounding it to float32 and then to ``dtype``
        # is what a float32 accumulator stored in ``dtype`` gives
        v = (cs - before[seg]).to(torch.float32).to(dtype)
    return v.to(torch.float64)
