"""Temporally blocked heat stencil: the hand-written Hopper kernel's wrappers.

Counterpart of ``cme213_tpu/ops/stencil_pipeline.py``.  Each launch of
``csrc/heat_stencil.cu`` runs ``k`` fused heat steps on (tile_y, tile_x)
output tiles: a block stages its tile plus ``K = k·border`` halo on every
side in shared memory, runs the k sub-steps there (re-imposing the
Dirichlet bands after each) and writes the tile to a second grid.  The host
loop makes ``iters / k`` launches, swapping two device buffers.

Dispatch is on the tensor's device: a CPU tensor takes the plain version
(``run_heat_pipeline_plain``); a CUDA tensor launches the kernel, and a
failed build or launch raises.  ``LAUNCHES`` counts kernel launches per
entry point.

The TPU kernels' layout constraints (128-lane and 8-sublane padding,
``tile_y % kpad``, ``K ≤ 128``) do not apply here; the bound on a tile is
the shared memory a Hopper block may use.
"""

from __future__ import annotations

import torch

from . import _kernels
from .stencil import BORDER_FOR_ORDER, run_heat_roll

#: kernel launches per entry point (the plain version launches nothing)
LAUNCHES = {"pipeline": 0, "pipeline2d": 0}

#: dynamic shared memory one Hopper block may opt in to (227 KB)
SMEM_BUDGET_BYTES = 232_448

#: tile widths in bytes: ``run_heat_pipeline``'s own (128 f32 / 64 f64
#: columns) and ``run_heat_pipeline2d``'s default (256 f32 / 128 f64)
PIPELINE_TILE_BYTES = 512
PIPELINE2D_TILE_BYTES = 1024


def smem_bytes(tile_y: int, tile_x: int, k: int, order: int,
               dtype_bytes: int = 4) -> int:
    """Shared memory of one block: the (tile_y+2K) × (tile_x+2K) window,
    twice when k > 1 (the sub-steps ping-pong between two buffers).  The
    launch is given this size; the kernel does not compute it again."""
    K = k * BORDER_FOR_ORDER[order]
    return ((1 if k == 1 else 2) * (tile_y + 2 * K) * (tile_x + 2 * K)
            * dtype_bytes)


def pick_pipeline_tile(gy: int, k: int, order: int, target: int = 64,
                       tile_x: int | None = None,
                       dtype_bytes: int = 4) -> int:
    """A tile_y for ``tile_x``-wide tiles (default: ``run_heat_pipeline``'s
    width) whose window fits in a block's shared memory.

    Starts at ``min(target, gy)`` and steps down by 8 rows while
    ``smem_bytes`` exceeds ``SMEM_BUDGET_BYTES``.  The launch checks the
    budget again and raises when even the smallest tile does not fit.
    """
    tx = tile_x or PIPELINE_TILE_BYTES // dtype_bytes
    t = max(1, min(target, gy))
    while t > 8 and smem_bytes(t, tx, k, order, dtype_bytes) \
            > SMEM_BUDGET_BYTES:
        t -= 8
    return t


def run_heat_pipeline_plain(u: torch.Tensor, iters: int, order: int, xcfl,
                            ycfl, bc: tuple[float, float, float, float],
                            k: int = 1) -> torch.Tensor:
    """The kernel's plain PyTorch version: the roll-and-mask formulation of
    ``_apply_substeps`` over the whole grid (``ops.stencil.run_heat_roll``).
    Same arithmetic, same band order, so on the card the kernel agrees with
    it bit for bit."""
    return run_heat_roll(u, iters, order, xcfl, ycfl, bc, k=k)


def _run(name: str, u: torch.Tensor, iters: int, order: int, xcfl, ycfl,
         bc, k: int, tile_y: int | None, tile_x: int) -> torch.Tensor:
    if iters % k != 0:
        raise ValueError(f"iters={iters} must divide by k={k}")
    if u.dim() != 2 or u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected a 2-D float32/float64 grid, got "
                        f"{u.dim()}-D {u.dtype}")
    if u.device.type == "cpu":
        return run_heat_pipeline_plain(u, iters, order, xcfl, ycfl, bc, k=k)
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    b = BORDER_FOR_ORDER[order]
    gy, gx = u.shape
    elem = u.element_size()
    ty = tile_y or pick_pipeline_tile(gy, k, order, tile_x=tile_x,
                                      dtype_bytes=elem)
    need = smem_bytes(ty, tile_x, k, order, elem)
    if need > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"tile {ty}x{tile_x} at k={k}, order {order} needs {need} B of "
            f"shared memory; a block has {SMEM_BUDGET_BYTES}")
    src = u.contiguous()
    if iters == 0:
        return src.clone()
    bufs = [torch.empty_like(src), torch.empty_like(src)]
    for i in range(iters // k):
        dst = bufs[i % 2]
        _kernels.heat_ksteps(src, dst, order=order, k=k, tile_y=ty,
                             tile_x=tile_x, smem_bytes=need, ny=gy - 2 * b,
                             nx=gx - 2 * b, xcfl=xcfl, ycfl=ycfl, bc=bc)
        LAUNCHES[name] += 1
        src = dst
    return src


def run_heat_pipeline(u: torch.Tensor, iters: int, order: int, xcfl, ycfl,
                      bc: tuple[float, float, float, float], k: int = 1,
                      tile_y: int | None = None) -> torch.Tensor:
    """``iters`` timesteps, ``k`` fused per launch, on tiles whose width the
    function chooses (``PIPELINE_TILE_BYTES``) and whose height is
    ``tile_y`` (default ``pick_pipeline_tile``).

    ``u`` is the (gy, gx) halo grid from ``make_initial_grid``; ``bc`` is
    ``SimParams.bc`` = (top, left, bottom, right).  ``iters`` must divide
    by ``k``.  Returns a new grid; ``u`` is not modified.
    """
    return _run("pipeline", u, iters, order, xcfl, ycfl, bc, k, tile_y,
                PIPELINE_TILE_BYTES // u.element_size())


def run_heat_pipeline2d(u: torch.Tensor, iters: int, order: int, xcfl,
                        ycfl, bc: tuple[float, float, float, float],
                        k: int = 1, tile_y: int | None = None,
                        tile_x: int | None = None) -> torch.Tensor:
    """``run_heat_pipeline`` on (tile_y, tile_x) tiles the caller chooses
    (default width ``PIPELINE2D_TILE_BYTES``).  Same kernel, same result."""
    return _run("pipeline2d", u, iters, order, xcfl, ycfl, bc, k, tile_y,
                tile_x or PIPELINE2D_TILE_BYTES // u.element_size())
