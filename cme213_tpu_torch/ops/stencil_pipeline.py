"""Temporally blocked heat stencil: the hand-written Hopper kernel's wrappers.

Counterpart of ``cme213_tpu/ops/stencil_pipeline.py``.  Each launch of
``csrc/heat_stencil.cu`` runs ``k`` fused heat steps on (tile_y, tile_x)
output tiles: a block stages its tile plus ``K = k·border`` halo on every
side in shared memory, runs the k sub-steps there (re-imposing the
Dirichlet bands after each) and writes the tile to a second grid.  The host
loop makes ``iters / k`` launches, swapping two device buffers.

The same kernel serves the distributed solve (``dist/heat.py``,
``local_kernel="pallas"``): ``stencil_local_multistep`` launches it once on
a shard's K-padded block with the shard's global offsets, so the Dirichlet
bands fall where they would on the whole grid.

Dispatch is on the tensor's device: a CPU tensor takes the plain version
(``run_heat_pipeline_plain``, ``stencil_local_multistep_plain``); a CUDA
tensor launches the kernel, and a failed build or launch raises.
``LAUNCHES`` counts kernel launches per entry point.

The TPU kernels' layout constraints (128-lane and 8-sublane padding,
``tile_y % kpad``, ``K ≤ 128``) do not apply here; the bound on a tile is
the shared memory a Hopper block may use.
"""

from __future__ import annotations

import torch

from . import _kernels
from .stencil import BORDER_FOR_ORDER, run_heat_roll, stencil_interior

#: kernel launches per entry point (the plain version launches nothing)
LAUNCHES = {"pipeline": 0, "pipeline2d": 0, "local": 0}

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


def _check_grid(u: torch.Tensor) -> None:
    if u.dim() != 2 or u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected a 2-D float32/float64 grid, got "
                        f"{u.dim()}-D {u.dtype}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {u.device}")


def _launch_shape(u: torch.Tensor, k: int, order: int, tile_y: int | None,
                  tile_x: int) -> tuple[int, int]:
    """(tile_y, shared memory bytes) of a launch on ``u``; raises when the
    tile's window does not fit in a block's shared memory."""
    elem = u.element_size()
    ty = tile_y or pick_pipeline_tile(u.shape[0], k, order, tile_x=tile_x,
                                      dtype_bytes=elem)
    need = smem_bytes(ty, tile_x, k, order, elem)
    if need > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"tile {ty}x{tile_x} at k={k}, order {order} needs {need} B of "
            f"shared memory; a block has {SMEM_BUDGET_BYTES}")
    return ty, need


def _run(name: str, u: torch.Tensor, iters: int, order: int, xcfl, ycfl,
         bc, k: int, tile_y: int | None, tile_x: int) -> torch.Tensor:
    if iters % k != 0:
        raise ValueError(f"iters={iters} must divide by k={k}")
    _check_grid(u)
    if u.device.type == "cpu":
        return run_heat_pipeline_plain(u, iters, order, xcfl, ycfl, bc, k=k)
    b = BORDER_FOR_ORDER[order]
    gy, gx = u.shape
    ty, need = _launch_shape(u, k, order, tile_y, tile_x)
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


def stencil_local_multistep_plain(p: torch.Tensor, gy0: int, gx0: int,
                                  ny: int, nx: int, order: int, xcfl, ycfl,
                                  bc: tuple[float, float, float, float],
                                  k: int = 1) -> torch.Tensor:
    """The shard kernel's plain PyTorch version: ``k`` applications of
    ``stencil_interior`` to the K-padded block, each followed by the
    Dirichlet bands on global coordinates (rows, then columns over the
    corners) — the sharded XLA step of the JAX package
    (``dist/heat._multistep_local_step``).  Rows and columns the global
    grid holds beyond its ``ny × nx`` interior (ghost padding of uneven
    shards) take the top and right bands.  Returns a new block."""
    b = BORDER_FOR_ORDER[order]
    H, W = p.shape
    bc_top, bc_left, bc_bottom, bc_right = bc
    gr = gy0 + torch.arange(H, device=p.device).view(H, 1)
    gc = gx0 + torch.arange(W, device=p.device).view(1, W)
    bands = ((gr < b, bc_bottom), (gr >= b + ny, bc_top),
             (gc < b, bc_left), (gc >= b + nx, bc_right))
    p = p.clone()
    for _ in range(k):
        p[b:-b, b:-b] = stencil_interior(p, order, xcfl, ycfl)
        for mask, value in bands:
            p.masked_fill_(mask, value)
    return p


def stencil_local_multistep(p: torch.Tensor, gy0: int, gx0: int, ny: int,
                            nx: int, order: int, xcfl, ycfl,
                            bc: tuple[float, float, float, float],
                            k: int = 1,
                            tile_y: int | None = None) -> torch.Tensor:
    """``k`` fused timesteps on a shard's K-padded block (B3): one launch
    of ``csrc/heat_stencil.cu:heat_ksteps``.

    ``p`` is the shard's block with K = k·border of halo on every side
    (neighbour data or BC fill, ``dist/heat._assemble_padded``); ``(gy0,
    gx0)`` are the global halo-grid coordinates of ``p[0, 0]`` and ``(ny,
    nx)`` the global interior extents, which place the Dirichlet bands.
    Returns a new (H, W) block whose rows and columns ``[K, H - K)`` hold
    the k-step result, equal bit for bit to the plain version's; the ring
    outside them differs between the two (the kernel's window reads 0
    beyond the block) and is never read.  ``tile_y`` defaults to
    ``pick_pipeline_tile`` on the padded block, at ``run_heat_pipeline``'s
    tile width.
    """
    _check_grid(p)
    if p.device.type == "cpu":
        return stencil_local_multistep_plain(p, gy0, gx0, ny, nx, order,
                                             xcfl, ycfl, bc, k=k)
    tile_x = PIPELINE_TILE_BYTES // p.element_size()
    ty, need = _launch_shape(p, k, order, tile_y, tile_x)
    src = p.contiguous()
    dst = torch.empty_like(src)
    _kernels.heat_ksteps(src, dst, order=order, k=k, tile_y=ty,
                         tile_x=tile_x, smem_bytes=need, ny=ny, nx=nx,
                         xcfl=xcfl, ycfl=ycfl, bc=bc, gy0=gy0, gx0=gx0)
    LAUNCHES["local"] += 1
    return dst
