"""Temporally blocked heat stencil: the hand-written Hopper kernel's wrappers.

Counterpart of ``cme213_tpu/ops/stencil_pipeline.py``.  One launch of
``csrc/heat_stencil.cu`` runs ``k`` fused heat steps on each of up to
``MAX_SHARDS`` grids of one shape: a CUDA block walks a strip of
``tile_x`` columns down a run of ``tile_y``-row tiles, staging the next
tile's window (the tile plus K = k·border of halo) in shared memory while
it computes the current one with register-blocked micro-tiles, re-imposes
the Dirichlet bands after each sub-step where they fall, and writes the
tile to a second grid.  ``run_heat_pipeline`` and ``run_heat_pipeline2d``
make ``iters / k`` launches on one grid, swapping two device buffers.

The same kernel serves the distributed solve (``dist/heat.py``,
``local_kernel="pallas"``): ``stencil_local_multistep_shards`` makes one
launch per device for every K-padded shard block the device holds, each
with its global offsets, so the Dirichlet bands fall where they would on
the whole grid (the JAX package's one ``pallas_call`` per device under
``shard_map``); ``stencil_local_multistep`` is its table of one.

The geometry is compiled in: ``DESIGNS`` gives, per dtype and k class (k =
1, 2, ≥ 3), the strip width, the threads a block and the micro-tile
height.  The tile height is a launch argument (``pick_pipeline_tile``).
Both widths the entry points ask for (``PIPELINE_TILE_BYTES``,
``PIPELINE2D_TILE_BYTES``) map to the class's one design, so
``run_heat_pipeline`` and ``run_heat_pipeline2d`` make the same launch.
``launch_plan`` computes a shape's tile, shared memory, occupancy and run
length once and keeps them.

Dispatch is on the tensor's device: a CPU tensor takes the plain version
(``run_heat_pipeline_plain``, ``stencil_local_multistep_plain``); a CUDA
tensor launches the kernel, and a failed build or launch raises.
``LAUNCHES`` counts kernel launches per entry point.

The TPU kernels' layout constraints (128-lane and 8-sublane padding,
``tile_y % kpad``, ``K ≤ 128``) do not apply here; the bound on a tile is
the shared memory a Hopper block may use.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _kernels
from ._kernels import MAX_SHARDS
from .stencil import BORDER_FOR_ORDER, run_heat_roll, stencil_interior

#: kernel launches per entry point (the plain version launches nothing)
LAUNCHES = {"pipeline": 0, "pipeline2d": 0, "local": 0}

#: dynamic shared memory one Hopper block may opt in to (227 KB)
SMEM_BUDGET_BYTES = 232_448

#: tile widths in bytes: ``run_heat_pipeline``'s own (128 f32 / 64 f64
#: columns) and ``run_heat_pipeline2d``'s default (256 f32 / 128 f64)
PIPELINE_TILE_BYTES = 512
PIPELINE2D_TILE_BYTES = 1024


@dataclass(frozen=True)
class Design:
    """One k class's compiled geometry (``csrc/heat_stencil.cu`` Design):
    strips of ``tile_x`` columns, ``threads`` a block, micro-tiles of 4
    columns × ``rows`` rows a thread; ``tile_y`` is the default tile
    height."""

    tile_x: int
    threads: int
    rows: int
    tile_y: int


#: (dtype bytes, k class) -> design; the class of k is min(k, 3).  Measured
#: on the H100 (PERF.md §5): f32 k = 1 runs two 83 KB blocks an SM, k = 2
#: three 68 KB blocks of 2-row micro-tiles, k ≥ 3 a 64-column strip whose
#: default 56-row tile keeps two blocks an SM up to k = 4 (one beyond)
DESIGNS = {
    (4, 1): Design(128, 256, 8, 64),
    (4, 2): Design(64, 256, 2, 48),
    (4, 3): Design(64, 256, 4, 56),
    (8, 1): Design(64, 128, 4, 32),
    (8, 2): Design(32, 128, 4, 48),
    (8, 3): Design(32, 128, 4, 48),
}


def design(k: int, dtype_bytes: int = 4, tile_x: int | None = None) -> Design:
    """The design ``heat_ksteps`` runs at ``k``.  ``tile_x``, when given,
    is the width an entry point asks for: ``PIPELINE_TILE_BYTES`` or
    ``PIPELINE2D_TILE_BYTES`` of columns, which both map to the class's
    design; any other width raises ``ValueError``."""
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    d = DESIGNS[(dtype_bytes, min(k, 3))]
    widths = (PIPELINE_TILE_BYTES // dtype_bytes,
              PIPELINE2D_TILE_BYTES // dtype_bytes)
    if tile_x is not None and tile_x not in widths:
        raise ValueError(f"tile_x={tile_x}: the kernel is built for the "
                         f"widths {widths} (both run its {d.tile_x}-column "
                         f"strips at k={k})")
    return d


def smem_bytes(tile_y: int, k: int, order: int, dtype_bytes: int = 4) -> int:
    """Shared memory of one block: two staging windows (the tile and the
    prefetched next one) and, when k > 1, a scratch window for the
    sub-steps' ping-pong.  A window holds the tile rows rounded up to whole
    micro-tiles, K = k·border halo rows above and below (plus one
    micro-tile of slack rows when 2·border is not a whole number of them),
    and the strip with ceil4(K) halo columns and a 4-column margin on each
    side.  The launch is given this size; the C entry checks it."""
    d = design(k, dtype_bytes)
    b = BORDER_FOR_ORDER[order]
    K = k * b
    ka = -(-K // 4) * 4
    rows = -(-tile_y // d.rows) * d.rows + 2 * K
    rows += 0 if (2 * b) % d.rows == 0 else d.rows
    windows = 2 if k == 1 else 3
    return windows * rows * (d.tile_x + 2 * ka + 8) * dtype_bytes


def pick_pipeline_tile(gy: int, k: int, order: int, target: int | None = None,
                       tile_x: int | None = None,
                       dtype_bytes: int = 4) -> int:
    """A tile_y for ``gy``-row grids at ``k`` (``tile_x``: the width an
    entry point asks for, see ``design``).

    Starts at ``min(target, gy)`` (default target: the design's tile) and
    steps down by one micro-tile while ``smem_bytes`` exceeds a block's
    shared memory.  The launch checks the budget again and raises when even
    the smallest tile does not fit.
    """
    d = design(k, dtype_bytes, tile_x)
    t = max(1, min(target or d.tile_y, gy))
    while t > d.rows and smem_bytes(t, k, order, dtype_bytes) \
            > SMEM_BUDGET_BYTES:
        t -= d.rows
    return t


@dataclass(frozen=True)
class PipelineGeometry:
    """One launch's decomposition: strips of ``tile_x`` columns, tiles of
    ``tile_y`` rows, ``run`` consecutive tiles a block, ``smem`` bytes a
    block of ``threads``, ``grid`` = (strips, blocks per strip, shards),
    ``blocks_per_sm`` the occupancy the split was made for."""

    tile_y: int
    tile_x: int
    threads: int
    run: int
    smem: int
    grid: tuple[int, int, int]
    blocks_per_sm: int


def pipeline_geometry(H: int, W: int, shards: int, k: int, order: int,
                      tile_y: int, dtype_bytes: int, sms: int,
                      blocks_per_sm: int) -> PipelineGeometry:
    """The decomposition of one launch over ``shards`` (H, W) grids.

    Each strip's tiles are split into runs so that the blocks of every
    shard fill about one wave of ``sms`` SMs at ``blocks_per_sm``; a block
    walks its run, prefetching the next tile's window.  Raises
    ``ValueError`` when the tile's windows do not fit in a block's shared
    memory.
    """
    d = design(k, dtype_bytes)
    smem = smem_bytes(tile_y, k, order, dtype_bytes)
    if smem > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"tile {tile_y}x{d.tile_x} at k={k}, order {order} needs {smem} "
            f"B of shared memory; a block has {SMEM_BUDGET_BYTES}")
    strips = -(-W // d.tile_x)
    tiles = -(-H // tile_y)
    splits = max(1, min(tiles, sms * blocks_per_sm // (strips * shards)))
    run = -(-tiles // splits)
    return PipelineGeometry(tile_y, d.tile_x, d.threads, run, smem,
                            (strips, -(-tiles // run), shards),
                            blocks_per_sm)


_PLANS: dict[tuple, PipelineGeometry] = {}


def launch_plan(grid: torch.Tensor, shards: int, k: int, order: int,
                tile_y: int | None = None) -> PipelineGeometry:
    """The decomposition of a launch over ``shards`` CUDA grids shaped and
    placed like ``grid``, computed once per (device, dtype, order, k, shape,
    shards, tile_y) and kept: the tile (``pick_pipeline_tile`` unless
    ``tile_y`` is given), its shared memory, the blocks an SM from the
    occupancy calculator and the runs.  Raises ``ValueError`` when the
    tile's windows do not fit in a block's shared memory."""
    H, W = grid.shape
    key = (grid.device, grid.dtype, order, k, H, W, shards, tile_y)
    plan = _PLANS.get(key)
    if plan is None:
        elem = grid.element_size()
        ty = tile_y or pick_pipeline_tile(H, k, order, dtype_bytes=elem)
        need = smem_bytes(ty, k, order, elem)
        if need > SMEM_BUDGET_BYTES:
            raise ValueError(
                f"tile_y={ty} at k={k}, order {order} needs {need} B of "
                f"shared memory; a block has {SMEM_BUDGET_BYTES}")
        per_sm, _, _ = _kernels.heat_ksteps_occupancy(grid.device, elem,
                                                      order, k, need)
        sms = torch.cuda.get_device_properties(
            grid.device).multi_processor_count
        plan = pipeline_geometry(H, W, shards, k, order, ty, elem, sms,
                                 max(1, per_sm))
        _PLANS[key] = plan
    return plan


def _launch(shards, plan: PipelineGeometry, order: int, k: int, ny: int,
            nx: int, xcfl, ycfl, bc) -> None:
    _kernels.heat_ksteps(shards, order=order, k=k, tile_y=plan.tile_y,
                         tile_x=plan.tile_x, run=plan.run,
                         smem_bytes=plan.smem, ny=ny, nx=nx, xcfl=xcfl,
                         ycfl=ycfl, bc=bc)


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


def _run(name: str, u: torch.Tensor, iters: int, order: int, xcfl, ycfl,
         bc, k: int, tile_y: int | None, tile_x: int) -> torch.Tensor:
    if iters % k != 0:
        raise ValueError(f"iters={iters} must divide by k={k}")
    _check_grid(u)
    design(k, u.element_size(), tile_x)
    if u.device.type == "cpu":
        return run_heat_pipeline_plain(u, iters, order, xcfl, ycfl, bc, k=k)
    b = BORDER_FOR_ORDER[order]
    gy, gx = u.shape
    src = u.contiguous()
    if iters == 0:
        return src.clone()
    plan = launch_plan(src, 1, k, order, tile_y)
    bufs = [torch.empty_like(src), torch.empty_like(src)]
    for i in range(iters // k):
        dst = bufs[i % 2]
        _launch([(src, dst, 0, 0)], plan, order, k, gy - 2 * b, gx - 2 * b,
                xcfl, ycfl, bc)
        LAUNCHES[name] += 1
        src = dst
    return src


def run_heat_pipeline(u: torch.Tensor, iters: int, order: int, xcfl, ycfl,
                      bc: tuple[float, float, float, float], k: int = 1,
                      tile_y: int | None = None) -> torch.Tensor:
    """``iters`` timesteps, ``k`` fused per launch, on tiles of
    ``PIPELINE_TILE_BYTES`` width (the k class's design, see ``design``)
    and ``tile_y`` rows (default ``pick_pipeline_tile``).

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
    """``run_heat_pipeline`` at the width the caller asks for (default
    ``PIPELINE2D_TILE_BYTES``; see ``design`` for the widths the kernel is
    built for, which all run the k class's one design).  Same kernel, same
    result."""
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


def stencil_local_multistep_shards_plain(
        blocks: list[torch.Tensor], offsets: list[tuple[int, int]], ny: int,
        nx: int, order: int, xcfl, ycfl,
        bc: tuple[float, float, float, float],
        k: int = 1) -> list[torch.Tensor]:
    """The batched shard kernel's plain version: one
    ``stencil_local_multistep_plain`` per block."""
    return [stencil_local_multistep_plain(p, gy0, gx0, ny, nx, order, xcfl,
                                          ycfl, bc, k=k)
            for p, (gy0, gx0) in zip(blocks, offsets, strict=True)]


def stencil_local_multistep_shards(
        blocks: list[torch.Tensor], offsets: list[tuple[int, int]], ny: int,
        nx: int, order: int, xcfl, ycfl,
        bc: tuple[float, float, float, float], k: int = 1,
        tile_y: int | None = None) -> list[torch.Tensor]:
    """``k`` fused timesteps on every shard's K-padded block (B3): one
    launch of ``csrc/heat_stencil.cu:heat_ksteps`` per device for all the
    blocks it holds (per ``MAX_SHARDS`` of them).

    ``blocks[i]`` is a shard's block with K = k·border of halo on every
    side (neighbour data or BC fill, ``dist/heat._assemble_padded``) and
    ``offsets[i]`` = (gy0, gx0) the global halo-grid coordinates of its
    element [0, 0]; ``(ny, nx)`` are the global interior extents, which
    place the Dirichlet bands.  Every block has one shape and dtype (a mesh
    ghost-pads its shards to one shape); mixed ones raise.  Returns a new
    (H, W) block per shard, views of one (n, H, W) tensor per launch, whose
    rows and columns ``[K, H - K)`` hold the k-step result, equal bit for
    bit to the plain version's; the ring outside them differs between the
    two (the kernel's window reads 0 beyond the block) and is never read.
    ``tile_y`` defaults to ``pick_pipeline_tile`` on the padded block.
    """
    if not blocks or len(blocks) != len(offsets):
        raise ValueError(f"{len(blocks)} blocks for {len(offsets)} offsets")
    first = blocks[0]
    _check_grid(first)
    dtype, shape = first.dtype, first.shape
    by_device: dict[torch.device, list[int]] = {}
    for i, p in enumerate(blocks):
        if p.dtype != dtype:
            raise TypeError(f"shards of mixed dtypes: {p.dtype} beside "
                            f"{dtype}")
        if p.shape != shape:
            raise ValueError(f"shards of mixed shapes: {tuple(p.shape)} "
                             f"beside {tuple(shape)}")
        by_device.setdefault(p.device, []).append(i)
    out: list[torch.Tensor | None] = [None] * len(blocks)
    for dev, idx in by_device.items():
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {dev}")
        if dev.type == "cpu":
            for i in idx:
                out[i] = stencil_local_multistep_plain(
                    blocks[i], *offsets[i], ny, nx, order, xcfl, ycfl, bc,
                    k=k)
            continue
        for lo in range(0, len(idx), MAX_SHARDS):
            part = idx[lo:lo + MAX_SHARDS]
            plan = launch_plan(blocks[part[0]], len(part), k, order, tile_y)
            res = torch.empty((len(part), *shape), dtype=dtype,
                              device=dev).unbind(0)
            _launch([(blocks[i].contiguous(), r, *offsets[i])
                     for i, r in zip(part, res)], plan, order, k, ny, nx,
                    xcfl, ycfl, bc)
            LAUNCHES["local"] += 1
            for i, r in zip(part, res):
                out[i] = r
    return out


def stencil_local_multistep(p: torch.Tensor, gy0: int, gx0: int, ny: int,
                            nx: int, order: int, xcfl, ycfl,
                            bc: tuple[float, float, float, float],
                            k: int = 1,
                            tile_y: int | None = None) -> torch.Tensor:
    """``k`` fused timesteps on one shard's K-padded block (B3):
    ``stencil_local_multistep_shards`` with a table of one.  ``(gy0,
    gx0)`` are the global halo-grid coordinates of ``p[0, 0]`` and ``(ny,
    nx)`` the global interior extents.  Returns a new (H, W) block whose
    rows and columns ``[K, H - K)`` hold the k-step result, equal bit for
    bit to ``stencil_local_multistep_plain``'s."""
    return stencil_local_multistep_shards([p], [(gy0, gx0)], ny, nx, order,
                                          xcfl, ycfl, bc, k=k,
                                          tile_y=tile_y)[0]
