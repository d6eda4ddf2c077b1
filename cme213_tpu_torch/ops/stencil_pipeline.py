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
tensor launches the kernel, and a failed build or launch raises.  A
single-grid solve enqueues its ``iters / k`` launches in one call of the
library's C loop (``_kernels.heat_ksteps_loop``); B3 makes one call a
launch, since its launches interleave with halo exchanges.
``LAUNCHES`` counts kernel launches per entry point, ``LAUNCH_LOOPS`` the
C loop's calls, and ``LOCAL_LAUNCHES`` B3's launches per card.

The TPU kernels' layout constraints (128-lane and 8-sublane padding,
``tile_y % kpad``, ``K ≤ 128``) do not apply here; the bound on a tile is
the shared memory a Hopper block may use.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _kernels
from ..core.errors import KernelError
from ..core.trace import host_range
from ._kernels import MAX_SHARDS
from .stencil import BORDER_FOR_ORDER, run_heat_roll, stencil_interior

#: kernel launches per entry point (the plain version launches nothing)
LAUNCHES = {"pipeline": 0, "pipeline2d": 0, "local": 0}
#: calls of the C launch loop per single-grid entry point, one a solve on a
#: CUDA grid: ``LAUNCHES[name] / LAUNCH_LOOPS[name]`` is ``iters // k``
LAUNCH_LOOPS = {"pipeline": 0, "pipeline2d": 0}
#: B3's launches per card (``"cuda:<index>"``), counted with
#: ``LAUNCHES["local"]``
LOCAL_LAUNCHES: dict[str, int] = {}

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
    occupancy calculator and the runs.  Raises ``KernelError`` when the
    tile's windows do not fit in a block's shared memory: the kernel
    cannot launch at that tile."""
    H, W = grid.shape
    key = (grid.device, grid.dtype, order, k, H, W, shards, tile_y)
    plan = _PLANS.get(key)
    if plan is None:
        elem = grid.element_size()
        ty = tile_y or pick_pipeline_tile(H, k, order, dtype_bytes=elem)
        need = smem_bytes(ty, k, order, elem)
        if need > SMEM_BUDGET_BYTES:
            raise KernelError(
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
    # one host range a solve, never one a launch: the loop's host work is
    # what it measures, and it waits for no launch
    with host_range("heat.launch_loop"):
        plan = launch_plan(src, 1, k, order, tile_y)
        bufs = (torch.empty_like(src), torch.empty_like(src))
        out = _kernels.heat_ksteps_loop(
            src, bufs, iters // k, order=order, k=k, tile_y=plan.tile_y,
            tile_x=plan.tile_x, run=plan.run, smem_bytes=plan.smem,
            ny=gy - 2 * b, nx=gx - 2 * b, xcfl=xcfl, ycfl=ycfl, bc=bc)
        LAUNCHES[name] += iters // k
        LAUNCH_LOOPS[name] += 1
    return out


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
        tile_y: int | None = None,
        out: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
    """``k`` fused timesteps on every shard's K-padded block (B3): one
    launch of ``csrc/heat_stencil.cu:heat_ksteps`` per device for all the
    blocks it holds (per ``MAX_SHARDS`` of them).

    ``blocks[i]`` is a shard's block with K = k·border of halo on every
    side (neighbour data or BC fill, ``dist/heat._assemble_padded``) and
    ``offsets[i]`` = (gy0, gx0) the global halo-grid coordinates of its
    element [0, 0]; ``(ny, nx)`` are the global interior extents, which
    place the Dirichlet bands.  Every block has one shape and dtype (a mesh
    ghost-pads its shards to one shape); mixed ones raise.  Returns an
    (H, W) block per shard whose rows and columns ``[K, H - K)`` hold the
    k-step result, equal bit for bit to the plain version's; the ring
    outside them differs between the two (the kernel's window reads 0
    beyond the block) and is never read.  The blocks returned are ``out``,
    a contiguous (H, W) tensor a shard on its block's device, none of them
    a block's storage (on the CPU the plain result is copied into it), or
    without ``out`` new views of one (n, H, W) tensor per launch.
    ``tile_y`` defaults to ``pick_pipeline_tile`` on the padded block.
    """
    if not blocks or len(blocks) != len(offsets):
        raise ValueError(f"{len(blocks)} blocks for {len(offsets)} offsets")
    if out is not None and len(out) != len(blocks):
        raise ValueError(f"{len(out)} destinations for {len(blocks)} blocks")
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
        if out is not None and (out[i].shape != shape
                                or out[i].dtype != dtype
                                or out[i].device != p.device
                                or not out[i].is_contiguous()):
            raise ValueError(
                f"destination {i} is a {tuple(out[i].shape)} "
                f"{out[i].dtype} tensor on {out[i].device}; its block is a "
                f"contiguous {tuple(shape)} {dtype} tensor on {p.device}")
        by_device.setdefault(p.device, []).append(i)
    res: list[torch.Tensor | None] = [None] * len(blocks)
    for dev, idx in by_device.items():
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {dev}")
        if dev.type == "cpu":
            for i in idx:
                r = stencil_local_multistep_plain(
                    blocks[i], *offsets[i], ny, nx, order, xcfl, ycfl, bc,
                    k=k)
                res[i] = r if out is None else out[i].copy_(r)
            continue
        for lo in range(0, len(idx), MAX_SHARDS):
            part = idx[lo:lo + MAX_SHARDS]
            plan = launch_plan(blocks[part[0]], len(part), k, order, tile_y)
            dst = (torch.empty((len(part), *shape), dtype=dtype,
                               device=dev).unbind(0) if out is None
                   else [out[i] for i in part])
            _launch([(blocks[i].contiguous(), r, *offsets[i])
                     for i, r in zip(part, dst)], plan, order, k, ny, nx,
                    xcfl, ycfl, bc)
            LAUNCHES["local"] += 1
            LOCAL_LAUNCHES[str(dev)] = LOCAL_LAUNCHES.get(str(dev), 0) + 1
            for i, r in zip(part, dst):
                res[i] = r
    return res


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


# ------------------------------------------------------------- the ladder

def staged_cost(H: int, W: int, k: int, order: int, tile_y: int,
                dtype_bytes: int = 4, launches: int = 1):
    """What ``launches`` launches of ``heat_ksteps`` over one (H, W) grid
    at ``tile_y`` stage and compute, from the launch's decomposition
    (``csrc/heat_stencil.cu``) rather than from the useful work
    (``core/roofline.heat_cost``).

    Bytes: every tile of every strip stages a window of the tile's rows
    rounded up to whole micro-tiles plus K = k·border halo rows above and
    below, by the strip plus ceil4(K) halo columns each side, reading the
    part that lies in the grid (the halo re-reads included); every launch
    writes the grid once.  Operations: the micro-tiles each sub-step
    issues (sub-step s < k covers the cells within (k−s)·border of the
    tile, sub-step k the tile's rounded rows), ``flops_per_point`` each
    cell.  Returns a ``core.roofline.Cost``.
    """
    from ..core.roofline import Cost
    from .stencil import flops_per_point

    d = design(k, dtype_bytes)
    b = BORDER_FOR_ORDER[order]
    K = k * b
    KA = -(-K // 4) * 4
    TX, R = d.tile_x, d.rows
    TYp = -(-tile_y // R) * R
    WY = TYp + 2 * K
    tiles = -(-H // tile_y)
    strips = -(-W // TX)

    def inside(lo, extent, size):
        return max(0, min(size, lo + extent) - max(0, lo))

    rows = sum(inside(t * tile_y - K, WY, H) for t in range(tiles))
    cols = sum(inside(c * TX - KA, TX + 2 * KA, W) for c in range(strips))
    cells = (TX // 4) * (TYp // R) * 4 * R
    for s in range(1, k):
        E = -(-((k - s) * b) // 4) * 4
        cells += ((TX + 2 * E) // 4) * (-(-(TYp + 2 * (k - s) * b) // R)) \
            * 4 * R
    per_launch = Cost((rows * cols + H * W) * dtype_bytes,
                      cells * tiles * strips * flops_per_point(order))
    return Cost(per_launch.nbytes * launches, per_launch.flops * launches)


def _heat_program(rung: str, u: torch.Tensor, iters: int, order: int, xcfl,
                  ycfl, bc, k: int, tile_y: int | None, cost=None):
    """The cached program (``core/programs.get``) of one heat rung for
    grids shaped, typed and placed like ``u``: ``runner(v, n=iters)``
    solves ``n`` steps of ``v``.

    ``pipeline`` and ``pipeline2d`` are ``run_heat_pipeline`` and
    ``run_heat_pipeline2d`` (at its default width); on a CUDA grid their build
    loads ``heat_stencil``'s library and fixes the launch plan, and the
    runner carries ``staged_cost`` for the attribution check.  ``xla`` is
    the torch ``run_heat`` (no tile).  The warm-up is one k-step launch of
    ``u`` behind a ``check_op`` barrier named for the rung.
    """
    from ..core import check_op, programs
    from ..core.tune import dtype_name
    from .stencil import run_heat

    gy, gx = u.shape
    if rung == "xla":
        tile_y = None

    def build():
        if rung == "xla":
            def runner(v, n=iters):
                return run_heat(v, n, order, xcfl, ycfl)
            return runner
        if rung == "pipeline":
            def entry(v, n, ty):
                return run_heat_pipeline(v, n, order, xcfl, ycfl, bc, k=k,
                                         tile_y=ty)
        else:
            def entry(v, n, ty):
                return run_heat_pipeline2d(v, n, order, xcfl, ycfl, bc, k=k,
                                           tile_y=ty)
        ty = tile_y or pick_pipeline_tile(gy, k, order,
                                          dtype_bytes=u.element_size())
        if u.is_cuda:
            _kernels.library("heat_stencil")
            ty = launch_plan(u.contiguous(), 1, k, order, ty).tile_y

        def runner(v, n=iters):
            return entry(v, n, ty)
        runner.staged_cost = lambda v: staged_cost(
            gy, gx, k, order, ty, v.element_size(), launches=iters // k)
        return runner

    def warm(fn):
        check_op(f"heat.{rung}", fn(u, k))

    return programs.get(
        "heat", rung, f"{gy}x{gx}/order{order}/k{k}", build,
        dtype=dtype_name(u.dtype), device=u.device, warm=warm, cost=cost,
        probe=lambda: (u,), iters=iters, xcfl=xcfl, ycfl=ycfl,
        bc=tuple(bc), k=k, tile_y=tile_y)


#: canonical conformance-probe state: distinct Dirichlet values on all
#: four sides (the JAX package's probe)
_PROBE_BC = (1.5, 0.5, 2.0, 0.25)


def _conformance_probe_grid(order: int, dtype=torch.float32, device=None):
    """(params, u0): the small canonical probe, 40×44 with a gradient
    interior and distinct Dirichlet values on all four sides, on
    ``device`` (default ``cuda``)."""
    import numpy as np

    from ..config import SimParams
    from ..core.platform import resolve_device
    from ..grid import make_initial_grid

    p = SimParams(nx=44, ny=40, order=order, iters=1, bc_top=_PROBE_BC[0],
                  bc_left=_PROBE_BC[1], bc_bottom=_PROBE_BC[2],
                  bc_right=_PROBE_BC[3])
    u0 = make_initial_grid(p, dtype=torch.float32, device="cpu")
    b = BORDER_FOR_ORDER[order]
    u0[b:-b, b:-b] += torch.from_numpy(np.linspace(
        0, 1, p.ny * p.nx, dtype=np.float32).reshape(p.ny, p.nx))
    return p, u0.to(device=resolve_device(device), dtype=dtype)


def _heat_conformance_gate(order: int, k: int, dtype=torch.float32,
                           device=None):
    """``gate(rung) -> bool`` for the heat ladder: the first use of a
    kernel rung (per process × order × k × dtype × device) runs the
    canonical probe (``4k`` steps) through that rung and through the
    ``xla`` rung, the torch ``run_heat``, and compares them bit for bit:
    the kernel equals its plain version and ``run_heat`` at 0 ULP, so
    anything else is a wrong answer.  Both probes run through the program
    cache, so gating a rung also builds and warms its probe program."""
    from ..core import conformance
    from ..core.platform import build_identity, resolve_device
    from ..core.tune import dtype_name

    dev = resolve_device(device)

    def gate(rung: str) -> bool:
        if rung == "xla":
            return True  # the reference rung needs no probe
        probe = {}  # the probe grid, built only on a verdict miss

        def run(r):
            def thunk():
                if not probe:
                    probe["p"], probe["u0"] = _conformance_probe_grid(
                        order, dtype, dev)
                p, u0 = probe["p"], probe["u0"]
                ty = pick_pipeline_tile(u0.shape[0], k, order, target=64,
                                        dtype_bytes=u0.element_size())
                return _heat_program(r, u0, 4 * k, order, p.xcfl, p.ycfl,
                                     p.bc, k, ty)(u0)
            return thunk

        return conformance.check(
            "heat", rung,
            shape_class=(f"order{order}/k{k}/{dtype_name(dtype)}/"
                         f"{build_identity(dev)}"),
            candidate=run(rung), reference=run("xla")).ok

    return gate


def run_heat_resilient(u: torch.Tensor, iters: int, order: int, xcfl, ycfl,
                       bc: tuple[float, float, float, float], k: int = 1,
                       tile_y: int | None = None, timer=None,
                       phase_label: str = "gpu computation shared",
                       conformance: bool = True,
                       plain_fallback: bool = False):
    """The heat stencil behind the kernel fallback ladder: ``pipeline``
    (``run_heat_pipeline``, B1) → ``pipeline2d`` (``run_heat_pipeline2d``,
    B2) → ``xla`` (the torch ``run_heat``).

    On a CUDA grid the ladder ends at its kernel rungs: ``xla`` is a rung
    only on the CPU, where every rung is a plain version, or when the
    caller asks for it with ``plain_fallback``.  A ladder whose rungs are
    all refused raises (``FrameworkError``), so a CUDA grid is never served
    by the plain version unasked.

    With ``conformance`` (default), each kernel rung's first use per
    process × (order, k, dtype, device and kernel build) runs a small probe
    against ``run_heat`` bit for bit (``_heat_conformance_gate``) and a
    diverging rung is demoted with ``WRONG_ANSWER`` before it serves.
    Injected faults demote too (``fail:heat.pipeline``, ``stage:``,
    ``wrong:heat``), as does an open breaker.  A rung whose kernel cannot
    build or launch raises (``KernelError``, a tile whose windows do not
    fit shared memory included).

    A ``tile_y`` the caller leaves open resolves through
    ``core/tune.resolve`` (keyed by ``"{gy}x{gx}/order{order}/k{k}"``);
    with no cached winner or ``CME213_TUNE=0`` it is
    ``pick_pipeline_tile``'s.  Both kernel rungs run the k class's one
    design (``design``), so the width is no knob.  A kernel rung that dies
    RESOURCE halves its ``tile_y``, down to the design's micro-tile rows,
    before it demotes, each halving a ``chunk-shrunk`` event; the
    allocator's out-of-memory is not halved, since the grid's buffers are
    the same at every tile.  Before any of it, the solve's buffers (the
    grid and two ping-pong grids) are held to ``core/admission.
    memory_budget`` and a grid over it raises ``AdmissionError``.

    ``pipeline2d`` is in the ladder when its smallest tile fits a block's
    shared memory (``smem_bytes`` at one micro-tile of rows against
    ``SMEM_BUDGET_BYTES``), the port's own limit; the JAX package's
    ``k·border ≤ 128`` is a Pallas layout limit that does not apply here.

    The whole solve is a ``heat.solve`` host range on the profiler's clock
    (``core/trace.host_range``), holding its ``admission.admit`` range and
    its ``heat.run`` spans.  Every attempt fetches its program through
    ``core/programs.get`` (a miss builds it and makes one warm-up launch;
    a hit does neither) and runs under a ``heat.run`` span carrying
    ``heat_cost``, timed as ``phase_label`` on ``timer``.
    Returns a ``FallbackResult``: ``.value`` the grid (``u`` is not
    modified), ``.rung`` the rung that served.
    """
    from ..core import PhaseTimer, admission, metrics, span, with_fallback
    from ..core.faults import maybe_oom
    from ..core.resilience import (FailureKind, allows_plain_rungs,
                                   classify_failure)
    from ..core.roofline import heat_cost
    from ..core.trace import record_event

    _check_grid(u)
    if iters % k != 0:
        raise ValueError(f"iters={iters} must divide by k={k}")
    gy, gx = u.shape
    shape_class = f"{gy}x{gx}/order{order}/k{k}"
    with host_range("heat.solve"):
        elem = u.element_size()
        admission.admit("heat", 3 * u.numel() * elem, u.device)
        if tile_y is None:
            from ..core import tune

            tile_y = tune.resolve("heat", shape_class,
                                  tune.dtype_name(u.dtype), device=u.device,
                                  tile_y=None)["tile_y"]
        quantum = design(k, elem).rows
        ty = tile_y or pick_pipeline_tile(gy, k, order, dtype_bytes=elem)
        timer = timer or PhaseTimer()
        cost = heat_cost(gy, gx, order=order, iters=iters, dtype=u.dtype)

        def timed(rung, shrinkable=True):
            def attempt(ty_cur):
                maybe_oom(f"heat.{rung}")
                runner = _heat_program(rung, u, iters, order, xcfl, ycfl,
                                       bc, k, ty_cur, cost)
                with span("heat.run", kernel=rung, size=gy, iters=iters,
                          shape_class=shape_class) as sp:
                    sp.roofline(cost.nbytes, cost.flops)
                    with timer.phase(phase_label) as ph:
                        out = runner(u)
                        ph.block(out)
                return out

            def thunk():
                ty_cur = ty
                while True:
                    try:
                        return attempt(ty_cur)
                    except Exception as e:  # noqa: BLE001 — classified below
                        if (not shrinkable or ty_cur <= quantum
                                or isinstance(e, torch.cuda.OutOfMemoryError)
                                or classify_failure(e)
                                is not FailureKind.RESOURCE):
                            raise
                        ty_new = max(quantum, -(-(ty_cur // 2) // quantum)
                                     * quantum)
                        if ty_new >= ty_cur:
                            raise
                        metrics.counter("admission.chunk_shrunk").inc()
                        record_event("chunk-shrunk", op=f"heat.{rung}",
                                     from_size=ty_cur, to_size=ty_new,
                                     reason=type(e).__name__)
                        ty_cur = ty_new
            return thunk

        ladder = [("pipeline", timed("pipeline"))]
        if smem_bytes(quantum, k, order, elem) <= SMEM_BUDGET_BYTES:
            ladder.append(("pipeline2d", timed("pipeline2d")))
        if allows_plain_rungs(u.device, plain_fallback):
            ladder.append(("xla", timed("xla", shrinkable=False)))
        gate = (_heat_conformance_gate(order, k, u.dtype, u.device)
                if conformance else None)
        return with_fallback("heat", ladder, gate=gate)
