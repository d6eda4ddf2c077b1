"""Band-staged heat stencil: the hand-written Hopper kernel's wrappers.

Counterpart of ``cme213_tpu/ops/stencil_pallas.py``.  There each Pallas grid
step DMAs a ``(tile_y + halo, gx)`` row band from HBM into VMEM, double
buffered by hand (``_stage_band``), and computes a full-width output tile:
one step per call (``stencil_interior_pallas``, ``run_heat_pallas``) or
``k`` fused steps per call with the Dirichlet bands re-imposed after each
(``run_heat_multistep``).  Here both are one launch of
``csrc/heat_band.cu``: a block walks a run of (tile_y, TX) output tiles down
one strip of TX columns, stages each tile's window with ``cp.async`` and
computes it with register-blocked micro-tiles (the tile body of
``csrc/heat_tile.cuh``).  ``tile_y`` stays the caller's knob; the strip
width, the threads and the micro-tile height are compiled per dtype and k
class (``DESIGNS``), and ``band_geometry`` derives the staging buffers and
the tiles a block walks for a shape.  ``launch_plan`` computes that once a
shape, with the blocks an SM from the occupancy calculator, and keeps it.

The TPU's 128-lane padding (``_pad_lanes``) is a Mosaic layout rule and is
dropped.  The kernel writes interior cells only: ``run_heat_pallas`` keeps
the input's halo as it is (it imposes no boundary values, as the JAX
kernel does not), ``run_heat_multistep`` holds the halo at the Dirichlet
values ``bc``.

Dispatch is on the tensor's device: a CPU tensor takes the plain version
(``stencil_interior_pallas_plain``, ``run_heat_pallas_plain``,
``run_heat_multistep_plain``); a CUDA tensor launches the kernel, and a
failed build or launch raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import _kernels
from .stencil import BORDER_FOR_ORDER, run_heat, run_heat_roll, \
    stencil_interior
from .stencil_pipeline import SMEM_BUDGET_BYTES

#: kernel launches: one-step calls (B4) and k-step calls (B5)
LAUNCHES = {"stencil_full": 0, "multistep": 0}

#: shared memory of one Hopper SM (228 KB), of which each resident block
#: also reserves 1 KB; threads of one SM
SMEM_PER_SM_BYTES = 233_472
SMEM_PER_BLOCK_RESERVED = 1024
THREADS_PER_SM = 2048

#: stand-in SM count of the plain path's geometry (an H100 SXM has 132)
DEFAULT_SMS = 132


@dataclass(frozen=True)
class Design:
    """One k class's compiled geometry (``csrc/heat_band.cu`` Menu):
    strips of ``tile_x`` columns, ``threads`` a block, micro-tiles of 4
    columns × ``rows`` rows a thread, and the blocks an SM its register
    budget is sized for (``min_blocks``, the kernel's
    ``__launch_bounds__``); and the plan's staging policy: ``prefetch``,
    two windows and runs of tiles where they fit, else one window and one
    tile a block."""

    tile_x: int
    threads: int
    rows: int
    min_blocks: int
    prefetch: bool


#: (dtype bytes, k class) -> design; the class of k is min(k, 3).  Timed
#: on the H100 (``bench/band_menu.py``, PERF.md §5): at k = 1 prefetching
#: beat two blocks an SM of one window; at k ≥ 2 one tile a block beat
#: every run length, with or without the prefetch
DESIGNS = {
    (4, 1): Design(96, 256, 8, 2, True),
    (4, 2): Design(48, 256, 4, 2, False),
    (4, 3): Design(32, 256, 4, 2, False),
    (8, 1): Design(64, 128, 4, 2, True),
    (8, 2): Design(32, 128, 4, 2, False),
    (8, 3): Design(32, 128, 4, 1, False),
}


def design(k: int, dtype_bytes: int = 4) -> Design:
    """The design ``heat_band`` runs at ``k`` for ``dtype_bytes`` values."""
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    return DESIGNS[(dtype_bytes, min(k, 3))]


stencil_interior_pallas_plain = stencil_interior
run_heat_pallas_plain = run_heat


def run_heat_multistep_plain(u: torch.Tensor, iters: int, order: int, xcfl,
                             ycfl, bc: tuple[float, float, float, float],
                             k: int = 4) -> torch.Tensor:
    """The k-step kernel's plain PyTorch version: ``run_heat_roll``, whose
    bands are re-imposed after every step; the result does not depend on
    ``k``."""
    return run_heat_roll(u, iters, order, xcfl, ycfl, bc, k=k)


def pick_tile(ny: int, target: int = 256) -> int:
    """Largest divisor of ny not exceeding ``target``.

    Prefers multiples of 8 (the JAX package's rule, kept so that both
    packages sweep the same tiles), falling back to any divisor only when
    ny has no 8-aligned one.
    """
    t = min(target, ny)
    t -= t % 8
    while t >= 8 and ny % t:
        t -= 8
    if t >= 8:
        return t
    t = min(target, ny)
    while ny % t:
        t -= 1
    return t


def band_smem_bytes(tile_y: int, k: int, order: int, nbuf: int,
                    dtype_bytes: int = 4) -> int:
    """Shared memory of one block: ``nbuf`` staging windows and, when k >
    1, one scratch window for the sub-steps' ping-pong.  A window holds the
    tile rows rounded up to whole micro-tiles, K = k·border halo rows above
    and below (plus one micro-tile of slack rows when 2·border is not a
    whole number of them), and the strip with ceil4(K) halo columns on each
    side.  The launch is given this size; the C entry checks it."""
    d = design(k, dtype_bytes)
    b = BORDER_FOR_ORDER[order]
    K = k * b
    ka = -(-K // 4) * 4
    rows = -(-tile_y // d.rows) * d.rows + 2 * K
    rows += 0 if (2 * b) % d.rows == 0 else d.rows
    windows = nbuf + (1 if k > 1 else 0)
    return windows * rows * (d.tile_x + 2 * ka) * dtype_bytes


def estimated_blocks_per_sm(smem: int, d: Design) -> int:
    """Blocks an SM at ``smem`` bytes a block by the shared memory, the
    threads and the design's register budget (``min_blocks``); the card's
    occupancy calculator may allow more by the registers."""
    return max(0, min(SMEM_PER_SM_BYTES // (smem + SMEM_PER_BLOCK_RESERVED),
                      THREADS_PER_SM // d.threads, d.min_blocks))


def balanced_run(strips: int, ntiles: int, slots: int) -> int:
    """The tiles a block walks: the longest run (the most tiles each
    prefetch can overlap) whose makespan is within 10% of the shortest.
    The makespan of runs of r tiles is the tiles the busiest of ``slots``
    resident blocks walks, ceil(strips · ceil(ntiles / r) / slots) · r."""
    def makespan(r):
        return -(-strips * -(-ntiles // r) // slots) * r

    best = min(makespan(r) for r in range(1, ntiles + 1))
    return max(r for r in range(1, ntiles + 1)
               if makespan(r) <= 1.1 * best)


@dataclass(frozen=True)
class BandGeometry:
    """One launch's decomposition: strips of ``tile_x`` columns (from grid
    column 0), tiles of ``tile_y`` interior rows, ``run`` consecutive tiles
    a block of ``threads``, micro-tiles of ``rows`` rows, ``nbuf`` staging
    buffers (2: the next tile's window is prefetched), ``smem`` bytes a
    block, ``grid`` = (strips, blocks per strip), ``blocks_per_sm`` the
    occupancy the split was made for."""

    tile_y: int
    tile_x: int
    threads: int
    rows: int
    nbuf: int
    run: int
    smem: int
    grid: tuple[int, int]
    blocks_per_sm: int


def band_geometry(ny: int, nx: int, tile_y: int, k: int, order: int,
                  dtype_bytes: int = 4, sms: int = DEFAULT_SMS,
                  occupancy: Callable[[int], int] | None = None,
                  nbuf: int | None = None) -> BandGeometry:
    """The kernel's decomposition of an (ny, nx) interior at ``tile_y``.

    The strip width, threads and micro-tile height are the k class's
    design.  Where the design prefetches and two staging buffers fit in a
    block's shared memory, the block takes two (the next tile's window
    prefetched) and walks ``balanced_run`` tiles; otherwise it stages one
    window and takes one tile.  ``occupancy(smem)`` gives the blocks an SM
    at ``smem`` bytes a block (default ``estimated_blocks_per_sm``; the
    launch plan asks the card).  Strips cover grid columns [0, border +
    nx).  ``nbuf``, when given, is taken instead of the choice.  Raises
    ``ValueError`` when the windows do not fit.
    """
    d = design(k, dtype_bytes)
    if occupancy is None:
        def occupancy(smem):
            return estimated_blocks_per_sm(smem, d)
    fits = {}
    for n in (1, 2) if nbuf is None else (nbuf,):
        smem = band_smem_bytes(tile_y, k, order, n, dtype_bytes)
        if smem <= SMEM_BUDGET_BYTES:
            fits[n] = (smem, occupancy(smem))
    if not fits:
        n = nbuf or 1
        need = band_smem_bytes(tile_y, k, order, n, dtype_bytes)
        raise ValueError(
            f"tile_y={tile_y} at k={k}, order {order}: {n} {d.tile_x}-"
            f"column staging window(s) need {need} B of shared memory; a "
            f"block has {SMEM_BUDGET_BYTES}")
    if nbuf is None:
        nbuf = 2 if d.prefetch and 2 in fits else min(fits)
    smem, per_sm = fits[nbuf]
    per_sm = max(1, per_sm)
    b = BORDER_FOR_ORDER[order]
    strips = -(-(b + nx) // d.tile_x)
    ntiles = -(-ny // tile_y)
    run = balanced_run(strips, ntiles, sms * per_sm) if nbuf == 2 else 1
    return BandGeometry(tile_y, d.tile_x, d.threads, d.rows, nbuf, run, smem,
                        (strips, -(-ntiles // run)), per_sm)


_PLANS: dict[tuple, BandGeometry] = {}


def launch_plan(src: torch.Tensor, k: int, order: int,
                tile_y: int) -> BandGeometry:
    """``band_geometry`` for the CUDA halo grid ``src``, computed once per
    (device, dtype, order, k, shape, tile_y) and kept: the blocks an SM come
    from the occupancy calculator (``_kernels.heat_band_occupancy``), the
    SM count from the device."""
    key = (src.device, src.dtype, order, k, *src.shape, tile_y)
    plan = _PLANS.get(key)
    if plan is None:
        b = BORDER_FOR_ORDER[order]
        gy, gx = src.shape
        elem = src.element_size()
        sms = torch.cuda.get_device_properties(
            src.device).multi_processor_count

        def occupancy(smem):
            return _kernels.heat_band_occupancy(src.device, elem, order, k,
                                                smem)[0]

        plan = band_geometry(gy - 2 * b, gx - 2 * b, tile_y, k, order, elem,
                             sms, occupancy)
        _PLANS[key] = plan
    return plan


def _bind(pairs, order: int, k: int, plan: BandGeometry, xcfl, ycfl, bc):
    """One checked launcher of ``csrc/heat_band.cu`` per (src, dst) pair."""
    return _kernels.heat_band_launchers(
        pairs, order=order, k=k, tile_y=plan.tile_y, run=plan.run,
        nbuf=plan.nbuf, smem_bytes=plan.smem, xcfl=xcfl, ycfl=ycfl, bc=bc)


def _check_grid(u: torch.Tensor, order: int, tile_y: int) -> None:
    """Raise where the JAX package asserts, and on what no kernel takes."""
    if u.dim() != 2 or u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected a 2-D float32/float64 grid, got "
                        f"{u.dim()}-D {u.dtype}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {u.device}")
    b = BORDER_FOR_ORDER[order]
    ny = u.shape[0] - 2 * b
    if tile_y < 1 or ny % tile_y:
        raise ValueError(f"ny={ny} must divide by tile_y={tile_y}")


def stencil_interior_pallas(u: torch.Tensor, order: int, xcfl, ycfl,
                            tile_y: int = 256) -> torch.Tensor:
    """New interior (ny, nx) from halo grid (gy, gx): one launch (B4),
    every argument checked.  ``ny`` must divide by ``tile_y`` (see
    ``pick_tile``)."""
    _check_grid(u, order, tile_y)
    if u.device.type == "cpu":
        return stencil_interior_pallas_plain(u, order, xcfl, ycfl)
    b = BORDER_FOR_ORDER[order]
    src = u.contiguous()
    out = torch.empty(src.shape[0] - 2 * b, src.shape[1] - 2 * b,
                      dtype=src.dtype, device=src.device)
    plan = launch_plan(src, 1, order, tile_y)
    _bind([(src, out)], order, 1, plan, xcfl, ycfl, (0.0, 0.0, 0.0, 0.0))[0]()
    LAUNCHES["stencil_full"] += 1
    return out


def _ping_pong(u: torch.Tensor, name: str, iters: int, order: int, k: int,
               tile_y: int, xcfl, ycfl, bc, halo) -> torch.Tensor:
    """``iters / k`` launches between two grids whose halo ``halo(grid)``
    sets once; returns the last grid written (a new tensor).  The plan,
    the interior views and the launchers (checked once) are made before the
    first launch."""
    b = BORDER_FOR_ORDER[order]
    src = u.contiguous()
    n = iters // k
    if n == 0:
        return src.clone()
    plan = launch_plan(src, k, order, tile_y)
    bufs = [torch.empty_like(src), torch.empty_like(src)]
    for buf in bufs:
        halo(buf)
    inner = [buf[b:-b, b:-b] for buf in bufs]
    first, even, odd = _bind([(src, inner[0]), (bufs[1], inner[0]),
                              (bufs[0], inner[1])],
                             order, k, plan, xcfl, ycfl, bc)
    first()
    LAUNCHES[name] += 1
    for i in range(1, n):
        (odd if i % 2 else even)()
        LAUNCHES[name] += 1
    return bufs[(n - 1) % 2]


def run_heat_pallas(u: torch.Tensor, iters: int, order: int, xcfl, ycfl,
                    tile_y: int = 256) -> torch.Tensor:
    """``iters`` timesteps, one launch each (B4).  The halo of ``u`` passes
    through unchanged; no boundary value is imposed.  ``ny`` must divide by
    ``tile_y``.  Returns a new grid; ``u`` is not modified."""
    _check_grid(u, order, tile_y)
    if u.device.type == "cpu":
        return run_heat_pallas_plain(u, iters, order, xcfl, ycfl)
    b = BORDER_FOR_ORDER[order]

    def copy_halo(g):
        g[:b] = u[:b]
        g[-b:] = u[-b:]
        g[:, :b] = u[:, :b]
        g[:, -b:] = u[:, -b:]

    return _ping_pong(u, "stencil_full", iters, order, 1, tile_y, xcfl, ycfl,
                      (0.0, 0.0, 0.0, 0.0), copy_halo)


def run_heat_multistep(u: torch.Tensor, iters: int, order: int, xcfl, ycfl,
                       bc: tuple[float, float, float, float], k: int = 4,
                       tile_y: int = 128) -> torch.Tensor:
    """Iterated solve with ``k`` timesteps fused per launch (B5).

    ``u`` is the (gy, gx) halo grid; ``bc`` = (top, left, bottom, right)
    Dirichlet values (as in ``SimParams.bc``), re-imposed after every step:
    the result's halo holds them.  ``iters`` must divide by ``k`` and ``ny``
    by ``tile_y``.  Returns a new grid; ``u`` is not modified.
    """
    if iters % k != 0:
        raise ValueError(f"iters={iters} must divide by k={k}")
    _check_grid(u, order, tile_y)
    if u.device.type == "cpu":
        return run_heat_multistep_plain(u, iters, order, xcfl, ycfl, bc, k=k)
    b = BORDER_FOR_ORDER[order]
    bc_top, bc_left, bc_bottom, bc_right = bc

    def fill_bands(g):  # rows, then columns over the corners
        g[:b] = bc_bottom
        g[-b:] = bc_top
        g[:, :b] = bc_left
        g[:, -b:] = bc_right

    return _ping_pong(u, "multistep", iters, order, k, tile_y, xcfl, ycfl,
                      bc, fill_bands)
