"""Band-staged heat stencil: the hand-written Hopper kernel's wrappers.

Counterpart of ``cme213_tpu/ops/stencil_pallas.py``.  There each Pallas grid
step DMAs a ``(tile_y + halo, gx)`` row band from HBM into VMEM, double
buffered by hand (``_stage_band``), and computes a full-width output tile:
one step per call (``stencil_interior_pallas``, ``run_heat_pallas``) or
``k`` fused steps per call with the Dirichlet bands re-imposed after each
(``run_heat_multistep``).  Here both are one launch of
``csrc/heat_band.cu``: a block walks a run of (tile_y, TX) output tiles down
one strip of TX columns and stages each tile's window with ``cp.async``
while the previous one is computed.  ``tile_y`` stays the caller's knob;
``band_geometry`` derives TX, the number of staging buffers and the tiles a
block walks from it and a block's 227 KB of shared memory.

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

import torch

from . import _kernels
from .stencil import BORDER_FOR_ORDER, run_heat, run_heat_roll, \
    stencil_interior
from .stencil_pipeline import SMEM_BUDGET_BYTES

#: kernel launches: one-step calls (B4) and k-step calls (B5)
LAUNCHES = {"stencil_full": 0, "multistep": 0}

#: shared memory of one Hopper SM (228 KB), of which each resident block
#: also reserves 1 KB; threads of one SM, and of one block of the kernel
SMEM_PER_SM_BYTES = 233_472
SMEM_PER_BLOCK_RESERVED = 1024
THREADS_PER_SM = 2048
BAND_THREADS = 512

#: strip widths: multiples of a warp, at most this many columns
TX_STEP = 32
TX_MAX = 128

#: stand-in SM count of the plain path's geometry (an H100 SXM has 132)
DEFAULT_SMS = 132


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


def band_smem_bytes(tile_y: int, tile_x: int, k: int, order: int, nbuf: int,
                    dtype_bytes: int = 4) -> int:
    """Shared memory of one block: ``nbuf`` staged (tile_y+2K) ×
    (tile_x+2K) windows, and one scratch window for the sub-steps' ping-pong
    when k > 1."""
    K = k * BORDER_FOR_ORDER[order]
    windows = nbuf + (1 if k > 1 else 0)
    return windows * (tile_y + 2 * K) * (tile_x + 2 * K) * dtype_bytes


@dataclass(frozen=True)
class BandGeometry:
    """One launch's decomposition: strips of ``tile_x`` columns, tiles of
    ``tile_y`` rows, ``run`` consecutive tiles a block, ``nbuf`` staging
    buffers (2: the next tile's window is prefetched), ``smem`` bytes a
    block, ``grid`` = (strips, blocks per strip)."""

    tile_y: int
    tile_x: int
    nbuf: int
    run: int
    smem: int
    grid: tuple[int, int]
    blocks_per_sm: int


def band_geometry(ny: int, nx: int, tile_y: int, k: int, order: int,
                  dtype_bytes: int = 4, sms: int = DEFAULT_SMS
                  ) -> BandGeometry:
    """The kernel's decomposition of an (ny, nx) interior at ``tile_y``.

    TX is the widest multiple of ``TX_STEP`` columns, at most ``TX_MAX`` and
    no wider than the interior needs, whose buffers fit in a block's shared
    memory with the prefetch buffer; when not even ``TX_STEP`` columns fit
    so, the block stages one window at a time (``nbuf`` = 1).  Each strip's
    tiles are then split into runs so that the blocks fill about one wave
    of the ``sms`` SMs at the blocks that fit on one SM.  Raises
    ``ValueError`` when no strip fits.
    """
    widest = min(TX_MAX, -(-nx // TX_STEP) * TX_STEP)
    for nbuf in (2, 1):
        tx = widest
        while tx >= TX_STEP and band_smem_bytes(
                tile_y, tx, k, order, nbuf, dtype_bytes) > SMEM_BUDGET_BYTES:
            tx -= TX_STEP
        if tx >= TX_STEP:
            break
    else:
        need = band_smem_bytes(tile_y, TX_STEP, k, order, 1, dtype_bytes)
        raise ValueError(
            f"tile_y={tile_y} at k={k}, order {order}: even a {TX_STEP}-"
            f"column strip needs {need} B of shared memory; a block has "
            f"{SMEM_BUDGET_BYTES}")
    smem = band_smem_bytes(tile_y, tx, k, order, nbuf, dtype_bytes)
    per_sm = max(1, min(THREADS_PER_SM // BAND_THREADS,
                        SMEM_PER_SM_BYTES // (smem + SMEM_PER_BLOCK_RESERVED)))
    strips = -(-nx // tx)
    ntiles = -(-ny // tile_y)
    splits = max(1, min(ntiles, sms * per_sm // strips))
    run = -(-ntiles // splits)
    return BandGeometry(tile_y, tx, nbuf, run, smem,
                        (strips, -(-ntiles // run)), per_sm)


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


def _geometry(src: torch.Tensor, order: int, k: int,
              tile_y: int) -> BandGeometry:
    b = BORDER_FOR_ORDER[order]
    gy, gx = src.shape
    sms = torch.cuda.get_device_properties(src.device).multi_processor_count
    return band_geometry(gy - 2 * b, gx - 2 * b, tile_y, k, order,
                         src.element_size(), sms)


def _launch(name: str, src: torch.Tensor, dst: torch.Tensor, order: int,
            k: int, geo: BandGeometry, xcfl, ycfl, bc) -> None:
    _kernels.heat_band(src, dst, order=order, k=k, tile_y=geo.tile_y,
                       tile_x=geo.tile_x, run=geo.run, nbuf=geo.nbuf,
                       smem_bytes=geo.smem, xcfl=xcfl, ycfl=ycfl, bc=bc)
    LAUNCHES[name] += 1


def stencil_interior_pallas(u: torch.Tensor, order: int, xcfl, ycfl,
                            tile_y: int = 256) -> torch.Tensor:
    """New interior (ny, nx) from halo grid (gy, gx): one launch (B4).
    ``ny`` must divide by ``tile_y`` (see ``pick_tile``)."""
    _check_grid(u, order, tile_y)
    if u.device.type == "cpu":
        return stencil_interior_pallas_plain(u, order, xcfl, ycfl)
    b = BORDER_FOR_ORDER[order]
    src = u.contiguous()
    out = torch.empty(src.shape[0] - 2 * b, src.shape[1] - 2 * b,
                      dtype=src.dtype, device=src.device)
    _launch("stencil_full", src, out, order, 1,
            _geometry(src, order, 1, tile_y), xcfl, ycfl,
            (0.0, 0.0, 0.0, 0.0))
    return out


def _ping_pong(u: torch.Tensor, name: str, iters: int, order: int, k: int,
               tile_y: int, xcfl, ycfl, bc, halo) -> torch.Tensor:
    """``iters / k`` launches between two grids whose halo ``halo(grid)``
    sets once; returns the last grid written (a new tensor)."""
    b = BORDER_FOR_ORDER[order]
    src = u.contiguous()
    if iters == 0:
        return src.clone()
    geo = _geometry(src, order, k, tile_y)
    bufs = [torch.empty_like(src), torch.empty_like(src)]
    for buf in bufs:
        halo(buf)
    for i in range(iters // k):
        dst = bufs[i % 2]
        _launch(name, src, dst[b:-b, b:-b], order, k, geo, xcfl, ycfl, bc)
        src = dst
    return src


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
