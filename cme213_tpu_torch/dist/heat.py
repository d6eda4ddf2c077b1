"""Distributed 2-D heat solve — domain decomposition over a device mesh.

Counterpart of ``cme213_tpu/dist/heat.py``, which runs the reference's MPI
heat engine (``hw/hw5/programming/2dHeat.cpp``) as one ``shard_map``.  The
interior grid (ny, nx) is cut over a 1-D ("y" stripes, gridMethod=1) or 2-D
("y", "x" blocks, gridMethod=2) mesh (``mesh.py``).  A process holds one
tensor per shard it owns, ``blocks[yi][xi]`` on the mesh's device ``(yi,
xi)``; a shard another rank of the gang owns is ``None`` there
(``Mesh.owners``).  The shard's place in that list stands in for
``lax.axis_index``.  Each step exchanges ``border``-wide halos
(``halo.py``: copies within the process, card to card between the cards
of a mesh; the gang's group across ranks, NCCL card to card or gloo
through the host) and applies the order-2/4/8 stencil to every block the process
holds.

Step variants, as in the JAX package:

- **sync** (``2dHeat.cpp:583-694``): exchange → padded block → stencil over
  the whole block.
- **overlap** (``:696-815``): the inner region, which needs no halo, is
  computed from the raw block on each device's current stream while the
  exchange runs on a side stream; the four halo-adjacent bands wait for the
  exchange through the streams.  On the CPU the same code runs in order.
- **k steps per exchange** (communication-avoiding): one K = k·border halo
  exchange, then k local steps with the Dirichlet bands re-imposed on
  global coordinates; ``local_kernel="pallas"`` runs those k steps of every
  shard a device holds as one launch of the hand-written kernel (B3,
  ``ops/stencil_pipeline.stencil_local_multistep_shards``).  There the
  K-padded blocks live in place: each shard has two padded buffers for a
  solve (``_padded``), the halos are written into the ring of one and B3
  writes the other (``_assemble_in_place``).

Every variant computes each cell with the same expression as
``ops.run_heat``, each operation rounded on its own, so every mesh, scheme,
k, local kernel and gang gives the single-device result bit for bit.
``run_distributed_heat`` returns the whole grid on every rank: each rank
builds its own initial blocks on their devices, and the final grid is
assembled on the card and copied to the host once, into page-locked
memory.  Its host ranges and span (``core/trace``; one each a solve):
``dist.solve`` around the whole of it, holding ``dist.prepare`` (the
initial blocks), ``dist.steps`` (the timed bracket, tagged ``kernel``,
``block`` and ``iters``; it holds ``dist.enqueue``, the step loop up to
the closing synchronise), ``dist.gather`` and ``dist.download``.
``run_distributed_heat_supervised`` runs the sync path in epochs, each
ending in an epoch commit (``ckpt.py``) and a heartbeat
(``supervisor.py``), and resumes from a commit on any mesh.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..config import SimParams
from ..core.platform import to_host
from ..core.trace import host_range, span
from ..grid import interior, make_initial_grid
from ..ops.stencil import stencil_interior
from ..ops.stencil_pipeline import (stencil_local_multistep_plain,
                                    stencil_local_multistep_shards)
from .halo import (PADS, exchange_halo_lines, gather_shards,
                   pad_lines_with_halos, settle_clock)
from .mesh import Mesh
from .multihost import barrier

#: one tensor per shard, ``blocks[yi][xi]``, ``None`` for a shard another
#: rank owns; a 1-D mesh has one column
Blocks = list[list[torch.Tensor | None]]


def _pad_axis(blocks: Blocks, dim: int, border: int, lo_fill, hi_fill,
              owners=None) -> Blocks:
    """Every line of shards along mesh axis ``dim`` (0: y, 1: x) extended
    by its halos along tensor dim ``dim`` — the JAX package's
    ``_pad_axis0``, which transposes for x.  ``owners`` (the mesh's, shaped
    like ``blocks``) names the ranks of absent shards; all lines exchange
    at once (``halo.pad_lines_with_halos``)."""
    y_size, x_size = len(blocks), len(blocks[0])
    if owners is None:
        owners = np.zeros((y_size, x_size), dtype=np.int64)
    if dim == 1:
        return pad_lines_with_halos(blocks, border, lo_fill, hi_fill, dim=1,
                                    owners=list(owners))
    cols = pad_lines_with_halos(
        [[row[xi] for row in blocks] for xi in range(x_size)], border,
        lo_fill, hi_fill, dim=0, owners=[owners[:, xi] for xi in range(x_size)])
    return [[col[yi] for col in cols] for yi in range(y_size)]


def _assemble_padded(blocks: Blocks, params: SimParams,
                     border: int | None = None, owners=None) -> Blocks:
    """Each block + y halos + x halos (BC fill at physical boundaries).

    ``border`` defaults to the stencil border; the k-step path passes K =
    k·border.  The x slabs are cut from the y-padded blocks, so a corner
    halo holds the diagonal neighbour's data (the reference's full-column
    pack buffers, ``2dHeat.cpp:456-462``); from k = 2 on the k-step path
    reads it.  So the y exchange completes (across ranks: every message
    waited on) before an x slab is cut."""
    b = params.border_size if border is None else border
    PADS["cat"] += 1
    ypad = _pad_axis(blocks, 0, b, params.bc_bottom, params.bc_top, owners)
    return _pad_axis(ypad, 1, b, params.bc_left, params.bc_right, owners)


@dataclass(frozen=True)
class _Padded:
    """One K-padded (ny_loc + 2K, nx_loc + 2K) buffer for each shard this
    process holds, and every view of them an in-place step uses, made
    once with the buffers: ``inner``, their interiors ``[K:-K, K:-K]``
    (``None`` for another rank's shard), the blocks a step returns;
    ``own``, the buffers in mesh order, with ``offsets`` the
    global halo-grid coordinates of their element [0, 0] (B3's shard
    table); ``y`` and ``x``, each phase's ``exchange_halo_lines``
    arguments: the lines its slabs are cut from, their owners and the
    ring slabs its halos land in."""

    K: int
    inner: Blocks
    own: list
    offsets: list
    y: tuple
    x: tuple


def _padded(blocks: Blocks, K: int, border: int, owners=None) -> _Padded:
    """New padded buffers shaped for ``blocks`` (``_Padded``).  The y
    lines are the interiors, and the y halos land in rows ``[0, K)`` and
    ``[H - K, H)`` over columns ``[K, W - K)``; the x lines are the
    columns ``[K, W - K)`` over every row, so the x slabs hold the y
    halos and a corner the diagonal neighbour's cells, and the x halos
    land in columns ``[0, K)`` and ``[W - K, W)``."""
    y_size, x_size = len(blocks), len(blocks[0])
    if owners is None:
        owners = np.zeros((y_size, x_size), dtype=np.int64)
    ny_loc, nx_loc = _own(blocks)[0].shape
    bufs = _per_shard(lambda blk, yi, xi: blk.new_empty(
        (ny_loc + 2 * K, nx_loc + 2 * K)), blocks)

    def views(fn, lines):
        return [[None if p is None else fn(p) for p in line]
                for line in lines]

    cols = [[row[xi] for row in bufs] for xi in range(x_size)]
    return _Padded(
        K=K, inner=views(lambda p: p[K:-K, K:-K], bufs),
        own=_own(bufs),
        offsets=[(yi * ny_loc + border - K, xi * nx_loc + border - K)
                 for yi, row in enumerate(bufs)
                 for xi, p in enumerate(row) if p is not None],
        y=(views(lambda p: p[K:-K, K:-K], cols),
           [owners[:, xi] for xi in range(x_size)],
           views(lambda p: (p[:K, K:-K], p[-K:, K:-K]), cols)),
        x=(views(lambda p: p[:, K:-K], bufs), list(owners),
           views(lambda p: (p[:, :K], p[:, -K:]), bufs)))


def _padded_pair(blocks: Blocks, K: int, border: int,
                 owners=None) -> tuple[_Padded, _Padded]:
    """Two sets of padded buffers for ``blocks`` (``_padded``): an
    in-place step assembles in one and B3 writes the other."""
    return (_padded(blocks, K, border, owners),
            _padded(blocks, K, border, owners))


def _assemble_in_place(blocks: Blocks, pad: _Padded,
                       params: SimParams) -> None:
    """``_assemble_padded(blocks, params, pad.K)`` written into ``pad``'s
    buffers, bit for bit: each block is placed in its buffer's interior
    (unless it is that interior, as after an in-place step), then the
    ring is rewritten whole, the y halos first, then the x halos (the
    views ``_padded`` made).  Each halo is filled with its BC or copied
    straight into the ring (``halo.exchange_halo_lines``'s ``rings``):
    nothing is allocated or concatenated."""
    for blk, inner in zip(_own(blocks), _own(pad.inner)):
        if blk.data_ptr() != inner.data_ptr():
            inner.copy_(blk)
    lines, owners, rings = pad.y
    exchange_halo_lines(lines, pad.K, params.bc_bottom, params.bc_top, 0,
                        owners, rings)
    lines, owners, rings = pad.x
    exchange_halo_lines(lines, pad.K, params.bc_left, params.bc_right, 1,
                        owners, rings)
    PADS["in_place"] += 1


def _reimpose_ghost(new_block: torch.Tensor, params: SimParams, yi: int,
                    xi: int, y_size: int, x_size: int) -> torch.Tensor:
    """Reset ghost rows/columns (padding beyond the true ny×nx domain, for
    grids that do not divide over the mesh — the reference's remainder-on-
    last-rank layout, ``2dHeat.cpp:284-307``) to the top/right BC values.
    Held there each step, the first ``b`` ghost lines are the Dirichlet
    band of the true domain's edge."""
    ny_loc, nx_loc = new_block.shape
    dev = new_block.device
    if y_size * ny_loc != params.ny:
        gr = yi * ny_loc + torch.arange(ny_loc, device=dev).view(-1, 1)
        new_block = new_block.masked_fill(gr >= params.ny, params.bc_top)
    if x_size * nx_loc != params.nx:
        gc = xi * nx_loc + torch.arange(nx_loc, device=dev).view(1, -1)
        new_block = new_block.masked_fill(gc >= params.nx, params.bc_right)
    return new_block


def _per_shard(fn, blocks: Blocks) -> Blocks:
    """``fn(block, yi, xi)`` for every shard this process holds."""
    return [[None if blk is None else fn(blk, yi, xi)
             for xi, blk in enumerate(row)]
            for yi, row in enumerate(blocks)]


def _own(blocks: Blocks) -> list[torch.Tensor]:
    """The blocks this process holds, in mesh order."""
    return [blk for row in blocks for blk in row if blk is not None]


def _sync_local_step(blocks: Blocks, params: SimParams,
                     owners=None) -> Blocks:
    y_size, x_size = len(blocks), len(blocks[0])
    padded = _assemble_padded(blocks, params, owners=owners)
    return _per_shard(
        lambda p, yi, xi: _reimpose_ghost(
            stencil_interior(p, params.order, params.xcfl, params.ycfl),
            params, yi, xi, y_size, x_size), padded)


@contextlib.contextmanager
def _on_streams(streams):
    """Make each stream of ``streams`` its device's current stream."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        yield


def _side_streams(devices) -> dict[torch.device, torch.cuda.Stream]:
    """One side stream per distinct CUDA device of ``devices`` (none on the
    CPU): the overlap step's exchange runs there."""
    return {d: torch.cuda.Stream(device=d)
            for d in dict.fromkeys(devices) if d.type == "cuda"}


def _overlap_local_step(blocks: Blocks, params: SimParams,
                        side: dict | None = None, owners=None) -> Blocks:
    """The overlap step.  The inner regions are issued first on the main
    streams; then, with ``side`` streams, the halo exchange and the padded
    blocks are enqueued there behind the main streams' work before the
    inner regions, so the exchange (a host round trip across ranks) runs
    while the device computes them; the bands run on the main streams
    after they wait for the side streams.  ``record_stream`` marks every
    tensor used on a stream other than its own, so the caching allocator
    reuses none of them while that stream may still read it."""
    b = params.border_size
    y_size, x_size = len(blocks), len(blocks[0])
    if side:
        for dev, s in side.items():
            s.wait_stream(torch.cuda.current_stream(dev))
        for blk in _own(blocks):
            blk.record_stream(side[blk.device])
    st = partial(stencil_interior, order=params.order, xcfl=params.xcfl,
                 ycfl=params.ycfl)
    # inner region from the raw block, independent of the exchange (the
    # offset-2·borderSize interior computed while MPI_Isend/Irecv are in
    # flight, 2dHeat.cpp:713-721)
    inner = _per_shard(lambda blk, yi, xi: st(blk), blocks)
    if side:
        with _on_streams(side.values()):
            padded = _assemble_padded(blocks, params, owners=owners)
        for dev, s in side.items():
            torch.cuda.current_stream(dev).wait_stream(s)
        for p in _own(padded):
            p.record_stream(torch.cuda.current_stream(p.device))
    else:
        padded = _assemble_padded(blocks, params, owners=owners)

    def bands(p, yi, xi):
        # local rows [0, b) and [ny-b, ny) full width, columns [0, b) and
        # [nx-b, nx) of the middle rows (2dHeat.cpp:724-745); padded index
        # = local index + b
        ny, nx = blocks[yi][xi].shape
        bottom = st(p[0:3 * b, :])
        top = st(p[ny - b:ny + 2 * b, :])
        left = st(p[b:b + ny, 0:3 * b])
        right = st(p[b:b + ny, nx - b:nx + 2 * b])
        middle = torch.cat([left, inner[yi][xi], right], dim=1)
        new = torch.cat([bottom, middle, top], dim=0)
        return _reimpose_ghost(new, params, yi, xi, y_size, x_size)

    return _per_shard(bands, padded)


def _multistep_local_step(blocks: Blocks, params: SimParams,
                          k: int, owners=None) -> Blocks:
    """k timesteps per halo exchange (communication-avoiding stencil).

    Exchanges K = k·border-wide halos once, then applies k plain torch
    steps to each K-padded block (``stencil_local_multistep_plain``),
    re-imposing the physical and ghost bands on global coordinates after
    each; the valid region shrinks by ``border`` a step and ends at the
    shard's own cells.  ``_multistep_local_step_pallas`` runs the same
    steps through B3."""
    b = params.border_size
    K = k * b
    padded = _assemble_padded(blocks, params, border=K, owners=owners)

    def shard(p, yi, xi):
        ny_loc, nx_loc = blocks[yi][xi].shape
        # global halo-grid coordinates of p[0, 0]
        gy0 = yi * ny_loc + b - K
        gx0 = xi * nx_loc + b - K
        out = stencil_local_multistep_plain(
            p, gy0, gx0, params.ny, params.nx, params.order, params.xcfl,
            params.ycfl, params.bc, k=k)
        return out[K:K + ny_loc, K:K + nx_loc]

    return _per_shard(shard, padded)


def _multistep_local_step_pallas(blocks: Blocks, params: SimParams,
                                 k: int, owners=None,
                                 pads: tuple[_Padded, _Padded] | None = None
                                 ) -> Blocks:
    """``_multistep_local_step`` with the hand-written kernel: one launch
    (B3) a device for the k steps of every shard this process holds (the
    hw5 pattern of running the hw2 kernel under the communication layer;
    the JAX package's one ``pallas_call`` a device under ``shard_map``).
    Bitwise equal to the plain steps.

    The K-padded blocks are assembled in place in ``pads[0]``
    (``_assemble_in_place``; a new pair without ``pads``) and B3 writes
    ``pads[1]``; the new blocks are ``pads[1]``'s interiors, so the next
    step, given the pair swapped, places nothing."""
    b = params.border_size
    src, dst = pads or _padded_pair(blocks, k * b, b, owners)
    _assemble_in_place(blocks, src, params)
    stencil_local_multistep_shards(
        src.own, src.offsets, params.ny, params.nx, params.order,
        params.xcfl, params.ycfl, params.bc, k=k, out=dst.own)
    return dst.inner


def _in_place_steps(params: SimParams, k: int, owners=None):
    """``_multistep_local_step_pallas`` over one pair of padded buffers a
    shard (``_padded_pair``), made at the first step and swapped after
    each: a solve's step allocates nothing.  Each call of ``_run`` makes
    its own pair, so the blocks a solve returns (views of one of them)
    alias nothing a later solve writes."""
    pads = None

    def step(blocks: Blocks) -> Blocks:
        nonlocal pads
        if pads is None:
            b = params.border_size
            pads = _padded_pair(blocks, k * b, b, owners)
        out = _multistep_local_step_pallas(blocks, params, k, pads=pads)
        pads = pads[::-1]
        return out

    return step


def _local_step(params: SimParams, overlap: bool, k: int, local_kernel: str,
                side: dict | None = None, owners=None):
    if local_kernel == "pallas":
        return _in_place_steps(params, k, owners)
    if k > 1:
        return partial(_multistep_local_step, params=params, k=k,
                       owners=owners)
    if overlap:
        return partial(_overlap_local_step, params=params, side=side,
                       owners=owners)
    return partial(_sync_local_step, params=params, owners=owners)


def _shard_devices(mesh: Mesh, y_size: int, x_size: int):
    return mesh.devices.reshape(y_size, x_size)


def _shard_owners(mesh: Mesh, y_size: int, x_size: int):
    return mesh.owners.reshape(y_size, x_size)


def _scatter(u: torch.Tensor, devices, ny_loc: int, nx_loc: int,
             owners=None, rank: int = 0) -> Blocks:
    """Cut the (ny_pad, nx_pad) interior into blocks, each copied to its
    shard's device; with ``owners``, only the blocks of ``rank`` (``None``
    for the others)."""
    y_size, x_size = devices.shape
    return [[u[yi * ny_loc:(yi + 1) * ny_loc,
               xi * nx_loc:(xi + 1) * nx_loc].to(devices[yi, xi], copy=True)
             if owners is None or owners[yi, xi] == rank else None
             for xi in range(x_size)] for yi in range(y_size)]


def _initial_blocks(params: SimParams, dtype, devices, ny_loc: int,
                    nx_loc: int, owners=None, rank: int = 0) -> Blocks:
    """The blocks ``_scatter`` cuts from the ghost-padded initial interior
    (``make_initial_grid``, then ``_pad_interior_for_mesh``), each built
    on its shard's device: ``ic``, the ghost rows beyond ``ny``
    ``bc_top`` and the ghost columns beyond ``nx`` ``bc_right`` (over the
    corner), each value rounded once to ``dtype``, so bit for bit those
    slices.  With ``owners``, only the blocks of ``rank`` (``None`` for
    the others)."""
    def block(yi: int, xi: int) -> torch.Tensor:
        blk = torch.full((ny_loc, nx_loc), params.ic, dtype=dtype,
                         device=devices[yi, xi])
        blk[max(0, params.ny - yi * ny_loc):, :] = params.bc_top
        blk[:, max(0, params.nx - xi * nx_loc):] = params.bc_right
        return blk

    y_size, x_size = devices.shape
    return [[block(yi, xi) if owners is None or owners[yi, xi] == rank
             else None for xi in range(x_size)] for yi in range(y_size)]


def _gather(blocks: Blocks, owners=None) -> torch.Tensor:
    """The blocks joined into one interior tensor on the first own shard's
    device.  In a gang every rank receives the blocks it does not hold
    from their owners (``halo.gather_shards``), so every rank returns the
    whole interior."""
    ref = _own(blocks)[0]
    dev = ref.device
    if owners is not None:
        flat = gather_shards([blk for row in blocks for blk in row],
                             owners.flat, ref.shape, ref.dtype, dev)
        x_size = len(blocks[0])
        blocks = [flat[yi * x_size:(yi + 1) * x_size]
                  for yi in range(len(blocks))]
    return torch.cat([torch.cat([b.to(dev) for b in row], dim=1)
                      for row in blocks], dim=0)


def _synchronize(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def distributed_heat_step(params: SimParams, mesh: Mesh,
                          overlap: bool = False):
    """The sharded single step ``u (ny_pad, nx_pad) -> u'`` on interior
    tensors (every rank of a gang passes the whole interior and gets it
    back)."""
    y_size, x_size, ny_loc, nx_loc = _mesh_layout(params, mesh)
    devices = _shard_devices(mesh, y_size, x_size)
    owners = _shard_owners(mesh, y_size, x_size)
    side = _side_streams(mesh.local_devices()) if overlap else None
    local = _local_step(params, overlap, 1, "xla", side=side, owners=owners)

    def step(u):
        return _gather(local(_scatter(u, devices, ny_loc, nx_loc, owners,
                                      mesh.rank)), owners)

    return step


def _run(blocks: Blocks, params: SimParams, iters: int, overlap: bool,
         steps_per_exchange: int = 1, local_kernel: str = "xla",
         side: dict | None = None, owners=None) -> Blocks:
    """``iters`` steps (``iters / k`` exchanges) on the shards."""
    k = steps_per_exchange
    local = _local_step(params, overlap, k, local_kernel, side, owners)
    for _ in range(iters // k):
        blocks = local(blocks)
    return blocks


def prepare_distributed_heat(params: SimParams, mesh: Mesh,
                             iters: int | None = None, dtype=torch.float32,
                             overlap: bool | None = None,
                             steps_per_exchange: int = 1,
                             local_kernel: str = "xla"):
    """Set up a distributed solve and return ``(iterate, overlap_used,
    steps_per_exchange_used)``.

    ``steps_per_exchange`` > 1 selects the communication-avoiding path; it
    falls back to 1 when shards are thinner than K, when ``iters`` does not
    divide by k, or with ``overlap``.  ``overlap`` falls back to sync when
    shards are under 2·border, and always with ``local_kernel="pallas"``.

    ``iterate()`` builds a fresh initial grid's blocks on the shards'
    devices (``_initial_blocks``), runs every step and returns ``(seconds,
    out)``: ``out`` is the (ny_pad, nx_pad) interior on the first own
    shard's device (on every rank of a gang), and ``seconds`` times only
    the step loop, between a ``torch.cuda.synchronize()`` of each device
    used before and after (the reference's ``MPI_Wtime`` bracket,
    ``2dHeat.cpp:832-841``; in a gang the ranks meet at a barrier before
    it opens).  Under NCCL nothing inside the bracket waits on the host
    until its closing synchronise.  In a gang the bracket's seconds and
    the seconds of its cross-rank exchanges go to the gauges
    ``dist_heat.solve_s`` and ``dist_heat.exchange_s``: on a card the
    exchanges' CUDA-event clocks on the current stream, each from the
    stream reaching the exchange to the halos being usable on it (under
    NCCL the launch of its graph, ``halo._Batch``), the wait for the peers
    included, all read by the closing synchronise's ``halo.settle_clock``;
    on the CPU the host clock around each exchange.
    It can be called again.
    """
    iters = params.iters if iters is None else iters
    overlap = (not params.synchronous) if overlap is None else overlap
    y_size, x_size, ny_loc, nx_loc = _mesh_layout(params, mesh)
    b = params.border_size
    if overlap and (ny_loc < 2 * b or nx_loc < 2 * b):
        # too thin for the interior/band split
        overlap = False
    if local_kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown local_kernel {local_kernel!r} "
                         "(expected 'xla' or 'pallas')")
    if local_kernel == "pallas":
        overlap = False  # the kernel's k-step launch subsumes the split
    k = steps_per_exchange
    if k > 1 and (overlap or iters % k
                  or ny_loc < k * b or nx_loc < k * b):
        k = 1  # communication-avoiding path ineligible: fall back

    devices = _shard_devices(mesh, y_size, x_size)
    owners = _shard_owners(mesh, y_size, x_size)
    local_devices = mesh.local_devices()
    side = _side_streams(local_devices) if overlap else None
    gang = owners.max() > 0

    def iterate():
        with host_range("dist.prepare"):
            blocks = _initial_blocks(params, dtype, devices, ny_loc, nx_loc,
                                     owners, mesh.rank)
        _synchronize(local_devices)
        barrier()
        exchanged = settle_clock()
        t0 = time.perf_counter()
        with span("dist.steps", kernel=local_kernel,
                  block=f"{ny_loc}x{nx_loc}", iters=iters):
            with host_range("dist.enqueue"):
                blocks = _run(blocks, params, iters, overlap,
                              steps_per_exchange=k,
                              local_kernel=local_kernel, side=side,
                              owners=owners)
            _synchronize(local_devices)
        seconds = time.perf_counter() - t0
        exchange_s = settle_clock() - exchanged
        if gang:
            from ..core import metrics

            metrics.gauge("dist_heat.solve_s").set(seconds)
            metrics.gauge("dist_heat.exchange_s").set(exchange_s)
        with host_range("dist.gather"):
            return seconds, _gather(blocks, owners)

    return iterate, overlap, k


def _mesh_layout(params: SimParams, mesh: Mesh):
    """(y_size, x_size, ny_loc, nx_loc) of ``params`` on ``mesh``.  Grids
    that do not divide are ghost-padded; raises ``ValueError`` when a shard
    would be thinner than the stencil border (a halo slab would then span
    more than one neighbour)."""
    axes = mesh.shape
    y_size = axes.get("y", 1)
    x_size = axes.get("x", 1)
    b = params.border_size
    ny_loc = -(-params.ny // y_size)
    nx_loc = -(-params.nx // x_size)
    if ny_loc < b or nx_loc < b:
        raise ValueError(
            f"local block ({ny_loc}×{nx_loc}) thinner than the stencil "
            f"border ({b}); use fewer devices or a larger grid")
    return y_size, x_size, ny_loc, nx_loc


def _pad_interior_for_mesh(u: np.ndarray, params: SimParams,
                           y_size: int, x_size: int) -> np.ndarray:
    """Ghost-pad a true (ny, nx) interior so it divides over the mesh, with
    the top/right BC values."""
    ny_pad = -(-params.ny // y_size) * y_size
    nx_pad = -(-params.nx // x_size) * x_size
    if ny_pad > params.ny:
        pad_rows = np.full((ny_pad - params.ny, u.shape[1]), params.bc_top,
                           u.dtype)
        u = np.concatenate([u, pad_rows], axis=0)
    if nx_pad > params.nx:
        pad_cols = np.full((u.shape[0], nx_pad - params.nx), params.bc_right,
                           u.dtype)
        u = np.concatenate([u, pad_cols], axis=1)
    return u


def _shard_map(blocks: Blocks, ny_loc: int, nx_loc: int) -> list:
    """``(index, block)`` of every shard in mesh order: its global index
    range in the padded interior and its tensor (``None`` where another
    rank holds it), the layout ``ckpt.commit_epoch`` records."""
    return [(((yi * ny_loc, (yi + 1) * ny_loc),
              (xi * nx_loc, (xi + 1) * nx_loc)), blk)
            for yi, row in enumerate(blocks) for xi, blk in enumerate(row)]


def _own_state(blocks: Blocks) -> np.ndarray:
    """The cells of this process's shards, one host vector: the state a
    rank's convergence trace measures."""
    return np.concatenate([blk.cpu().numpy().ravel() for blk in _own(blocks)])


def run_distributed_heat_supervised(params: SimParams, mesh: Mesh,
                                    ckpt_dir: str, ckpt_every: int = 0,
                                    iters: int | None = None,
                                    dtype=torch.float32,
                                    overlap: bool | None = None,
                                    resume: bool = True,
                                    heartbeat=None,
                                    commit_timeout: float = 120.0
                                    ) -> np.ndarray:
    """The supervised form of ``run_distributed_heat``: the solve runs in
    epochs of ``ckpt_every`` iterations, each ending in an epoch-committed
    distributed checkpoint (``ckpt.py``) and a heartbeat carrying the step
    counter (``supervisor.py``) — the two hooks gang supervision needs to
    detect a dead or frozen rank and relaunch the whole gang from the last
    globally consistent state.

    ``resume`` loads the newest valid commit in ``ckpt_dir`` (how a gang
    restart continues; ``CME213_RESUME`` gates it from the launcher).
    Resume is **elastic**: the commit records each shard's global index
    range, so the global grid is reassembled and re-cut for *this* mesh
    even when the committed run used another shard count, rank count or
    ``GridMethod``; every decomposition is bitwise identical per cell, so
    the recovered solve equals an uninterrupted one exactly.
    ``faults.maybe_kill_rank`` guards each epoch boundary, so
    ``CME213_FAULTS=rankkill:<rank>:<epoch>`` injects a deterministic
    mid-solve death for recovery tests.

    An epoch that dies RESOURCE-classified (``CME213_FAULTS=
    oom:heat_chunk``) halves ``ckpt_every``, re-cuts the last committed
    state and retries; the allocator's own ``torch.cuda.OutOfMemoryError``
    re-raises (an epoch holds the same buffers whatever its length).  A
    ``solver-progress`` event an epoch (``ConvergenceTracker("heat2d")``)
    measures the change of this rank's own shards.

    Returns the final full halo grid (gy, gx) as numpy on every rank, like
    ``run_distributed_heat``.
    """
    from ..core import metrics
    from ..core.faults import maybe_kill_rank, maybe_oom
    from ..core.numerics import ConvergenceTracker, progress_from_states
    from ..core.resilience import FailureKind, classify_failure
    from ..core.trace import record_event
    from ..core.tune import dtype_name
    from .ckpt import check_meta, commit_epoch, load_latest_commit
    from .multihost import process_info

    iters = params.iters if iters is None else iters
    ckpt_every = ckpt_every or iters
    overlap = (not params.synchronous) if overlap is None else overlap
    y_size, x_size, ny_loc, nx_loc = _mesh_layout(params, mesh)
    b = params.border_size
    if overlap and (ny_loc < 2 * b or nx_loc < 2 * b):
        overlap = False
    meta = {"kind": "heat2d", "ny": params.ny, "nx": params.nx,
            "order": params.order, "border": b,
            "grid_method": int(params.grid_method),
            "dtype": dtype_name(dtype)}
    process_id, process_count = process_info()
    devices = _shard_devices(mesh, y_size, x_size)
    owners = _shard_owners(mesh, y_size, x_size)
    local_devices = mesh.local_devices()
    side = _side_streams(local_devices) if overlap else None

    def state(force: bool = False):
        """(step, epoch, blocks) from the newest commit, or the initial
        grid; ``force`` reloads even when the solve started fresh (the
        halving retry: this run's own commits are durable)."""
        loaded = load_latest_commit(ckpt_dir) if (resume or force) else None
        if loaded is not None:
            manifest, u = loaded
            check_meta(manifest, **meta)
            step, epoch = manifest["step"], manifest["epoch"]
        else:
            step, epoch = 0, 0
            u = interior(make_initial_grid(params, dtype=dtype,
                                           device="cpu"), b).numpy()
        u = torch.from_numpy(np.ascontiguousarray(
            _pad_interior_for_mesh(u, params, y_size, x_size))).to(dtype)
        return step, epoch, _scatter(u, devices, ny_loc, nx_loc, owners,
                                     mesh.rank)

    it, epoch, blocks = state()
    if heartbeat is not None:
        heartbeat.beat(it)
    # per-epoch convergence trace: the solve's residual, delta-norm and
    # iterations/s ride solver-progress events, so a stalled gang shows in
    # `top` before the supervisor's timeout
    tracker = ConvergenceTracker("heat2d")
    while it < iters:
        # deterministic kill window: `step` counts committed epochs, so
        # rankkill:<rank>:<e> always dies holding exactly e commits
        maybe_kill_rank(step=epoch)
        k = min(ckpt_every, iters - it)
        prev = _own_state(blocks)
        t0 = time.perf_counter()
        try:
            maybe_oom("heat_chunk")
            new = _run(blocks, params, k, overlap, side=side, owners=owners)
            _synchronize(local_devices)
        except Exception as e:  # noqa: BLE001 — classify, then decide
            if (isinstance(e, torch.cuda.OutOfMemoryError)
                    or classify_failure(e) is not FailureKind.RESOURCE
                    or k <= 1):
                raise
            ckpt_every = max(1, k // 2)
            metrics.counter("admission.chunk_shrunk").inc()
            record_event("chunk-shrunk", op="heat2d", from_size=k,
                         to_size=ckpt_every, reason=type(e).__name__)
            it, epoch, blocks = state(force=True)
            continue
        progress_from_states(tracker, it + k, prev, _own_state(new), k,
                             time.perf_counter() - t0)
        blocks = new
        it += k
        epoch += 1
        commit_epoch(ckpt_dir, epoch, it, _shard_map(blocks, ny_loc, nx_loc),
                     true_shape=(params.ny, params.nx), meta=meta,
                     process_id=process_id, process_count=process_count,
                     timeout=commit_timeout)
        if heartbeat is not None:
            heartbeat.beat(it)
    out = _gather(blocks, owners).cpu().numpy()
    final = make_initial_grid(params, dtype=dtype, device="cpu").numpy()
    final[b:-b, b:-b] = out[:params.ny, :params.nx]
    return final


def _probe_params(params: SimParams, mesh: Mesh, k: int) -> SimParams:
    """A small probe configuration for ``mesh`` and the
    communication-avoiding factor ``k``: every shard keeps at least K =
    k·border rows and columns; the caller's order and grid method."""
    axes = mesh.shape
    y_size = axes.get("y", 1)
    x_size = axes.get("x", 1)
    b = params.border_size
    loc = max(8, k * b)
    return SimParams(nx=max(40, x_size * loc), ny=y_size * loc,
                     order=params.order, iters=4 * k, bc_top=2.0,
                     bc_left=0.5, bc_bottom=1.0, bc_right=3.0,
                     grid_method=params.grid_method)


def _gated_heat_config(params: SimParams, mesh: Mesh, local_kernel: str,
                       k: int, dtype,
                       plain_fallback: bool = False) -> tuple[str, int]:
    """Conformance-gate the distributed heat rungs before they serve:

    - the ``pallas`` local kernel (B3) is probed against the ``xla`` local
      step at the same communication-avoiding factor;
    - the k > 1 exchange-every-k path against the k = 1 path;

    each on a small distributed solve on this mesh, bit for bit (both are
    the port's contracts), demoting to ``xla`` / k = 1 on divergence with
    a ``rung-failed`` (``wrong_answer``) event.  On a CUDA mesh a diverging
    ``pallas`` kernel raises ``FrameworkError`` instead, unless the caller
    asks for the plain step (``plain_fallback``; ``core/resilience.
    allows_plain_rungs``).  Verdicts cache per process × order × k × mesh
    shape × device and kernel build; in a gang every rank probes and all
    take one verdict (``multihost.agreed_check``).  A kernel that cannot build or launch
    raises out of the probe (``KernelError``)."""
    from ..core import metrics
    from ..core.errors import FrameworkError
    from ..core.platform import build_identity
    from ..core.resilience import FailureKind, allows_plain_rungs
    from ..core.trace import record_event

    from .multihost import agreed_check

    device = mesh.local_devices()[0]
    dev = build_identity(device)

    def probe(kernel: str, kk: int, ref_kernel: str, ref_k: int) -> bool:
        p = _probe_params(params, mesh, max(kk, ref_k))

        def solve(kern, sk):
            return lambda: torch.from_numpy(run_distributed_heat(
                p, mesh, dtype=dtype, overlap=False, steps_per_exchange=sk,
                local_kernel=kern, conformance=False))

        shape = "x".join(str(s) for s in mesh.devices.shape)
        # in a gang every rank runs the probe solves (they exchange halos)
        # and all take one verdict
        return agreed_check(
            "dist_heat", f"{kernel}-k{kk}",
            f"order{params.order}/k{kk}/mesh{shape}/{dev}",
            candidate=solve(kernel, kk), reference=solve(ref_kernel, ref_k))

    def demote(rung: str) -> None:
        metrics.counter("fallback.demotions").inc()
        record_event("rung-failed", op="dist_heat", rung=rung,
                     kind=FailureKind.WRONG_ANSWER.value,
                     error="ConformanceFailed")

    if local_kernel == "pallas" and not probe("pallas", k, "xla", k):
        demote(f"pallas-k{k}")
        if not allows_plain_rungs(device, plain_fallback):
            raise FrameworkError(
                f"the pallas local kernel (B3) at k={k}, order "
                f"{params.order} failed its conformance probe on {device}; "
                f"plain_fallback=True serves the xla step instead")
        local_kernel = "xla"
    if local_kernel == "xla" and k > 1 and not probe("xla", k, "xla", 1):
        demote(f"xla-k{k}")
        k = 1
    return local_kernel, k


def run_distributed_heat(params: SimParams, mesh: Mesh,
                         iters: int | None = None, dtype=torch.float32,
                         overlap: bool | None = None,
                         steps_per_exchange: int = 1,
                         local_kernel: str = "xla",
                         conformance: bool = True,
                         plain_fallback: bool = False) -> np.ndarray:
    """Full distributed solve.  Returns the final full halo grid (gy, gx)
    as numpy, for direct comparison with the single-device solve and the
    reference's per-rank ``grid{rank}_final.txt`` methodology.

    ``overlap`` defaults to ``not params.synchronous`` (hw5 ``sync`` flag).
    ``local_kernel="pallas"`` runs the hand-written kernel (B3), one launch a
    device for all its shards.

    With ``conformance`` (default), the non-reference rungs (the
    ``pallas`` local kernel, and the k > 1 communication-avoiding
    exchange) are probed on first use against the reference rungs on a
    small solve on this mesh and demoted (``WRONG_ANSWER``) on divergence
    (``_gated_heat_config``): the hw5 N-vs-1 comparison in the serving
    path.  On a CUDA mesh a diverging ``pallas`` kernel raises rather than
    demoting to ``xla``, unless ``plain_fallback`` asks for the plain step.
    ``conformance=False`` pins the requested rung.  A kernel that fails to
    build or launch raises.

    The final grid is assembled on the interior's device
    (``make_initial_grid`` there, the interior written into it) and comes
    to the host in one copy, into page-locked memory from a card
    (``core/platform.to_host``): an array of its own, which no later solve
    writes.
    """
    with host_range("dist.solve"):
        if conformance and (local_kernel == "pallas"
                            or steps_per_exchange > 1):
            local_kernel, steps_per_exchange = _gated_heat_config(
                params, mesh, local_kernel, steps_per_exchange, dtype,
                plain_fallback)
        iterate, _, _ = prepare_distributed_heat(
            params, mesh, iters=iters, dtype=dtype, overlap=overlap,
            steps_per_exchange=steps_per_exchange, local_kernel=local_kernel)
        _, out = iterate()
        with host_range("dist.download"):
            b = params.border_size
            final = make_initial_grid(params, dtype=dtype, device=out.device)
            final[b:-b, b:-b] = out[:params.ny, :params.nx]
            return to_host(final)
