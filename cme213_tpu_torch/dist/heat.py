"""Distributed 2-D heat solve — domain decomposition over a device mesh.

Counterpart of ``cme213_tpu/dist/heat.py``, which runs the reference's MPI
heat engine (``hw/hw5/programming/2dHeat.cpp``) as one ``shard_map``.  The
interior grid (ny, nx) is cut over a 1-D ("y" stripes, gridMethod=1) or 2-D
("y", "x" blocks, gridMethod=2) mesh (``mesh.py``).  One process holds one
tensor per shard, ``blocks[yi][xi]`` on the mesh's device ``(yi, xi)``, and
the shard's place in that list stands in for ``lax.axis_index``.  Each step
exchanges ``border``-wide halos (``halo.py``) and applies the order-2/4/8
stencil to every block.

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
  ``ops/stencil_pipeline.stencil_local_multistep_shards``).

Every variant computes each cell with the same expression as
``ops.run_heat``, each operation rounded on its own, so every mesh, scheme,
k and local kernel gives the single-device result bit for bit.
"""

from __future__ import annotations

import contextlib
import time
from functools import partial

import numpy as np
import torch

from ..config import SimParams
from ..grid import interior, make_initial_grid
from ..ops.stencil import stencil_interior
from ..ops.stencil_pipeline import (stencil_local_multistep_plain,
                                    stencil_local_multistep_shards)
from .halo import pad_with_halos
from .mesh import Mesh

#: one tensor per shard, ``blocks[yi][xi]``; a 1-D mesh has one column
Blocks = list[list[torch.Tensor]]


def _pad_axis(blocks: Blocks, dim: int, border: int, lo_fill,
              hi_fill) -> Blocks:
    """Every line of shards along mesh axis ``dim`` (0: y, 1: x) extended
    by its halos along tensor dim ``dim`` — the JAX package's
    ``_pad_axis0``, which transposes for x."""
    if dim == 1:
        return [pad_with_halos(row, border, lo_fill, hi_fill, dim=1)
                for row in blocks]
    cols = [pad_with_halos([row[xi] for row in blocks], border, lo_fill,
                           hi_fill, dim=0)
            for xi in range(len(blocks[0]))]
    return [[col[yi] for col in cols] for yi in range(len(blocks))]


def _assemble_padded(blocks: Blocks, params: SimParams,
                     border: int | None = None) -> Blocks:
    """Each block + y halos + x halos (BC fill at physical boundaries).

    ``border`` defaults to the stencil border; the k-step path passes K =
    k·border.  The x slabs are cut from the y-padded blocks, so a corner
    halo holds the diagonal neighbour's data (the reference's full-column
    pack buffers, ``2dHeat.cpp:456-462``); from k = 2 on the k-step path
    reads it."""
    b = params.border_size if border is None else border
    ypad = _pad_axis(blocks, 0, b, params.bc_bottom, params.bc_top)
    return _pad_axis(ypad, 1, b, params.bc_left, params.bc_right)


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
    """``fn(block, yi, xi)`` for every shard."""
    return [[fn(blk, yi, xi) for xi, blk in enumerate(row)]
            for yi, row in enumerate(blocks)]


def _sync_local_step(blocks: Blocks, params: SimParams) -> Blocks:
    y_size, x_size = len(blocks), len(blocks[0])
    padded = _assemble_padded(blocks, params)
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
                        side: dict | None = None) -> Blocks:
    """The overlap step.  With ``side`` streams, the halo exchange and the
    padded blocks are enqueued there after the main streams' work so far,
    the inner regions on the main streams (issued before the exchange is
    waited on, so the two run together), and the bands on the main streams
    after they wait for the side streams.  ``record_stream`` marks every
    tensor used on a stream other than its own, so the caching allocator
    reuses none of them while that stream may still read it."""
    b = params.border_size
    y_size, x_size = len(blocks), len(blocks[0])
    if side:
        for dev, s in side.items():
            s.wait_stream(torch.cuda.current_stream(dev))
        for row in blocks:
            for blk in row:
                blk.record_stream(side[blk.device])
        with _on_streams(side.values()):
            padded = _assemble_padded(blocks, params)
    else:
        padded = _assemble_padded(blocks, params)
    st = partial(stencil_interior, order=params.order, xcfl=params.xcfl,
                 ycfl=params.ycfl)
    # inner region from the raw block, independent of the exchange (the
    # offset-2·borderSize interior computed while MPI_Isend/Irecv are in
    # flight, 2dHeat.cpp:713-721)
    inner = _per_shard(lambda blk, yi, xi: st(blk), blocks)
    if side:
        for dev, s in side.items():
            torch.cuda.current_stream(dev).wait_stream(s)
        for row in padded:
            for p in row:
                p.record_stream(torch.cuda.current_stream(p.device))

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
                          k: int) -> Blocks:
    """k timesteps per halo exchange (communication-avoiding stencil).

    Exchanges K = k·border-wide halos once, then applies k plain torch
    steps to each K-padded block (``stencil_local_multistep_plain``),
    re-imposing the physical and ghost bands on global coordinates after
    each; the valid region shrinks by ``border`` a step and ends at the
    shard's own cells.  ``_multistep_local_step_pallas`` runs the same
    steps through B3."""
    b = params.border_size
    K = k * b
    padded = _assemble_padded(blocks, params, border=K)

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
                                 k: int) -> Blocks:
    """``_multistep_local_step`` with the hand-written kernel: one launch
    (B3) a device for the k steps of every shard it holds (the hw5 pattern
    of running the hw2 kernel under the communication layer; the JAX
    package's one ``pallas_call`` a device under ``shard_map``).  Bitwise
    equal to the plain steps."""
    b = params.border_size
    K = k * b
    padded = _assemble_padded(blocks, params, border=K)
    ny_loc, nx_loc = blocks[0][0].shape
    x_size = len(blocks[0])
    # global halo-grid coordinates of each padded block's element [0, 0]
    offsets = [(yi * ny_loc + b - K, xi * nx_loc + b - K)
               for yi in range(len(blocks)) for xi in range(x_size)]
    outs = stencil_local_multistep_shards(
        [p for row in padded for p in row], offsets, params.ny, params.nx,
        params.order, params.xcfl, params.ycfl, params.bc, k=k)
    return [[outs[yi * x_size + xi][K:K + ny_loc, K:K + nx_loc]
             for xi in range(x_size)] for yi in range(len(blocks))]


def _local_step(params: SimParams, overlap: bool, k: int, local_kernel: str,
                side: dict | None = None):
    if local_kernel == "pallas":
        return partial(_multistep_local_step_pallas, params=params, k=k)
    if k > 1:
        return partial(_multistep_local_step, params=params, k=k)
    if overlap:
        return partial(_overlap_local_step, params=params, side=side)
    return partial(_sync_local_step, params=params)


def _shard_devices(mesh: Mesh, y_size: int, x_size: int):
    return mesh.devices.reshape(y_size, x_size)


def _scatter(u: torch.Tensor, devices, ny_loc: int, nx_loc: int) -> Blocks:
    """Cut the (ny_pad, nx_pad) interior into blocks, each copied to its
    shard's device."""
    y_size, x_size = devices.shape
    return [[u[yi * ny_loc:(yi + 1) * ny_loc,
               xi * nx_loc:(xi + 1) * nx_loc].to(devices[yi, xi], copy=True)
             for xi in range(x_size)] for yi in range(y_size)]


def _gather(blocks: Blocks) -> torch.Tensor:
    """The blocks joined into one interior tensor on the first shard's
    device."""
    dev = blocks[0][0].device
    return torch.cat([torch.cat([b.to(dev) for b in row], dim=1)
                      for row in blocks], dim=0)


def _synchronize(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def distributed_heat_step(params: SimParams, mesh: Mesh,
                          overlap: bool = False):
    """The sharded single step ``u (ny_pad, nx_pad) -> u'`` on interior
    tensors."""
    y_size, x_size, ny_loc, nx_loc = _mesh_layout(params, mesh)
    devices = _shard_devices(mesh, y_size, x_size)
    side = _side_streams(devices.flat) if overlap else None
    local = _local_step(params, overlap, 1, "xla", side=side)

    def step(u):
        return _gather(local(_scatter(u, devices, ny_loc, nx_loc)))

    return step


def _run(blocks: Blocks, params: SimParams, iters: int, overlap: bool,
         steps_per_exchange: int = 1, local_kernel: str = "xla",
         side: dict | None = None) -> Blocks:
    """``iters`` steps (``iters / k`` exchanges) on the shards."""
    k = steps_per_exchange
    local = _local_step(params, overlap, k, local_kernel, side)
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

    ``iterate()`` copies a fresh initial grid to the shards' devices, runs
    every step and returns ``(seconds, out)``: ``out`` is the (ny_pad,
    nx_pad) interior on the first shard's device, and ``seconds`` times only
    the step loop, between a ``torch.cuda.synchronize()`` of each device
    used before and after (the reference's ``MPI_Wtime`` bracket,
    ``2dHeat.cpp:832-841``).  It can be called again.
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

    u0 = _pad_interior_for_mesh(
        interior(make_initial_grid(params, dtype=dtype, device="cpu"),
                 b).numpy(), params, y_size, x_size)
    devices = _shard_devices(mesh, y_size, x_size)
    side = _side_streams(devices.flat) if overlap else None

    def iterate():
        blocks = _scatter(torch.from_numpy(u0), devices, ny_loc, nx_loc)
        _synchronize(devices.flat)
        t0 = time.perf_counter()
        blocks = _run(blocks, params, iters, overlap, steps_per_exchange=k,
                      local_kernel=local_kernel, side=side)
        _synchronize(devices.flat)
        seconds = time.perf_counter() - t0
        return seconds, _gather(blocks)

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
    shape × device and kernel build.  A kernel that cannot build or launch
    raises out of the probe (``KernelError``)."""
    from ..core import conformance, metrics
    from ..core.errors import FrameworkError
    from ..core.platform import build_identity
    from ..core.resilience import FailureKind, allows_plain_rungs
    from ..core.trace import record_event

    device = next(iter(mesh.devices.flat))
    dev = build_identity(device)

    def probe(kernel: str, kk: int, ref_kernel: str, ref_k: int) -> bool:
        p = _probe_params(params, mesh, max(kk, ref_k))

        def solve(kern, sk):
            return lambda: torch.from_numpy(run_distributed_heat(
                p, mesh, dtype=dtype, overlap=False, steps_per_exchange=sk,
                local_kernel=kern, conformance=False))

        shape = "x".join(str(s) for s in mesh.devices.shape)
        return conformance.check(
            "dist_heat", f"{kernel}-k{kk}",
            shape_class=f"order{params.order}/k{kk}/mesh{shape}/{dev}",
            candidate=solve(kernel, kk), reference=solve(ref_kernel, ref_k)
        ).ok

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
    """
    if conformance and (local_kernel == "pallas" or steps_per_exchange > 1):
        local_kernel, steps_per_exchange = _gated_heat_config(
            params, mesh, local_kernel, steps_per_exchange, dtype,
            plain_fallback)
    iterate, _, _ = prepare_distributed_heat(
        params, mesh, iters=iters, dtype=dtype, overlap=overlap,
        steps_per_exchange=steps_per_exchange, local_kernel=local_kernel)
    _, out = iterate()
    b = params.border_size
    final = make_initial_grid(params, dtype=dtype, device="cpu").numpy()
    final[b:-b, b:-b] = out.cpu().numpy()[:params.ny, :params.nx]
    return final
