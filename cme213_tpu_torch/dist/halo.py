"""Halo exchange over the shards of one mesh axis, within a process and
across the ranks of a gang.

Counterpart of ``cme213_tpu/dist/halo.py``, which shifts ``border``-wide
slabs with ``lax.ppermute`` inside ``shard_map`` — itself the replacement of
the reference's ``MPI_Isend/Irecv`` row-band exchange
(``hw/hw5/programming/2dHeat.cpp:503-547``).  Here the shards along the
axis are a list of tensors, in mesh order, each on its own device (a
device may repeat).  A shard that another rank of the gang holds is
``None`` in the list, and ``owners`` names its rank.

- Between two shards of this process a slab is copied to the receiving
  shard's device (``Tensor.to(..., copy=True)``: the receiver owns its
  copy, as after a ``ppermute``), on the current stream of the devices
  involved.
- Between shards of different ranks it travels over the gang's gloo group
  (``dist/multihost.py``), whose point-to-point ops take CPU tensors: the
  sender copies its slab to the host (a synchronising copy, so the slab is
  whole before it is sent), the receiver copies the host buffer to its
  device on the current stream.  Every receive and send of an exchange is
  posted before any is waited on, so no order of blocking sends can
  deadlock the gang; a message's tag names the receiving shard and side.

A shard with no neighbour on a side lies on the physical boundary: its halo
on that side is the Dirichlet fill, keyed on the shard's index along the
axis, which replaces the reference's "-1 neighbour" case analysis
(``2dHeat.cpp:407-450``).
"""

from __future__ import annotations

import time

import torch

#: the cross-rank exchanges of this process: their host-clock seconds
#: (copies to and from the host included), messages and bytes sent
EXCHANGE = {"seconds": 0.0, "messages": 0, "bytes": 0}


def exchange_halo_1d(blocks: list[torch.Tensor | None], border: int,
                     lo_fill, hi_fill, dim: int = 0, owners=None,
                     tag: int = 0
                     ) -> list[tuple[torch.Tensor, torch.Tensor] | None]:
    """Exchange ``border``-wide slabs along tensor dim ``dim`` between
    neighbouring shards of ``blocks``.

    Returns ``(lo_halo, hi_halo)`` for each shard this process holds
    (``None`` for the others): ``lo_halo`` is the lower neighbour's last
    ``border`` slices (``lo_fill`` for shard 0), ``hi_halo`` the upper
    neighbour's first ``border`` slices (``hi_fill`` for the last shard).
    Each halo lies on its shard's device.  ``owners[i]`` is the rank that
    holds shard i where ``blocks[i]`` is ``None``; the exchange with those
    ranks uses message tags ``tag`` to ``tag + 2·len(blocks) - 1``, and
    every rank holding a neighbour of a shard here must call this with the
    same ``tag``.
    """
    n = len(blocks)
    out: list[tuple[torch.Tensor, torch.Tensor] | None] = []
    remote = []  # (shard, side, host buffer) received from another rank
    for i, blk in enumerate(blocks):
        if blk is None:
            out.append(None)
            continue
        shape = list(blk.shape)
        shape[dim] = border
        halo = []
        for side, j in ((0, i - 1), (1, i + 1)):
            if j < 0 or j >= n:
                fill = lo_fill if side == 0 else hi_fill
                halo.append(torch.full(shape, fill, dtype=blk.dtype,
                                       device=blk.device))
            elif blocks[j] is None:
                halo.append(None)
                remote.append((i, side, torch.empty(shape, dtype=blk.dtype)))
            else:
                nb = blocks[j]
                start = nb.shape[dim] - border if side == 0 else 0
                halo.append(nb.narrow(dim, start, border).to(
                    blk.device, non_blocking=True, copy=True))
        out.append(tuple(halo))
    sends = [(i, side) for i, blk in enumerate(blocks) if blk is not None
             for side, j in ((0, i - 1), (1, i + 1))
             if 0 <= j < n and blocks[j] is None]
    if not (remote or sends):
        return out

    import torch.distributed as dist

    t0 = time.perf_counter()
    reqs = [dist.irecv(buf, src=int(owners[i - 1 if side == 0 else i + 1]),
                       tag=tag + 2 * i + side)
            for i, side, buf in remote]
    staged = []
    for i, side in sends:
        blk = blocks[i]
        # my first slices are the hi halo of shard i - 1, my last ones the
        # lo halo of shard i + 1
        j = i - 1 if side == 0 else i + 1
        start = 0 if side == 0 else blk.shape[dim] - border
        host = blk.narrow(dim, start, border).contiguous().cpu()
        staged.append(host)
        reqs.append(dist.isend(host, dst=int(owners[j]),
                               tag=tag + 2 * j + (1 - side)))
    for r in reqs:
        r.wait()
    for i, side, buf in remote:
        lo, hi = out[i]
        dev_buf = buf.to(blocks[i].device, non_blocking=False)
        out[i] = (dev_buf, hi) if side == 0 else (lo, dev_buf)
    EXCHANGE["seconds"] += time.perf_counter() - t0
    EXCHANGE["messages"] += len(staged)
    EXCHANGE["bytes"] += sum(h.numel() * h.element_size() for h in staged)
    return out


def pad_with_halos(blocks: list[torch.Tensor | None], border: int, lo_fill,
                   hi_fill, dim: int = 0, owners=None, tag: int = 0
                   ) -> list[torch.Tensor | None]:
    """Exchange along ``dim`` and return each block this process holds
    extended by ``border`` slices on both sides (``None`` for the
    others)."""
    halos = exchange_halo_1d(blocks, border, lo_fill, hi_fill, dim, owners,
                             tag)
    return [None if h is None else torch.cat([h[0], blk, h[1]], dim=dim)
            for blk, h in zip(blocks, halos)]


def gather_shards(shards: list[torch.Tensor | None], owners, shape, dtype,
                  device) -> list[torch.Tensor]:
    """Every shard on every rank: each shard another rank holds is
    broadcast from its owner (``owners[i]``) through the host and copied
    to ``device``; the shards of this process are returned as they are.
    Every shard has ``shape`` and ``dtype``.  In a gang every rank must
    call it with the same shards' layout; outside one it returns
    ``shards``."""
    from .multihost import process_info

    rank, world = process_info()
    if world == 1:
        return list(shards)
    import torch.distributed as dist

    out = []
    for s, owner in zip(shards, owners):
        owner = int(owner)
        if owner == rank:
            dist.broadcast(s.contiguous().cpu(), src=owner)
            out.append(s)
            continue
        buf = torch.empty(tuple(shape), dtype=dtype)
        dist.broadcast(buf, src=owner)
        out.append(buf.to(device))
    return out
