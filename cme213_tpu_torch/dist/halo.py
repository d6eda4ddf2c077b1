"""Halo exchange over the shards of one mesh axis, within a process and
across the ranks of a gang.

Counterpart of ``cme213_tpu/dist/halo.py``, which shifts ``border``-wide
slabs with ``lax.ppermute`` inside ``shard_map`` — itself the replacement of
the reference's ``MPI_Isend/Irecv`` row-band exchange
(``hw/hw5/programming/2dHeat.cpp:503-547``).  Here the shards along the
axis are a list of tensors, in mesh order, each on its own device (a
device may repeat).  A shard that another rank of the gang holds is
``None`` in the list, and ``owners`` names its rank.  An exchange takes
every line of shards along the axis at once (``exchange_halo_lines``).

- Between two shards of this process a slab is copied to the receiving
  shard's device (``Tensor.to(..., copy=True)``: the receiver owns its
  copy, as after a ``ppermute``), on the current stream of the devices
  involved; between two cards the copy goes peer to peer.
- Between shards of different ranks, under NCCL and for shards on the CPU,
  the slabs themselves travel as ONE ``dist.batch_isend_irecv`` list for
  the whole exchange (card to card under NCCL, no host staging).  NCCL
  ignores tags, and matches the messages between two ranks by their
  order, so both sides post them in the order ``exchange_plan`` derives
  from ``owners`` alone: every message of the exchange, receiving line,
  shard and side ascending.  One batch posts every receive and send
  together, so no order of blocking sends can deadlock the gang.
- Across ranks whose shards lie on cards under gloo, whose ops take CPU
  tensors, the sender copies its slab to the host (a synchronising copy,
  so the slab is whole before it is sent) and the receiver copies the host
  buffer to its device on the current stream; every receive and send of a
  line is posted before any is waited on, and a message's tag names the
  receiving shard and side.

A shard with no neighbour on a side lies on the physical boundary: its halo
on that side is the Dirichlet fill, keyed on the shard's index along the
axis, which replaces the reference's "-1 neighbour" case analysis
(``2dHeat.cpp:407-450``).
"""

from __future__ import annotations

import time

import torch

from .multihost import backend

#: the cross-rank exchanges of this process: their host-clock seconds
#: (copies to and from the host included), messages and bytes sent
EXCHANGE = {"seconds": 0.0, "messages": 0, "bytes": 0}


def exchange_plan(owners, rank: int) -> list[tuple[str, int, int, int, int]]:
    """The cross-rank messages of one exchange over lines of shards whose
    ranks are ``owners`` (a list of lines, each the owner of every shard
    along it), in the order ``rank`` posts them: ``(op, peer, line, shard,
    side)``, ``op`` ``"send"`` or ``"recv"``, where ``(line, shard, side)``
    names the halo the message fills (side 0: the shard's lower halo, from
    shard - 1; side 1: its upper one, from shard + 1).

    Every message of the exchange is listed once, receiving line, shard
    and side ascending, and each rank keeps those it sends or receives, so
    the messages between two ranks come in one order on both sides,
    whatever each rank holds; no tag is needed to match them."""
    plan = []
    for li, line in enumerate(owners):
        line = [int(o) for o in line]
        for i, dst in enumerate(line):
            for side, j in ((0, i - 1), (1, i + 1)):
                if not 0 <= j < len(line) or line[j] == dst:
                    continue
                if rank == dst:
                    plan.append(("recv", line[j], li, i, side))
                elif rank == line[j]:
                    plan.append(("send", dst, li, i, side))
    return plan


def _local_halos(blocks: list[torch.Tensor | None], border: int, lo_fill,
                 hi_fill, dim: int) -> list[list | None]:
    """``[lo_halo, hi_halo]`` for each shard this process holds (``None``
    for the others): the fill at a physical edge, a copy of a neighbour
    this process holds, ``None`` where another rank sends it."""
    n = len(blocks)
    out: list[list | None] = []
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
            else:
                nb = blocks[j]
                start = nb.shape[dim] - border if side == 0 else 0
                halo.append(nb.narrow(dim, start, border).to(
                    blk.device, non_blocking=True, copy=True))
        out.append(halo)
    return out


def _slab(blk: torch.Tensor, border: int, dim: int, side: int
          ) -> torch.Tensor:
    """The slab of ``blk`` that fills its neighbour's halo on ``side``
    (0: the upper neighbour's lower halo, the last ``border`` slices; 1:
    the lower neighbour's upper halo, the first ones)."""
    start = blk.shape[dim] - border if side == 0 else 0
    return blk.narrow(dim, start, border).contiguous()


def _sync_streams(devices) -> None:
    """Wait for the current stream of each CUDA device of ``devices``."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()


def _exchange_batched(lines, halos, border: int, dim: int, owners) -> None:
    """The cross-rank messages of every line as one batch of
    point-to-point ops in ``exchange_plan``'s order; fills the ``None``
    entries of ``halos``.  The clock runs from the slabs being ready to the
    received halos being on the card (the current streams synchronised
    before and after)."""
    import torch.distributed as dist

    from .multihost import collective, process_info

    ops, received, sent = [], [], []
    for op, peer, li, i, side in exchange_plan(owners, process_info()[0]):
        line = lines[li]
        if op == "recv":
            blk = line[i]
            shape = list(blk.shape)
            shape[dim] = border
            buf = torch.empty(shape, dtype=blk.dtype, device=blk.device)
            received.append((li, i, side, buf))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
        else:
            slab = _slab(line[i - 1 if side == 0 else i + 1], border, dim,
                         side)
            sent.append(slab)
            ops.append(dist.P2POp(dist.isend, slab, peer))
    if not ops:
        return
    devices = [b.device for line in lines for b in line if b is not None]
    _sync_streams(devices)
    t0 = time.perf_counter()
    with collective("halo exchange"):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        _sync_streams(devices)
    EXCHANGE["seconds"] += time.perf_counter() - t0
    for li, i, side, buf in received:
        halos[li][i][side] = buf
    EXCHANGE["messages"] += len(sent)
    EXCHANGE["bytes"] += sum(s.numel() * s.element_size() for s in sent)


def _exchange_staged(blocks, halos, border: int, dim: int, owners,
                     tag: int) -> None:
    """One line's cross-rank messages through host buffers (gloo with
    shards on a card), tagged ``tag + 2·shard + side``; fills the ``None``
    entries of ``halos``."""
    import torch.distributed as dist

    n = len(blocks)
    remote = []  # (shard, side, host buffer) received from another rank
    for i, blk in enumerate(blocks):
        if blk is None:
            continue
        for side in (0, 1):
            if halos[i][side] is None:
                shape = list(blk.shape)
                shape[dim] = border
                remote.append((i, side, torch.empty(shape, dtype=blk.dtype)))
    sends = [(i, side) for i, blk in enumerate(blocks) if blk is not None
             for side, j in ((0, i - 1), (1, i + 1))
             if 0 <= j < n and blocks[j] is None]
    if not (remote or sends):
        return
    t0 = time.perf_counter()
    reqs = [dist.irecv(buf, src=int(owners[i - 1 if side == 0 else i + 1]),
                       tag=tag + 2 * i + side)
            for i, side, buf in remote]
    staged = []
    for i, side in sends:
        # my first slices are the hi halo of shard i - 1, my last ones the
        # lo halo of shard i + 1
        j = i - 1 if side == 0 else i + 1
        host = _slab(blocks[i], border, dim, 1 - side).cpu()
        staged.append(host)
        reqs.append(dist.isend(host, dst=int(owners[j]),
                               tag=tag + 2 * j + (1 - side)))
    for r in reqs:
        r.wait()
    for i, side, buf in remote:
        halos[i][side] = buf.to(blocks[i].device, non_blocking=False)
    EXCHANGE["seconds"] += time.perf_counter() - t0
    EXCHANGE["messages"] += len(staged)
    EXCHANGE["bytes"] += sum(h.numel() * h.element_size() for h in staged)


def exchange_halo_lines(lines: list[list[torch.Tensor | None]], border: int,
                        lo_fill, hi_fill, dim: int = 0, owners=None,
                        tags=None
                        ) -> list[list[tuple[torch.Tensor, torch.Tensor]
                                       | None]]:
    """``exchange_halo_1d`` for every line of shards along one mesh axis
    at once: ``lines[l]`` is a line's shards, ``owners[l]`` their ranks
    and ``tags[l]`` its first message tag on the staged path.  Under NCCL,
    and for shards on the CPU, the cross-rank messages of all lines form
    one batch; on the staged path each line exchanges in turn.  Every rank
    holding a shard of any line must call it with the same ``owners`` and
    ``tags``."""
    halos = [_local_halos(line, border, lo_fill, hi_fill, dim)
             for line in lines]
    own = [b for line in lines for b in line if b is not None]
    if own and len(own) < sum(map(len, lines)):
        if backend() == "nccl" or own[0].device.type == "cpu":
            _exchange_batched(lines, halos, border, dim, owners)
        else:
            tags = tags or [0] * len(lines)
            for line, h, line_owners, tag in zip(lines, halos, owners, tags):
                _exchange_staged(line, h, border, dim, line_owners, tag)
    return [[None if h is None else tuple(h) for h in line]
            for line in halos]


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
    holds shard i where ``blocks[i]`` is ``None``; on the staged path the
    exchange with those ranks uses message tags ``tag`` to ``tag +
    2·len(blocks) - 1``, and every rank holding a neighbour of a shard here
    must call this with the same ``tag``.
    """
    return exchange_halo_lines([blocks], border, lo_fill, hi_fill, dim,
                               None if owners is None else [owners],
                               [tag])[0]


def pad_lines_with_halos(lines: list[list[torch.Tensor | None]],
                         border: int, lo_fill, hi_fill, dim: int = 0,
                         owners=None, tags=None
                         ) -> list[list[torch.Tensor | None]]:
    """Exchange every line along ``dim`` (``exchange_halo_lines``) and
    return each block this process holds extended by ``border`` slices on
    both sides (``None`` for the others)."""
    halos = exchange_halo_lines(lines, border, lo_fill, hi_fill, dim, owners,
                                tags)
    return [[None if h is None else torch.cat([h[0], blk, h[1]], dim=dim)
             for blk, h in zip(line, hl)] for line, hl in zip(lines, halos)]


def pad_with_halos(blocks: list[torch.Tensor | None], border: int, lo_fill,
                   hi_fill, dim: int = 0, owners=None, tag: int = 0
                   ) -> list[torch.Tensor | None]:
    """Exchange along ``dim`` and return each block this process holds
    extended by ``border`` slices on both sides (``None`` for the
    others)."""
    return pad_lines_with_halos([blocks], border, lo_fill, hi_fill, dim,
                                None if owners is None else [owners],
                                [tag])[0]


def gather_shards(shards: list[torch.Tensor | None], owners, shape, dtype,
                  device) -> list[torch.Tensor]:
    """Every shard on every rank: each shard another rank holds is
    broadcast from its owner (``owners[i]``) and lands on ``device``; the
    shards of this process are returned as they are.  Under NCCL the
    owner broadcasts its tensor on its card, card to card; under gloo
    through the host.  Every shard has ``shape`` and ``dtype``.  In a gang
    every rank must call it with the same shards' layout; outside one it
    returns ``shards``."""
    from .multihost import collective, process_info

    rank, world = process_info()
    if world == 1:
        return list(shards)
    import torch.distributed as dist

    nccl = backend() == "nccl"
    out = []
    with collective("gather"):
        for s, owner in zip(shards, owners):
            owner = int(owner)
            if owner == rank:
                dist.broadcast(s.contiguous() if nccl else s.contiguous().cpu(),
                               src=owner)
                out.append(s)
                continue
            buf = torch.empty(tuple(shape), dtype=dtype,
                              device=device if nccl else "cpu")
            dist.broadcast(buf, src=owner)
            out.append(buf if nccl else buf.to(device))
    return out
