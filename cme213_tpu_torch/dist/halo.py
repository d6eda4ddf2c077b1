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
- Between shards of different ranks the slabs travel as ONE
  ``dist.batch_isend_irecv`` list for the whole exchange, on every
  backend.  NCCL ignores tags, and matches the messages between two ranks
  by their order, so both sides post them in the order ``exchange_plan``
  derives from ``owners`` alone: every message of the exchange, receiving
  line, shard and side ascending.  One batch posts every receive and send
  together, so no order of blocking sends can deadlock the gang.  Under
  NCCL a slab goes card to card; under gloo, whose ops take CPU tensors, a
  card's slab goes through the host (``_through_host``).

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
#: (from the streams' sync to the halos on their devices, copies to and
#: from the host included), messages and bytes sent
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


def _through_host(device) -> bool:
    """Whether a cross-rank message to or from a tensor on ``device``
    goes through a host buffer: under a backend other than NCCL (gloo,
    whose ops take CPU tensors) for a CUDA device."""
    return backend() != "nccl" and torch.device(device).type == "cuda"


def _exchange_batched(lines, halos, border: int, dim: int, owners) -> None:
    """The cross-rank messages of every line as one batch of
    point-to-point ops in ``exchange_plan``'s order; fills the ``None``
    entries of ``halos``.  A message whose shard lies on a card under gloo
    goes through the host: its slab is copied there (a synchronising copy,
    so it is whole before it is posted), its receive lands in a host
    buffer copied to the card once the batch completes.  The clock runs
    from the current streams being synchronised to the received halos
    being on their devices (the host copies inside)."""
    import torch.distributed as dist

    from .multihost import collective, process_info

    plan = exchange_plan(owners, process_info()[0])
    if not plan:
        return
    # each message's tensor, in plan order: the receive buffer or the slab
    tensors = []
    for op, _, li, i, side in plan:
        if op == "recv":
            blk = lines[li][i]
            shape = list(blk.shape)
            shape[dim] = border
            tensors.append(torch.empty(
                shape, dtype=blk.dtype,
                device="cpu" if _through_host(blk.device) else blk.device))
        else:
            tensors.append(_slab(lines[li][i - 1 if side == 0 else i + 1],
                                 border, dim, side))
    devices = [b.device for line in lines for b in line if b is not None]
    _sync_streams(devices)
    t0 = time.perf_counter()
    with collective("halo exchange"):
        posted = [t.cpu() if op == "send" and _through_host(t.device) else t
                  for (op, *_), t in zip(plan, tensors)]
        reqs = dist.batch_isend_irecv(
            [dist.P2POp(dist.irecv if op == "recv" else dist.isend, t, peer)
             for (op, peer, *_), t in zip(plan, posted)])
        for req in reqs:
            req.wait()
        for (op, _, li, i, side), t in zip(plan, posted):
            if op == "recv":
                halos[li][i][side] = t.to(lines[li][i].device)
        _sync_streams(devices)
    EXCHANGE["seconds"] += time.perf_counter() - t0
    sent = [t for (op, *_), t in zip(plan, tensors) if op == "send"]
    EXCHANGE["messages"] += len(sent)
    EXCHANGE["bytes"] += sum(s.numel() * s.element_size() for s in sent)


def exchange_halo_lines(lines: list[list[torch.Tensor | None]], border: int,
                        lo_fill, hi_fill, dim: int = 0, owners=None
                        ) -> list[list[tuple[torch.Tensor, torch.Tensor]
                                       | None]]:
    """``exchange_halo_1d`` for every line of shards along one mesh axis
    at once: ``lines[l]`` is a line's shards and ``owners[l]`` their
    ranks.  The cross-rank messages of all lines form one batch
    (``_exchange_batched``).  Every rank holding a shard of any line must
    call it with the same ``owners``."""
    halos = [_local_halos(line, border, lo_fill, hi_fill, dim)
             for line in lines]
    own = [b for line in lines for b in line if b is not None]
    if own and len(own) < sum(map(len, lines)):
        _exchange_batched(lines, halos, border, dim, owners)
    return [[None if h is None else tuple(h) for h in line]
            for line in halos]


def exchange_halo_1d(blocks: list[torch.Tensor | None], border: int,
                     lo_fill, hi_fill, dim: int = 0, owners=None
                     ) -> list[tuple[torch.Tensor, torch.Tensor] | None]:
    """Exchange ``border``-wide slabs along tensor dim ``dim`` between
    neighbouring shards of ``blocks``.

    Returns ``(lo_halo, hi_halo)`` for each shard this process holds
    (``None`` for the others): ``lo_halo`` is the lower neighbour's last
    ``border`` slices (``lo_fill`` for shard 0), ``hi_halo`` the upper
    neighbour's first ``border`` slices (``hi_fill`` for the last shard).
    Each halo lies on its shard's device.  ``owners[i]`` is the rank that
    holds shard i where ``blocks[i]`` is ``None``.
    """
    return exchange_halo_lines([blocks], border, lo_fill, hi_fill, dim,
                               None if owners is None else [owners])[0]


def pad_lines_with_halos(lines: list[list[torch.Tensor | None]],
                         border: int, lo_fill, hi_fill, dim: int = 0,
                         owners=None) -> list[list[torch.Tensor | None]]:
    """Exchange every line along ``dim`` (``exchange_halo_lines``) and
    return each block this process holds extended by ``border`` slices on
    both sides (``None`` for the others)."""
    halos = exchange_halo_lines(lines, border, lo_fill, hi_fill, dim, owners)
    return [[None if h is None else torch.cat([h[0], blk, h[1]], dim=dim)
             for blk, h in zip(line, hl)] for line, hl in zip(lines, halos)]


def pad_with_halos(blocks: list[torch.Tensor | None], border: int, lo_fill,
                   hi_fill, dim: int = 0, owners=None
                   ) -> list[torch.Tensor | None]:
    """Exchange along ``dim`` and return each block this process holds
    extended by ``border`` slices on both sides (``None`` for the
    others)."""
    return pad_lines_with_halos([blocks], border, lo_fill, hi_fill, dim,
                                None if owners is None else [owners])[0]


def gather_shards(shards: list[torch.Tensor | None], owners, shape, dtype,
                  device) -> list[torch.Tensor]:
    """Every shard on every rank: each shard another rank holds is
    broadcast from its owner (``owners[i]``) and lands on ``device``; the
    shards of this process are returned as they are.  Under NCCL the
    owner broadcasts its tensor on its card, card to card; under gloo a
    card's shard goes through the host (``_through_host``).  Every shard
    has ``shape`` and ``dtype``.  In a gang every rank must call it with
    the same shards' layout; outside one it returns ``shards``."""
    from .multihost import collective, process_info

    rank, world = process_info()
    if world == 1:
        return list(shards)
    import torch.distributed as dist

    host = _through_host(device)
    out = []
    with collective("gather"):
        for s, owner in zip(shards, owners):
            owner = int(owner)
            if owner == rank:
                payload = s.contiguous()
                dist.broadcast(payload.cpu() if _through_host(s.device)
                               else payload, src=owner)
                out.append(s)
                continue
            buf = torch.empty(tuple(shape), dtype=dtype,
                              device="cpu" if host else device)
            dist.broadcast(buf, src=owner)
            out.append(buf.to(device) if host else buf)
    return out
