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
  NCCL a slab goes card to card and the exchange makes no host wait: the
  streams order every step (the slab's copy before its send, the received
  halo before its first use).  There a batch whose messages (peers,
  shapes, dtype, card) were seen once is replayed as a CUDA graph of its
  NCCL sends and receives (``_Batch``), with buffers of its own, so the
  host's part of an exchange is a copy into the send buffers and a graph
  launch.  Under gloo, whose ops take CPU tensors, a card's slab goes
  through the host (``_through_host``), which waits for the card around
  it.

The exchange clock (``EXCHANGE["seconds"]``) is, on a card, a pair of
CUDA events on the current stream around each batch: the time from the
stream reaching the batch to the received halos being usable on it, the
wait for the peers included (and, under gloo, the host copies).  Each
pair is read once it has passed, at a later exchange or by
``settle_clock`` (after a solve's closing synchronise); on the CPU the
host clock times the batch.

A shard with no neighbour on a side lies on the physical boundary: its halo
on that side is the Dirichlet fill, keyed on the shard's index along the
axis, which replaces the reference's "-1 neighbour" case analysis
(``2dHeat.cpp:407-450``).

Given ``rings`` (``exchange_halo_lines``), the halos land in tensors the
caller holds, such as the ring of a padded block: each is filled, or
copied into from its neighbour or its receive buffer, and nothing is
allocated for it.
"""

from __future__ import annotations

import atexit
import math
import time

import torch

from ..core import metrics
from .multihost import backend

#: the cross-rank exchanges of this process: their seconds (the exchange
#: clock, the module's docstring), messages and bytes sent, and the host
#: synchronisations made inside them (none under NCCL);
#: ``dist.exchanges.<key>`` in the exit snapshot
EXCHANGE = {"seconds": 0.0, "messages": 0, "bytes": 0, "host_waits": 0}

#: the padded assemblies of the distributed heat step, one a step of a
#: process, by path: ``in_place`` (halos written into the ring of a padded
#: block that persists, ``dist/heat._assemble_in_place``) or ``cat`` (new
#: padded blocks concatenated, ``pad_lines_with_halos``);
#: ``dist.pads.<path>`` in the exit snapshot
PADS = {"in_place": 0, "cat": 0}

#: the clocks of exchanges on a card not yet read: ``(start, end)`` CUDA
#: events on the current stream (``settle_clock``)
_CLOCKS: list = []


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
                 hi_fill, dim: int, rings=None) -> list[list | None]:
    """``[lo_halo, hi_halo]`` for each shard this process holds (``None``
    for the others): the fill at a physical edge, a copy of a neighbour
    this process holds, ``None`` where another rank sends it.  With
    ``rings`` (a ``(lo, hi)`` pair of tensors a shard held here) the fill
    and the copy are written into the shard's pair, and the halos are
    those tensors; where another rank sends the halo, its ring stands in
    the list, for ``_exchange_batched`` to copy the halo into."""
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
            ring = None if rings is None else rings[i][side]
            if j < 0 or j >= n:
                fill = lo_fill if side == 0 else hi_fill
                halo.append(torch.full(shape, fill, dtype=blk.dtype,
                                       device=blk.device) if ring is None
                            else ring.fill_(fill))
            elif blocks[j] is None:
                halo.append(ring)
            else:
                slab = _slab(blocks[j], border, dim, side)
                halo.append(slab.to(blk.device, non_blocking=True, copy=True)
                            if ring is None
                            else ring.copy_(slab, non_blocking=True))
        out.append(halo)
    return out


def _slab(blk: torch.Tensor, border: int, dim: int, side: int
          ) -> torch.Tensor:
    """The slab of ``blk`` that fills its neighbour's halo on ``side``
    (0: the upper neighbour's lower halo, the last ``border`` slices; 1:
    the lower neighbour's upper halo, the first ones), a view."""
    start = blk.shape[dim] - border if side == 0 else 0
    return blk.narrow(dim, start, border)


def _sync_streams(devices) -> None:
    """Wait for the current stream of each CUDA device of ``devices``; each
    wait is one of ``EXCHANGE["host_waits"]``."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()
            EXCHANGE["host_waits"] += 1


def _through_host(device) -> bool:
    """Whether a cross-rank message to or from a tensor on ``device``
    goes through a host buffer, and so whether an exchange waits on the
    host for the card: under a backend other than NCCL (gloo, whose ops
    take CPU tensors) for a CUDA device.  Under NCCL, never."""
    return backend() != "nccl" and torch.device(device).type == "cuda"


def _clock_start(device):
    """Start an exchange's clock: an event on ``device``'s current stream,
    or the host clock on the CPU."""
    if device.type != "cuda":
        return time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    return start


def _clock_stop(device, start) -> None:
    """Stop the clock ``_clock_start`` started: on a card, an event
    recorded behind the exchange; the pairs whose end has passed are read
    at once (a query, not a wait), the others by a later exchange or
    ``settle_clock``, so the pairs pending never outnumber the exchanges
    the host runs ahead of the card."""
    if device.type != "cuda":
        EXCHANGE["seconds"] += time.perf_counter() - start
        return
    end = torch.cuda.Event(enable_timing=True)
    end.record(torch.cuda.current_stream(device))
    _CLOCKS.append((start, end))
    while _CLOCKS and _CLOCKS[0][1].query():
        _read_clock(*_CLOCKS.pop(0))


def _read_clock(start, end) -> None:
    """Add the seconds between two passed events to ``EXCHANGE``."""
    EXCHANGE["seconds"] += start.elapsed_time(end) / 1e3


def settle_clock() -> float:
    """Read every exchange clocked on a card and not yet read, and return
    ``EXCHANGE["seconds"]``.  It waits for the last of those exchanges to
    end, so a solve calls it after its closing synchronise, where nothing
    is left to wait for."""
    while _CLOCKS:
        start, end = _CLOCKS.pop(0)
        end.synchronize()
        _read_clock(start, end)
    return EXCHANGE["seconds"]


def _post(plan, tensors) -> None:
    """Post ``tensors`` (in ``exchange_plan``'s order, each message's
    receive buffer or slab) as one ``batch_isend_irecv`` and wait for it:
    under NCCL ``wait()`` orders the current stream behind the batch,
    under gloo it waits on the host."""
    import torch.distributed as dist

    reqs = dist.batch_isend_irecv(
        [dist.P2POp(dist.irecv if op == "recv" else dist.isend, t, peer)
         for (op, peer, *_), t in zip(plan, tensors)])
    for req in reqs:
        req.wait()


def _graphed(devices) -> bool:
    """Whether an exchange over shards on ``devices`` is replayed as a
    CUDA graph once its batch has been seen (``_Batch``): under NCCL, all
    of this process's shards on one card."""
    return (backend() == "nccl" and devices[0].type == "cuda"
            and len(set(devices)) == 1)


def _capture(post):
    """``post()`` captured as a CUDA graph on a side stream of the current
    card, and the graph's ``replay``, which runs it on the current stream.
    The capture runs nothing and waits for nothing on the host; other
    threads (NCCL's watchdog) may still use the card while it lasts."""
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            post()
        finally:
            graph.capture_end()
    current.wait_stream(side)
    return graph.replay


class _Batch:
    """The point-to-point batch of an exchange under NCCL, replayed as a
    CUDA graph: each message has a buffer of its own on the card (a
    slab is copied into its send buffer before the replay, a halo is
    received into its receive buffer) and the graph holds the batch's
    NCCL sends and receives and their waits (``_post``).  A key's first
    batch runs eagerly, which forms NCCL's connections to its peers
    before any capture; its second is captured and every later one
    replays.  The ranks run their exchanges in one order, so all capture
    and replay the same batches in step.

    A received halo is the batch's buffer, which its next replay
    rewrites; every use of it is enqueued on the current stream before
    that replay: ``pad_lines_with_halos``, or the copy into its ring,
    copies it at once.  The buffers and the graph live as long as the
    process's group (their key holds it) and are dropped at exit before
    the group is destroyed."""

    def __init__(self, plan, shapes, dtype, device):
        if not any(_BATCHES.values()):
            # the first graph: registered after the group's own exit hook
            # (``multihost._leave``), so it runs first
            atexit.register(_BATCHES.clear)
        self.tensors = [torch.empty(s, dtype=dtype, device=device)
                        for s in shapes]
        self.replay = _capture(lambda: _post(plan, self.tensors))


#: the batches of exchanges under NCCL by their messages (``_Batch``):
#: ``None`` once a key's first batch has run eagerly, then its ``_Batch``
_BATCHES: dict = {}


def _exchange_batched(lines, halos, border: int, dim: int, owners) -> None:
    """The cross-rank messages of every line as one batch of
    point-to-point ops in ``exchange_plan``'s order; sets each halo it
    receives in ``halos``, or copies it into the tensor standing there (a
    ring, ``exchange_halo_lines``).

    Under NCCL nothing here waits on the host.  ``batch_isend_irecv``
    orders NCCL's stream behind the current stream, where the slabs were
    cut, and ``wait()`` orders the current stream behind NCCL's, so the
    halos are whole before anything on it reads them (``ProcessGroupNCCL``
    also keeps each tensor of the batch from the caching allocator until
    then).  The slabs and receive buffers are dropped only after that
    ``wait()``, and the caching allocator hands a freed block out again
    only to work on the stream it was allocated on, which then runs
    behind the exchange.  A batch seen before replays as a CUDA graph on
    its own buffers (``_Batch``), in the same stream order.

    A message whose shard lies on a card under gloo goes through the host:
    the streams are synchronised, its slab is copied there (a synchronising
    copy), its receive lands in a host buffer copied to the card once the
    batch completes, and the streams are synchronised again."""
    import torch.distributed as dist

    from .multihost import collective, process_info

    plan = exchange_plan(owners, process_info()[0])
    if not plan:
        return
    # each message's block: the receiving shard's or the slab's source
    blocks = [lines[li][i] if op == "recv"
              else lines[li][i - 1 if side == 0 else i + 1]
              for op, _, li, i, side in plan]
    shapes = [(*b.shape[:dim], border, *b.shape[dim + 1:]) for b in blocks]
    devices = [b.device for line in lines for b in line if b is not None]
    batch = None
    if _graphed(devices):
        key = (dist.group.WORLD, blocks[0].dtype, devices[0],
               tuple((op, peer, s) for (op, peer, *_), s in zip(plan, shapes)))
        if key in _BATCHES:
            if _BATCHES[key] is None:
                _BATCHES[key] = _Batch(plan, shapes, blocks[0].dtype,
                                       devices[0])
            batch = _BATCHES[key]
        else:
            _BATCHES[key] = None
    if batch is not None:
        tensors = batch.tensors
        for (op, *_, side), t, b in zip(plan, tensors, blocks):
            if op == "send":
                t.copy_(_slab(b, border, dim, side))
    else:
        # each message's tensor, in plan order: the receive buffer or the
        # slab
        tensors = [
            torch.empty(s, dtype=b.dtype,
                        device="cpu" if _through_host(b.device) else b.device)
            if op == "recv" else _slab(b, border, dim, side).contiguous()
            for (op, *_, side), s, b in zip(plan, shapes, blocks)]
    waits = any(_through_host(d) for d in devices)
    if waits:
        _sync_streams(devices)
    start = _clock_start(devices[0])
    with collective("halo exchange"):
        if batch is not None:
            batch.replay()
            posted = tensors
        else:
            posted = []
            for (op, *_), t in zip(plan, tensors):
                if op == "send" and _through_host(t.device):
                    t = t.cpu()
                    EXCHANGE["host_waits"] += 1
                posted.append(t)
            _post(plan, posted)
        for (op, _, li, i, side), t in zip(plan, posted):
            if op == "recv":
                ring = halos[li][i][side]
                halos[li][i][side] = (t.to(lines[li][i].device)
                                      if ring is None else ring.copy_(t))
        if waits:
            _sync_streams(devices)
    _clock_stop(devices[0], start)
    sent = [s for (op, *_), s in zip(plan, shapes) if op == "send"]
    EXCHANGE["messages"] += len(sent)
    EXCHANGE["bytes"] += blocks[0].element_size() * sum(
        math.prod(s) for s in sent)


def exchange_halo_lines(lines: list[list[torch.Tensor | None]], border: int,
                        lo_fill, hi_fill, dim: int = 0, owners=None,
                        rings=None
                        ) -> list[list[tuple[torch.Tensor, torch.Tensor]
                                       | None]]:
    """``exchange_halo_1d`` for every line of shards along one mesh axis
    at once: ``lines[l]`` is a line's shards and ``owners[l]`` their
    ranks.  The cross-rank messages of all lines form one batch
    (``_exchange_batched``).  Every rank holding a shard of any line must
    call it with the same ``owners``.

    ``rings[l][i]``, for each shard this process holds, is a ``(lo, hi)``
    pair of tensors of the halos' shape on its device: the halos are
    written into them (filled at a physical edge, copied from a neighbour
    or a receive buffer) and returned, so nothing is allocated for them.
    No ring may overlap a shard of ``lines``, whose slabs are sent."""
    halos = [_local_halos(line, border, lo_fill, hi_fill, dim,
                          None if rings is None else rings[li])
             for li, line in enumerate(lines)]
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


def _record_exchanges() -> None:
    """At exit, add the process's cross-rank exchanges to the metrics
    registry as ``dist.exchanges.<key>`` counters (the seconds read so
    far as a gauge), and its padded assemblies as ``dist.pads.<path>``,
    as ``ops._record_launches`` adds its launches (registered after
    ``core/metrics``' exit snapshot, so it runs first); a process that
    exchanged or assembled nothing adds nothing of that."""
    if any(PADS.values()):
        for path, n in PADS.items():
            metrics.counter(f"dist.pads.{path}").inc(n)
    if not EXCHANGE["messages"]:
        return
    for key in ("messages", "bytes", "host_waits"):
        metrics.counter(f"dist.exchanges.{key}").inc(EXCHANGE[key])
    metrics.gauge("dist.exchanges.seconds").set(EXCHANGE["seconds"])


atexit.register(_record_exchanges)
