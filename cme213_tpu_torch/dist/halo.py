"""Halo exchange over the shards of one mesh axis.

Counterpart of ``cme213_tpu/dist/halo.py``, which shifts ``border``-wide
slabs with ``lax.ppermute`` inside ``shard_map`` — itself the replacement of
the reference's ``MPI_Isend/Irecv`` row-band exchange
(``hw/hw5/programming/2dHeat.cpp:503-547``).  Here the shards along the
axis are a list of tensors, in mesh order, each on its own device (a
device may repeat).  A slab is copied to the receiving shard's device
(``Tensor.to(..., copy=True)``: the receiver owns its copy, as after a
``ppermute``), on the current stream of the devices involved.

A shard with no neighbour on a side lies on the physical boundary: its halo
on that side is the Dirichlet fill, keyed on the shard's index along the
axis, which replaces the reference's "-1 neighbour" case analysis
(``2dHeat.cpp:407-450``).
"""

from __future__ import annotations

import torch


def exchange_halo_1d(blocks: list[torch.Tensor], border: int, lo_fill,
                     hi_fill, dim: int = 0
                     ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Exchange ``border``-wide slabs along tensor dim ``dim`` between
    neighbouring shards of ``blocks``.

    Returns ``(lo_halo, hi_halo)`` for each shard: ``lo_halo`` is the lower
    neighbour's last ``border`` slices (``lo_fill`` for shard 0),
    ``hi_halo`` the upper neighbour's first ``border`` slices (``hi_fill``
    for the last shard).  Each halo lies on its shard's device.
    """
    n = len(blocks)
    out = []
    for i, blk in enumerate(blocks):
        shape = list(blk.shape)
        shape[dim] = border
        if i == 0:
            lo = torch.full(shape, lo_fill, dtype=blk.dtype,
                            device=blk.device)
        else:
            lo = blocks[i - 1].narrow(dim, blocks[i - 1].shape[dim] - border,
                                      border).to(blk.device,
                                                 non_blocking=True, copy=True)
        if i == n - 1:
            hi = torch.full(shape, hi_fill, dtype=blk.dtype,
                            device=blk.device)
        else:
            hi = blocks[i + 1].narrow(dim, 0, border).to(
                blk.device, non_blocking=True, copy=True)
        out.append((lo, hi))
    return out


def pad_with_halos(blocks: list[torch.Tensor], border: int, lo_fill,
                   hi_fill, dim: int = 0) -> list[torch.Tensor]:
    """Exchange along ``dim`` and return each block extended by ``border``
    slices on both sides."""
    halos = exchange_halo_1d(blocks, border, lo_fill, hi_fill, dim)
    return [torch.cat([lo, blk, hi], dim=dim)
            for blk, (lo, hi) in zip(blocks, halos)]
