"""Multi-device segmented scan — long-sequence parallelism.

Counterpart of ``cme213_tpu/dist/scan.py``: the reference's block-scan
decomposition (``hw/hw4/programming/radixsort.cpp:44-108``) at mesh scale.
A sequence cut into one shard per device of a mesh axis is scanned per
shard (the plain ``ops.segmented.segmented_scan``, as the JAX package
leaves it to XLA), the shard carries are combined with the segmented-scan
operator across shards, and each shard adds its incoming carry to the
elements before its first segment head.  A process holds its shards as a
list of tensors in mesh order, each on its device; in a gang a shard
another rank holds is ``None`` there, each rank scans its own shards, and
the (value, flag) carry of every shard reaches every rank through the
gang's group (``halo.gather_shards``: card to card under NCCL, through the
host under gloo), so every rank combines all
carries in the same order and a gang gives the single-process mesh's bits.

Two carry-combine backends, with the JAX package's association:

- ``ring`` (default): the segmented Hillis–Steele sweep over the shard
  axis, log2(P) rounds of distance-d shifts (``lax.ppermute`` there, a
  copy to the receiving shard's device here);
- ``gather``: every carry to one device and an unrolled exclusive prefix
  (``lax.all_gather`` there), fine for small P.
"""

from __future__ import annotations

import torch

from ..ops.segmented import segmented_scan
from .halo import gather_shards
from .mesh import Mesh
from .multihost import process_info


def _axis_index(mesh: Mesh, axis_name: str | None) -> tuple:
    """The index of the shards along ``axis_name`` (default the first
    axis), the other axes at 0: the shards of a sequence cut over that
    axis."""
    axis = mesh.axis_names.index(axis_name or mesh.axis_names[0])
    index = [0] * mesh.devices.ndim
    index[axis] = slice(None)
    return tuple(index)


def _axis_devices(mesh: Mesh, axis_name: str | None) -> list[torch.device]:
    return list(mesh.devices[_axis_index(mesh, axis_name)])


def _axis_owners(mesh: Mesh, axis_name: str | None) -> list[int]:
    return [int(o) for o in mesh.owners[_axis_index(mesh, axis_name)]]


def _first_own(shards: list) -> torch.Tensor:
    return next(s for s in shards if s is not None)


def _all_shards(shards: list, owners) -> list[torch.Tensor]:
    """Every shard of the sequence on every rank (``halo.gather_shards``);
    the shards of this process as they are."""
    own = _first_own(shards)
    return gather_shards(shards, owners, own.shape, own.dtype, own.device)


def _carry_gather(carry_v: list[torch.Tensor], carry_f: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
    """Exclusive segmented prefix of the shard carries: all of them on the
    first shard's device, an unrolled combine, each prefix sent back."""
    dev = carry_v[0].device
    vs = [v.to(dev) for v in carry_v]
    fs = [f.to(dev) for f in carry_f]
    prefixes_v = [torch.zeros_like(vs[0])]
    for j in range(len(vs) - 1):
        pv = prefixes_v[-1]
        prefixes_v.append(vs[j] + torch.where(fs[j] > 0,
                                              torch.zeros_like(pv), pv))
    return [p.to(v.device) for p, v in zip(prefixes_v, carry_v)]


def _carry_ring(carry_v: list[torch.Tensor], carry_f: list[torch.Tensor]
                ) -> list[torch.Tensor]:
    """Exclusive segmented prefix of the shard carries by log2(P)
    distance-d shifts.  A shard with no source at distance d adds 0 and
    keeps its flag, as ``ppermute``'s zero fill does in the JAX package."""
    inc_v, inc_f = list(carry_v), list(carry_f)  # inclusive through shard i
    n = len(inc_v)
    d = 1
    while d < n:
        new_v, new_f = [], []
        for i in range(n):
            v, f = inc_v[i], inc_f[i]
            if i >= d:
                pv = inc_v[i - d].to(v.device)
                pf = inc_f[i - d].to(v.device)
                new_v.append(v + torch.where(f == 0, pv,
                                             torch.zeros_like(pv)))
                new_f.append(f | pf)
            else:
                new_v.append(v + torch.zeros_like(v))
                new_f.append(f)
        inc_v, inc_f = new_v, new_f
        d *= 2
    # exclusive = inclusive of the previous shard, shifted one along
    return [torch.zeros_like(inc_v[0])] + [
        inc_v[i - 1].to(inc_v[i].device) for i in range(1, n)]


def _local_with_carry(values: list[torch.Tensor | None],
                      flags: list[torch.Tensor | None],
                      carry_mode: str = "ring", owners=None
                      ) -> list[torch.Tensor | None]:
    local = [None if v is None else segmented_scan(v, f)
             for v, f in zip(values, flags)]
    # shard carry: (last partial sum, does the shard hold a head?)
    carry_v = [None if s is None else s[-1] for s in local]
    carry_f = [None if f is None else f.max().to(torch.int32) for f in flags]
    if owners is not None and process_info()[1] > 1:
        # every shard's carry on every rank, packed as (value, flag) in
        # float64, which holds both exactly
        dtype = _first_own(carry_v).dtype
        packed = _all_shards(
            [None if v is None else torch.stack([v.double(), f.double()])
             for v, f in zip(carry_v, carry_f)], owners)
        carry_v = [p[0].to(dtype) for p in packed]
        carry_f = [p[1].to(torch.int32) for p in packed]
    combine = _carry_ring if carry_mode == "ring" else _carry_gather
    incoming = combine(carry_v, carry_f)
    # the incoming open segment covers the positions before the first head
    # (JAX's cummax(flags) == 0; a cumsum of the 0/1 flags says the same,
    # and torch's cummax of one long row runs in a single CUDA block)
    out = []
    for s, f, c in zip(local, flags, incoming):
        if s is None:
            out.append(None)
            continue
        no_head_yet = torch.cumsum(f, dim=0) == 0
        out.append(s + torch.where(no_head_yet, c, torch.zeros_like(c)))
    return out


def shard_1d(x: torch.Tensor, mesh: Mesh,
             axis_name: str | None = None) -> list[torch.Tensor | None]:
    """Cut ``x`` into equal shards along dim 0, each this process owns
    copied to its device of the mesh axis (``None`` for another rank's).
    Raises ``ValueError`` when the length does not divide."""
    devices = _axis_devices(mesh, axis_name)
    owners = _axis_owners(mesh, axis_name)
    if x.shape[0] % len(devices):
        raise ValueError("sequence length must divide over the mesh axis")
    return [c.to(d, copy=True) if o == mesh.rank else None
            for c, d, o in zip(torch.chunk(x, len(devices)), devices,
                               owners)]


def unshard_1d(shards: list[torch.Tensor | None], mesh: Mesh,
               axis_name: str | None = None) -> torch.Tensor:
    """The inverse of ``shard_1d``: the whole sequence on the first own
    shard's device, on every rank of a gang (the shards of other ranks
    come from their owners)."""
    out = _all_shards(shards, _axis_owners(mesh, axis_name))
    dev = _first_own(shards).device
    return torch.cat([s.to(dev) for s in out])


def make_iterated_sharded_scan(mesh: Mesh, axis_name: str | None = None,
                               carry_mode: str = "ring"):
    """The iterated form of the sharded scan — the ``a ← segmented_scan(a
    · xx)`` loop of ``apps/spmv_scan`` over shards.

    Returns ``iterate(a, xx, flags, iters)``; each argument is a list of
    shards (``shard_1d``) over ``axis_name``, and so is the result (the
    shards this process holds; ``None`` for another rank's).  The shards
    of ``a`` are not modified.
    """
    if carry_mode not in ("ring", "gather"):
        raise ValueError(f"unknown carry_mode {carry_mode!r}")
    owners = _axis_owners(mesh, axis_name)

    def iterate(a, xx, flags, iters: int):
        for _ in range(iters):
            a = _local_with_carry([None if v is None else v * w
                                   for v, w in zip(a, xx)], flags,
                                  carry_mode, owners)
        return a

    return iterate


def make_iterated_sharded_scan_gated(mesh: Mesh,
                                     axis_name: str | None = None):
    """``make_iterated_sharded_scan`` behind the conformance gate.

    The carry-combine backends form a ladder, ``ring`` (log-P shifts, the
    fast path) demoting to ``gather`` (one device combines), and each
    mode's first use per process is probed: a small deterministic sharded
    scan against the single-device ``segmented_scan_flat`` on the first
    shard's device, to the iterated-scan tolerance (rel-L2 1e-5; both
    modes reorder the carry combine, so bitwise is not their contract).  A
    mode whose probe diverges (``CME213_FAULTS=wrong:dist_scan``) is
    demoted with ``WRONG_ANSWER`` before it serves.  Returns ``(iterate,
    carry_mode)``."""
    import numpy as np

    from ..core.platform import build_identity
    from ..core.resilience import with_fallback
    from ..ops.segmented import segmented_scan_flat
    from .multihost import agreed_check

    devices = _axis_devices(mesh, axis_name)
    local = mesh.local_devices()[0]
    n = 64 * len(devices)

    def probe_inputs():
        values = torch.from_numpy(
            np.sin(np.arange(n, dtype=np.float32)) + np.float32(0.5))
        flags = torch.from_numpy((np.arange(n) % 23 == 0).astype(np.int32))
        return values, flags

    def gate(mode: str) -> bool:
        def probe():
            values, flags = probe_inputs()
            return distributed_segmented_scan(values, flags, mesh,
                                              axis_name, carry_mode=mode)

        def reference():
            values, flags = probe_inputs()
            return segmented_scan_flat(values.to(local), flags.to(local))

        # in a gang every rank runs the probe (its carries cross ranks)
        # and all take one verdict
        return agreed_check(
            "dist_scan", mode, f"p{len(devices)}/{build_identity(local)}",
            candidate=probe, reference=reference, rel_l2=1e-5)

    res = with_fallback(
        "dist_scan",
        [(mode, lambda m=mode: make_iterated_sharded_scan(
            mesh, axis_name, carry_mode=m)) for mode in ("ring", "gather")],
        gate=gate)
    return res.value, res.rung


def distributed_segmented_scan(values: torch.Tensor, head_flags: torch.Tensor,
                               mesh: Mesh, axis_name: str | None = None,
                               carry_mode: str = "ring") -> torch.Tensor:
    """Segmented inclusive scan of a sequence sharded over one mesh axis.

    ``len(values)`` must divide evenly over the axis.  Returns the whole
    scanned sequence on the first own shard's device (on every rank of a
    gang).  ``carry_mode``: ``"ring"`` (log-P shift sweep) or
    ``"gather"`` (one device combines).
    """
    v = shard_1d(values, mesh, axis_name)
    f = shard_1d(head_flags.to(torch.int32), mesh, axis_name)
    if carry_mode not in ("ring", "gather"):
        raise ValueError(f"unknown carry_mode {carry_mode!r}")
    return unshard_1d(_local_with_carry(v, f, carry_mode,
                                        _axis_owners(mesh, axis_name)),
                      mesh, axis_name)
