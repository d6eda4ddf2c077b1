"""Device mesh of a multi-shard run — the topology layer.

Counterpart of ``cme213_tpu/dist/mesh.py``.  The JAX package runs over a
``jax.sharding.Mesh`` and ``shard_map``; the port runs over a ``Mesh`` of
torch devices and keeps one tensor per shard, in mesh order.  A device may
appear more than once (``core.platform.virtual_devices``): the shards then
share it, as the JAX package's tests share the host among virtual CPU
devices.  Neighbour relations are not stored; ``halo.py`` reads them off
the shard's index along an axis, as the JAX package reads
``lax.axis_index``.

In a gang (``dist/multihost.py``) a mesh spans every rank: its shards are
laid out rank-major, each rank's own shards next to each other (the
reference's "fill each node first" placement,
``cme213_tpu/dist/multihost.py:11-14``), and ``Mesh.owners`` names the
rank that holds each one.  A rank holds tensors for its own shards only.
Outside a gang rank 0 owns every shard.

Decompositions follow the reference's rank topology: 1-D stripes
(``hw/hw5/programming/2dHeat.cpp:284-307``) and 2-D blocks (``:308-377``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config import GridMethod
from ..core.platform import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``, shape ``(py,)``
    or ``(py, px)``; ``axis_names``: one name per dimension; ``owners``:
    the rank holding each shard, the shape of ``devices`` (all 0 outside a
    gang); ``rank``: this process's rank.  The entries of ``devices`` for
    another rank's shards name the device that rank uses on a host like
    this one, and only their owner touches them."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    owners: np.ndarray | None = None
    rank: int = 0

    def __post_init__(self):
        if self.owners is None:
            object.__setattr__(self, "owners",
                               np.zeros(self.devices.shape, dtype=np.int64))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_devices(self) -> list[torch.device]:
        """The distinct devices of this process's own shards."""
        return list(dict.fromkeys(
            d for d, o in zip(self.devices.flat, self.owners.flat)
            if int(o) == self.rank))


def default_devices(device=None) -> list[torch.device]:
    """The devices a mesh takes by default: every CUDA device, or the CPU
    when ``device`` asks for it.  In a gang, or under ``dist.launch
    --devices-per-proc N`` (``CME213_DEVICES_PER_PROC``), world × N
    entries, rank-major: rank r's N shards share its device (``cuda:r``
    modulo the cards here, or the CPU).  Raises (``resolve_device``) when
    CUDA is asked for and absent."""
    from .multihost import devices_per_proc, process_info

    dev = resolve_device(device)
    _, world = process_info()
    per = devices_per_proc()
    if world == 1 and per is None:
        if dev.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [dev]

    def rank_device(r: int) -> torch.device:
        if dev.type != "cuda" or dev.index is not None:
            return dev
        return torch.device("cuda", r % torch.cuda.device_count())

    return [rank_device(r) for r in range(world) for _ in range(per or 1)]


def _make(devices: list, n: int, shape: tuple[int, ...],
          axes: tuple[str, ...]) -> Mesh:
    """A mesh over the first ``n`` of ``devices``.  In a gang ``devices``
    is the gang's rank-major list (``default_devices``): its length divides
    by the world size, shard i belongs to rank i // (length / world), and
    every rank holds a shard."""
    from .multihost import process_info

    rank, world = process_info()
    owners = np.zeros(n, dtype=np.int64)
    if world > 1:
        if len(devices) % world:
            raise ValueError(
                f"a gang of {world} ranks needs a device list of world x "
                f"shards-per-rank entries, got {len(devices)}")
        owners = np.arange(n, dtype=np.int64) // (len(devices) // world)
        if n == 0 or owners[-1] != world - 1:
            raise ValueError(f"a mesh of {n} shards leaves a rank of the "
                             f"gang of {world} without a shard")
    return Mesh(_device_array(devices, n).reshape(shape), axes,
                owners.reshape(shape), rank)


def _device_array(devices, n: int) -> np.ndarray:
    """The first ``n`` devices as an object array, each a ``torch.device``
    with its index, as a tensor on it reports its device."""
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        arr[i] = d
    return arr


def make_mesh_1d(num_devices: int | None = None, axis: str = "y",
                 devices=None) -> Mesh:
    """1-D stripe decomposition mesh (hw5 gridMethod=1)."""
    devices = list(devices if devices is not None else default_devices())
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return _make(devices, n, (n,), (axis,))


def make_mesh_2d(py: int, px: int, axes: tuple[str, str] = ("y", "x"),
                 devices=None) -> Mesh:
    """2-D block decomposition mesh (hw5 gridMethod=2).  Any py×px
    rectangle is allowed; the reference's square rank count
    (``2dHeat.cpp:316``) was an MPI bookkeeping simplification."""
    devices = list(devices if devices is not None else default_devices())
    if py * px > len(devices):
        raise ValueError(f"need {py * px} devices, have {len(devices)}")
    return _make(devices, py * px, (py, px), axes)


def mesh_for_method(method: GridMethod, num_devices: int | None = None,
                    devices=None) -> Mesh:
    """The mesh a ``SimParams.grid_method`` asks for.  For BLOCKS_2D a
    near-square py×px factorization of the device count (square when the
    count is a perfect square, the reference's √P×√P)."""
    devices = list(devices if devices is not None else default_devices())
    n = num_devices or len(devices)
    if method == GridMethod.STRIPES_1D:
        return make_mesh_1d(n, devices=devices)
    py = int(math.isqrt(n))
    while n % py:
        py -= 1
    return make_mesh_2d(py, n // py, devices=devices)
