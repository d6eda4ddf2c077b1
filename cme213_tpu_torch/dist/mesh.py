"""Device mesh of a single-process, multi-shard run — the topology layer.

Counterpart of ``cme213_tpu/dist/mesh.py``.  The JAX package runs one
process over a ``jax.sharding.Mesh`` and ``shard_map``; the port runs one
process over a ``Mesh`` of torch devices and keeps one tensor per shard,
in mesh order.  A device may appear more than once
(``core.platform.virtual_devices``): the shards then share it, as the JAX
package's tests share the host among virtual CPU devices.  Neighbour
relations are not stored; ``halo.py`` reads them off the shard's index
along an axis, as the JAX package reads ``lax.axis_index``.

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
    or ``(py, px)``; ``axis_names``: one name per dimension."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def default_devices(device=None) -> list[torch.device]:
    """The physical devices a mesh takes by default: every CUDA device, or
    the CPU when ``device`` asks for it.  Raises (``resolve_device``) when
    CUDA is asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


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
    return Mesh(_device_array(devices, n), (axis,))


def make_mesh_2d(py: int, px: int, axes: tuple[str, str] = ("y", "x"),
                 devices=None) -> Mesh:
    """2-D block decomposition mesh (hw5 gridMethod=2).  Any py×px
    rectangle is allowed; the reference's square rank count
    (``2dHeat.cpp:316``) was an MPI bookkeeping simplification."""
    devices = list(devices if devices is not None else default_devices())
    if py * px > len(devices):
        raise ValueError(f"need {py * px} devices, have {len(devices)}")
    return Mesh(_device_array(devices, py * px).reshape(py, px), axes)


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
