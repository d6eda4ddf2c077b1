"""Tiled matrix transpose: the hand-written Hopper kernel and the library
call.

Counterpart of ``cme213_tpu/ops/transpose.py``.  There the Pallas kernel
loads a (tile, tile) block into VMEM, transposes it on-chip and writes the
mirrored output block.  Here ``transpose_pallas`` launches
``csrc/transpose.cu``, the classic shared-memory transpose on 32 × 33
padded tiles; ``transpose_xla`` is one PyTorch call, ``x.t().contiguous()``,
as the JAX package's XLA row is ``jnp.transpose``, and is also the kernel's
plain version.

Dispatch is on the tensor's device: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel, and a failed build or launch raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _kernels

#: kernel launches
LAUNCHES = {"transpose": 0}


def transpose_xla(x: torch.Tensor) -> torch.Tensor:
    """``x.T`` as a new contiguous tensor: one PyTorch call."""
    return x.t().contiguous()


transpose_pallas_plain = transpose_xla


def transpose_pallas(x: torch.Tensor, tile: int = 256) -> torch.Tensor:
    """Transpose an (M, N) tensor of any dtype of 1, 2, 4 or 8 bytes.

    ``M`` and ``N`` must divide by ``tile``, the JAX kernel's contract.  On
    Hopper ``tile`` is not the shared-memory tile: a 256² f32 tile is
    256 KB and a block has 227 KB, so the kernel always moves 32 × 32
    tiles (which divide any ``tile`` the sweeps use) and ``tile`` is only
    checked.  The result equals ``x.t().contiguous()`` bit for bit.
    """
    if x.dim() != 2:
        raise ValueError(f"transpose_pallas takes a 2-D tensor, got "
                         f"{x.dim()}-D")
    m, n = x.shape
    if tile < 1 or m % tile or n % tile:
        raise ValueError(f"shape {m}x{n} must divide by tile={tile}")
    if x.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"no kernel for {x.dtype} ({x.element_size()} "
                        f"bytes an element)")
    if x.device.type == "cpu":
        return transpose_pallas_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    src = x.contiguous()
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    _kernels.transpose_tiles(src, out)
    LAUNCHES["transpose"] += 1
    return out
