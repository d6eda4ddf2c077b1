"""Device choice, the kernel build directory and the card's identity.

The port's entry points run on ``cuda`` unless the caller asks for the CPU.
They never fall back to the CPU on their own: with no device given and no
CUDA device present, :func:`resolve_device` raises.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

import torch

#: where ``ops/_kernels.py`` puts the shared libraries it compiles from
#: ``csrc/`` (listed in ``.gitignore``; rebuilt when a source changes)
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and is not available; the CPU is used only when asked for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (or --device=cpu) "
            "to run on the CPU")
    return dev


def virtual_devices(n: int, device=None) -> list[torch.device]:
    """``n`` entries naming one device (default ``cuda``, resolved by
    :func:`resolve_device`): a mesh over them puts ``n`` shards on one
    device.  Counterpart of ``cme213_tpu/core/platform.force_cpu_devices``,
    which splits the host into virtual devices; here the shards of a
    single-process mesh simply share the device."""
    return [resolve_device(device)] * n


def card_identity() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (``name, power.limit`` per line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
