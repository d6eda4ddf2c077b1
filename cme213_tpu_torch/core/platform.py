"""Device choice, the device preflight, the kernel build directory and the
card's identity.

Counterpart of ``cme213_tpu/core/platform.py``.  The port's entry points run
on ``cuda`` unless the caller asks for the CPU.  They never fall back to the
CPU on their own: with no device given and no CUDA device present,
:func:`resolve_device` raises, and :func:`device_preflight` answers False.

Three functions of the JAX package have no counterpart here.
``apply_platform_env`` re-applies ``JAX_PLATFORMS``, and torch has no
platform override to re-apply; ``enable_compile_cache`` turns on XLA's
persistent compilation cache, and torch has none (the CUDA kernels are
built once into ``BUILD_DIR`` and loaded from there by every later
process); ``force_cpu_devices`` splits the host into virtual XLA devices,
whose counterpart is :func:`virtual_devices`.
"""

from __future__ import annotations

import subprocess
import threading
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


def device_preflight(seconds: float = 90.0, device=None) -> bool:
    """True iff a trivial op on the device completes within ``seconds``.

    The device is ``device`` if given, else ``cuda``; with no CUDA device
    and no ``device`` the answer is False: the CPU is never probed in the
    card's place.  A ``CME213_FAULTS`` ``unreachable`` clause answers
    False first.  The op runs on a daemon thread that synchronises the
    device, and the caller waits at most ``seconds``, so a hung device
    yields False instead of a hung caller; an op that fails at once
    answers False at once.
    """
    from .faults import maybe_unreachable

    if maybe_unreachable("device.preflight"):
        return False
    try:
        dev = resolve_device(device)
    except RuntimeError:
        return False

    done = threading.Event()
    ok = [False]

    def probe():
        try:
            x = torch.ones((8, 8), device=dev) * 2
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ok[0] = bool(x.sum().item() == 128.0)
        except Exception:  # noqa: BLE001 — a failing device answers False
            pass
        finally:
            done.set()

    threading.Thread(target=probe, daemon=True,
                     name="device-preflight").start()
    return done.wait(seconds) and ok[0]


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
