"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Counterpart of ``cme213_tpu/native/build.py``.  At the first launch on a
CUDA tensor, ``nvcc`` compiles ``csrc/heat_stencil.cu`` for Hopper into a
shared library with a plain C interface under ``core.platform.BUILD_DIR``,
keyed by a hash of the source and the flags, and ``ctypes`` loads it.
Importing this module builds nothing, so the CPU tests import it without a
toolchain; a missing ``nvcc`` or a failed build raises ``FrameworkError``
at that first launch.  Nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..core.errors import FrameworkError
from ..core.platform import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "heat_stencil.cu"

#: ``--fmad=false``: no multiply-add contraction anywhere in the library
#: (the kernel also spells every operation with a round-to-nearest
#: intrinsic); ``-Xptxas -v`` writes registers, shared memory and spills of
#: each kernel into the build log beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise FrameworkError(
        "nvcc not found (PATH, CUDA_HOME, CUDA_PATH, /usr/local/cuda): the "
        f"CUDA kernels are built from {SOURCE.name} at first use on a CUDA "
        "tensor")


def library_path() -> Path:
    """Path of the built library for the current source and flags."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{SOURCE.stem}-{tag}.so"


def build() -> Path:
    """Compile the source unless the library for it already exists.

    The compiler's output (``-Xptxas -v``) goes to a ``.log`` beside the
    library.  Raises ``FrameworkError`` when ``nvcc`` is missing or fails.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise FrameworkError(
            f"nvcc failed on {SOURCE.name} (rc {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, real in (("heat_ksteps_f32", ctypes.c_float),
                           ("heat_ksteps_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 11 + [real] * 6
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.heat_error_string.argtypes = [ctypes.c_int]
        lib.heat_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def heat_ksteps(src: torch.Tensor, dst: torch.Tensor, *, order: int, k: int,
                tile_y: int, tile_x: int, smem_bytes: int, ny: int, nx: int,
                xcfl: float, ycfl: float,
                bc: tuple[float, float, float, float], gy0: int = 0,
                gx0: int = 0) -> None:
    """Enqueue one launch of ``csrc/heat_stencil.cu:heat_ksteps``: ``k``
    fused heat steps from ``src`` into ``dst`` on the current stream.

    ``src`` and ``dst`` are distinct contiguous (H, W) float32/float64
    tensors on one CUDA device; ``(gy0, gx0)`` are the global halo-grid
    coordinates of element [0, 0] and ``(ny, nx)`` the global interior
    extents, which place the Dirichlet bands.  ``smem_bytes`` is the
    block's shared memory (``stencil_pipeline.smem_bytes``).  Raises
    ``FrameworkError`` when the launch is refused.
    """
    if not (src.is_cuda and dst.device == src.device):
        raise ValueError("heat_ksteps takes two tensors on one CUDA device")
    if src.dtype not in (torch.float32, torch.float64) \
            or dst.dtype != src.dtype:
        raise TypeError(f"heat_ksteps takes float32 or float64 grids, got "
                        f"{src.dtype} -> {dst.dtype}")
    if src.dim() != 2 or dst.shape != src.shape:
        raise ValueError(f"heat_ksteps takes two equal 2-D grids, got "
                         f"{tuple(src.shape)} -> {tuple(dst.shape)}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("heat_ksteps takes contiguous grids")
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("heat_ksteps cannot update a grid in place")
    lib = library()
    fn = lib.heat_ksteps_f32 if src.dtype == torch.float32 \
        else lib.heat_ksteps_f64
    H, W = src.shape
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), dst.data_ptr(), H, W, gy0, gx0, ny, nx,
                 order, k, tile_y, tile_x, smem_bytes, xcfl, ycfl, *bc,
                 stream)
    if err != 0:
        raise FrameworkError(
            f"heat_ksteps launch failed: "
            f"{lib.heat_error_string(err).decode()} (cudaError {err}; "
            f"order={order} k={k} tile={tile_y}x{tile_x} grid={H}x{W} "
            f"{src.dtype})")
