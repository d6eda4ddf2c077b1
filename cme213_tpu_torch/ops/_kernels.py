"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Counterpart of ``cme213_tpu/native/build.py``.  Each source in ``csrc/`` is
compiled by ``nvcc`` for Hopper into its own shared library with a plain C
interface under ``core.platform.BUILD_DIR``, keyed by a hash of the source
and the flags, and loaded with ``ctypes``.  A library is built at the first
launch on a CUDA tensor that needs it; ``build()`` builds several at once,
one ``nvcc`` each, all started together.  Importing this module builds
nothing, so the CPU tests import it without a toolchain; a missing ``nvcc``
or a failed build raises ``FrameworkError`` at that first launch.  Nothing
falls back to another implementation.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"

#: library name -> its CUDA source
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("heat_stencil", "segmented_scan", "heat_band",
                        "transpose")}

#: ``--fmad=false``: no multiply-add contraction anywhere in the libraries
#: (the kernels also spell every operation with a round-to-nearest
#: intrinsic); ``-Xptxas -v`` writes registers, shared memory and spills of
#: each kernel into the build log beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


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
        "CUDA kernels are built from cme213_tpu_torch/csrc at first use on "
        "a CUDA tensor")


def library_path(name: str) -> Path:
    """Path of library ``name``'s build for the current source and flags."""
    tag = hashlib.sha256(SOURCES[name].read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named libraries (default: all) unless already built.

    One ``nvcc`` per missing library, all started together and all waited
    for.  The compiler's output (``-Xptxas -v``) goes to a ``.log`` beside
    each library.  Raises ``FrameworkError`` when ``nvcc`` is missing or any
    build fails.
    """
    names = names or tuple(SOURCES)
    out = {name: library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    failed = []
    try:
        for name in todo:
            tmp = out[name].with_name(f"{out[name].name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, (tmp, proc) in procs.items():
            stdout, stderr = proc.communicate()
            out[name].with_suffix(".log").write_text(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name].name} (rc "
                              f"{proc.returncode}):\n{stderr[-4000:]}")
            else:
                os.replace(tmp, out[name])  # atomic: all or nothing
    finally:  # an interrupted build leaves no compiler running
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise FrameworkError("nvcc failed on " + "\n".join(failed))
    return out


def _bind_heat_stencil(lib: ctypes.CDLL) -> None:
    for name, real in (("heat_ksteps_f32", ctypes.c_float),
                       ("heat_ksteps_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 11 + [real] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.heat_error_string.argtypes = [ctypes.c_int]
    lib.heat_error_string.restype = ctypes.c_char_p


def _bind_segmented_scan(lib: ctypes.CDLL) -> None:
    lib.segmented_scan_geometry.argtypes = [ctypes.c_void_p]
    lib.segmented_scan_geometry.restype = None
    lib.segmented_scan_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p])
    lib.segmented_scan_f32.restype = ctypes.c_int
    lib.segmented_scan_error_string.argtypes = [ctypes.c_int]
    lib.segmented_scan_error_string.restype = ctypes.c_char_p


def _bind_heat_band(lib: ctypes.CDLL) -> None:
    for name, real in (("heat_band_f32", ctypes.c_float),
                       ("heat_band_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 12 + [real] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.heat_band_error_string.argtypes = [ctypes.c_int]
    lib.heat_band_error_string.restype = ctypes.c_char_p


def _bind_transpose(lib: ctypes.CDLL) -> None:
    lib.transpose_tiles.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.transpose_tiles.restype = ctypes.c_int
    lib.transpose_error_string.argtypes = [ctypes.c_int]
    lib.transpose_error_string.restype = ctypes.c_char_p


_BINDERS = {"heat_stencil": _bind_heat_stencil,
            "segmented_scan": _bind_segmented_scan,
            "heat_band": _bind_heat_band,
            "transpose": _bind_transpose}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first call."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)[name]))
        _BINDERS[name](lib)
        _libs[name] = lib
    return _libs[name]


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
    lib = library("heat_stencil")
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


def segmented_scan_geometry() -> tuple[int, int, int, int]:
    """(items per thread, threads per tile, warp width, carry-pass threads)
    as compiled into ``csrc/segmented_scan.cu``."""
    buf = (ctypes.c_int * 4)()
    library("segmented_scan").segmented_scan_geometry(buf)
    return tuple(buf)


def segmented_scan(values: torch.Tensor, xx: torch.Tensor | None,
                   flags: torch.Tensor, out: torch.Tensor,
                   workspace: torch.Tensor) -> None:
    """Enqueue one scan of ``csrc/segmented_scan.cu`` on the current stream:
    ``out = segscan(values)`` (``xx`` None, B6) or ``segscan(values·xx)``
    (B7).  ``out`` may be ``values``.

    Every tensor is contiguous, 1-D and on one CUDA device: float32
    ``values``, ``xx`` and ``out`` of n elements, int32 ``flags`` of n, and
    a 32-bit ``workspace`` of at least 3 words per tile.  Raises
    ``FrameworkError`` when the C entry refuses the call or a launch.
    """
    tensors = [values, flags, out, workspace] + ([] if xx is None else [xx])
    if not all(t.is_cuda and t.device == values.device for t in tensors):
        raise ValueError("segmented_scan takes tensors on one CUDA device")
    if not all(t.dim() == 1 and t.is_contiguous() for t in tensors):
        raise ValueError("segmented_scan takes contiguous 1-D tensors")
    n = values.shape[0]
    f32 = [values, out] + ([] if xx is None else [xx])
    if any(t.dtype != torch.float32 for t in f32) \
            or flags.dtype != torch.int32 or workspace.element_size() != 4:
        raise TypeError("segmented_scan takes float32 values/xx/out, int32 "
                        "flags and a 32-bit workspace")
    if any(t.shape[0] != n for t in f32 + [flags]):
        raise ValueError("segmented_scan takes values, xx, flags and out of "
                         "one length")
    lib = library("segmented_scan")
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.segmented_scan_f32(
            values.data_ptr(), None if xx is None else xx.data_ptr(),
            flags.data_ptr(), out.data_ptr(), n, workspace.data_ptr(),
            workspace.shape[0], stream)
    if err != 0:
        raise FrameworkError(
            f"segmented_scan launch failed: "
            f"{lib.segmented_scan_error_string(err).decode()} (cudaError "
            f"{err}; n={n} fused={xx is not None} "
            f"workspace={workspace.shape[0]} words)")


def heat_band(src: torch.Tensor, dst: torch.Tensor, *, order: int, k: int,
              tile_y: int, tile_x: int, run: int, nbuf: int, smem_bytes: int,
              xcfl: float, ycfl: float,
              bc: tuple[float, float, float, float]) -> None:
    """Enqueue one launch of ``csrc/heat_band.cu:heat_band``: ``k`` fused
    heat steps of the (gy, gx) halo grid ``src`` into the (ny, nx) = (gy −
    order, gx − order) interior ``dst`` on the current stream.

    ``src`` is a contiguous float32/float64 grid on a CUDA device; ``dst``
    a 2-D tensor of the same type and device, rows of unit stride at any
    row stride (a view of another grid's interior, or a bare array), in
    other storage than ``src``.  ``(tile_y, tile_x)`` is the output tile,
    ``run`` the tiles a block walks, ``nbuf`` its staging buffers and
    ``smem_bytes`` its shared memory (``stencil_pallas.band_geometry``).
    Raises ``FrameworkError`` when the launch is refused.
    """
    if not (src.is_cuda and dst.device == src.device):
        raise ValueError("heat_band takes two tensors on one CUDA device")
    if src.dtype not in (torch.float32, torch.float64) \
            or dst.dtype != src.dtype:
        raise TypeError(f"heat_band takes float32 or float64 grids, got "
                        f"{src.dtype} -> {dst.dtype}")
    if src.dim() != 2 or not src.is_contiguous():
        raise ValueError("heat_band takes a contiguous 2-D source grid")
    H, W = src.shape
    if dst.dim() != 2 or tuple(dst.shape) != (H - order, W - order) \
            or dst.stride(1) != 1:
        raise ValueError(f"heat_band writes a ({H - order}, {W - order}) "
                         f"interior with unit column stride, got "
                         f"{tuple(dst.shape)} strides {dst.stride()}")
    if dst.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        raise ValueError("heat_band cannot update a grid in place")
    lib = library("heat_band")
    fn = lib.heat_band_f32 if src.dtype == torch.float32 \
        else lib.heat_band_f64
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), dst.data_ptr(), H, W, dst.stride(0),
                 H - order, W - order, order, k, tile_y, tile_x, run, nbuf,
                 smem_bytes, xcfl, ycfl, *bc, stream)
    if err != 0:
        raise FrameworkError(
            f"heat_band launch failed: "
            f"{lib.heat_band_error_string(err).decode()} (cudaError {err}; "
            f"order={order} k={k} tile={tile_y}x{tile_x} run={run} "
            f"nbuf={nbuf} smem={smem_bytes} grid={H}x{W} {src.dtype})")


def transpose_tiles(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Enqueue one launch of ``csrc/transpose.cu``: ``dst = src.T`` for a
    contiguous (M, N) ``src`` and a contiguous (N, M) ``dst`` of one dtype
    of 1, 2, 4 or 8 bytes on one CUDA device.  Raises ``FrameworkError``
    when the launch is refused."""
    if not (src.is_cuda and dst.device == src.device):
        raise ValueError("transpose_tiles takes two tensors on one CUDA "
                         "device")
    if dst.dtype != src.dtype or src.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"transpose_tiles moves elements of 1, 2, 4 or 8 "
                        f"bytes of one dtype, got {src.dtype} -> "
                        f"{dst.dtype}")
    if src.dim() != 2 or tuple(dst.shape) != tuple(src.shape[::-1]) \
            or not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError(f"transpose_tiles takes a contiguous (M, N) source "
                         f"and a contiguous (N, M) output, got "
                         f"{tuple(src.shape)} -> {tuple(dst.shape)}")
    lib = library("transpose")
    M, N = src.shape
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.transpose_tiles(src.data_ptr(), dst.data_ptr(), M, N,
                                  src.element_size(), stream)
    if err != 0:
        raise FrameworkError(
            f"transpose_tiles launch failed: "
            f"{lib.transpose_error_string(err).decode()} (cudaError {err}; "
            f"{M}x{N} {src.dtype})")
