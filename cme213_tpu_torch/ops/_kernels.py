"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Counterpart of ``cme213_tpu/native/build.py``.  Each source in ``csrc/`` is
compiled by ``nvcc`` for Hopper into its own shared library with a plain C
interface under ``core.platform.BUILD_DIR``, keyed by a hash of the source
and the flags, and loaded with ``ctypes``.  A library is built at the first
launch on a CUDA tensor that needs it; ``build()`` builds several at once,
one ``nvcc`` each, all started together.  Importing this module builds
nothing, so the CPU tests import it without a toolchain; a missing ``nvcc``
or a failed build raises ``KernelError`` (a ``FrameworkError``) at that
first launch, and so does a launch the C entry refuses.  Nothing
falls back to another implementation.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path

import torch

from ..core.errors import KernelError
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
    raise KernelError(
        "nvcc not found (PATH, CUDA_HOME, CUDA_PATH, /usr/local/cuda): the "
        "CUDA kernels are built from cme213_tpu_torch/csrc at first use on "
        "a CUDA tensor")


def library_path(name: str) -> Path:
    """Path of library ``name``'s build for the current source, the headers
    beside it (every ``csrc/*.cuh``, which any source may include) and the
    flags."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@functools.cache
def sources_digest() -> str:
    """A digest of every kernel source, header and the build flags: it
    changes whenever any library would be rebuilt."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*SOURCES.values(), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:16]


def build(*names: str) -> dict[str, Path]:
    """Compile the named libraries (default: all) unless already built.

    One ``nvcc`` per missing library, all started together and all waited
    for.  The compiler's output (``-Xptxas -v``) goes to a ``.log`` beside
    each library.  Raises ``KernelError`` when ``nvcc`` is missing or any
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
        raise KernelError("nvcc failed on " + "\n".join(failed))
    return out


#: shards one ``heat_ksteps`` launch takes (``csrc/heat_stencil.cu``
#: kMaxShards)
MAX_SHARDS = 32

#: ``csrc/heat_stencil.cu``'s shard descriptor, ``struct HeatShard {const
#: void* src; void* dst; int gy0, gx0;}``: 24 bytes, no padding
HEAT_SHARD = struct.Struct("<QQii")


def _bind_heat_stencil(lib: ctypes.CDLL) -> None:
    for name, real in (("heat_ksteps_f32", ctypes.c_float),
                       ("heat_ksteps_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_char_p] + [ctypes.c_int] * 11
                       + [real] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for name, real in (("heat_ksteps_loop_f32", ctypes.c_float),
                       ("heat_ksteps_loop_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                       + [real] * 6 + [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    lib.heat_ksteps_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.heat_ksteps_occupancy.restype = ctypes.c_int
    lib.heat_ksteps_design.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.heat_ksteps_design.restype = ctypes.c_int
    lib.heat_error_string.argtypes = [ctypes.c_int]
    lib.heat_error_string.restype = ctypes.c_char_p


def _bind_segmented_scan(lib: ctypes.CDLL) -> None:
    lib.segmented_scan_geometry.argtypes = [ctypes.c_void_p]
    lib.segmented_scan_geometry.restype = None
    lib.segmented_scan_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_uint,
                                 ctypes.c_void_p])
    lib.segmented_scan_f32.restype = ctypes.c_int
    lib.pagerank_pull_geometry.argtypes = [ctypes.c_void_p]
    lib.pagerank_pull_geometry.restype = None
    lib.pagerank_pull_f32.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_uint, ctypes.c_void_p])
    lib.pagerank_pull_f32.restype = ctypes.c_int
    lib.pagerank_update_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_double,
                                 ctypes.c_double] + [ctypes.c_void_p] * 4)
    lib.pagerank_update_f32.restype = ctypes.c_int
    lib.segmented_scan_error_string.argtypes = [ctypes.c_int]
    lib.segmented_scan_error_string.restype = ctypes.c_char_p


def _bind_heat_band(lib: ctypes.CDLL) -> None:
    for name, real in (("heat_band_f32", ctypes.c_float),
                       ("heat_band_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 9 + [real] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.heat_band_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.heat_band_occupancy.restype = ctypes.c_int
    lib.heat_band_design.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.heat_band_design.restype = ctypes.c_int
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


def heat_ksteps(shards, *, order: int, k: int, tile_y: int, tile_x: int,
                run: int, smem_bytes: int, ny: int, nx: int, xcfl: float,
                ycfl: float, bc: tuple[float, float, float, float]) -> None:
    """Enqueue one launch of ``csrc/heat_stencil.cu:heat_ksteps``: ``k``
    fused heat steps of every shard on the current stream.

    ``shards`` is a list of 1 to ``MAX_SHARDS`` tuples ``(src, dst, gy0,
    gx0)``: contiguous (H, W) float32/float64 tensors of one shape and
    dtype, all on one CUDA device, no ``dst`` the storage of any ``src``;
    ``(gy0, gx0)`` are the global halo-grid coordinates of the block's
    element [0, 0] and ``(ny, nx)`` the global interior extents, which
    place the Dirichlet bands.  ``(tile_y, tile_x)``, ``run`` and
    ``smem_bytes`` are the launch's decomposition
    (``stencil_pipeline.launch_plan``).  Raises ``KernelError`` when the
    launch is refused.
    """
    n = len(shards)
    if not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"heat_ksteps takes 1 to {MAX_SHARDS} shards, got "
                         f"{n}")
    first = shards[0][0]
    dtype, shape, device = first.dtype, first.shape, first.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"heat_ksteps takes float32 or float64 grids, got "
                        f"{dtype}")
    if len(shape) != 2:
        raise ValueError(f"heat_ksteps takes 2-D grids, got {tuple(shape)}")
    fields = []  # the descriptors' fields, shard by shard
    for src, dst, gy0, gx0 in shards:
        if src.dtype != dtype or dst.dtype != dtype:
            raise TypeError(f"heat_ksteps takes grids of one dtype, got "
                            f"{src.dtype} -> {dst.dtype} beside {dtype}")
        if src.shape != shape or dst.shape != shape:
            raise ValueError(f"heat_ksteps takes grids of one shape, got "
                             f"{tuple(src.shape)} -> {tuple(dst.shape)} "
                             f"beside {tuple(shape)}")
        if not (src.is_contiguous() and dst.is_contiguous()):
            raise ValueError("heat_ksteps takes contiguous grids")
        if src.device != device or dst.device != device:
            raise ValueError("heat_ksteps takes tensors on one CUDA device")
        fields += (src.data_ptr(), dst.data_ptr(), gy0, gx0)
    if not set(fields[1::4]).isdisjoint(fields[0::4]):
        raise ValueError("heat_ksteps cannot update a grid in place")
    if not first.is_cuda:
        raise ValueError("heat_ksteps takes tensors on one CUDA device")
    lib = library("heat_stencil")
    fn = lib.heat_ksteps_f32 if dtype == torch.float32 \
        else lib.heat_ksteps_f64
    table = struct.pack("<" + HEAT_SHARD.format[1:] * n, *fields)
    H, W = shape
    # the launch goes to the current device; switching costs host time a
    # step, so it is done only when the shards lie on another device
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    with contextlib.nullcontext() if index == current \
            else torch.cuda.device(index):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table, n, H, W, ny, nx, order, k, tile_y, tile_x, run,
                 smem_bytes, xcfl, ycfl, *bc, stream)
    if err != 0:
        raise KernelError(
            f"heat_ksteps launch failed: "
            f"{lib.heat_error_string(err).decode()} (cudaError {err}; "
            f"order={order} k={k} tile={tile_y}x{tile_x} run={run} "
            f"smem={smem_bytes} {n} shard(s) of {H}x{W} {dtype})")


def heat_ksteps_loop(src: torch.Tensor, bufs, launches: int, *,
                     order: int, k: int, tile_y: int, tile_x: int, run: int,
                     smem_bytes: int, ny: int, nx: int, xcfl: float,
                     ycfl: float, bc: tuple[float, float, float, float]
                     ) -> torch.Tensor:
    """Enqueue a single-grid solve's ``launches`` launches of
    ``csrc/heat_stencil.cu:heat_ksteps`` in one call of the C loop, on the
    current stream: launch i reads the previous output (``src`` for the
    first) and writes ``bufs[i % 2]``, ``k`` fused steps each, offsets
    (0, 0).  Returns the last output, ``bufs[(launches - 1) % 2]``.

    ``src`` and the two ``bufs`` are contiguous (H, W) float32/float64
    tensors of one shape and dtype on one CUDA device, three separate
    storages; ``launches`` ≥ 1.  They are checked here once, before the
    library loads; the geometry (``stencil_pipeline.launch_plan``) once in
    the C entry.  Raises ``KernelError`` naming the refused launch's index
    when a launch is refused; the launches before it stay enqueued.
    """
    if launches < 1:
        raise ValueError(f"heat_ksteps_loop takes at least one launch, got "
                         f"{launches}")
    if len(bufs) != 2:
        raise ValueError(f"heat_ksteps_loop takes two buffers, got "
                         f"{len(bufs)}")
    grids = (src, *bufs)
    dtype, shape, device = src.dtype, src.shape, src.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"heat_ksteps takes float32 or float64 grids, got "
                        f"{dtype}")
    if len(shape) != 2:
        raise ValueError(f"heat_ksteps takes 2-D grids, got {tuple(shape)}")
    if any(g.dtype != dtype for g in bufs):
        raise TypeError(f"heat_ksteps takes grids of one dtype, got "
                        f"{[g.dtype for g in grids]}")
    if any(g.shape != shape for g in bufs):
        raise ValueError(f"heat_ksteps takes grids of one shape, got "
                         f"{[tuple(g.shape) for g in grids]}")
    if not all(g.is_contiguous() for g in grids):
        raise ValueError("heat_ksteps takes contiguous grids")
    if any(g.device != device for g in bufs):
        raise ValueError("heat_ksteps takes tensors on one CUDA device")
    if len({g.untyped_storage().data_ptr() for g in grids}) != 3:
        raise ValueError("heat_ksteps cannot update a grid in place: the "
                         "source and the two buffers need storages of "
                         "their own")
    if not src.is_cuda:
        raise ValueError("heat_ksteps takes tensors on one CUDA device")
    lib = library("heat_stencil")
    fn = lib.heat_ksteps_loop_f32 if dtype == torch.float32 \
        else lib.heat_ksteps_loop_f64
    H, W = shape
    launched = ctypes.c_int(0)
    # the launches go to the current device; switching costs host time, so
    # it is done only when the grid lies on another device
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    with contextlib.nullcontext() if index == current \
            else torch.cuda.device(index):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
                 launches, H, W, ny, nx, order, k, tile_y, tile_x, run,
                 smem_bytes, xcfl, ycfl, *bc, stream, ctypes.byref(launched))
    if err != 0:
        raise KernelError(
            f"heat_ksteps launch failed: "
            f"{lib.heat_error_string(err).decode()} (cudaError {err}; "
            f"launch {launched.value} of {launches}; order={order} k={k} "
            f"tile={tile_y}x{tile_x} run={run} smem={smem_bytes} "
            f"{H}x{W} {dtype})")
    return bufs[(launches - 1) % 2]


def heat_ksteps_occupancy(device: torch.device, dtype_bytes: int, order: int,
                          k: int, smem_bytes: int) -> tuple[int, int, int]:
    """(blocks an SM, registers a thread, local-memory bytes a thread) of
    ``heat_ksteps``' instance for (dtype, order, k) at ``smem_bytes`` of
    shared memory a block on ``device``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    ``cudaFuncGetAttributes``; local memory holds what ptxas spills)."""
    lib = library("heat_stencil")
    buf = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = lib.heat_ksteps_occupancy(dtype_bytes, order, k, smem_bytes,
                                        buf)
    if err != 0:
        raise KernelError(
            f"heat_ksteps occupancy query failed: "
            f"{lib.heat_error_string(err).decode()} (cudaError {err}; "
            f"order={order} k={k} smem={smem_bytes} {dtype_bytes}-byte)")
    return tuple(buf)


def heat_ksteps_design(dtype_bytes: int, k: int) -> tuple[int, int, int]:
    """(strip width, threads a block, micro-tile rows) compiled into
    ``csrc/heat_stencil.cu`` for the dtype size and k's class."""
    buf = (ctypes.c_int * 3)()
    lib = library("heat_stencil")
    err = lib.heat_ksteps_design(dtype_bytes, k, buf)
    if err != 0:
        raise KernelError(f"no heat_ksteps design for {dtype_bytes}-byte "
                             f"values at k={k}")
    return tuple(buf)


def segmented_scan_geometry() -> tuple[int, int, int]:
    """(items per thread, threads per tile, warp width) as compiled into
    ``csrc/segmented_scan.cu``."""
    buf = (ctypes.c_int * 3)()
    library("segmented_scan").segmented_scan_geometry(buf)
    return tuple(buf)


def segmented_scan(values: torch.Tensor, xx: torch.Tensor | None,
                   flags: torch.Tensor, out: torch.Tensor,
                   workspace: torch.Tensor, epoch: int,
                   stream: int | None = None) -> None:
    """Enqueue the one launch of a scan of ``csrc/segmented_scan.cu`` on
    ``stream`` (a ``cuda_stream`` handle of the tensors' device; default
    its current stream): ``out = segscan(values)`` (``xx`` None, B6) or
    ``segscan(values·xx)`` (B7).  ``out`` may be ``values``.

    Every tensor is contiguous, 1-D and on one CUDA device: float32
    ``values``, ``xx`` and ``out`` of n elements, int32 ``flags`` of n, and
    a 32-bit ``workspace`` of at least 2 + 2 words per tile, zero before
    its first call; ``epoch`` (1 ≤ epoch < 2³⁰) is new to the workspace
    since it was zeroed.  Raises ``KernelError`` when the C entry
    refuses the call or the launch.
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
    if stream is None:
        stream = torch.cuda.current_stream(values.device).cuda_stream
    # the launch goes to the current device; switching costs host time a
    # call, so it is done only when the tensors lie on another device
    index = values.device.index
    with contextlib.nullcontext() if index == torch.cuda.current_device() \
            else torch.cuda.device(index):
        err = lib.segmented_scan_f32(
            values.data_ptr(), None if xx is None else xx.data_ptr(),
            flags.data_ptr(), out.data_ptr(), n, workspace.data_ptr(),
            workspace.shape[0], epoch, stream)
    if err != 0:
        raise KernelError(
            f"segmented_scan launch failed: "
            f"{lib.segmented_scan_error_string(err).decode()} (cudaError "
            f"{err}; n={n} fused={xx is not None} "
            f"workspace={workspace.shape[0]} words, epoch {epoch})")


def pagerank_pull_geometry() -> tuple[int, int, int]:
    """(slots per thread, threads per tile, the update's most blocks) as
    compiled into ``csrc/segmented_scan.cu``."""
    buf = (ctypes.c_int * 3)()
    library("segmented_scan").pagerank_pull_geometry(buf)
    return tuple(buf)


def _one_cuda_device(what: str, tensors) -> torch.device:
    device = tensors[0].device
    if not all(t.is_cuda and t.device == device for t in tensors):
        raise ValueError(f"{what} takes tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")
    return device


def _raise_on(err: int, what: str, detail: str) -> None:
    if err != 0:
        lib = library("segmented_scan")
        raise KernelError(
            f"{what} launch failed: "
            f"{lib.segmented_scan_error_string(err).decode()} (cudaError "
            f"{err}; {detail})")


def pagerank_pull(nbrs: torch.Tensor, contrib: torch.Tensor,
                  off: torch.Tensor, rowmap: torch.Tensor,
                  tile_row: torch.Tensor, sums: torch.Tensor,
                  workspace: torch.Tensor, epoch: int) -> None:
    """Enqueue the one launch of ``csrc/segmented_scan.cu``'s pull on the
    current stream: ``sums[rowmap[r]] = Σ contrib[nbrs[i]]`` over each
    compacted row ``r``'s slots ``off[r] ≤ i < off[r+1]``.

    int32 ``nbrs`` (nnz ≥ 1), float32 ``contrib`` and ``sums``, int64
    ``off`` (rows + 1), int32 ``rowmap`` (rows) and ``tile_row`` (tiles +
    1), a 32-bit ``workspace`` of at least 2 + 4 words a tile, zero before
    its first call, and an ``epoch`` new to it, as ``segmented_scan``'s.
    Raises ``KernelError`` when the call or the launch is refused."""
    tensors = [nbrs, contrib, off, rowmap, tile_row, sums, workspace]
    device = _one_cuda_device("pagerank_pull", tensors)
    if (nbrs.dtype, contrib.dtype, off.dtype, rowmap.dtype, tile_row.dtype,
            sums.dtype) != (torch.int32, torch.float32, torch.int64,
                            torch.int32, torch.int32, torch.float32) \
            or workspace.element_size() != 4:
        raise TypeError("pagerank_pull takes int32 nbrs, rowmap and "
                        "tile_row, float32 contrib and sums, int64 off and "
                        "a 32-bit workspace")
    rows = rowmap.shape[0]
    if off.shape[0] != rows + 1:
        raise ValueError("pagerank_pull takes rows + 1 offsets")
    lib = library("segmented_scan")
    stream = torch.cuda.current_stream(device).cuda_stream
    with contextlib.nullcontext() if device.index == \
            torch.cuda.current_device() else torch.cuda.device(device.index):
        err = lib.pagerank_pull_f32(
            nbrs.data_ptr(), contrib.data_ptr(), off.data_ptr(),
            rowmap.data_ptr(), tile_row.data_ptr(), sums.data_ptr(),
            nbrs.shape[0], rows, workspace.data_ptr(), workspace.shape[0],
            epoch, stream)
    _raise_on(err, "pagerank_pull", f"nnz={nbrs.shape[0]} rows={rows} "
              f"workspace={workspace.shape[0]} words, epoch {epoch}")


def pagerank_update(sums: torch.Tensor, deg: torch.Tensor,
                    score: torch.Tensor, contrib: torch.Tensor, base: float,
                    damping: float, partials: torch.Tensor,
                    counter: torch.Tensor, err: torch.Tensor) -> None:
    """Enqueue the one launch of ``csrc/segmented_scan.cu``'s per-vertex
    update on the current stream: ``score = float32(base + damping·sums)``,
    ``err[0] = Σ |score − old score|`` in float64, ``contrib = score /
    deg`` (0 where ``deg`` is 0).  float32 ``sums``, ``score`` and
    ``contrib``, int32 ``deg``, float64 ``partials`` (the geometry's most
    blocks) and ``err``, an int32 ``counter`` zero before the first call.
    Raises ``KernelError`` when the call or the launch is refused."""
    tensors = [sums, deg, score, contrib, partials, counter, err]
    device = _one_cuda_device("pagerank_update", tensors)
    if (sums.dtype, deg.dtype, score.dtype, contrib.dtype, partials.dtype,
            counter.dtype, err.dtype) != (
            torch.float32, torch.int32, torch.float32, torch.float32,
            torch.float64, torch.int32, torch.float64):
        raise TypeError("pagerank_update takes float32 sums, score and "
                        "contrib, int32 deg and counter, float64 partials "
                        "and err")
    n = score.shape[0]
    if any(t.shape[0] != n for t in (sums, deg, contrib)):
        raise ValueError("pagerank_update takes vectors of one length")
    lib = library("segmented_scan")
    stream = torch.cuda.current_stream(device).cuda_stream
    with contextlib.nullcontext() if device.index == \
            torch.cuda.current_device() else torch.cuda.device(device.index):
        rc = lib.pagerank_update_f32(
            sums.data_ptr(), deg.data_ptr(), score.data_ptr(),
            contrib.data_ptr(), n, float(base), float(damping),
            partials.data_ptr(), counter.data_ptr(), err.data_ptr(), stream)
    _raise_on(rc, "pagerank_update", f"n={n}")


def heat_band_launchers(pairs, *, order: int, k: int, tile_y: int,
                        run: int, nbuf: int, smem_bytes: int, xcfl: float,
                        ycfl: float, bc: tuple[float, float, float, float]
                        ) -> list:
    """One launcher per ``(src, dst)`` pair of ``csrc/heat_band.cu:
    heat_band``: a call with no argument enqueues ``k`` fused heat steps of
    the (gy, gx) halo grid ``src`` into the (ny, nx) = (gy − order, gx −
    order) interior ``dst`` on the stream that was current when the
    launchers were made, and raises ``KernelError`` when the launch is
    refused.

    The tensors are checked here, once: ``src`` a contiguous float32/
    float64 grid on a CUDA device; ``dst`` a 2-D tensor of the same type
    and device, rows of unit stride at any row stride (a view of another
    grid's interior, or a bare array), in other storage than ``src``.
    ``tile_y``, ``run``, ``nbuf`` and ``smem_bytes`` are the launch's
    decomposition (``stencil_pallas.launch_plan``), which the C entry
    checks at every launch.  Each launcher holds its two tensors, whose
    addresses it passes.
    """
    launchers = []
    for src, dst in pairs:
        if not (src.is_cuda and dst.device == src.device):
            raise ValueError("heat_band takes two tensors on one CUDA "
                             "device")
        if src.dtype not in (torch.float32, torch.float64) \
                or dst.dtype != src.dtype:
            raise TypeError(f"heat_band takes float32 or float64 grids, got "
                            f"{src.dtype} -> {dst.dtype}")
        if src.dim() != 2 or not src.is_contiguous():
            raise ValueError("heat_band takes a contiguous 2-D source grid")
        H, W = src.shape
        if dst.dim() != 2 or tuple(dst.shape) != (H - order, W - order) \
                or dst.stride(1) != 1:
            raise ValueError(f"heat_band writes a ({H - order}, "
                             f"{W - order}) interior with unit column "
                             f"stride, got {tuple(dst.shape)} strides "
                             f"{dst.stride()}")
        if dst.untyped_storage().data_ptr() \
                == src.untyped_storage().data_ptr():
            raise ValueError("heat_band cannot update a grid in place")
        lib = library("heat_band")
        fn = lib.heat_band_f32 if src.dtype == torch.float32 \
            else lib.heat_band_f64
        index = src.device.index
        if index is None:
            index = torch.cuda.current_device()
        switch = index != torch.cuda.current_device()
        stream = torch.cuda.current_stream(index).cuda_stream
        args = (src.data_ptr(), dst.data_ptr(), H, W, dst.stride(0), order,
                k, tile_y, run, nbuf, smem_bytes, xcfl, ycfl, *bc, stream)
        what = (f"order={order} k={k} tile_y={tile_y} run={run} "
                f"nbuf={nbuf} smem={smem_bytes} grid={H}x{W} {src.dtype}")

        # `keep` holds the tensors whose addresses `args` pass
        def launch(fn=fn, args=args, lib=lib, what=what, switch=switch,
                   index=index, keep=(src, dst)):
            # the launch goes to the current device; switching costs host
            # time, so it is done only for a grid on another device
            if switch:
                with torch.cuda.device(index):
                    err = fn(*args)
            else:
                err = fn(*args)
            if err != 0:
                raise KernelError(
                    f"heat_band launch failed: "
                    f"{lib.heat_band_error_string(err).decode()} "
                    f"(cudaError {err}; {what})")

        launchers.append(launch)
    return launchers


def heat_band_occupancy(device: torch.device, dtype_bytes: int, order: int,
                        k: int, smem_bytes: int) -> tuple[int, int, int]:
    """(blocks an SM, registers a thread, local-memory bytes a thread) of
    ``heat_band``'s instance for (dtype, order, k) at ``smem_bytes`` of
    shared memory a block on ``device`` (local memory holds what ptxas
    spills)."""
    lib = library("heat_band")
    buf = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = lib.heat_band_occupancy(dtype_bytes, order, k, smem_bytes, buf)
    if err != 0:
        raise KernelError(
            f"heat_band occupancy query failed: "
            f"{lib.heat_band_error_string(err).decode()} (cudaError {err}; "
            f"order={order} k={k} smem={smem_bytes} {dtype_bytes}-byte)")
    return tuple(buf)


def heat_band_design(dtype_bytes: int, k: int) -> tuple[int, int, int, int]:
    """(strip width, threads a block, micro-tile rows, blocks an SM of the
    register budget) compiled into ``csrc/heat_band.cu`` for the dtype size
    and k's class."""
    buf = (ctypes.c_int * 4)()
    lib = library("heat_band")
    err = lib.heat_band_design(dtype_bytes, k, buf)
    if err != 0:
        raise KernelError(f"no heat_band design for {dtype_bytes}-byte "
                             f"values at k={k}")
    return tuple(buf)


def transpose_tiles(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Enqueue one launch of ``csrc/transpose.cu``: ``dst = src.T`` for a
    contiguous (M, N) ``src`` and a contiguous (N, M) ``dst`` of one dtype
    of 1, 2, 4 or 8 bytes on one CUDA device.  Raises ``KernelError``
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
        raise KernelError(
            f"transpose_tiles launch failed: "
            f"{lib.transpose_error_string(err).decode()} (cudaError {err}; "
            f"{M}x{N} {src.dtype})")
