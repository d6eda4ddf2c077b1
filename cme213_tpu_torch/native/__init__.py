"""Host-native C++/OpenMP components (hw4 sorts, the SpMV-scan CPU axis,
problem-file IO) with ctypes bindings.

Counterpart of ``cme213_tpu/native/__init__.py`` over the port's own copy of
the sources.  The library is compiled at first use (g++ -O3 -fopenmp) into
``cme213_tpu_torch/_build/``; see ``build.py``.  A failed build, or a library
the loader refuses, raises ``FrameworkError``.  Python entry points:

- ``merge_sort(arr, sort_threshold, merge_threshold)`` — in-place int32 sort
  via the fork-join task tree (reference CLI knobs, mergesort.cpp:148-158).
- ``radix_sort(arr, num_bits, block_size)`` / ``radix_sort_serial`` —
  in-place uint32 LSD radix sorts (reference knobs, radixsort.cpp:163-179).
- ``parallel_sum``, ``saxpy`` — the host baselines of the elementwise ops;
- ``spmv_read``, ``read_floats``, ``write_floats`` — the SpMV-scan problem
  files (``apps/spmv_scan.py``'s native tokenizer and writer);
- ``spmv_scan_cpu`` — the OpenMP SpMV-scan (the suite sweep's ``cpu_ms``);
- ``set_threads(n)`` / ``thread_count()`` — the OMP_NUM_THREADS control the
  reference's PBS harness swept (pa4.pbs:20-28).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.errors import FrameworkError
from .build import build_library

_lib = None


def _load():
    global _lib
    if _lib is None:
        path = build_library()
        try:
            _lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise FrameworkError(f"cannot load {path}: {e}") from e
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        _lib.merge_sort_omp.argtypes = [i32p, i32p, ctypes.c_long,
                                        ctypes.c_long, ctypes.c_long]
        _lib.radix_sort_omp.argtypes = [u32p, u32p, ctypes.c_long,
                                        ctypes.c_int, ctypes.c_long]
        _lib.radix_sort_serial.argtypes = [u32p, u32p, ctypes.c_long,
                                           ctypes.c_int]
        _lib.set_omp_threads.argtypes = [ctypes.c_int]
        _lib.omp_thread_count.restype = ctypes.c_int
        _lib.wtime_now.restype = ctypes.c_double
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        _lib.parallel_sum_omp.argtypes = [f32p, ctypes.c_long]
        _lib.parallel_sum_omp.restype = ctypes.c_double
        _lib.saxpy_omp.argtypes = [ctypes.c_float, f32p, f32p, ctypes.c_long]
        ll4 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        _lib.spmv_read_header.argtypes = [ctypes.c_char_p, ll4]
        _lib.spmv_read_header.restype = ctypes.c_int
        _lib.spmv_read_arrays.argtypes = [ctypes.c_char_p, f32p,
                                          ctypes.c_longlong, i32p,
                                          ctypes.c_longlong, i32p]
        _lib.spmv_read_arrays.restype = ctypes.c_int
        _lib.read_floats.argtypes = [ctypes.c_char_p, f32p,
                                     ctypes.c_longlong]
        _lib.read_floats.restype = ctypes.c_longlong
        _lib.write_floats.argtypes = [ctypes.c_char_p, f32p,
                                      ctypes.c_longlong]
        _lib.write_floats.restype = ctypes.c_int
        _lib.spmv_scan_omp.argtypes = [f32p, f32p, i32p, ctypes.c_long,
                                       ctypes.c_long, ctypes.c_int]
    return _lib


def spmv_read(a_path: str):
    """Parse the hw_final ``a.txt`` format natively.

    Returns ``(a, s, k, q, iters)``.  Raises ``OSError`` / ``ValueError``
    on unreadable or malformed files (the fail-fast behavior of the
    reference's validating loader)."""
    lib = _load()
    hdr = np.zeros(4, np.int64)
    rc = lib.spmv_read_header(a_path.encode(), hdr)
    if rc:
        raise OSError(f"cannot read header of {a_path} (code {rc})")
    n, p, q, iters = (int(v) for v in hdr)
    a = np.empty(n, np.float32)
    s = np.empty(p, np.int32)
    k = np.empty(n, np.int32)
    rc = lib.spmv_read_arrays(a_path.encode(), a, n, s, p, k)
    if rc:
        raise ValueError(f"malformed {a_path} (section {rc})")
    return a, s, k, q, iters


def read_floats(path: str, count: int) -> np.ndarray:
    """Read ``count`` whitespace-separated floats (x.txt / b.txt shape)."""
    lib = _load()
    out = np.empty(count, np.float32)
    got = lib.read_floats(path.encode(), out, count)
    if got < 0:
        raise OSError(f"cannot read {path}")
    if got < count:
        raise ValueError(f"{path}: expected {count} floats, found {got}")
    return out


def write_floats(path: str, values: np.ndarray) -> None:
    """Write one float per line (the b.txt output shape, fp.cu:192-199)."""
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.float32)
    rc = lib.write_floats(path.encode(), values, values.size)
    if rc:
        raise OSError(f"cannot write {path} (code {rc})")


def merge_sort(arr: np.ndarray, sort_threshold: int = 4096,
               merge_threshold: int = 4096) -> np.ndarray:
    """In-place parallel merge sort of an int32 array; returns ``arr``."""
    lib = _load()
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    scratch = np.empty_like(arr)
    lib.merge_sort_omp(arr, scratch, arr.size, sort_threshold, merge_threshold)
    return arr


def radix_sort(arr: np.ndarray, num_bits: int = 8,
               block_size: int = 8192) -> np.ndarray:
    """In-place parallel LSD radix sort of a uint32 array; returns ``arr``."""
    lib = _load()
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    scratch = np.empty_like(arr)
    lib.radix_sort_omp(arr, scratch, arr.size, num_bits, block_size)
    return arr


def radix_sort_serial(arr: np.ndarray, num_bits: int = 8) -> np.ndarray:
    lib = _load()
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    scratch = np.empty_like(arr)
    lib.radix_sort_serial(arr, scratch, arr.size, num_bits)
    return arr


def parallel_sum(x: np.ndarray) -> float:
    """OpenMP reduction sum over a float32 array (f64 accumulator)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    return float(_load().parallel_sum_omp(x, x.size))


def saxpy(alpha: float, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """In-place y ← α·x + y over float32 arrays; returns ``y``."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if y.dtype != np.float32 or not y.flags["C_CONTIGUOUS"]:
        raise TypeError("saxpy updates a C-contiguous float32 y in place")
    if x.size != y.size:
        raise ValueError(f"saxpy: x has {x.size} values, y {y.size}")
    _load().saxpy_omp(alpha, x, y, x.size)
    return y


def spmv_scan_cpu(a: np.ndarray, seg_starts: np.ndarray, xx: np.ndarray,
                  iters: int) -> np.ndarray:
    """OpenMP CPU SpMV-scan: ``a ← segscan(a·xx)`` iterated ``iters`` times.

    The hw_final CPU reference axis (parallel multiply + one-segment-per-
    thread serial scan, ``fp.cu:130-152``).  ``seg_starts`` excludes the
    terminal sentinel.  Returns a new array; ``a`` is untouched.
    """
    lib = _load()
    out = np.array(a, dtype=np.float32, copy=True, order="C")
    xx = np.ascontiguousarray(xx, dtype=np.float32)
    s = np.ascontiguousarray(seg_starts, dtype=np.int32)
    lib.spmv_scan_omp(out, xx, s, s.size, out.size, iters)
    return out


def set_threads(n: int) -> None:
    _load().set_omp_threads(n)


def thread_count() -> int:
    return _load().omp_thread_count()
