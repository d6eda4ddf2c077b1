"""Build the port's native host library at first use.

Counterpart of ``cme213_tpu/native/build.py``, over the port's own copies of
the C++/OpenMP sources beside this file (``sorts.cpp``, ``io.cpp``,
``spmv.cpp``), in place of the reference's per-unit Makefiles (``g++
-fopenmp -O3``, ``hw/hw4/programming/Makefile``).  The library goes into
``core.platform.BUILD_DIR`` (``cme213_tpu_torch/_build/``, git-ignored),
named by a hash of the sources and the flags, so an edited source builds
anew and a stale library is never loaded.  ``CME213_TPU_NATIVE_DEBUG=1``
builds ``-g -O0`` (the reference Makefile's ``DEBUG=1``).  A missing
compiler or a failed build raises ``FrameworkError``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..core.errors import FrameworkError
from ..core.platform import BUILD_DIR

HERE = Path(__file__).resolve().parent
SOURCES = (HERE / "sorts.cpp", HERE / "io.cpp", HERE / "spmv.cpp")
DEBUG_ENV = "CME213_TPU_NATIVE_DEBUG"


def flags() -> tuple[str, ...]:
    opt = ("-g", "-O0") if os.environ.get(DEBUG_ENV) == "1" else ("-O3",)
    return ("-std=c++17", *opt, "-fopenmp", "-shared", "-fPIC")


def library_path() -> Path:
    """The library's path for the current sources and flags."""
    h = hashlib.sha256(" ".join(flags()).encode())
    for src in SOURCES:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}.so"


def build_library(force: bool = False) -> Path:
    """Compile the library unless it is built; returns its path.  The
    compiler writes a temporary file that is renamed into place, so a
    process never loads a half-written library."""
    path = library_path()
    if path.exists() and not force:
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise FrameworkError("g++ not found on PATH: the native library is "
                             "built from cme213_tpu_torch/native at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *flags(), *map(str, SOURCES), "-o",
                           str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise FrameworkError(f"g++ failed on the native library (rc "
                             f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path
