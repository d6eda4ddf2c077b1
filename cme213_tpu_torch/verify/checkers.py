"""Result checkers — the reference's dual-implementation testing model.

A copy of ``cme213_tpu/verify/checkers.py`` (numpy only); inputs may be
numpy arrays or CPU tensors.

Tolerance hierarchy preserved from the reference (SURVEY §4):
- exact byte/int equality (cipher ``checkResults`` ``hw/hw1/programming/
  cipher.cu:94-125``; sort asserts ``hw/hw4/programming/radixsort.cpp:196-211``)
- ULP-10 for per-element float stencils (``hw/hw2/programming/2dHeat.cu:
  651-671``, ``pagerank.cu:216-235``)
- absolute tolerance for accumulating float pipelines (1e-2,
  ``hw/hw_final/programming/fp.cu:193-206``)
- L2 / relative-L∞ for the double-precision external checker
  (``hw/hw_final/programming/aux/reference_spMVscan-released.cu:38-54``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.compare import almost_equal_ulps


@dataclass
class CheckResult:
    ok: bool
    message: str
    num_bad: int = 0

    def __bool__(self) -> bool:
        return self.ok


def check_exact(expected, got, label: str = "") -> CheckResult:
    """Elementwise exact equality; reports the first mismatch position like
    the reference's ``checkResults`` ("Error at pos: ...")."""
    expected = np.asarray(expected)
    got = np.asarray(got)
    if expected.shape != got.shape:
        return CheckResult(False, f"{label}: shape {expected.shape} vs {got.shape}")
    bad = expected != got
    if bad.any():
        pos = np.unravel_index(int(np.argmax(bad)), bad.shape)
        return CheckResult(
            False,
            f"{label}: Error at pos: {pos} expected: {expected[pos]} got: {got[pos]}",
            int(bad.sum()),
        )
    return CheckResult(True, f"{label}: exact match")


def check_ulp(expected, got, max_ulps: int = 10, label: str = "") -> CheckResult:
    """Per-element ULP-distance equality (maxUlps=10 default, as the
    reference's ``checkErrors``)."""
    expected = np.asarray(expected)
    got = np.asarray(got)
    if expected.shape != got.shape:
        return CheckResult(False, f"{label}: shape {expected.shape} vs {got.shape}")
    ok = almost_equal_ulps(expected, got, max_ulps)
    nbad = int((~ok).sum())
    if nbad:
        pos = np.unravel_index(int(np.argmax(~ok)), ok.shape)
        return CheckResult(
            False,
            f"{label}: {nbad} mismatches; first at {pos}: "
            f"expected {expected[pos]!r} got {got[pos]!r}",
            nbad,
        )
    return CheckResult(True, f"{label}: ULP-{max_ulps} match")


def check_abs_tol(expected, got, tol: float = 1e-2, label: str = "") -> CheckResult:
    """Absolute-difference tolerance (hw_final fp.cu:193-206 style)."""
    expected = np.asarray(expected, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    bad = np.abs(expected - got) > tol
    nbad = int(bad.sum())
    if nbad:
        pos = np.unravel_index(int(np.argmax(bad)), bad.shape)
        return CheckResult(
            False,
            f"{label}: {nbad} elements exceed |diff|>{tol}; first at {pos}: "
            f"expected {expected[pos]} got {got[pos]}",
            nbad,
        )
    return CheckResult(True, f"{label}: within abs tol {tol}")


def l2_distance(a, b) -> float:
    """Absolute L2 distance (reference ``L2Distance``,
    ``aux/reference_spMVscan-released.cu``)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2)))


def relative_l2_error(a, b) -> float:
    denom = float(np.sqrt(np.sum(np.asarray(a, np.float64) ** 2)))
    return l2_distance(a, b) / denom if denom else l2_distance(a, b)


def relative_linf_error(a, b) -> float:
    """Relative L∞ error (reference ``relativeLInfError``)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    denom = np.max(np.abs(a))
    num = np.max(np.abs(a - b))
    return float(num / denom) if denom else float(num)
