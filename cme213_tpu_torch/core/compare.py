"""ULP-distance float comparison.

A copy of ``cme213_tpu/core/compare.py`` (numpy only): the port keeps its
own so that it imports nothing of the JAX package.

Re-expresses the reference's ``AlmostEqual2sComplement`` (two's-complement ULP
trick, ``hw/hw1/programming/mp1-util.h:44-61``; templated float/double variant
``hw/hw2/programming/mp1-util.h:43-76``) as a vectorized numpy operation using
the monotonic unsigned "radix key" transform — the same ordering as the
reference's signed transform but free of signed-overflow corner cases:

    key(x) = bits(x) flipped so that key is monotonic in x over all finite
             floats (sign bit set for positives, all bits flipped for
             negatives).

ULP distance is then plain unsigned subtraction of keys.
"""

from __future__ import annotations

import numpy as np

_FLOAT_VIEWS = {
    np.dtype(np.float32): (np.uint32, np.uint64, 0x8000_0000),
    np.dtype(np.float64): (np.uint64, np.uint64, 0x8000_0000_0000_0000),
}


def _monotonic_key(x: np.ndarray) -> np.ndarray:
    uint_t, wide_t, signbit = _FLOAT_VIEWS[x.dtype]
    bits = x.view(uint_t)
    neg = (bits & uint_t(signbit)) != 0
    key = np.where(neg, ~bits, bits | uint_t(signbit))
    return key.astype(wide_t) if uint_t is not np.uint64 else key


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise ULP distance between two same-dtype float arrays.

    Returned as uint64 (saturating semantics unnecessary: exact for f32; for
    f64 the distance itself fits uint64).
    """
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if a.dtype not in _FLOAT_VIEWS:
        raise ValueError(f"unsupported dtype {a.dtype}")
    ka = _monotonic_key(a)
    kb = _monotonic_key(b)
    return np.where(ka >= kb, ka - kb, kb - ka)


def almost_equal_ulps(a, b, max_ulps: int = 10) -> np.ndarray:
    """Elementwise bool: within ``max_ulps`` ULPs.

    ``max_ulps`` defaults to 10, the reference's checker tolerance
    (``hw/hw1/programming/pagerank.cu:43``, ``hw/hw2/programming/2dHeat.cu``
    ``checkErrors``).  NaNs never compare equal.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    ok = ulp_distance(a, b) <= np.uint64(max_ulps)
    return ok & ~(np.isnan(a) | np.isnan(b))
