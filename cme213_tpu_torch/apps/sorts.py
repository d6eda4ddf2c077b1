"""Sorts workload driver (the reference's hw4).

Counterpart of ``cme213_tpu/apps/sorts.py``: the driver of
``hw/hw4/programming/mergesort.cpp:146-195`` and ``radixsort.cpp:163-215``.
Generate random keys, run the ``std::sort``-class golden, run the parallel
implementations, require element-wise equality, and report times and
throughputs.  The implementations:

- the host OpenMP merge sort and LSD radix sort (``cme213_tpu_torch.native``),
  host code by nature, as in the reference;
- the device radix sort (``ops/sort.py``), with ``run_radix_sort(...,
  device=True)`` (the reference's ``tpu=True``), on ``cuda`` unless
  ``device="cpu"``.

The CLI keeps the reference's knobs, ``sort_threshold merge_threshold
num_elements run_serial``, and runs the host sorts as the reference's does,
then the device radix sort on ``--device`` (default ``cuda``; like every
entry point it raises without a card unless given ``--device=cpu``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.trace import span
from ..verify import check_exact

# the timed sections mirror the reference's omp_get_wtime pairs
# (mergesort.cpp:168-184, radixsort.cpp:163-215): the perf_counter reads
# keep the printouts, the enclosing spans put the same phases in
# `python -m cme213_tpu_torch trace summary`


def run_merge_sort(num_elements: int = 1_000_000, sort_threshold: int = 4096,
                   merge_threshold: int = 4096, seed: int = 0) -> bool:
    from .. import native

    rng = np.random.default_rng(seed)
    keys = rng.integers(-(2**31), 2**31, size=num_elements,
                        dtype=np.int64).astype(np.int32)
    with span("sorts.std_sort", n=num_elements):
        t0 = time.perf_counter()
        golden = np.sort(keys)
        t_std = time.perf_counter() - t0

    data = keys.copy()
    with span("sorts.merge_sort", n=num_elements,
              threads=native.thread_count()):
        t0 = time.perf_counter()
        native.merge_sort(data, sort_threshold, merge_threshold)
        t_par = time.perf_counter() - t0
    print(f"std sort: {t_std:.3f} s, parallel merge sort: {t_par:.3f} s "
          f"({native.thread_count()} threads)")
    res = check_exact(golden, data, "merge sort")
    if not res:
        print(res.message)
    return bool(res)


def run_radix_sort(num_elements: int = 1_000_000, num_bits: int = 8,
                   block_size: int = 8192, run_serial: bool = True,
                   seed: int = 0, device: bool | str = False) -> bool:
    """The host radix sorts, and with ``device`` (True: ``cuda``; or a
    device name) the device radix sort too, each held to ``np.sort``."""
    from .. import native

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=num_elements,
                        dtype=np.uint64).astype(np.uint32)
    golden = np.sort(keys)
    ok = True

    data = keys.copy()
    with span("sorts.radix_parallel", n=num_elements,
              threads=native.thread_count()):
        t0 = time.perf_counter()
        native.radix_sort(data, num_bits, block_size)
        t_par = time.perf_counter() - t0
    print(f"parallel radix: {num_elements / t_par / 1e6:.1f}e6 elems/s "
          f"({t_par:.3f} s, {native.thread_count()} threads)")
    res = check_exact(golden, data, "parallel radix")
    ok &= bool(res)

    if run_serial:
        data = keys.copy()
        with span("sorts.radix_serial", n=num_elements):
            t0 = time.perf_counter()
            native.radix_sort_serial(data, num_bits)
            t_ser = time.perf_counter() - t0
        print(f"serial radix: {num_elements / t_ser / 1e6:.1f}e6 elems/s")
        ok &= bool(check_exact(golden, data, "serial radix"))

    if device is not False:
        from ..core import resolve_device
        from ..ops.sort import radix_sort

        dev = resolve_device(None if device is True else device)
        out = radix_sort(torch.from_numpy(keys).to(dev), num_bits=num_bits,
                         block_size=block_size)
        ok &= bool(check_exact(golden, out.cpu().numpy(), "device radix"))
    return ok


def main(argv: list[str]) -> int:
    from ..core import resolve_device

    device = None
    args = []
    for a in argv[1:]:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--"):
            print(f"error: unknown option {a!r}")
            return 2
        else:
            args.append(a)
    dev = resolve_device(device)
    sort_threshold = int(args[0]) if len(args) > 0 else 4096
    merge_threshold = int(args[1]) if len(args) > 1 else 4096
    num_elements = int(args[2]) if len(args) > 2 else 1_000_000
    run_serial = bool(int(args[3])) if len(args) > 3 else True
    ok = run_merge_sort(num_elements, sort_threshold, merge_threshold)
    ok &= run_radix_sort(num_elements, run_serial=run_serial,
                         device=str(dev))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
