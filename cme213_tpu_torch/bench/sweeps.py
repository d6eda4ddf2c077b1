"""Benchmark sweeps → CSV (the reference's analysis harness).

Counterpart of ``cme213_tpu/bench/sweeps.py``, with the same rows, column
names, labels and error-row semantics:

- ``cipher_vector_length_sweep`` — device bandwidth against array length
  for the three cipher variants
  (``hw/hw1/programming/analysis/cipher_vl.cu:154-159``);
- ``pagerank_avg_edges_sweep`` — bandwidth against the average out-degree
  (``analysis/pagerank.cu:47-62,172-174``);
- ``heat_sweep``              — GB/s and GFLOP/s over grid sizes × orders ×
  kernels (the reference's ``data/data.ods`` tables);
- ``pipeline_tune_sweep``     — k × tile_y surface of the pipelined kernels;
- ``pallas_tile_sweep``       — bandwidth against the band kernel's tile
  height (the reference's block-size sweep);
- ``heat_kernel_sweep``       — the kernel-strategy table behind
  ``bench.py``'s best-kernel pick;
- ``transfer_bandwidth_sweep`` — host↔device copy bandwidth;
- ``dist_heat_sweep``, ``dist_heat_compile_coverage`` — hw5's scaling
  table and the per-shard kernel's coverage matrix;
- ``scan_sweep``              — scans and the tiled transpose;
- ``sort_thread_sweep``        — the native sorts against the OpenMP
  thread count (the PBS harness ``pa4.pbs:20-28``), host work;
- ``sort_sweep``               — the device sorts against size;
- ``spmv_scan_sweep``, ``spmv_pallas_coverage``, ``spmv_suite_sweep`` — the
  SpMV-scan engine, its kernel's coverage and the suite table beside the
  4-thread OpenMP CPU run.

Every sweep takes ``device`` (default ``cuda``, resolved by
``core.platform.resolve_device``; no silent CPU fallback).  Where the JAX
package runs a Pallas kernel in interpret mode off the TPU, the port runs
the kernel's plain version on the CPU, and a ``mode`` column reads
``"plain"`` there and ``"compiled"`` on the card.  Byte and flop accounting
is ``core/roofline.py``'s; every timing row carries ``pct_peak`` and
``bound`` against the card's peaks (empty on the CPU, which has no entry).
"""

from __future__ import annotations

import csv
import time

import numpy as np
import torch

from ..core.platform import resolve_device

#: timed repeats of ``_time_ms``, after one untimed call
TIME_ITERS = 5


def _attrib(gbs: float, gflops: float, device: torch.device) -> dict:
    """``pct_peak``/``bound`` columns for a row measured on ``device``
    (empty strings when there is no signal or the device has no peak
    entry, as on the CPU)."""
    from ..core import roofline

    if not gbs or gbs <= 0:
        return {"pct_peak": "", "bound": ""}
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    att = roofline.attribute(gbs, gflops, device=name)
    if att["pct_peak"] is None:
        return {"pct_peak": "", "bound": ""}
    return {"pct_peak": att["pct_peak"], "bound": att["bound"]}


def write_csv(rows: list[dict], path: str) -> None:
    if not rows:
        return
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def _raise_if_device_error(e: Exception) -> None:
    """Re-raise CUDA errors instead of recording them as data.

    A sticky device error (an illegal address, a launch failure) poisons
    every later cell on the card, so it must fail the sweep (and the
    harness's retry re-runs it); only per-cell failures — a tile that does
    not fit, a shape a kernel refuses — belong in the table.  The kernel
    wrappers name the CUDA error code ("cudaError N"); PyTorch's own
    messages say "CUDA error".
    """
    msg = str(e)
    if any(tag in msg for tag in ("CUDA error", "cudaError")):
        raise e


def _synchronize(*values) -> None:
    """Wait for the devices of the CUDA tensors among ``values``."""
    for v in values:
        if torch.is_tensor(v) and v.is_cuda:
            torch.cuda.synchronize(v.device)


def _time_ms(fn, *args, iters: int = TIME_ITERS) -> float:
    """Best of ``iters`` host-clock runs of ``fn(*args)`` after one untimed
    run, each ended by a device synchronisation."""
    _synchronize(fn(*args), *args)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _synchronize(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _time_donated_ms(runner, u0: np.ndarray, device) -> float:
    """Warm-up and one timed run of a heat loop.

    Each call gets a fresh device copy of ``u0``, and the upload has
    finished before the clock starts (``torch.cuda.synchronize``): the
    copy is asynchronous, and timing ``runner(upload(u0))`` would hide the
    upload inside the timed region and deflate every bandwidth column.
    """
    dev = torch.device(device)

    def upload():
        u = torch.from_numpy(u0).to(dev)
        _synchronize(u)
        return u

    _synchronize(runner(upload()))
    u = upload()
    t0 = time.perf_counter()
    _synchronize(runner(u))
    return (time.perf_counter() - t0) * 1e3


def _initial_grid(p, dtype=torch.float32) -> np.ndarray:
    from ..grid import make_initial_grid

    return make_initial_grid(p, dtype=dtype, device="cpu").numpy()


def heat_sweep(sizes=(1000, 2000, 4000), orders=(2, 4, 8),
               iters: int = 100, dtype: str = "f32",
               ks=(1, 8), device=None) -> list[dict]:
    """Grid sizes × orders × kernels × dtype — the ``data/data.ods`` table.

    ``dtype='f64'`` reproduces the reference's double-precision rows; as in
    the JAX package, f64 rows measure ``run_heat`` alone.
    """
    from ..config import SimParams
    from ..core.roofline import heat_cost
    from ..ops import run_heat
    from ..ops.stencil_pipeline import pick_pipeline_tile, run_heat_pipeline

    dev = resolve_device(device)
    tdt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    rows = []
    for n in sizes:
        for order in orders:
            p = SimParams(nx=n, ny=n, order=order, iters=iters)
            u0 = _initial_grid(p, tdt)
            cands = [("xla", iters,
                      lambda u: run_heat(u, iters, order, p.xcfl, p.ycfl))]
            if dtype == "f32":
                for k in ks:
                    # round the count down to a multiple of k rather than
                    # silently dropping the kernel from the table
                    it_k = iters - iters % k
                    if not it_k:
                        continue
                    ty = pick_pipeline_tile(p.gy, k, order)
                    cands.append((f"pipeline-k{k}", it_k,
                                  lambda u, k=k, ty=ty, it=it_k:
                                  run_heat_pipeline(
                                      u, it, order, p.xcfl, p.ycfl, p.bc,
                                      k=k, tile_y=ty)))
            for label, n_it, runner in cands:
                cost = heat_cost(n, order=order, iters=n_it, dtype=dtype)
                try:
                    ms = _time_donated_ms(runner, u0, dev)
                except Exception as e:  # sticky per-cell failure = data
                    _raise_if_device_error(e)
                    rows.append({
                        "size": n, "order": order, "kernel": label,
                        "dtype": dtype, "iters": n_it, "ms": -1.0,
                        "gbs": 0.0, "gflops": 0.0,
                        "error": type(e).__name__,
                        "pct_peak": "", "bound": "",
                    })
                    continue
                rows.append({
                    "size": n, "order": order, "kernel": label,
                    "dtype": dtype, "iters": n_it, "ms": round(ms, 2),
                    "gbs": round(cost.gbs(ms), 2),
                    "gflops": round(cost.gflops(ms), 2),
                    "error": "",
                    **_attrib(cost.gbs(ms), cost.gflops(ms), dev),
                })
    return rows


def transfer_bandwidth_sweep(sizes=(1 << 20, 1 << 24, 1 << 26),
                             device=None) -> list[dict]:
    """Host↔device copy bandwidth (the reference's PCIe measurements,
    ``analysis/PA1_Dong-Bang_Tsai.odt`` §1c), from pageable host memory as
    the reference copies.  On the CPU both directions are host copies."""
    from ..core.roofline import transfer_cost

    dev = resolve_device(device)
    rows = []
    for n in sizes:
        host = torch.from_numpy(np.random.default_rng(0).integers(
            0, 255, n, dtype=np.uint64).astype(np.uint8))
        _synchronize(host[:64].to(dev, copy=True))
        cost = transfer_cost(n)
        t0 = time.perf_counter()
        d = host.to(dev, copy=True)
        _synchronize(d)
        h2d = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        d.to("cpu", copy=True)  # returns once the copy has landed
        d2h = (time.perf_counter() - t0) * 1e3
        rows.append({
            "bytes": n,
            "h2d_gbs": round(cost.gbs(h2d), 3),
            "d2h_gbs": round(cost.gbs(d2h), 3),
            # quoted against the card's memory peak like everything else:
            # the interconnect at low single-digit pct of it is the point
            # the reference's PCIe analysis makes
            **_attrib(max(cost.gbs(h2d), cost.gbs(d2h)), 0.0, dev),
        })
    return rows


def pipeline_tune_sweep(size: int = 4000, order: int = 8, iters: int = 64,
                        ks=(1, 2, 4, 8, 16),
                        targets=(256, 192, 128, 64),
                        device=None) -> list[dict]:
    """Tuning table for the pipelined kernels at the headline shape: k
    (fused sub-steps per launch) × tile_y ladder × {``run_heat_pipeline``,
    ``run_heat_pipeline2d``}.  Each target is clamped to the tile whose
    window fits a block's shared memory at that kernel's own width
    (``pick_pipeline_tile``), so the tiles differ from the JAX package's
    VMEM-clamped ladder.  Failed cells — at k = 16 no tile fits — are rows
    with an error tag, not aborts."""
    from ..config import SimParams
    from ..core.roofline import heat_cost
    from ..ops.stencil import BORDER_FOR_ORDER
    from ..ops.stencil_pipeline import (PIPELINE2D_TILE_BYTES,
                                        PIPELINE_TILE_BYTES,
                                        pick_pipeline_tile,
                                        run_heat_pipeline,
                                        run_heat_pipeline2d)

    dev = resolve_device(device)
    p = SimParams(nx=size, ny=size, order=order, iters=iters)
    u0 = _initial_grid(p)
    rows = []
    for k in ks:
        it_k = iters - iters % k
        if not it_k:
            continue
        widths = {f"pipeline-k{k}": (run_heat_pipeline,
                                     PIPELINE_TILE_BYTES // 4)}
        if k * BORDER_FOR_ORDER[order] <= 128:
            widths[f"pipeline2d-k{k}"] = (run_heat_pipeline2d,
                                          PIPELINE2D_TILE_BYTES // 4)
        cands = []
        for name, (entry, tx) in widths.items():
            tiles = []
            for tgt in targets:
                ty = pick_pipeline_tile(p.gy, k, order, target=tgt,
                                        tile_x=tx)
                if ty not in tiles:
                    tiles.append(ty)
            cands += [(name, ty, lambda u, entry=entry, k=k, ty=ty: entry(
                u, it_k, order, p.xcfl, p.ycfl, p.bc, k=k, tile_y=ty))
                for ty in tiles]
        for name, ty, runner in cands:
            cost = heat_cost(size, order=order, iters=it_k)
            try:
                ms = _time_donated_ms(runner, u0, dev)
            except Exception as e:  # a failing (k, tile) cell is data
                _raise_if_device_error(e)
                rows.append({"kernel": name, "k": k, "tile_y": ty,
                             "ms": -1.0, "gbs": 0.0, "gflops": 0.0,
                             "error": type(e).__name__,
                             "pct_peak": "", "bound": ""})
                continue
            rows.append({"kernel": name, "k": k, "tile_y": ty,
                         "ms": round(ms, 2),
                         "gbs": round(cost.gbs(ms), 2),
                         "gflops": round(cost.gflops(ms), 2),
                         "error": "",
                         **_attrib(cost.gbs(ms), cost.gflops(ms), dev)})
    return rows


def pallas_tile_sweep(size: int = 2000, order: int = 8, iters: int = 50,
                      tiles=(40, 80, 200, 400), device=None) -> list[dict]:
    """Effective bandwidth against the tile height of the band-staged
    stencil (B4) — the analog of the reference's CUDA block-size sweep
    (``analysis/cipher_bs.cu:154-170``): the knob of the on-chip staging
    granularity."""
    from ..config import SimParams
    from ..core.roofline import heat_cost
    from ..ops.stencil_pallas import run_heat_pallas

    dev = resolve_device(device)
    p = SimParams(nx=size, ny=size, order=order, iters=iters)
    u0 = _initial_grid(p)
    cost = heat_cost(size, order=order, iters=iters)
    rows = []
    for t in tiles:
        if size % t:
            continue
        runner = lambda u: run_heat_pallas(u, iters, order, p.xcfl,  # noqa: E731
                                           p.ycfl, tile_y=t)
        ms = _time_donated_ms(runner, u0, dev)
        rows.append({"tile_y": t, "ms": round(ms, 2),
                     "gbs": round(cost.gbs(ms), 2),
                     **_attrib(cost.gbs(ms), cost.gflops(ms), dev)})
    return rows


def heat_kernel_sweep(size: int = 4000, order: int = 8,
                      iters: int = 64, ks=(2, 4, 8),
                      tile: int | None = None, device=None) -> list[dict]:
    """Kernel-strategy comparison for the headline stencil: plain torch
    slices vs one conv vs the band-staged kernel (B4) vs k-step temporal
    blocking (B5) vs the pipelined kernels (B1, B2) — the effective-
    bandwidth table behind ``bench.py``'s best-kernel pick (reference
    analog: global vs shared-memory kernels in ``data/data.ods``).

    The pipelined rows take the tile height that fits at each kernel's own
    width: the JAX package asks ``pipeline2d`` for ``tile_x=512``, a TPU
    lane count; in shared memory an 8-row 512-wide window at k = 8 is
    331,776 B, over a block's 232,448, so the port passes its own width
    (``PIPELINE2D_TILE_BYTES``).
    """
    from ..config import SimParams
    from ..core.roofline import heat_cost
    from ..ops import run_heat, run_heat_conv
    from ..ops.stencil import run_heat_roll
    from ..ops.stencil_pallas import (pick_tile, run_heat_multistep,
                                      run_heat_pallas)
    from ..ops.stencil_pipeline import (PIPELINE2D_TILE_BYTES,
                                        pick_pipeline_tile,
                                        run_heat_pipeline,
                                        run_heat_pipeline2d)

    dev = resolve_device(device)
    p = SimParams(nx=size, ny=size, order=order, iters=iters)
    u0 = _initial_grid(p)
    t = tile or pick_tile(p.ny, 200)
    # the conv formulation is far slower per iteration in the JAX package;
    # it keeps the short run and the scaled accounting
    conv_iters = min(iters, 8)
    tx2d = PIPELINE2D_TILE_BYTES // 4

    cands = {
        "xla": (iters, lambda u: run_heat(u, iters, order, p.xcfl, p.ycfl)),
        "xla-roll": (iters,
                     lambda u: run_heat_roll(u, iters, order, p.xcfl,
                                             p.ycfl, p.bc)),
        "xla-conv": (conv_iters,
                     lambda u: run_heat_conv(u, conv_iters, order, p.xcfl,
                                             p.ycfl)),
        "pallas-roll": (iters,
                        lambda u: run_heat_pallas(u, iters, order, p.xcfl,
                                                  p.ycfl, tile_y=t)),
    }
    for k in ks:
        if iters % k == 0:
            cands[f"xla-roll-k{k}"] = (
                iters, lambda u, k=k: run_heat_roll(u, iters, order, p.xcfl,
                                                    p.ycfl, p.bc, k=k))
    for k in (1,) + tuple(ks):
        if iters % k == 0:
            ty = pick_pipeline_tile(p.gy, k, order)
            ty2d = pick_pipeline_tile(p.gy, k, order, tile_x=tx2d)
            cands[f"pipeline-k{k}"] = (
                iters, lambda u, k=k, ty=ty: run_heat_pipeline(
                    u, iters, order, p.xcfl, p.ycfl, p.bc, k=k, tile_y=ty))
            cands[f"pipeline2d-k{k}"] = (
                iters, lambda u, k=k, ty=ty2d: run_heat_pipeline2d(
                    u, iters, order, p.xcfl, p.ycfl, p.bc, k=k, tile_y=ty,
                    tile_x=tx2d))
    for k in ks:
        if iters % k == 0:
            cands[f"pallas-k{k}"] = (
                iters, lambda u, k=k: run_heat_multistep(
                    u, iters, order, p.xcfl, p.ycfl, p.bc, k=k, tile_y=t))

    rows = []
    for name, (n_it, fn) in cands.items():
        cost = heat_cost(size, order=order, iters=n_it)
        try:
            ms = _time_donated_ms(fn, u0, dev)
        except Exception as e:  # a kernel variant failing to launch is data
            _raise_if_device_error(e)
            rows.append({"kernel": name, "ms": -1.0, "gbs": 0.0,
                         "error": type(e).__name__,
                         "pct_peak": "", "bound": ""})
            continue
        rows.append({"kernel": name, "ms": round(ms, 2),
                     "gbs": round(cost.gbs(ms), 2),
                     "error": "",
                     **_attrib(cost.gbs(ms), cost.gflops(ms), dev)})
    return rows


def _method_name(method) -> str:
    from ..config import GridMethod

    return "1D" if method == GridMethod.STRIPES_1D else "2D"


def dist_heat_sweep(size: int = 256, order: int = 8, iters: int = 20,
                    ndevs=(1, 2, 4, 8), pallas: bool | None = None,
                    devices=None, device=None) -> list[dict]:
    """Strong-scaling table for the distributed heat solver: device count ×
    {1-D stripes, 2-D blocks} × {sync, overlapped, k-step} — the hw5
    measurement grid (``hw/hw5/programming/data.ods``).

    ``devices`` is the list a mesh takes its devices from (default
    ``dist.mesh.default_devices(device)``, every card); a count larger
    than the list is skipped.  ``core.virtual_devices(n)`` puts n shards on
    one device, the counterpart of the JAX tests' virtual CPU devices.
    ``pallas`` adds the per-shard kernel scheme (``pallas-k4``, B3);
    default: on the card only, where it is the kernel and not its plain
    version.
    """
    from ..config import GridMethod, SimParams
    from ..core.roofline import heat_cost
    from ..dist import mesh_for_method, prepare_distributed_heat
    from ..dist.mesh import default_devices

    dev = resolve_device(device)
    devices = list(devices) if devices is not None \
        else default_devices(dev)
    rows = []
    schemes = [("sync", False, 1, "xla"), ("async", True, 1, "xla"),
               ("ca-k4", False, 4, "xla")]
    if pallas is None:
        pallas = dev.type == "cuda"
    if pallas:
        schemes.append(("pallas-k4", False, 4, "pallas"))
    for nd in ndevs:
        if nd > len(devices):
            continue
        for method in (GridMethod.STRIPES_1D, GridMethod.BLOCKS_2D):
            for requested, overlap, k, lk in schemes:
                p = SimParams(nx=size, ny=size, order=order, iters=iters)
                mesh = mesh_for_method(method, nd, devices=devices)
                iterate, used_overlap, used_k = prepare_distributed_heat(
                    p, mesh, overlap=overlap, steps_per_exchange=k,
                    local_kernel=lk)
                iterate()          # warm-up: builds the kernel
                secs, _ = iterate()  # the step loop only (MPI_Wtime analog)
                # record the scheme that actually ran: overlap and the
                # communication-avoiding path fall back when shards are
                # too thin (or iters does not divide)
                if used_k > 1:
                    scheme = f"ca-k{used_k}"
                elif used_overlap:
                    scheme = "async"
                else:
                    scheme = "sync"
                cost = heat_cost(size, order=order, iters=iters)
                rows.append({
                    "devices": nd,
                    "method": _method_name(method),
                    "scheme": scheme,
                    "requested": requested,
                    "local_kernel": lk,
                    # the plain version times PyTorch on the CPU, not the
                    # kernel: the column keeps such a row from being read
                    # as the kernel's timing
                    "mode": ("plain" if lk == "pallas" and dev.type == "cpu"
                             else "compiled"),
                    "seconds": round(secs, 4),
                    # aggregate effective bandwidth across the mesh: the
                    # strong-scaling view the hw5 tables quote
                    "gbs": round(cost.gbs(secs * 1e3), 2),
                    **_attrib(cost.gbs(secs * 1e3),
                              cost.gflops(secs * 1e3), dev),
                })
    return rows


def dist_heat_compile_coverage(size: int = 2000, order: int = 8,
                               iters: int = 4, ndevs=(1, 2, 4, 8),
                               devices=None, device=None) -> list[dict]:
    """Coverage matrix of the per-shard kernel scheme under every mesh
    shape — NOT a timing table: does it build and run under this mesh shape
    (few iterations, ``ok`` column).  ``devices`` as in
    ``dist_heat_sweep``."""
    from ..config import GridMethod, SimParams
    from ..dist import mesh_for_method, prepare_distributed_heat
    from ..dist.mesh import default_devices

    dev = resolve_device(device)
    devices = list(devices) if devices is not None \
        else default_devices(dev)
    mode = "compiled" if dev.type == "cuda" else "plain"
    rows = []
    for nd in ndevs:
        if nd > len(devices):
            continue
        for method in (GridMethod.STRIPES_1D, GridMethod.BLOCKS_2D):
            p = SimParams(nx=size, ny=size, order=order, iters=iters)
            mesh = mesh_for_method(method, nd, devices=devices)
            try:
                iterate, _, used_k = prepare_distributed_heat(
                    p, mesh, overlap=False, steps_per_exchange=4,
                    local_kernel="pallas")
                iterate()
                ok, err = True, ""
                scheme = f"ca-k{used_k}" if used_k > 1 else "sync"
            except Exception as e:  # noqa: BLE001 — coverage, not timing
                _raise_if_device_error(e)
                ok, err, scheme = False, f"{type(e).__name__}: {e}", ""
            rows.append({
                "devices": nd,
                "method": _method_name(method),
                "scheme": scheme, "local_kernel": "pallas", "mode": mode,
                "iters": iters, "ok": ok, "error": err,
                "pct_peak": "", "bound": "",  # coverage table, not timing
            })
    return rows


def scan_sweep(n: int = 1 << 26, num_segments: int = 1 << 16,
               device=None) -> list[dict]:
    """Effective bandwidth of the scan family at 2^26 floats: plain
    inclusive scan, segmented scan, and the tiled transpose (B8) beside the
    library call (the "transpose+scan eff. GB/s" metrics)."""
    from ..core.roofline import scan_cost, transpose_cost
    from ..ops import (inclusive_scan, segmented_scan, transpose_pallas,
                       transpose_xla)
    from ..ops.segmented import head_flags_from_starts

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    starts = np.sort(rng.choice(np.arange(1, n, dtype=np.int64),
                                size=num_segments - 1, replace=False))
    starts = np.concatenate([[0], starts]).astype(np.int64)
    flags = head_flags_from_starts(torch.from_numpy(starts).to(dev), n)

    rows = []
    cost = scan_cost(n)
    ms = _time_ms(inclusive_scan, v)
    rows.append({"op": "inclusive_scan", "n": n, "ms": round(ms, 2),
                 "gbs": round(cost.gbs(ms), 2),
                 **_attrib(cost.gbs(ms), 0.0, dev)})
    ms = _time_ms(segmented_scan, v, flags)
    rows.append({"op": "segmented_scan", "n": n, "ms": round(ms, 2),
                 "gbs": round(cost.gbs(ms), 2),
                 **_attrib(cost.gbs(ms), 0.0, dev)})

    side = 4096
    m = torch.from_numpy(rng.standard_normal((side, side)).astype(
        np.float32)).to(dev)
    tcost = transpose_cost(side, side)
    for name, fn in [("transpose_xla", transpose_xla),
                     ("transpose_pallas",
                      lambda x: transpose_pallas(x, tile=256))]:
        ms = _time_ms(fn, m)
        rows.append({"op": name, "n": side * side, "ms": round(ms, 2),
                     "gbs": round(tcost.gbs(ms), 2),
                     **_attrib(tcost.gbs(ms), 0.0, dev)})
    return rows


def spmv_scan_sweep(ns=(1 << 16, 1 << 20, 1 << 22), iters: int = 8,
                    kernels=None, p_frac: float = 0.01,
                    device=None) -> list[dict]:
    """Effective bandwidth of the iterated SpMV-scan engine against kernel
    and problem size.

    Byte accounting is ``roofline.spmv_scan_cost``: every kernel is quoted
    against the single-pass useful-byte count, so the GB/s column shows the
    flat sweep's log2(n) extra traffic.  ``kernels=None`` picks all four on
    the card but only the torch pair on the CPU.  ``run_spmv_scan`` runs
    with ``fallback=False``, so a kernel failing at a shape is a data row.
    The ``tuned`` column names the cached winner (``core/tune.py``, op
    ``spmv_scan`` at the canonical size) that ``auto`` would dispatch to,
    empty when none is cached.
    """
    from ..apps import spmv_scan as sp
    from ..core import PhaseTimer, programs, tune
    from ..core.roofline import spmv_scan_cost

    dev = resolve_device(device)
    if kernels is None:
        kernels = (("flat", "blocked", "pallas", "pallas-fused")
                   if dev.type == "cuda" else ("flat", "blocked"))
    rows = []
    for n in ns:
        p = max(3, int(n * p_frac))
        prob = sp.generate_problem(n, p, max(2, p - 1), iters=iters,
                                   seed=n % 97)
        cost = spmv_scan_cost(n, iters)
        rec = tune.lookup("spmv_scan", f"n{programs.canonical_size(n)}",
                          device=dev)
        tuned = rec["candidate"] if rec else ""
        for kernel in kernels:
            timer = PhaseTimer()
            try:
                out = sp.run_spmv_scan(prob, timer=timer, kernel=kernel,
                                       fallback=False, device=dev)
            except Exception as e:  # a kernel failing at a shape is data
                _raise_if_device_error(e)
                rows.append({"n": n, "p": p, "iters": iters,
                             "kernel": kernel, "tuned": tuned,
                             "ms": -1.0, "gbs": 0.0,
                             "rel_l2": "", "error": type(e).__name__,
                             "pct_peak": "", "bound": ""})
                continue
            errs = sp.external_check(prob, out)
            ms = timer.last_ms("spmv_scan")
            rows.append({"n": n, "p": p, "iters": iters, "kernel": kernel,
                         "tuned": tuned, "ms": round(ms, 3),
                         "gbs": round(cost.gbs(ms), 3),
                         "rel_l2": f"{errs['rel_l2']:.2e}", "error": "",
                         **_attrib(cost.gbs(ms), cost.gflops(ms), dev)})
    return rows


def spmv_pallas_coverage(names=None, scale: float = 1.0, iters: int = 1,
                         device=None) -> list[dict]:
    """Shape-coverage rehearsal of the segmented-scan kernel (B7) at suite
    sizes — NOT a timing table.  Every instance's ``pallas-fused`` result is
    held to ``flat``'s (rel L2 < 1e-4); on the CPU this exercises the
    kernel's plain version."""
    import dataclasses

    from ..apps import spmv_scan as sp
    from ..apps.matrix_market import real_instance_specs

    dev = resolve_device(device)
    mode = "compiled" if dev.type == "cuda" else "plain"
    specs = [(n, "synthetic", None)
             for n in (names or sp.BELL_GARLAND_SUITE)]
    if names is None:
        specs.extend(real_instance_specs())
    rows = []
    for name, source, factory in specs:
        prob = (sp.suite_problem(name, scale=scale) if factory is None
                else factory())
        prob = dataclasses.replace(prob, iters=iters)
        rel = None
        try:
            out_pallas = sp.run_spmv_scan(prob, kernel="pallas-fused",
                                          fallback=False, device=dev)
            out_flat = sp.run_spmv_scan(prob, kernel="flat",
                                        fallback=False, device=dev)
            rel = float(np.linalg.norm(out_pallas - out_flat)
                        / max(np.linalg.norm(out_flat), 1e-30))
            ok, err = bool(rel < 1e-4), ""
        except Exception as e:  # noqa: BLE001 — coverage, not timing
            _raise_if_device_error(e)
            ok, err = False, f"{type(e).__name__}: {e}"
        rows.append({
            "matrix": name, "source": source, "n": prob.n, "p": prob.p,
            "mode": mode, "iters": iters, "ok": ok,
            "rel_l2_vs_flat": f"{rel:.2e}" if rel is not None else "",
            "error": err,
            "pct_peak": "", "bound": "",  # coverage table, not timing
        })
        print(rows[-1])
    return rows


def cipher_vector_length_sweep(steps: int = 10, max_bytes: int = 1 << 24,
                               shift: int = 17, device=None) -> list[dict]:
    """GB/s of each cipher variant against the array length, on text
    tiled to length (the reference carves its buffers from its novel), by
    ``roofline.cipher_cost``."""
    from ..apps.corpus import load_corpus
    from ..core.roofline import cipher_cost
    from ..ops import shift_cipher, shift_cipher_packed

    dev = resolve_device(device)
    base = load_corpus()  # loaded once for every step
    rows = []
    for i in range(1, steps + 1):
        n = max(64, (max_bytes * i // steps) // 64 * 64)
        data = torch.from_numpy(np.tile(base, -(-n // base.size))[:n]).to(dev)
        cost = cipher_cost(n)
        row = {"length": n}
        for name, fn in [
                ("char_gbs", lambda d: shift_cipher(d, shift)),
                ("uint_gbs", lambda d: shift_cipher_packed(d, shift, 4)),
                ("uint2_gbs", lambda d: shift_cipher_packed(d, shift, 8))]:
            row[name] = round(cost.gbs(_time_ms(fn, data)), 3)
        # the fastest variant is the device-capability signal the
        # reference's bandwidth plot reads off this table
        row.update(_attrib(max(row["char_gbs"], row["uint_gbs"],
                               row["uint2_gbs"]), 0.0, dev))
        rows.append(row)
    return rows


def pagerank_avg_edges_sweep(num_nodes: int = 1 << 18,
                             edges_range=range(2, 21),
                             iterations: int = 20,
                             device=None) -> list[dict]:
    """ms and GB/s of ``iterations`` PageRank sweeps against the average
    out-degree, by ``roofline.pagerank_cost``.  The graph is uploaded and
    laid out before the clock starts, as the reference's analysis program
    times its kernels (the JAX package's row also holds the upload)."""
    from ..apps.pagerank import build_graph, iterate, upload
    from ..core.roofline import pagerank_cost

    dev = resolve_device(device)
    rows = []
    for avg in edges_range:
        g = build_graph(num_nodes, avg, seed=avg)
        dg = upload(g, dev)
        rank0 = torch.from_numpy(g.rank0).to(dev)
        ms = _time_ms(lambda r: iterate(dg, r, iterations), rank0)
        cost = pagerank_cost(g.num_nodes, g.edges.shape[0], iterations)
        rows.append({
            "avg_edges": avg,
            "ms": round(ms, 3),
            "bytes": cost.nbytes,
            "gbs": round(cost.gbs(ms), 3),
            **_attrib(cost.gbs(ms), cost.gflops(ms), dev),
        })
    return rows


def sort_thread_sweep(num_elements: int = 1_000_000,
                      threads=(1, 2, 4, 8, 16, 32),
                      device=None) -> list[dict]:
    """Seconds of the native merge sort and keys/s of the native radix sort
    against the OpenMP thread count.  Host work: ``device`` is taken for
    the harness's uniform call and not used, and the rows carry no peak
    share (the host has no entry in the peak table)."""
    from .. import native
    from ..core.roofline import sort_cost

    rng = np.random.default_rng(0)
    mkeys = rng.integers(-(2**31), 2**31, num_elements,
                         dtype=np.int64).astype(np.int32)
    rkeys = rng.integers(0, 2**32, num_elements,
                         dtype=np.uint64).astype(np.uint32)
    # build/load the library and touch the buffers before the first row
    native.merge_sort(mkeys[:10_000].copy())
    native.radix_sort(rkeys[:10_000].copy())
    host = torch.device("cpu")
    prev = native.thread_count()
    rows = []
    try:
        for t in threads:
            native.set_threads(t)
            a = mkeys.copy()
            t0 = time.perf_counter()
            native.merge_sort(a)
            t_merge = time.perf_counter() - t0
            b = rkeys.copy()
            t0 = time.perf_counter()
            native.radix_sort(b)
            t_radix = time.perf_counter() - t0
            merge_gbs = sort_cost(num_elements, "merge").nbytes / 1e9 / t_merge
            radix_gbs = sort_cost(num_elements, "radix").nbytes / 1e9 / t_radix
            rows.append({
                "threads": t,
                "merge_s": round(t_merge, 4),
                "radix_elems_per_s": round(num_elements / t_radix, 0),
                **_attrib(max(merge_gbs, radix_gbs), 0.0, host),
            })
    finally:
        native.set_threads(prev)
    return rows


def sort_sweep(ns=(1 << 16, 1 << 20),
               kernels=("lax", "radix", "bitonic", "auto"),
               device=None) -> list[dict]:
    """The device sorts against size: the library sort (``lax``), the
    4-phase radix, the bitonic network and the tuned ``auto`` dispatch
    (``ops.sort.sort_auto``), each held to ``np.sort``.  Bytes by
    ``roofline.sort_cost`` (radix: 4 passes; the others: log2(n)); the
    ``tuned`` column names the cached winner ``auto`` dispatched to (empty:
    none cached, ``auto`` is ``lax``)."""
    from ..core import programs, tune
    from ..core.roofline import sort_cost
    # not ``from ..ops import sort``: the package re-exports the sort
    # function under that name, shadowing the submodule
    from ..ops.sort import bitonic_sort, radix_sort, sort, sort_auto

    dev = resolve_device(device)
    fns = {"lax": sort, "radix": radix_sort, "bitonic": bitonic_sort,
           "auto": sort_auto}
    rows = []
    for n in ns:
        rng = np.random.default_rng(n % 97)
        keys_host = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
        keys = torch.from_numpy(keys_host).to(dev)
        expect = np.sort(keys_host)
        rec = tune.lookup("sort", f"n{programs.canonical_size(n)}",
                          "uint32", device=dev)
        tuned = rec["candidate"] if rec else ""
        for kernel in kernels:
            resolved = (tuned or "lax") if kernel == "auto" else kernel
            cost = sort_cost(n, kind="radix" if resolved == "radix"
                             else "merge")
            try:
                ms = _time_ms(fns[kernel], keys)
                ok = bool((fns[kernel](keys).cpu().numpy() == expect).all())
            except Exception as e:  # a kernel failing at a size is data
                _raise_if_device_error(e)
                rows.append({"n": n, "kernel": kernel, "tuned": tuned,
                             "ms": -1.0, "gbs": 0.0, "ok": False,
                             "error": type(e).__name__,
                             "pct_peak": "", "bound": ""})
                continue
            rows.append({"n": n, "kernel": kernel, "tuned": tuned,
                         "ms": round(ms, 3),
                         "gbs": round(cost.gbs(ms), 3), "ok": ok,
                         "error": "", **_attrib(cost.gbs(ms), 0.0, dev)})
    return rows


def spmv_suite_sweep(names=None, scale: float = 0.05, kernels=None,
                     cpu_threads: int | None = 4,
                     device=None) -> list[dict]:
    """Device kernels against the OpenMP CPU run over the suite.

    ``cpu_threads`` adds the reference's CPU axis (its 4-thread table,
    ``hw/hw_final/programming/data.ods`` table 2, ``fp.cu:130-152``) as a
    ``cpu_ms`` column (host clock); ``None`` skips it.  ``kernels=None``
    picks ``flat``, ``blocked`` and ``pallas-fused`` (B7) on the card and
    ``flat`` on the CPU, where ``pallas-fused`` would run its plain version.
    Each row's ``rel_l2`` is against the f64 golden, computed once a
    problem.  ``run_spmv_scan`` runs with ``fallback=False``: a failing
    kernel fails its row, never demotes to another."""
    from .. import native
    from ..apps import spmv_scan as sp
    from ..apps.matrix_market import real_instance_specs
    from ..core import PhaseTimer
    from ..core.roofline import spmv_scan_cost
    from ..verify import golden
    from ..verify.checkers import relative_l2_error

    dev = resolve_device(device)
    if kernels is None:
        kernels = (("flat", "blocked", "pallas-fused") if dev.type == "cuda"
                   else ("flat",))
    specs = [(n, "synthetic", None)
             for n in (names or sp.BELL_GARLAND_SUITE)]
    # on the full default suite, the reconstructed real instances ride the
    # same sweep, so the table has rows whose source is a published problem
    if names is None:
        specs.extend(real_instance_specs())
    rows = []
    for name, source, factory in specs:
        prob = (sp.suite_problem(name, scale=scale) if factory is None
                else factory())
        cpu_ms = None
        if cpu_threads is not None:
            prev = native.thread_count()
            try:
                native.set_threads(cpu_threads)
                native.spmv_scan_cpu(prob.a, prob.s[:-1], prob.xx, 1)  # warm
                t0 = time.perf_counter()
                native.spmv_scan_cpu(prob.a, prob.s[:-1], prob.xx,
                                     prob.iters)
                cpu_ms = (time.perf_counter() - t0) * 1e3
            finally:
                native.set_threads(prev)
        ref = golden.host_spmv_scan(prob.a, prob.s[:-1], prob.xx,
                                    prob.iters, dtype=np.float64)
        cost = spmv_scan_cost(prob.n, prob.iters)
        for kernel in kernels:
            timer = PhaseTimer()
            out = sp.run_spmv_scan(prob, timer=timer, kernel=kernel,
                                   fallback=False, device=dev)
            ms = timer.last_ms("spmv_scan")
            row = {
                "matrix": name, "source": source, "kernel": kernel,
                "n": prob.n, "p": prob.p, "iters": prob.iters,
                "ms": round(ms, 3),
                "gbs": round(cost.gbs(ms), 3),
                "rel_l2": f"{relative_l2_error(ref, out):.2e}",
                **_attrib(cost.gbs(ms), cost.gflops(ms), dev),
            }
            if cpu_ms is not None:
                row["cpu_ms"] = round(cpu_ms, 3)
                row["cpu_threads"] = cpu_threads
            rows.append(row)
    return rows
