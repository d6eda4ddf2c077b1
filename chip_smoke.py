#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It drives the
port (``cme213_tpu_torch``) and imports nothing of JAX or of the JAX
package.  Phases, each of which fails the run (non-zero exit) when it
fails:

1. Identity and build: the card's name and power limit (``nvidia-smi``),
   the torch and CUDA versions, and the time ``nvcc`` takes to build every
   library from ``cme213_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together; set-up, not measured work), with each kernel's
   registers and spills.
2. The example: ``apps.heat2d.run_single`` on ``examples/params.in``
   (512², order 8, 400 iterations) on ``cuda``: both phases pass the
   numpy-golden ULP-10 check and the kernel was launched.
3. Kernel against its plain version on the card, on the same CUDA
   tensors: ``run_heat_pipeline`` and ``run_heat_pipeline2d`` × k ∈
   {1,2,4,8} × order ∈ {2,4,8} at 1000² f32 (8·k iterations), one f64
   case, one awkward shape (257×121), and the main path's shapes (512²
   and 4000², order 8).  Fails above 10 ULP; 0 is expected, since both
   round every operation alike.
4. Full size, the headline workload of ``bench.py``: 4000² order 8 f32.
   ``run_single`` with 1000 iterations, then each entry point at each k
   for 1000 iterations: ms/iter, GB/s and % of the card's memory peak, the
   bound, the plain version's and ``ops.stencil.run_heat``'s ms/iter, and
   ``library_ms``, one step of ``conv2d`` with the cross-shaped stencil
   (TF32 off), a yardstick the port never calls.  Every kernel result is
   held to ``run_heat`` within ULP-10.
5. The SpMV-scan example (hw_final) through its CLI,
   ``apps.spmv_scan.main``, in a temporary directory: ``gen`` at its
   default size (n = 100,000, p = 1,000, q = 999, seed 0), then a run with
   ``cpu_check`` for each of ``--kernel=pallas-fused`` (B7) and
   ``--kernel=pallas`` (B6); each must print "Worked!" (the numpy f64
   golden at rel L2 ≤ 1e-4 and rel L∞ ≤ 1e-3).
6. A real instance at full size: the suite's Williams/dense2
   reconstruction (``dense2_problem(iters=10, seed=0)``: n = 4,000,000,
   2,000 segments, N = 10) through ``run_spmv_scan`` with each kernel, held
   to ``external_check`` (the f64 golden) at rel L2 ≤ 1e-4, rel L∞ ≤ 1e-3.
7. B6 and B7 against their plain versions on the same CUDA tensors: n ∈
   {1, 31, T−1, T, T+1, 3T+5, 100,003, 2²²} (T = 2048, the kernel's tile)
   × heads {one segment, every element, on tile boundaries, random}, B7 at
   1 and 8 iterations, and the main path's full-size shape (below).
   Fails above 0 ULP: both make the same additions in the same order.
8. Full size, the suite's largest instance: ``suite_problem("pwtk")``
   (n = 11,634,424, p = 217,919, N = 25) through ``run_spmv_scan`` with
   ``pallas-fused``, ``pallas``, ``auto`` (blocked torch) and ``flat``:
   ms per iteration (CUDA events, one warm-up, best of 2), GB/s against
   ``spmv_scan_cost`` and % of the card's memory peak, the bound; each
   result held to the plain version run in float64 on the card at rel L2
   ≤ 1e-5 and rel L∞ ≤ 1e-3 (``auto``, the blocked scan: rel L2 ≤ 1e-4,
   see ``PWTK_TOL``).  Then B6 alone per scan, the plain versions
   in f32, and ``torch.cumsum`` of n f32 as a yardstick the port never
   calls (no single PyTorch call computes a segmented scan, so
   ``library_ms`` is null).

9. B3, the shard kernel (``stencil_local_multistep``), against its plain
   version on the same CUDA tensors: the K-padded shard blocks the
   distributed solve assembles (``dist/heat._assemble_padded``) from a
   seeded 2000² interior — corners of a 2×2 mesh, an edge stripe of a
   1-D mesh of 4, the interior shard of a 3×3 mesh (2001²), a ghost-padded
   shard of a 2×2 mesh over 1999×2001 — × order ∈ {2,4,8} × k ∈
   {1,2,4,8} in f32, and two f64 cases.  The rows and columns ``[K, H−K)``
   are compared; fails above 10 ULP (0 expected).
10. The distributed heat solve (hw5) at the reference's largest size,
   2000², order 8, 1000 iterations, on four shards of the one card
   (``core.virtual_devices(4)``): ``apps.heat2d.run_distributed`` for 1-D
   stripes and 2-D blocks × sync and async with the ``xla`` local step and
   for 1-D and 2-D with ``pallas`` (B3); then ``run_distributed_heat`` on
   the 2-D mesh at k ∈ {2, 4} with each local kernel, and with ``pallas``
   on a 1-shard mesh.  Every result is held to ``ops.run_heat`` on the
   card within ULP-10 (0 expected).  Each path is timed again through
   ``prepare_distributed_heat`` (``iterate()`` times the step loop
   between device synchronisations): ms/step, GB/s and % of the memory
   peak by ``roofline.heat_cost``, and the bound.  Then B3 alone on the
   2-D path's four padded blocks (ms per step at k ∈ {1,2,4}, CUDA
   events), its plain version and ``library_ms``: ``conv2d`` over each
   padded block with the cross-shaped stencil (TF32 off).  Last, the CLI,
   ``heat2d.main([..., "examples/params_dist.in", "--distributed",
   "--local-kernel=pallas"])`` in a temporary directory, a 1×1 mesh of
   the physical card: its dumps must exist and its grid equal
   ``ops.run_heat``'s within ULP-10.
11. The sharded SpMV-scan at pwtk: ``run_spmv_scan_distributed`` over four
   shards of the card (``ring`` carries), held to phase 8's f64 plain run
   at ``auto``'s bound (rel L2 ≤ 1e-4, rel L∞ ≤ 1e-3: the per-shard scan
   is the blocked one), ms per iteration.

The main paths are what phases 2, 4, 5, 6, 8, 10 and 11 drive through the
entry points a user calls: ``run_single`` at 512² and at 4000² (kernel
B1), one solve of each of ``run_heat_pipeline`` and ``run_heat_pipeline2d``
(B2) at each k, the SpMV-scan runs (B6 through ``pallas``, B7 through
``pallas-fused``), the distributed heat solves (B3 through ``pallas``) and
the sharded SpMV-scan.  Every launch count
(``ops.stencil_pipeline.LAUNCHES`` and ``ops.segmented_pallas.LAUNCHES``)
is set to 0 just before each of these paths and read just after; each
path must launch exactly its own kernel and no other, ``iters + 1`` times
for ``run_single`` and ``run_spmv_scan`` (one untimed step or iteration,
then the solve), ``iters / k`` times for a heat solve and ``shards × iters
/ k`` for a distributed solve with ``pallas``; ``auto``, ``flat``, the
``xla`` distributed solves and the sharded SpMV-scan launch none.  The
launches of phases 3, 7 and 9's comparisons and of the timed repeats are
not read.

The lines before the last: the card's identity, then one JSON object
``{"kernels": [...]}`` with each kernel's launches on its full-size main
path (``launches``) and on every path (``launches_by_path``), its error,
times and bound (B1, B2: ms per step at 4000² order 8 f32, k = 1; B3: ms
per step of the 2-D pallas path at 2000², its four launches; the scan:
ms per iteration or per scan at pwtk).  The last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = {"pipeline": "cme213_tpu_torch/csrc/heat_stencil.cu",
          "pipeline2d": "cme213_tpu_torch/csrc/heat_stencil.cu",
          "local": "cme213_tpu_torch/csrc/heat_stencil.cu",
          "segscan": "cme213_tpu_torch/csrc/segmented_scan.cu",
          "spmv_fused": "cme213_tpu_torch/csrc/segmented_scan.cu"}
REPLACES = {"pipeline": "cme213_tpu/ops/stencil_pipeline.py:169",
            "pipeline2d": "cme213_tpu/ops/stencil_pipeline.py:558",
            "local": "cme213_tpu/ops/stencil_pipeline.py:656",
            "segscan": "cme213_tpu/ops/segmented_pallas.py:140",
            "spmv_fused": "cme213_tpu/ops/segmented_pallas.py:182"}
MAX_ULPS = 10
FULL_N, FULL_ORDER, FULL_ITERS = 4000, 8, 1000
#: hw5's largest size (BASELINE.md, hw5 table), on four shards of the card
DIST_N, DIST_ITERS, DIST_SHARDS = 2000, 1000, 4
#: the SpMV-scan kernels by ``run_spmv_scan`` kernel name, and the full size
SCAN_KERNELS = {"pallas-fused": "spmv_fused", "pallas": "segscan"}
SUITE = "pwtk"
NO_LIBRARY = "no single PyTorch call computes a segmented scan"
#: (rel L2, rel L∞) of each pwtk result from the f64 plain run.  ``auto`` is
#: the blocked scan, whose local sums are cumsums over 4096-element blocks
#: minus the cumsum before the segment's head; that cancellation costs
#: ~1e-5 over pwtk's 25 iterations in the reference too (JAX's blocked scan
#: on the CPU at a tenth of pwtk: 1.8e-5), so it is held to the engine's own
#: pass bound (``apps/spmv_scan.py`` ``cpu_check``).
PWTK_TOL = {"pallas-fused": (1e-5, 1e-3), "pallas": (1e-5, 1e-3),
            "flat": (1e-5, 1e-3), "auto": (1e-4, 1e-3)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a card")
    sys.path.insert(0, HERE)
    try:
        import cme213_tpu_torch
        from cme213_tpu_torch import config, core, dist, grid, ops
        from cme213_tpu_torch.apps import heat2d
        from cme213_tpu_torch.apps import spmv_scan as spmv
        from cme213_tpu_torch.apps.matrix_market import dense2_problem
        from cme213_tpu_torch.core import roofline
        from cme213_tpu_torch.dist import heat as dheat
        from cme213_tpu_torch.ops import _kernels
        from cme213_tpu_torch.ops import segmented_pallas as segp
        from cme213_tpu_torch.ops import stencil_pipeline as sp
        from cme213_tpu_torch.verify.checkers import (relative_l2_error,
                                                      relative_linf_error)
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    if os.path.dirname(os.path.dirname(
            os.path.abspath(cme213_tpu_torch.__file__))) != HERE:
        fail(f"imported {cme213_tpu_torch.__file__}, not the checkout's "
             f"package beside this script")

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    peak = roofline.peak_for(kind)
    if peak is None:
        fail(f"no peak figures for {kind!r} in core/roofline.PEAKS")
    entries = {"pipeline": ops.run_heat_pipeline,
               "pipeline2d": ops.run_heat_pipeline2d}

    def max_errors(a, b) -> tuple[int, float]:
        a, b = a.cpu().numpy(), b.cpu().numpy()
        ulp = int(core.ulp_distance(a, b).max())
        err = float(np.abs(a.astype(np.float64) - b).max())
        if not (np.isfinite(a).all() and ulp <= MAX_ULPS):
            fail(f"{ulp} ULP apart (limit {MAX_ULPS}) or not finite")
        return ulp, err

    def seeded_grid(p, dtype, seed):
        u = grid.make_initial_grid(p, dtype=torch.float64, device="cpu")
        b = p.border_size
        rng = np.random.default_rng(seed)
        u[b:-b, b:-b] += torch.from_numpy(rng.uniform(0, 1, (p.ny, p.nx)))
        return u.to(device=dev, dtype=dtype)

    # ---------------------------------------------------- 1. identity, build
    ident = core.card_identity()
    print(f"card: {ident}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    built = _kernels.build()
    print(f"kernel build (set-up): {time.perf_counter() - t0:.2f} s, "
          f"{len(built)} libraries, one nvcc each, in parallel")
    for name, path in built.items():
        _kernels.library(name)
        print(f"  {name}: {path.name}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling" in line or "Used" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    # ---------------------------------------------------- 2. the example
    paths: dict[str, dict[str, int]] = {}

    counters = (sp.LAUNCHES, segp.LAUNCHES)

    def counted(label, expect, run):
        """Drive one path with every count set to 0 just before it; fail
        unless the counts read just after are ``expect``."""
        for counter in counters:
            for key in counter:
                counter[key] = 0
        out = run()
        torch.cuda.synchronize()
        paths[label] = {k: v for c in counters for k, v in c.items()}
        print(f"launches of {label}: {paths[label]}")
        if paths[label] != expect:
            fail(f"{label}: launches {paths[label]}, expected {expect}")
        return out

    def only(name, n):
        return {key: (n if key == name else 0)
                for counter in counters for key in counter}

    params = config.SimParams.from_file(
        os.path.join(HERE, "examples", "params.in"))
    with tempfile.TemporaryDirectory() as out_dir:
        # run_single launches one untimed step, then the timed solve
        res = counted(
            f"run_single {params.nx}x{params.ny}",
            only("pipeline", params.iters + 1),
            lambda: heat2d.run_single(params, check_cpu=True,
                                      save_files=True, out_dir=out_dir,
                                      device="cuda"))
        dumps = sorted(os.listdir(out_dir))
    print(f"example {params.nx}x{params.ny} order {params.order} "
          f"{params.iters} iters: ok={res.ok} dumps={dumps}")
    if not res.ok:
        fail("the example failed its golden ULP-10 check")
    if len(dumps) != 4:
        fail(f"example: dumps {dumps}")

    # ---------------------------------------------------- 3. kernel vs plain
    worst_ulp = dict.fromkeys(entries, 0)
    worst_err = dict.fromkeys(entries, 0.0)

    def note(name, ulp, err):
        worst_ulp[name] = max(worst_ulp[name], ulp)
        worst_err[name] = max(worst_err[name], err)

    cases = [((1000, 1000), order, k, torch.float32)
             for order in (2, 4, 8) for k in (1, 2, 4, 8)]
    cases += [((1000, 1000), 8, 4, torch.float64),
              ((257, 121), 8, 1, torch.float32),
              ((257, 121), 4, 8, torch.float32),
              ((512, 512), 8, 1, torch.float32)]
    # the main path's own shapes: the example's and the full size's
    cases += [((FULL_N, FULL_N), FULL_ORDER, k, torch.float32)
              for k in (1, 2, 4, 8)]
    for seed, ((ny, nx), order, k, dtype) in enumerate(cases):
        p = config.SimParams(nx=nx, ny=ny, order=order, bc_top=1.5,
                             bc_left=0.5, bc_bottom=2.0, bc_right=0.25)
        u = seeded_grid(p, dtype, seed)
        args = (8 * k, order, p.xcfl, p.ycfl, p.bc)
        plain = ops.run_heat_pipeline_plain(u, *args, k=k)
        for name, fn in entries.items():
            ulp, err = max_errors(core.check_op(name, fn(u, *args, k=k)),
                                  plain)
            note(name, ulp, err)
            print(f"  vs plain: {name:<10} {ny}x{nx} order {order} k={k} "
                  f"{str(dtype)[6:]}: max ULP {ulp}, max |err| {err:.3g}")

    # ---------------------------------------------------- 4. full size
    full = config.SimParams(nx=FULL_N, ny=FULL_N, order=FULL_ORDER,
                            iters=FULL_ITERS)
    full_path = f"run_single {FULL_N}x{FULL_N}"
    res = counted(full_path, only("pipeline", full.iters + 1),
                  lambda: heat2d.run_single(full, check_cpu=False,
                                            device="cuda"))
    if not res.ok:
        fail("full-size run_single")
    u = grid.make_initial_grid(full, device="cuda")
    args = (full.iters, full.order, full.xcfl, full.ycfl, full.bc)
    step = roofline.heat_cost(full.ny, full.nx, order=full.order, iters=1)
    timings = {name: [] for name in entries}
    outs = []
    for name, fn in entries.items():
        for k in (1, 2, 4, 8):
            # one counted solve (its result is checked below), then the
            # timed solves, whose launches are not read
            out = counted(f"{fn.__name__} {FULL_N}x{FULL_N} k={k}",
                          only(name, full.iters // k),
                          lambda fn=fn, k=k: fn(u, *args, k=k))
            outs.append((name, k, out))
            ms = core.time_fn(lambda v, fn=fn, k=k: fn(v, *args, k=k), u,
                              warmup=1, iters=2) / full.iters
            # one launch runs k steps: it reads and writes the grid once
            # and does k steps' arithmetic
            launch = roofline.Cost(step.nbytes, step.flops * k)
            b_ms, b_by = roofline.bound_ms(launch, peak, torch.float32)
            gbs = step.gbs(ms)
            timings[name].append({"k": k, "ms": ms, "bound_ms": b_ms / k,
                                  "bound_by": b_by, "gbs": gbs})
            att = roofline.attribute(gbs, step.gflops(ms), device=kind)
            print(f"full {name:<10} k={k}: {ms:.6f} ms/iter, {gbs:.1f} GB/s "
                  f"({att['pct_peak']}% of {peak.gbs:.0f} GB/s), "
                  f"bound {b_ms / k:.6f} ms/iter by {b_by}")
    n_plain = 10
    plain_ms = core.time_fn(
        lambda v: ops.run_heat_pipeline_plain(v, n_plain, *args[1:], k=1),
        u, warmup=1, iters=2) / n_plain
    torch_ms = core.time_fn(lambda v: ops.run_heat(v, n_plain, *args[1:4]),
                            u, warmup=1, iters=2) / n_plain
    ref = ops.run_heat(u, *args[:4])
    for name, k, out in outs:
        ulp, err = max_errors(out, ref)
        note(name, ulp, err)
        print(f"  vs run_heat: {name:<10} k={k} {FULL_ITERS} iters: "
              f"max ULP {ulp}, max |err| {err:.3g}")

    torch.backends.cudnn.allow_tf32 = False

    def cross_weight(p):
        """``p``'s stencil step as a (1, 1, 2b+1, 2b+1) conv2d weight."""
        b = p.border_size
        w = torch.zeros(2 * b + 1, 2 * b + 1, dtype=torch.float32)
        coeffs = torch.tensor(ops.STENCIL_COEFFS[p.order])
        w[b, :] += coeffs * p.xcfl
        w[:, b] += coeffs * p.ycfl
        w[b, b] += 1.0
        return w.to(dev)[None, None]

    w = cross_weight(full)
    conv = torch.nn.functional.conv2d
    library_ms = core.time_fn(lambda v: conv(v[None, None], w), u,
                              warmup=2, iters=5)
    print(f"plain version {plain_ms:.6f} ms/iter, ops.stencil.run_heat "
          f"{torch_ms:.6f} ms/iter, conv2d yardstick {library_ms:.6f} ms")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"card after the runs: {smi.stdout.strip()}")

    # ---------------------------------------------------- 5. SpMV example
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as out_dir:
        os.chdir(out_dir)  # the CLI writes b.txt and b_cpu.txt here
        try:
            if spmv.main(["spmv_scan", "gen", "a.txt", "x.txt"]) != 0:
                fail("spmv_scan gen")
            gen = spmv.load_problem("a.txt", "x.txt")
            for kernel, name in SCAN_KERNELS.items():
                buf = io.StringIO()

                def cli(kernel=kernel, buf=buf):
                    with contextlib.redirect_stdout(buf):
                        return spmv.main(["spmv_scan", "a.txt", "x.txt",
                                          "cpu_check", f"--kernel={kernel}"])
                rc = counted(f"spmv_scan CLI gen n={gen.n} {kernel}",
                             only(name, gen.iters + 1), cli)
                print(buf.getvalue(), end="")
                if rc != 0 or "Worked!" not in buf.getvalue():
                    fail(f"spmv_scan CLI --kernel={kernel}: rc {rc}, no "
                         f"'Worked!'")
        finally:
            os.chdir(cwd)

    # ---------------------------------------------------- 6. dense2
    d2 = dense2_problem(iters=10, seed=0)
    for kernel, name in SCAN_KERNELS.items():
        out = counted(f"run_spmv_scan dense2 {kernel}",
                      only(name, d2.iters + 1),
                      lambda k=kernel: spmv.run_spmv_scan(d2, kernel=k,
                                                          device=dev))
        errs = spmv.external_check(d2, out)
        print(f"dense2 n={d2.n} p={d2.p} N={d2.iters} {kernel}: rel L2 "
              f"{errs['rel_l2']:.3e}, rel Linf {errs['rel_linf']:.3e}")
        if not (np.isfinite(out).all() and errs["rel_l2"] <= 1e-4
                and errs["rel_linf"] <= 1e-3):
            fail(f"dense2 {kernel}: external_check {errs}")

    # ---------------------------------------------------- 7. scan vs plain
    scan_ulp = dict.fromkeys(SCAN_KERNELS.values(), 0)
    scan_err = dict.fromkeys(SCAN_KERNELS.values(), 0.0)

    def scan_note(name, got, ref, label):
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        if not np.isfinite(ref).all():
            fail(f"{label}: the plain version is not finite")
        ulp = int(core.ulp_distance(got, ref).max())
        err = float(np.abs(got.astype(np.float64) - ref).max())
        print(f"  vs plain: {label}: max ULP {ulp}, max |err| {err:.3g}")
        if ulp > 0:
            fail(f"{label}: {ulp} ULP from the plain version (limit 0)")
        scan_ulp[name] = max(scan_ulp[name], ulp)
        scan_err[name] = max(scan_err[name], err)

    tile = segp.TILE
    rng = np.random.default_rng(2)
    for n in (1, 31, tile - 1, tile, tile + 1, 3 * tile + 5, 100_003,
              1 << 22):
        v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        xx = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
        v, xx = v.to(dev), xx.to(dev)
        for heads in ("one", "every", "tile-edges", "random"):
            f = np.zeros(n, np.int32)
            if heads == "one":
                f[0] = 1
            elif heads == "every":
                f[:] = 1
            elif heads == "tile-edges":
                f[::tile] = 1
            else:
                f[rng.random(n) < 0.02] = 1
                f[0] = 1
            f = torch.from_numpy(f).to(dev)
            scan_note("segscan", segp.segmented_scan_pallas(v, f),
                      segp.segmented_scan_pallas_plain(v, f),
                      f"B6 n={n} heads={heads}")
            for it in (1, 8):
                scan_note("spmv_fused", segp.spmv_scan_pallas(v, xx, f, it),
                          segp.spmv_scan_pallas_plain(v, xx, f, it),
                          f"B7 n={n} heads={heads} N={it}")

    # ---------------------------------------------------- 8. full size: pwtk
    prob = spmv.suite_problem(SUITE)
    a, xx, flags, starts = spmv.problem_tensors(prob, device=dev)
    n, n_it = prob.n, prob.iters
    print(f"{SUITE}: n={n} p={prob.p} q={prob.q} N={n_it}")
    ref64 = segp.spmv_scan_pallas_plain(a.double(), xx.double(), flags,
                                        n_it).cpu().numpy()
    it_cost = roofline.spmv_scan_cost(n, 1)
    it_bound, it_by = roofline.bound_ms(it_cost, peak, torch.float32)

    def per_call_ms(fn, x, reps):
        """Best of 2 timed runs of ``reps`` calls after one warm-up run
        (CUDA events), per call."""
        def run(v):
            for _ in range(reps):
                out = fn(v)
            return out
        return core.time_fn(run, x, warmup=1, iters=2) / reps

    spmv_rows = {}
    for kernel in ("pallas-fused", "pallas", "auto", "flat"):
        label = f"run_spmv_scan {SUITE} {kernel}"
        out = counted(label, only(SCAN_KERNELS.get(kernel), n_it + 1),
                      lambda k=kernel: spmv.run_spmv_scan(prob, kernel=k,
                                                          device=dev))
        runner = spmv._build_runner(kernel, n_it)
        ms = core.time_fn(lambda v, r=runner: r(v, xx, flags, starts), a,
                          warmup=1, iters=2) / n_it
        rel_l2 = relative_l2_error(ref64, out)
        rel_linf = relative_linf_error(ref64, out)
        gbs = it_cost.gbs(ms)
        att = roofline.attribute(gbs, it_cost.gflops(ms), device=kind)
        spmv_rows[kernel] = {"ms": ms, "gbs": gbs, "pct_peak": att["pct_peak"],
                             "bound_ms": it_bound, "bound_by": it_by,
                             "rel_l2_vs_f64": rel_l2,
                             "rel_linf_vs_f64": rel_linf}
        print(f"full {SUITE} {kernel:<12}: {ms:.6f} ms/iter, {gbs:.1f} GB/s "
              f"({att['pct_peak']}% of {peak.gbs:.0f} GB/s), bound "
              f"{it_bound:.6f} ms/iter by {it_by}; vs f64 plain: rel L2 "
              f"{rel_l2:.3e}, rel Linf {rel_linf:.3e}")
        tol_l2, tol_linf = PWTK_TOL[kernel]
        if not (np.isfinite(out).all() and rel_l2 <= tol_l2
                and rel_linf <= tol_linf):
            fail(f"{label}: rel L2 {rel_l2:.3e} / rel Linf {rel_linf:.3e} "
                 f"from the f64 plain run (limits {tol_l2} / {tol_linf})")

    w = a * xx  # B6's input on the pallas path's first iteration
    scan_note("segscan", segp.segmented_scan_pallas(w, flags),
              segp.segmented_scan_pallas_plain(w, flags), f"B6 {SUITE} n={n}")
    scan_note("spmv_fused", segp.spmv_scan_pallas(a, xx, flags, n_it),
              segp.spmv_scan_pallas_plain(a, xx, flags, n_it),
              f"B7 {SUITE} n={n} N={n_it}")
    scan_cost = roofline.segmented_scan_cost(n)
    b6_bound, b6_by = roofline.bound_ms(scan_cost, peak, torch.float32)
    b6_ms = per_call_ms(lambda v: segp.segmented_scan_pallas(v, flags), w,
                        n_it)
    b6_plain_ms = per_call_ms(
        lambda v: segp.segmented_scan_pallas_plain(v, flags), w, 3)
    b7_plain_ms = per_call_ms(
        lambda v: segp.spmv_scan_pallas_plain(v, xx, flags, 1), a, 3)
    cumsum_ms = per_call_ms(lambda v: torch.cumsum(v, 0), a, n_it)
    print(f"B6 alone {SUITE}: {b6_ms:.6f} ms/scan, "
          f"{scan_cost.gbs(b6_ms):.1f} GB/s, bound {b6_bound:.6f} ms by "
          f"{b6_by}; plain version {b6_plain_ms:.6f} ms/scan")
    print(f"B7 plain version {SUITE}: {b7_plain_ms:.6f} ms/iter")
    print(f"library_ms: null ({NO_LIBRARY})")
    print(f"yardstick, not a segmented scan: torch.cumsum of {n} f32 "
          f"{cumsum_ms:.6f} ms")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"card after the runs: {smi.stdout.strip()}")

    # ---------------------------------------------------- 9. B3 vs plain
    local_ulp, local_err = 0, 0.0

    def note_local(ulp, err):
        nonlocal local_ulp, local_err
        local_ulp = max(local_ulp, ulp)
        local_err = max(local_err, err)

    def shard_blocks(p, mesh, K, dtype, seed=0):
        """{(yi, xi): (K-padded block, gy0, gx0)} as the distributed solve
        assembles them on the card from a seeded interior of ``p``."""
        y_size, x_size, ny_loc, nx_loc = dheat._mesh_layout(p, mesh)
        rng = np.random.default_rng(seed)
        u = dheat._pad_interior_for_mesh(
            p.ic + rng.uniform(0, 1, (p.ny, p.nx)), p, y_size, x_size)
        blocks = dheat._scatter(torch.from_numpy(u).to(dtype),
                                dheat._shard_devices(mesh, y_size, x_size),
                                ny_loc, nx_loc)
        padded = dheat._assemble_padded(blocks, p, border=K)
        b = p.border_size
        return {(yi, xi): (padded[yi][xi], yi * ny_loc + b - K,
                           xi * nx_loc + b - K)
                for yi in range(y_size) for xi in range(x_size)}

    vdev = core.virtual_devices(DIST_SHARDS)
    local_cases = {  # name: (ny, nx, mesh, shard)
        "corner": (DIST_N, DIST_N, dist.make_mesh_2d(2, 2, devices=vdev),
                   [(0, 0), (1, 1)]),
        "edge": (DIST_N, DIST_N, dist.make_mesh_1d(4, devices=vdev),
                 [(1, 0)]),
        "interior": (2001, 2001,
                     dist.make_mesh_2d(3, 3, devices=vdev * 3), [(1, 1)]),
        "ghost": (1999, 2001, dist.make_mesh_2d(2, 2, devices=vdev),
                  [(1, 1)])}
    local_runs = [(order, k, torch.float32) for order in (2, 4, 8)
                  for k in (1, 2, 4, 8)] + [(8, 4, torch.float64),
                                            (2, 8, torch.float64)]
    for seed, (order, k, dtype) in enumerate(local_runs):
        for where, (ny, nx, mesh, shards) in local_cases.items():
            p = config.SimParams(nx=nx, ny=ny, order=order, bc_top=1.5,
                                 bc_left=0.5, bc_bottom=2.0, bc_right=0.25)
            K = k * p.border_size
            blocks = shard_blocks(p, mesh, K, dtype, seed)
            for shard in shards:
                blk, gy0, gx0 = blocks[shard]
                args = (gy0, gx0, p.ny, p.nx, order, p.xcfl, p.ycfl, p.bc)
                got = sp.stencil_local_multistep(blk, *args, k=k)
                ref = sp.stencil_local_multistep_plain(blk, *args, k=k)
                ulp, err = max_errors(got[K:-K, K:-K], ref[K:-K, K:-K])
                note_local(ulp, err)
                print(f"  vs plain: local {where} {shard} of {ny}x{nx} "
                      f"order {order} k={k} {str(dtype)[6:]}: max ULP {ulp}, "
                      f"max |err| {err:.3g}")

    # ---------------------------------------------------- 10. hw5 full size
    base = dict(nx=DIST_N, ny=DIST_N, order=8, iters=DIST_ITERS)
    dist_p = config.SimParams(**base)
    dist_ref = ops.run_heat(grid.make_initial_grid(dist_p, device=dev),
                            DIST_ITERS, dist_p.order, dist_p.xcfl,
                            dist_p.ycfl)
    dist_step = roofline.heat_cost(DIST_N, DIST_N, order=8, iters=1)
    dist_bound, dist_by = roofline.bound_ms(dist_step, peak, torch.float32)
    method = {"1d": config.GridMethod.STRIPES_1D,
              "2d": config.GridMethod.BLOCKS_2D}
    dist_rows = {}

    def dist_path(label, out, kernel, timed):
        """Hold ``out`` (the full halo grid) to ``run_heat`` and time the
        same solve again through ``timed`` (an ``iterate``)."""
        ulp, err = max_errors(torch.from_numpy(out), dist_ref)
        if kernel == "pallas":
            note_local(ulp, err)
        seconds, _ = timed()
        ms = seconds * 1e3 / DIST_ITERS
        gbs = dist_step.gbs(ms)
        att = roofline.attribute(gbs, dist_step.gflops(ms), device=kind)
        dist_rows[label] = {"ms": ms, "gbs": gbs,
                            "pct_peak": att["pct_peak"],
                            "bound_ms": dist_bound, "bound_by": dist_by,
                            "max_ulp_vs_run_heat": ulp}
        print(f"{label}: {ms:.6f} ms/step, {gbs:.1f} GB/s "
              f"({att['pct_peak']}% of {peak.gbs:.0f} GB/s), bound "
              f"{dist_bound:.6f} ms/step by {dist_by}; vs run_heat: max "
              f"ULP {ulp}, max |err| {err:.3g}")

    for dim, sync, kernel in [("1d", True, "xla"), ("1d", False, "xla"),
                              ("2d", True, "xla"), ("2d", False, "xla"),
                              ("1d", True, "pallas"), ("2d", True, "pallas")]:
        p = config.SimParams(**base, grid_method=method[dim],
                             synchronous=sync)
        label = (f"run_distributed {DIST_N}x{DIST_N} {dim} "
                 f"{'sync' if sync else 'async'} {kernel}")
        n_local = DIST_SHARDS * DIST_ITERS if kernel == "pallas" else 0
        out = counted(label, only("local", n_local),
                      lambda p=p, kernel=kernel: heat2d.run_distributed(
                          p, local_kernel=kernel, devices=vdev))
        mesh = dist.mesh_for_method(p.grid_method, devices=vdev)
        iterate, _, _ = dist.prepare_distributed_heat(p, mesh,
                                                      local_kernel=kernel)
        dist_path(label, out, kernel, iterate)
    mesh2d = dist.make_mesh_2d(2, 2, devices=vdev)
    mesh1 = dist.make_mesh_1d(1, devices=[dev])
    for mesh, k, kernel in [(mesh2d, 2, "xla"), (mesh2d, 4, "xla"),
                            (mesh2d, 2, "pallas"), (mesh2d, 4, "pallas"),
                            (mesh1, 1, "pallas")]:
        shards = mesh.devices.size
        label = (f"run_distributed_heat {DIST_N}x{DIST_N} "
                 f"{'x'.join(map(str, mesh.devices.shape))} {kernel} k={k}")
        n_local = shards * DIST_ITERS // k if kernel == "pallas" else 0
        out = counted(label, only("local", n_local),
                      lambda mesh=mesh, k=k, kernel=kernel:
                      dist.run_distributed_heat(
                          dist_p, mesh, steps_per_exchange=k,
                          local_kernel=kernel))
        iterate, _, k_used = dist.prepare_distributed_heat(
            dist_p, mesh, steps_per_exchange=k, local_kernel=kernel)
        if k_used != k:
            fail(f"{label}: ran k={k_used}")
        dist_path(label, out, kernel, iterate)

    # B3 alone on the 2-D path's four padded blocks, per step
    local_timing = []
    for k in (1, 2, 4):
        K = k * dist_p.border_size
        blocks = list(shard_blocks(dist_p, mesh2d, K,
                                   torch.float32).values())
        args = (dist_p.ny, dist_p.nx, dist_p.order, dist_p.xcfl,
                dist_p.ycfl, dist_p.bc)

        def launch_all(_, blocks=blocks, k=k):
            return [sp.stencil_local_multistep(blk, gy0, gx0, *args, k=k)
                    for blk, gy0, gx0 in blocks]

        ms = per_call_ms(launch_all, blocks[0][0], 200) / k
        nbytes = sum(2 * blk.numel() * blk.element_size()
                     for blk, _, _ in blocks)
        cost = roofline.Cost(nbytes, ops.flops_per_point(dist_p.order) * k
                             * DIST_N * DIST_N)
        b_ms, b_by = roofline.bound_ms(cost, peak, torch.float32)
        local_timing.append({"k": k, "ms": ms, "bound_ms": b_ms / k,
                             "bound_by": b_by,
                             "gbs": dist_step.gbs(ms)})
        print(f"B3 alone, 2x2 blocks of {DIST_N}x{DIST_N} k={k}: {ms:.6f} "
              f"ms/step, bound {b_ms / k:.6f} ms/step by {b_by}")
        if k == 1:
            local_plain_ms = per_call_ms(
                lambda _: [sp.stencil_local_multistep_plain(blk, gy0, gx0,
                                                            *args, k=1)
                           for blk, gy0, gx0 in blocks], blocks[0][0], 5)
            w_dist = cross_weight(dist_p)
            local_library_ms = per_call_ms(
                lambda _: [conv(blk[None, None], w_dist)
                           for blk, _, _ in blocks], blocks[0][0], 20)
    print(f"B3 plain version {local_plain_ms:.6f} ms/step, conv2d "
          f"yardstick over the 4 padded blocks {local_library_ms:.6f} ms")

    # the CLI: a 1x1 mesh of the physical card; the grid it computes is
    # caught on its way to the dumps
    params_dist = os.path.join(HERE, "examples", "params_dist.in")
    cli_p = config.SimParams.from_file(params_dist, distributed=True)
    caught = {}
    run_distributed = heat2d.run_distributed

    def catch(*a, **kw):
        caught["out"] = run_distributed(*a, **kw)
        return caught["out"]

    with tempfile.TemporaryDirectory() as out_dir:
        os.chdir(out_dir)
        heat2d.run_distributed = catch
        try:
            rc = counted(f"heat2d CLI --distributed pallas {cli_p.nx}x"
                         f"{cli_p.ny}", only("local", cli_p.iters
                                             * torch.cuda.device_count()),
                         lambda: heat2d.main(["heat2d", params_dist,
                                              "--distributed",
                                              "--local-kernel=pallas"]))
            dumps = sorted(os.listdir(out_dir))
        finally:
            heat2d.run_distributed = run_distributed
            os.chdir(cwd)
    if rc != 0 or dumps != ["grid0_final.txt", "grid_final.txt",
                            "grid_init.txt"]:
        fail(f"heat2d --distributed CLI: rc {rc}, dumps {dumps}")
    cli_ref = ops.run_heat(grid.make_initial_grid(cli_p, device=dev),
                           cli_p.iters, cli_p.order, cli_p.xcfl, cli_p.ycfl)
    ulp, err = max_errors(torch.from_numpy(caught["out"]), cli_ref)
    note_local(ulp, err)
    print(f"heat2d CLI --distributed --local-kernel=pallas: dumps {dumps}, "
          f"vs run_heat max ULP {ulp}, max |err| {err:.3g}")

    # ---------------------------------------------------- 11. sharded pwtk
    timer = core.PhaseTimer()
    label = f"run_spmv_scan_distributed {SUITE} {DIST_SHARDS} shards"
    out = counted(label, only(None, 0),
                  lambda: spmv.run_spmv_scan_distributed(
                      prob, dist.make_mesh_1d(devices=vdev), timer=timer))
    dist_scan_ms = timer.last_ms("spmv_scan_distributed") / n_it
    rel_l2 = relative_l2_error(ref64, out)
    rel_linf = relative_linf_error(ref64, out)
    print(f"{label}: {dist_scan_ms:.6f} ms/iter (host clock after a sync), "
          f"vs f64 plain: rel L2 {rel_l2:.3e}, rel Linf {rel_linf:.3e}")
    tol_l2, tol_linf = PWTK_TOL["auto"]
    if not (np.isfinite(out).all() and rel_l2 <= tol_l2
            and rel_linf <= tol_linf):
        fail(f"{label}: rel L2 {rel_l2:.3e} / rel Linf {rel_linf:.3e} "
             f"(limits {tol_l2} / {tol_linf})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"card after the runs: {smi.stdout.strip()}")

    # ---------------------------------------------------- summary lines
    # launches: the full-size path a user reaches each kernel by (B1 through
    # run_single, B2 through its own entry point at k = 1, B6 and B7 through
    # run_spmv_scan at pwtk)
    main_path = {"pipeline": full_path,
                 "pipeline2d": f"run_heat_pipeline2d {FULL_N}x{FULL_N} k=1",
                 "local": f"run_distributed {DIST_N}x{DIST_N} 2d sync "
                          f"pallas",
                 "segscan": f"run_spmv_scan {SUITE} pallas",
                 "spmv_fused": f"run_spmv_scan {SUITE} pallas-fused"}
    for name, path in main_path.items():
        if paths[path][name] <= 0:
            fail(f"kernel {name} was not launched on the main path")

    def by_path(name):
        return {label: seen[name] for label, seen in paths.items()
                if seen[name]}

    kernels = []
    for name in entries:
        k1 = timings[name][0]
        kernels.append({
            "name": f"heat_ksteps ({name})", "route": "cuda",
            "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": paths[main_path[name]][name],
            "main_path": main_path[name],
            "launches_by_path": by_path(name),
            "max_abs_err": worst_err[name], "max_ulp": worst_ulp[name],
            "ms": k1["ms"], "plain_ms": plain_ms, "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"], "library_ms": library_ms,
            "unit": f"ms per step, {FULL_N}x{FULL_N} order {FULL_ORDER} "
                    f"f32, k=1", "per_k": timings[name]})
    k1 = local_timing[0]
    kernels.append({
        "name": "heat_ksteps (local)", "route": "cuda",
        "source": SOURCE["local"], "replaces": REPLACES["local"],
        "launches": paths[main_path["local"]]["local"],
        "main_path": main_path["local"],
        "launches_by_path": by_path("local"),
        "max_abs_err": local_err, "max_ulp": local_ulp,
        "ms": k1["ms"], "plain_ms": local_plain_ms,
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": local_library_ms,
        "unit": f"ms per step (4 launches on the 2x2 mesh's padded blocks), "
                f"{DIST_N}x{DIST_N} order 8 f32, k=1",
        "per_k": local_timing, "paths": dist_rows})
    scan_rows = {
        "segscan": (b6_ms, b6_plain_ms, b6_bound, b6_by,
                    f"ms per scan, {SUITE} n={n} f32"),
        "spmv_fused": (spmv_rows["pallas-fused"]["ms"], b7_plain_ms,
                       it_bound, it_by,
                       f"ms per iteration, {SUITE} n={n} f32")}
    for name, (ms, p_ms, b_ms, b_by, unit) in scan_rows.items():
        kernels.append({
            "name": f"segmented_scan ({name})", "route": "cuda",
            "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": paths[main_path[name]][name],
            "main_path": main_path[name],
            "launches_by_path": by_path(name),
            "max_abs_err": scan_err[name], "max_ulp": scan_ulp[name],
            "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "library_note": NO_LIBRARY,
            "cumsum_yardstick_ms": cumsum_ms, "unit": unit})
    kernels[-1]["paths"] = spmv_rows  # B7's row: every kernel at pwtk
    print(ident)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
