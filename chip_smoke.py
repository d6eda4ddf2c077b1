#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It drives the
port (``cme213_tpu_torch``) and imports nothing of JAX or of the JAX
package.  Phases, each of which fails the run (non-zero exit) when it
fails:

1. Identity and build: the card's name and power limit (``nvidia-smi``),
   the torch and CUDA versions, and the time ``nvcc`` takes to build the
   kernels from ``cme213_tpu_torch/csrc`` (set-up, not measured work).
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

The main path is what phases 2 and 4 drive through the entry points a user
calls: ``run_single`` at 512² and at 4000² (kernel B1), and one solve of
each of ``run_heat_pipeline`` and ``run_heat_pipeline2d`` (B2) at each k.
The launch counts (``ops.stencil_pipeline.LAUNCHES``) are set to 0 just
before each of these paths and read just after; each path must launch
exactly its own kernel, ``iters + 1`` times for ``run_single`` (one
untimed step, then the solve) and ``iters / k`` times for a solve.  The
launches of phase 3's comparisons and of the timed repeats are not read.

The lines before the last: the card's identity, then one JSON object
``{"kernels": [...]}`` with each kernel's launches on its full-size main
path (``launches``) and on every path (``launches_by_path``), its error,
times and bound (ms per step at 4000² order 8 f32, k = 1).  The last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "cme213_tpu_torch/csrc/heat_stencil.cu"
REPLACES = {"pipeline": "cme213_tpu/ops/stencil_pipeline.py:169",
            "pipeline2d": "cme213_tpu/ops/stencil_pipeline.py:558"}
MAX_ULPS = 10
FULL_N, FULL_ORDER, FULL_ITERS = 4000, 8, 1000


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
        from cme213_tpu_torch import config, core, grid, ops
        from cme213_tpu_torch.apps import heat2d
        from cme213_tpu_torch.core import roofline
        from cme213_tpu_torch.ops import _kernels
        from cme213_tpu_torch.ops import stencil_pipeline as sp
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
    _kernels.library()
    print(f"kernel build (set-up): {time.perf_counter() - t0:.2f} s, "
          f"{_kernels.library_path().name}")
    for line in _kernels.library_path().with_suffix(".log").read_text() \
            .splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---------------------------------------------------- 2. the example
    paths: dict[str, dict[str, int]] = {}

    def counted(label, expect, run):
        """Drive one path with every count set to 0 just before it; fail
        unless the counts read just after are ``expect``."""
        for key in sp.LAUNCHES:
            sp.LAUNCHES[key] = 0
        out = run()
        torch.cuda.synchronize()
        paths[label] = dict(sp.LAUNCHES)
        print(f"launches of {label}: {paths[label]}")
        if paths[label] != expect:
            fail(f"{label}: launches {paths[label]}, expected {expect}")
        return out

    def only(name, n):
        return {key: (n if key == name else 0) for key in sp.LAUNCHES}

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

    b = full.border_size
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros(2 * b + 1, 2 * b + 1, dtype=torch.float32)
    coeffs = torch.tensor(ops.STENCIL_COEFFS[full.order])
    w[b, :] += coeffs * full.xcfl
    w[:, b] += coeffs * full.ycfl
    w[b, b] += 1.0
    w = w.to(dev)[None, None]
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

    # ---------------------------------------------------- 5. summary lines
    # launches: the full-size path a user reaches each kernel by (B1 through
    # run_single, B2 through its own entry point at k = 1)
    main_path = {"pipeline": full_path,
                 "pipeline2d": f"run_heat_pipeline2d {FULL_N}x{FULL_N} k=1"}
    kernels = []
    for name in entries:
        if paths[main_path[name]][name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
        k1 = timings[name][0]
        kernels.append({
            "name": f"heat_ksteps ({name})", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[name],
            "launches": paths[main_path[name]][name],
            "main_path": main_path[name],
            "launches_by_path": {label: seen[name]
                                 for label, seen in paths.items()
                                 if seen[name]},
            "max_abs_err": worst_err[name], "max_ulp": worst_ulp[name],
            "ms": k1["ms"], "plain_ms": plain_ms, "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"], "library_ms": library_ms,
            "unit": f"ms per step, {FULL_N}x{FULL_N} order {FULL_ORDER} "
                    f"f32, k=1", "per_k": timings[name]})
    print(ident)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
