"""Time variants of the band kernel's menu (``csrc/heat_band.cu``) on a card.

    python -m cme213_tpu_torch.bench.band_menu [--quick]

The menu fixes, per dtype and k class, the strip width TX, the threads a
block and the micro-tile height R (``ops/stencil_pallas.DESIGNS``).  Each
variant here replaces one f32 entry: its library is built with the entry
defined in a header that ``nvcc`` includes first (``-include``; the
entry's commas cannot go through ``-D``), one ``nvcc`` per variant, all
started together, into the package's build directory, and the wrappers
run it in place of the shipped one.  For each
variant and cell (B4 at 4000² tile_y 200 and 2000² tile_y 40/80/200/400,
B5 at 4000² tile_y 200 k = 2/4/8, order 8) it prints ms per step (CUDA
events around a solve, best of 3 after a warm-up), the host-clocked solve
at 2000², the buffers and runs of the plan, blocks an SM, registers and
local memory, and holds a small case to the plain version bit for bit.
Besides the plan's own choice, each variant runs with the staging buffers
forced to 1 and to 2 where they fit (two buffers walk ``balanced_run``
tiles a block, one buffer one tile), and with one buffer walking
``balanced_run`` tiles.  Prints one JSON line per timing; needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import subprocess
import sys
import time

import torch

from ..config import SimParams
from ..grid import make_initial_grid
from ..ops import _kernels
from ..ops import stencil_pallas as spl

#: k class -> the f32 variants (TX, threads, R, blocks an SM) to time
VARIANTS = {
    1: [(96, 256, 8, 2), (128, 256, 8, 2), (128, 256, 4, 2),
        (64, 128, 8, 4), (64, 256, 8, 2), (128, 128, 8, 4)],
    2: [(48, 256, 4, 2), (64, 512, 4, 1), (64, 256, 4, 2), (32, 256, 4, 2),
        (64, 256, 2, 3), (48, 512, 4, 1)],
    3: [(32, 256, 4, 2), (32, 512, 4, 1), (32, 256, 2, 2), (32, 512, 2, 1)],
}

#: (forced nbuf, forced run) of each timing: the plan's own, then forced;
#: run 0 stands for ``balanced_run``
MODES = [(None, None), (1, None), (2, None), (1, 0)]

#: (n, tile_y, k, steps) of each k class's cells, order 8 f32
CELLS = {1: [(4000, 200, 1, 64), (2000, 40, 1, 100), (2000, 80, 1, 100),
             (2000, 200, 1, 100), (2000, 400, 1, 100)],
         2: [(4000, 200, 2, 64)],
         3: [(4000, 200, 4, 64), (4000, 200, 8, 64)]}


def _build(variants):
    """{(kc, entry): ctypes library} for every variant, one nvcc each."""
    nvcc = _kernels._nvcc()
    src = _kernels.SOURCES["heat_band"]
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for kc, entry in variants:
        define = (f"#define HEAT_BAND_F32_K{kc} "
                  f"{', '.join(map(str, entry))}\n")
        tag = hashlib.sha256((src.read_text() + define).encode()).hexdigest()
        path = _kernels.BUILD_DIR / f"heat_band-variant-{tag[:16]}.so"
        header = path.with_suffix(".h")
        header.write_text(define)
        out[(kc, entry)] = path
        if not path.exists():
            procs[(kc, entry)] = subprocess.Popen(
                [nvcc, *_kernels.NVCC_FLAGS, "-include", str(header), "-o",
                 str(path), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    for key, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {key}:\n{err[-3000:]}")
    libs = {}
    for key, path in out.items():
        lib = ctypes.CDLL(str(path))
        _kernels._bind_heat_band(lib)
        libs[key] = lib
    return libs


def _ms(fn, u, steps):
    """(CUDA-event ms a step, host-clock ms a step) of ``fn(u)``."""
    fn(u)
    torch.cuda.synchronize()
    best, wall = float("inf"), float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn(u)
        b.record()
        torch.cuda.synchronize()
        wall = min(wall, (time.perf_counter() - t0) * 1e3)
        best = min(best, a.elapsed_time(b))
    return best / steps, wall / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the first variant of each class only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("band_menu: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    variants = [(kc, e) for kc, es in VARIANTS.items()
                for e in (es[:1] if args.quick else es)]
    t0 = time.perf_counter()
    libs = _build(variants)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    shipped = dict(spl.DESIGNS)
    geometry = spl.band_geometry
    grids = {}
    for (kc, entry), lib in libs.items():
        _kernels._libs["heat_band"] = lib
        spl.DESIGNS.clear()
        spl.DESIGNS.update(shipped)
        spl.DESIGNS[(4, kc)] = spl.Design(*entry,
                                          shipped[(4, kc)].prefetch)
        # a small case held to the plain version bit for bit
        p = SimParams(nx=121, ny=240, order=8, bc_top=1.5, bc_left=0.5,
                      bc_bottom=2.0, bc_right=0.25)
        k0 = {1: 1, 2: 2, 3: 3}[kc]
        u = make_initial_grid(p, device=dev)
        gen = torch.Generator(device=dev).manual_seed(kc)
        u[4:-4, 4:-4] += torch.rand(p.ny, p.nx, device=dev, generator=gen)
        for nbuf, run in MODES:
            def forced(ny, nx, tile_y, k, order, elem, sms, occupancy,
                       nbuf=nbuf, run=run):
                g = geometry(ny, nx, tile_y, k, order, elem, sms, occupancy,
                             nbuf=nbuf)
                if run is None:
                    return g
                tiles = -(-ny // tile_y)
                r = run or spl.balanced_run(g.grid[0], tiles,
                                            sms * g.blocks_per_sm)
                return dataclasses.replace(g, run=r,
                                           grid=(g.grid[0], -(-tiles // r)))

            spl._PLANS.clear()
            spl.band_geometry = forced
            try:
                got = spl.run_heat_multistep(u, 2 * k0, 8, p.xcfl, p.ycfl,
                                             p.bc, k=k0, tile_y=40)
            except ValueError:
                continue
            want = spl.run_heat_multistep_plain(u, 2 * k0, 8, p.xcfl,
                                                p.ycfl, p.bc, k=k0)
            if not torch.equal(got, want):
                print(f"variant {kc} {entry} nbuf={nbuf}: differs from "
                      f"the plain version")
                return 1
            for n, ty, k, steps in CELLS[kc]:
                if (n, k) not in grids:
                    grids[(n, k)] = make_initial_grid(
                        SimParams(nx=n, ny=n, order=8), device=dev)
                g = grids[(n, k)]
                fp = SimParams(nx=n, ny=n, order=8)
                try:
                    plan = spl.launch_plan(g, k, 8, ty)
                except ValueError:
                    continue
                if k == 1:
                    def fn(v, ty=ty, steps=steps):
                        return spl.run_heat_pallas(v, steps, 8, fp.xcfl,
                                                   fp.ycfl, tile_y=ty)
                else:
                    def fn(v, ty=ty, steps=steps, k=k):
                        return spl.run_heat_multistep(
                            v, steps, 8, fp.xcfl, fp.ycfl, fp.bc, k=k,
                            tile_y=ty)
                ms, wall = _ms(fn, g, steps)
                per_sm, regs, local = _kernels.heat_band_occupancy(
                    dev, 4, 8, k, plan.smem)
                print(json.dumps({
                    "class": kc, "entry": entry, "force_nbuf": nbuf,
                    "force_run": run,
                    "n": n, "tile_y": ty, "k": k, "ms": ms,
                    "host_ms": wall, "nbuf": plan.nbuf, "run": plan.run,
                    "grid": plan.grid, "smem": plan.smem,
                    "blocks_per_sm": per_sm, "registers": regs,
                    "local_bytes": local}), flush=True)
    spl.band_geometry = geometry
    spl.DESIGNS.clear()
    spl.DESIGNS.update(shipped)
    spl._PLANS.clear()
    _kernels._libs.pop("heat_band", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
