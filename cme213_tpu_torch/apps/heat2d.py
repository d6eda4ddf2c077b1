"""2-D heat-diffusion workload driver (reference hw2 single-device main).

Counterpart of ``cme213_tpu/apps/heat2d.py``, single device only.  The
orchestration mirrors ``hw/hw2/programming/2dHeat.cu:674-714``: parse
params → build grid → save the initial state → (optional) host golden →
device solve with the plain PyTorch stencil ("global memory" phase) → ULP
check → device solve with the hand-written kernel ("shared memory" phase)
→ ULP check → save the finals and report bandwidth/GFLOPs for each.

Runs on ``cuda`` unless the caller passes ``device="cpu"``
(``--device=cpu``); with no device and no CUDA it raises.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from ..config import SimParams
from ..core import PhaseTimer, bandwidth_gbs, check_op, gflops, resolve_device
from ..grid import make_initial_grid, save_grid_to_file
from ..ops import run_heat
from ..ops.stencil import flops_per_point
from ..ops.stencil_pipeline import run_heat_pipeline
from ..verify import check_ulp, golden


@dataclass
class HeatResult:
    ok: bool
    reports: list[str] = field(default_factory=list)


def _report(params: SimParams, label: str, ms: float) -> str:
    per_iter = ms / params.iters
    nbytes = 2 * 4 * params.nx * params.ny
    nflops = flops_per_point(params.order) * params.nx * params.ny
    return (f"{label}: {ms:.1f} ms total, "
            f"{bandwidth_gbs(nbytes, per_iter):.2f} GB/s, "
            f"{gflops(nflops, per_iter):.2f} GFLOP/s")


def run_single(params: SimParams, check_cpu: bool = True,
               save_files: bool = False, out_dir: str = ".",
               device=None) -> HeatResult:
    dev = resolve_device(device)
    timer = PhaseTimer(verbose=True)
    u0 = make_initial_grid(params, device=dev)
    if save_files:
        save_grid_to_file(u0, f"{out_dir}/grid_init.txt")

    ref = None
    if check_cpu:
        with timer.phase("cpu computation"):
            ref = golden.host_heat(u0.cpu().numpy(), params.iters,
                                   params.order, params.xcfl, params.ycfl)

    result = HeatResult(ok=True)
    args = (params.iters, params.order, params.xcfl, params.ycfl)

    # plain PyTorch stencil (the "global memory" kernel analog); one
    # untimed step first takes the device's lazy set-up out of the phase
    check_op("heat.torch", run_heat(u0, 1, *args[1:]))
    with timer.phase("gpu computation global") as ph:
        out_torch = run_heat(u0, *args)
        ph.block(out_torch)
    result.reports.append(
        _report(params, "torch", timer.last_ms("gpu computation global")))

    # the hand-written kernel (the "shared memory" kernel analog); the
    # untimed step builds it on first use and surfaces a failed launch here
    check_op("heat.pipeline",
             run_heat_pipeline(u0, 1, *args[1:], params.bc, k=1))
    with timer.phase("gpu computation shared") as ph:
        out_pipe = run_heat_pipeline(u0, *args, params.bc, k=1)
        ph.block(out_pipe)
    result.reports.append(
        _report(params, "pipeline", timer.last_ms("gpu computation shared")))

    if save_files and ref is not None:
        # the reference's artifact set includes the golden dump
        # (grid_final_cpu.txt, 2dHeat.cu:686-711)
        save_grid_to_file(ref, f"{out_dir}/grid_final_cpu.txt")

    for label, out in [("global", out_torch), ("shared", out_pipe)]:
        if ref is not None:
            res = check_ulp(ref, out.cpu().numpy(), max_ulps=10,
                            label=f"heat-{label}")
            if not res:
                print(res.message)
                result.ok = False
        if save_files:
            save_grid_to_file(out, f"{out_dir}/grid_final_gpu_{label}.txt")

    for r in result.reports:
        print(r)
    return result


def main(argv: list[str]) -> int:
    paths = [a for a in argv[1:] if not a.startswith("--")]
    path = paths[0] if paths else "params.in"
    if "--distributed" in argv:
        raise NotImplementedError(
            "the distributed heat solve is not ported yet (ROADMAP.md, "
            "queue A: dist on torch.distributed)")
    device = next((a.split("=", 1)[1] for a in argv
                   if a.startswith("--device=")), None)
    params = SimParams.from_file(path)
    res = run_single(params, check_cpu=params.nx * params.ny <= 512 * 512,
                     save_files=True, device=device)
    return 0 if res.ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
