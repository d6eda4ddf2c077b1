"""2-D heat-diffusion workload: the reference's hw2 single-device main and
hw5 distributed main.

Counterpart of ``cme213_tpu/apps/heat2d.py``.  The single-device
orchestration mirrors ``hw/hw2/programming/2dHeat.cu:674-714``: parse
params → build grid → save the initial state → (optional) host golden →
device solve with the plain PyTorch stencil ("global memory" phase) → ULP
check → device solve with the hand-written kernel behind the fallback
ladder (``ops/stencil_pipeline.run_heat_resilient``, "shared memory"
phase) → ULP check → save the finals and report bandwidth/GFLOPs for each.

Report labels: ``torch`` for the plain stencil (the JAX package's
``xla``), ``pipeline`` for the kernel (its ``pallas``), and
``pipeline-><rung>`` when the ladder demoted (its ``pallas-><rung>``).  The
distributed entry (``run_distributed``, ``--distributed``) is the hw5 main
(``2dHeat.cpp:817-851``): grid method and sync/async from the params file;
launched as a gang (``dist.launch --np N``) each rank joins the process
group and holds its own shards.  ``run_distributed_supervised``
(``--supervised``) is its form under gang supervision: epoch commits,
heartbeats, resume.
``run_heat_checkpointed`` is the long-solve form (``run_heat`` in
checkpointed chunks, ``core/checkpoint.py``) and ``run_heat_batched`` the
stacked form the serving layer batches same-shape requests through; both
run the plain torch stencil, as the JAX package runs XLA there.

Runs on ``cuda`` unless the caller passes ``device="cpu"``
(``--device=cpu``); with no device and no CUDA it raises.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import SimParams
from ..core import PhaseTimer, bandwidth_gbs, check_op, gflops, resolve_device
from ..core.numerics import host_array
from ..dist import mesh_for_method, run_distributed_heat
from ..dist.mesh import default_devices
from ..dist.multihost import initialize_multihost, process_info
from ..grid import make_initial_grid, save_grid_to_file
from ..ops import run_heat
from ..ops.stencil import flops_per_point, run_heat_bytes
from ..ops.stencil_pipeline import run_heat_resilient
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

    # the hand-written kernel (the "shared memory" kernel analog) behind
    # the fallback ladder pipeline -> pipeline2d (-> xla on the CPU): a
    # rung that an injected fault or its conformance probe rejects
    # demotes; a kernel that cannot build or launch raises, and so does a
    # card whose kernel rungs are all refused.  The program's first use builds
    # it and makes one untimed launch; the timed phase is the solve alone
    res = run_heat_resilient(u0, *args, params.bc, k=1, timer=timer)
    out_pipe = res.value
    label = "pipeline" if not res.demoted else f"pipeline->{res.rung}"
    if res.demoted:
        print(f"heat2d: kernel demoted to {res.rung!r} "
              f"(failed: {', '.join(f.rung for f in res.failures)})")
    result.reports.append(
        _report(params, label, timer.last_ms("gpu computation shared")))

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


def run_heat_batched(grids: list, iters: int, order: int, xcfls: list[float],
                     ycfls: list[float], device=None) -> list[np.ndarray]:
    """Serve B same-class heat requests (equal grid shape, ``order`` and
    ``iters``) as one stacked solve, the path the serving layer batches
    same-shape grids through: ``run_heat`` on the (B, gy, gx) stack (the
    JAX package's ``_heat_batched``).  CFL factors are per-lane, (B, 1, 1)
    in the grid's dtype, so requests need not share them to share a
    batch.  ``grids`` are arrays or tensors; they are stacked in f32 on
    ``device`` (default ``cuda``).  The program comes from
    ``core/programs`` (its warm-up, one step on zeros, behind
    ``check_op``), and the solve runs under the ``heat_batched.run`` span.
    Returns one host array a lane, each bit for bit its serial
    ``run_heat``."""
    if not grids:
        return []
    shape = tuple(grids[0].shape)
    for g in grids:
        if tuple(g.shape) != shape:
            raise ValueError(
                f"batch mixes grid shapes: {tuple(g.shape)} vs {shape}")
    from ..core import programs, span

    dev = resolve_device(device)
    b, (gy, gx) = len(grids), shape
    shape_class = f"{gy}x{gx}/order{order}/i{iters}/b{b}"

    def build():
        return lambda u, xc, yc: run_heat(u, iters, order, xc, yc)

    def warm(fn):
        z = torch.zeros(b, 1, 1, dtype=torch.float32, device=dev)
        check_op("heat_batched.xla", run_heat(
            torch.zeros(b, gy, gx, dtype=torch.float32, device=dev), 1,
            order, z, z))

    runner = programs.get("heat_batched", "xla", shape_class, build,
                          dtype="f32", device=dev, warm=warm, iters=iters,
                          order=order, batch=b)
    u = torch.stack([torch.as_tensor(g).to(dev, torch.float32)
                     for g in grids])
    # per-lane factors, rounded to f32 as the serial solve rounds its own
    xc = torch.tensor(xcfls, dtype=torch.float32, device=dev).view(b, 1, 1)
    yc = torch.tensor(ycfls, dtype=torch.float32, device=dev).view(b, 1, 1)
    with span("heat_batched.run", kernel="xla",
              shape_class=shape_class) as sp:
        out = runner(u, xc, yc)
        sp.block(out)
    out = out.cpu().numpy()
    return [out[i] for i in range(b)]


def run_heat_checkpointed(params: SimParams, path: str, every: int = 0,
                          max_retries: int = 1, device=None) -> np.ndarray:
    """Long-solve form of the single-device heat driver: ``run_heat`` in
    checkpointed chunks of ``every`` steps on ``device`` (default
    ``cuda``), with a finiteness guard between chunks.

    The state is ``{"grid": u}`` (the halo bands ride in the grid).  A NaN
    blow-up (``CME213_FAULTS=nan:heat2d`` or real) rolls back to the last
    good checkpoint and retries the chunk; a killed process resumes from
    ``path``.  Chunking is deterministic, so an interrupted and resumed
    solve equals an uninterrupted one bit for bit.  The first chunk is
    preflighted (``core/admission.admit``) at its count of device bytes
    (``ops.stencil.run_heat_bytes``), and a grid over the budget is
    refused with ``AdmissionError`` before any allocation; a chunk that
    dies RESOURCE (``CME213_FAULTS=oom:heat_chunk``) is halved and retried
    from the last checkpoint.  Returns the final grid on the host.
    """
    from ..core import admission
    from ..core.checkpoint import run_with_checkpoints
    from ..core.numerics import ConvergenceTracker
    from ..core.resilience import all_finite

    dev = resolve_device(device)
    admission.admit("heat2d", run_heat_bytes(params.gy, params.gx,
                                             params.order, 4), dev)
    u0 = make_initial_grid(params, device=dev)

    def step(state, k):
        return {"grid": run_heat(torch.as_tensor(state["grid"]).to(dev), k,
                                 params.order, params.xcfl, params.ycfl)}

    # diffusion decays toward its steady state, so a residual flat for 3
    # chunks already means the solve burns iterations for nothing
    out = run_with_checkpoints(step, {"grid": u0}, params.iters, path,
                               every=every, guard=all_finite, op="heat2d",
                               max_retries=max_retries,
                               chunk_op="heat_chunk",
                               tracker=ConvergenceTracker(
                                   "heat2d", stall_epochs=3))
    return host_array(out["grid"])


def _save_finals(params: SimParams, out: np.ndarray, mesh,
                 out_dir: str) -> None:
    """``grid_final.txt`` (rank 0) and the per-shard interior dumps, like
    the reference's ``grid{rank}_final.txt`` (2dHeat.cpp:549-557), each
    written by the rank that owns the shard, for offline N-vs-1 diffing."""
    if mesh.rank == 0:
        save_grid_to_file(out, f"{out_dir}/grid_final.txt")
    b = params.border_size
    interior_grid = out[b:-b, b:-b]
    y_size = mesh.shape.get("y", 1)
    x_size = mesh.shape.get("x", 1)
    ylocal = params.ny // y_size
    xlocal = params.nx // x_size
    owners = mesh.owners.reshape(y_size, x_size)
    for yi in range(y_size):
        for xi in range(x_size):
            if owners[yi, xi] == mesh.rank:
                save_grid_to_file(
                    interior_grid[yi * ylocal:(yi + 1) * ylocal,
                                  xi * xlocal:(xi + 1) * xlocal],
                    f"{out_dir}/grid{yi * x_size + xi}_final.txt")


def run_distributed(params: SimParams, num_devices: int | None = None,
                    save_files: bool = False, out_dir: str = ".",
                    local_kernel: str = "xla", devices=None) -> np.ndarray:
    """hw5 main: mesh from ``params.grid_method`` over ``devices`` (default
    every CUDA device; ``core.virtual_devices`` puts several shards on one),
    sync/overlap from ``params.synchronous``; writes init/final dumps and
    the per-rank finals like the reference.  ``local_kernel="pallas"`` runs
    the hand-written kernel per shard (B3).

    Launched as a gang (``WORLD_SIZE`` > 1, ``dist.launch``), it joins the
    process group first; ``devices`` then defaults to the gang's
    (``dist.mesh.default_devices``), rank 0 writes ``grid_init.txt`` and
    ``grid_final.txt``, the owner of each shard its ``grid{i}_final.txt``,
    and each rank prints the solve's seconds and the share of them its
    cross-rank exchanges took."""
    initialize_multihost()
    mesh = mesh_for_method(params.grid_method, num_devices, devices=devices)
    timer = PhaseTimer(verbose=True)
    if save_files and mesh.rank == 0:
        save_grid_to_file(make_initial_grid(params, device="cpu"),
                          f"{out_dir}/grid_init.txt")
    with timer.phase("distributed computation"):
        out = run_distributed_heat(params, mesh, local_kernel=local_kernel)
    rank, world = process_info()
    if world > 1:
        from ..core import metrics
        from ..dist.multihost import backend

        solve = metrics.gauge("dist_heat.solve_s").value
        exchange = metrics.gauge("dist_heat.exchange_s").value
        print(f"rank {rank}/{world}: solve {solve:.6f} s, halo exchange "
              f"{exchange:.6f} s ({100 * exchange / solve:.1f}%), backend "
              f"{backend()}")
    if save_files:
        _save_finals(params, out, mesh, out_dir)
    return out


def run_distributed_supervised(params: SimParams,
                               num_devices: int | None = None,
                               ckpt_dir: str | None = None,
                               ckpt_every: int = 0,
                               resume: bool | None = None,
                               save_files: bool = False,
                               out_dir: str = ".",
                               devices=None) -> np.ndarray:
    """hw5 main under gang supervision: the worker entry a supervised
    launcher gang runs (``dist.launch --stall-timeout ... -- python -m
    cme213_tpu_torch heat2d params.in --distributed --supervised``).

    Checkpoint plumbing defaults from the launcher's exported env
    (``CME213_CKPT_DIR`` / ``CME213_CKPT_EVERY`` / ``CME213_RESUME``);
    heartbeats wire up when ``CME213_HEARTBEAT_DIR`` is set.  Joins the
    process group first when launched with several ranks.  Runs the sync
    path (the bitwise-reproducible, decomposition-invariant scheme),
    committing an epoch every ``ckpt_every`` iterations.  Rank 0 writes
    ``grid_final.txt``.
    """
    from ..dist.heat import run_distributed_heat_supervised
    from ..dist.supervisor import heartbeat_from_env, supervised_env_config

    cfg = supervised_env_config()
    ckpt_dir = ckpt_dir or cfg["ckpt_dir"]
    if not ckpt_dir:
        raise ValueError("supervised run needs a checkpoint directory "
                         "(--ckpt-dir or CME213_CKPT_DIR)")
    ckpt_every = ckpt_every or cfg["ckpt_every"]
    resume = cfg["resume"] if resume is None else resume
    initialize_multihost()
    mesh = mesh_for_method(params.grid_method, num_devices, devices=devices)
    timer = PhaseTimer(verbose=True)
    with timer.phase("supervised distributed computation"):
        out = run_distributed_heat_supervised(
            params, mesh, ckpt_dir, ckpt_every=ckpt_every, resume=resume,
            heartbeat=heartbeat_from_env())
    print(f"supervised solve complete: {params.iters} iters, "
          f"epoch commits in {ckpt_dir}")
    if save_files and mesh.rank == 0:
        save_grid_to_file(out, f"{out_dir}/grid_final.txt")
    return out


def main(argv: list[str]) -> int:
    # a run that dies uncleanly leaves a flight dump when CME213_FLIGHT_DIR
    # asks for one (a supervised rank inherits it from the launcher)
    from ..core import flight

    flight.install_from_env()
    paths = [a for a in argv[1:] if not a.startswith("--")]
    path = paths[0] if paths else "params.in"
    distributed = "--distributed" in argv
    supervised = "--supervised" in argv
    device = next((a.split("=", 1)[1] for a in argv
                   if a.startswith("--device=")), None)
    local_kernel = next((a.split("=", 1)[1] for a in argv
                         if a.startswith("--local-kernel=")), "xla")
    ckpt_dir = next((a.split("=", 1)[1] for a in argv
                     if a.startswith("--ckpt-dir=")), None)
    ckpt_every = int(next((a.split("=", 1)[1] for a in argv
                           if a.startswith("--ckpt-every=")), "0"))
    params = SimParams.from_file(path, distributed=distributed or supervised)
    if distributed or supervised:
        # a gang's ranks join the process group before they list its
        # devices (no-op outside a gang); the device picks the backend
        initialize_multihost(device=device)
    if supervised:
        run_distributed_supervised(params, ckpt_dir=ckpt_dir,
                                   ckpt_every=ckpt_every, save_files=True,
                                   devices=default_devices(device))
        return 0
    if distributed:
        run_distributed(params, save_files=True, local_kernel=local_kernel,
                        devices=default_devices(device))
        return 0
    res = run_single(params, check_cpu=params.nx * params.ny <= 512 * 512,
                     save_files=True, device=device)
    return 0 if res.ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
