"""The port's CUDA kernel on the card (skips where there is none).

Run on a machine with a card, from the repository root, without the JAX
test harness in ``tests/conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX.  Each kernel is held bitwise against its
plain version on the same CUDA tensors (both round every operation alike,
in the same order), and the distributed solve on a mesh of virtual devices
against ``run_heat``.
"""

import numpy as np
import pytest
import torch

from cme213_tpu_torch.apps import heat2d
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import (FrameworkError, KernelError,
                                   ulp_distance, virtual_devices)
from cme213_tpu_torch.dist import (make_mesh_1d, make_mesh_2d,
                                   run_distributed_heat)
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import (LAUNCHES, run_heat, run_heat_pipeline,
                                  run_heat_pipeline2d,
                                  run_heat_pipeline_plain,
                                  stencil_local_multistep,
                                  stencil_local_multistep_plain,
                                  stencil_local_multistep_shards,
                                  stencil_local_multistep_shards_plain)
from cme213_tpu_torch.ops import _kernels
from cme213_tpu_torch.ops import segmented_pallas as segp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _grid(p, dtype, device, seed=0):
    u = make_initial_grid(p, dtype=torch.float64, device="cpu")
    b = p.border_size
    rng = np.random.default_rng(seed)
    u[b:-b, b:-b] += torch.from_numpy(rng.uniform(0, 1, (p.ny, p.nx)))
    return u.to(device=device, dtype=dtype)


@pytest.mark.parametrize("entry", [run_heat_pipeline, run_heat_pipeline2d])
@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(257, 121), (5, 7)],
                         ids=["257x121", "smaller-than-a-tile"])
def test_kernel_bitwise_vs_plain(cuda, entry, order, k, dtype, shape):
    ny, nx = shape
    p = SimParams(nx=nx, ny=ny, order=order, bc_top=1.5, bc_left=0.5,
                  bc_bottom=2.0, bc_right=0.25)
    u = _grid(p, dtype, cuda, seed=order * k)
    args = (4 * k, order, p.xcfl, p.ycfl, p.bc)
    name = "pipeline" if entry is run_heat_pipeline else "pipeline2d"
    before = LAUNCHES[name]
    out = entry(u, *args, k=k)
    assert LAUNCHES[name] - before == 4
    ref = run_heat_pipeline_plain(u, *args, k=k)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("order", [2, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_bitwise_vs_plain_unaligned_rows(cuda, order, k, dtype):
    # 3999 x 4001 interior: W·4 is not a multiple of 16 (order 2: 4003,
    # order 8: 4009 columns), so the kernel stages element by element
    p = SimParams(nx=4001, ny=3999, order=order, bc_top=1.5, bc_left=0.5,
                  bc_bottom=2.0, bc_right=0.25)
    u = _grid(p, dtype, cuda, seed=k)
    args = (k, order, p.xcfl, p.ycfl, p.bc)
    out = run_heat_pipeline2d(u, *args, k=k)
    torch.testing.assert_close(out, run_heat_pipeline_plain(u, *args, k=k),
                               rtol=0, atol=0)


def test_kernel_matches_run_heat(cuda):
    p = SimParams(nx=300, ny=200, order=8)
    u = make_initial_grid(p, device=cuda)
    out = run_heat_pipeline(u, 64, 8, p.xcfl, p.ycfl, p.bc, k=8)
    ref = run_heat(u, 64, 8, p.xcfl, p.ycfl)
    assert ulp_distance(out.cpu().numpy(), ref.cpu().numpy()).max() <= 10


@pytest.mark.parametrize("entry,k", [(run_heat_pipeline, 1),
                                     (run_heat_pipeline2d, 4)])
def test_launch_loop_is_one_span_a_solve(cuda, entry, k):
    """``_run``'s launch loop is one ``heat.launch_loop`` host range a
    solve under the profiler, holding every one of its ``iters // k``
    launches, and writes no record."""
    from torch.profiler import ProfilerActivity, profile

    from cme213_tpu_torch.core import trace
    from cme213_tpu_torch.ops import stencil_pipeline

    p = SimParams(nx=300, ny=200, order=8)
    u = make_initial_grid(p, device=cuda)
    rung = "pipeline" if entry is run_heat_pipeline else "pipeline2d"
    entry(u, 8 * k, 8, p.xcfl, p.ycfl, p.bc, k=k)  # builds the library
    trace.clear_events()
    before = stencil_pipeline.LAUNCHES[rung]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        entry(u, 8 * k, 8, p.xcfl, p.ycfl, p.bc, k=k)
        torch.cuda.synchronize()
    assert stencil_pipeline.LAUNCHES[rung] - before == 8
    assert not [e for e in trace.events("span-begin")
                if e["span"] == "heat.launch_loop"]
    host = [ev for ev in prof.profiler.kineto_results.events()
            if "CPU" in str(ev.device_type())]
    (loop,) = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
               for ev in host if ev.name() == "heat.launch_loop"]
    launches = [ev for ev in host if "LaunchKernel" in ev.name()
                and loop[0] <= ev.start_ns() <= loop[1]]
    assert len(launches) == 8
    trace.clear_events()


def test_over_budget_tile_raises(cuda):
    p = SimParams(nx=300, ny=200, order=8)
    u = make_initial_grid(p, device=cuda)
    # k = 16 at order 8: no tile's windows fit in a block; the kernel
    # cannot launch, a KernelError that no ladder demotes
    with pytest.raises(KernelError, match="shared memory"):
        run_heat_pipeline2d(u, 16, 8, p.xcfl, p.ycfl, p.bc, k=16)
    with pytest.raises(KernelError, match="shared memory"):
        run_heat_pipeline(u, 8, 8, p.xcfl, p.ycfl, p.bc, k=8, tile_y=512)
    with pytest.raises(ValueError, match="tile_x=1024"):
        run_heat_pipeline2d(u, 8, 8, p.xcfl, p.ycfl, p.bc, k=8, tile_y=64,
                            tile_x=1024)


def test_refused_launch_raises(cuda):
    u = torch.zeros(64, 64, device=cuda)
    kw = dict(order=8, k=1, tile_y=32, tile_x=128, run=1, ny=56, nx=56,
              xcfl=0.1, ycfl=0.1, bc=(1.0, 1.0, 1.0, 1.0))
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    good = sp.smem_bytes(32, 1, 8)
    _kernels.heat_ksteps([(u, torch.empty_like(u), 0, 0)], smem_bytes=good,
                         **kw)
    for bad in (dict(smem_bytes=good - 16), dict(smem_bytes=good,
                                                  tile_x=64)):
        args = {**kw, **bad}
        with pytest.raises(FrameworkError, match="heat_ksteps launch failed"):
            _kernels.heat_ksteps([(u, torch.empty_like(u), 0, 0)], **args)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("launches", [1, 2, 3, 400])
@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_loop_bitwise_vs_single_launches(cuda, launches, order, k,
                                                dtype):
    """A solve's one call of the C loop (``_kernels.heat_ksteps_loop``)
    equals a loop of single ``_kernels.heat_ksteps`` launches (the entry
    B3 keeps) and ``run_heat_roll`` bit for bit, through both entry
    points; it leaves the input alone and counts ``iters // k`` launches
    and one loop a solve."""
    from cme213_tpu_torch.ops import run_heat_roll
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    p = SimParams(nx=131, ny=67, order=order, bc_top=1.5, bc_left=0.5,
                  bc_bottom=2.0, bc_right=0.25)
    u = _grid(p, dtype, cuda, seed=launches + order + k)
    keep = u.clone()
    iters = launches * k
    plan = sp.launch_plan(u, 1, k, order)
    src, bufs = u, (torch.empty_like(u), torch.empty_like(u))
    for i in range(launches):
        _kernels.heat_ksteps([(src, bufs[i % 2], 0, 0)], order=order, k=k,
                             tile_y=plan.tile_y, tile_x=plan.tile_x,
                             run=plan.run, smem_bytes=plan.smem, ny=p.ny,
                             nx=p.nx, xcfl=p.xcfl, ycfl=p.ycfl, bc=p.bc)
        src = bufs[i % 2]
    roll = run_heat_roll(u, iters, order, p.xcfl, p.ycfl, p.bc, k=k)
    assert torch.equal(_bits(src), _bits(roll))
    for name, entry in (("pipeline", run_heat_pipeline),
                        ("pipeline2d", run_heat_pipeline2d)):
        launched, loops = LAUNCHES[name], sp.LAUNCH_LOOPS[name]
        out = entry(u, iters, order, p.xcfl, p.ycfl, p.bc, k=k)
        assert LAUNCHES[name] - launched == launches
        assert sp.LAUNCH_LOOPS[name] - loops == 1
        assert torch.equal(_bits(out), _bits(src)), name
    assert torch.equal(_bits(u), _bits(keep))


def test_launch_loop_refusal_names_the_launch(cuda, monkeypatch):
    """A launch the C loop refuses raises ``KernelError`` with the single
    launch's text and the refused launch's index, classified as the
    single launch's refusal is; through ``run_heat_pipeline`` it counts
    neither launches nor a loop."""
    import dataclasses

    from cme213_tpu_torch.core import classify_failure
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    u = torch.zeros(64, 64, device=cuda)
    bufs = (torch.empty_like(u), torch.empty_like(u))
    kw = dict(order=8, k=1, tile_y=32, tile_x=128, run=1, ny=56, nx=56,
              xcfl=0.1, ycfl=0.1, bc=(1.0, 1.0, 1.0, 1.0))
    good = sp.smem_bytes(32, 1, 8)
    assert _kernels.heat_ksteps_loop(u, bufs, 3, smem_bytes=good,
                                     **kw) is bufs[0]
    for bad in (dict(smem_bytes=good - 16), dict(smem_bytes=good,
                                                  tile_x=64)):
        args = {**kw, **bad}
        with pytest.raises(KernelError, match=r"heat_ksteps launch failed: "
                           r".*\(cudaError \d+; launch 0 of 3;") as loop:
            _kernels.heat_ksteps_loop(u, bufs, 3, **args)
        with pytest.raises(KernelError) as single:
            _kernels.heat_ksteps([(u, bufs[0], 0, 0)], **args)
        assert classify_failure(loop.value) \
            == classify_failure(single.value)
    torch.cuda.synchronize()

    plan = sp.launch_plan(u, 1, 1, 8)
    bad_plan = dataclasses.replace(plan, smem=plan.smem - 16)
    monkeypatch.setattr(sp, "launch_plan", lambda *args, **kws: bad_plan)
    launched, loops = LAUNCHES["pipeline"], sp.LAUNCH_LOOPS["pipeline"]
    with pytest.raises(KernelError, match="launch 0 of 4;"):
        run_heat_pipeline(u, 4, 8, 0.1, 0.1, (1.0, 1.0, 1.0, 1.0))
    assert LAUNCHES["pipeline"] == launched
    assert sp.LAUNCH_LOOPS["pipeline"] == loops


def test_heat_design_matches_the_compiled_menu(cuda):
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    for elem in (4, 8):
        for k in (1, 2, 3, 8):
            d = sp.design(k, elem)
            assert _kernels.heat_ksteps_design(elem, k) == (
                d.tile_x, d.threads, d.rows)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("elem", [4, 8])
def test_heat_occupancy_and_no_spills(cuda, order, k, elem):
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    ty = sp.pick_pipeline_tile(4008, k, order, dtype_bytes=elem)
    need = sp.smem_bytes(ty, k, order, elem)
    blocks, regs, local = _kernels.heat_ksteps_occupancy(cuda, elem, order,
                                                         k, need)
    assert local == 0, f"{regs} registers, {local} B of local memory"
    assert blocks >= 1
    if elem == 4 and order == 8:
        # the designs' occupancy: two blocks an SM at k = 1, three at k = 2,
        # two at k = 3 and 4, one at k = 8
        assert blocks >= {1: 2, 2: 3, 3: 2, 4: 2}.get(k, 1)


def _cold():
    """No conformance verdict and no program cached: the next gated call
    probes and builds."""
    from cme213_tpu_torch.core import conformance, trace

    conformance.reset()
    trace.clear_events()


def test_run_single_on_card(cuda, tmp_path):
    p = SimParams(nx=100, ny=90, order=4, iters=20)
    _cold()
    before = LAUNCHES["pipeline"]
    res = heat2d.run_single(p, save_files=True, out_dir=str(tmp_path))
    assert res.ok
    # the gate's probe (a warm-up launch and four steps), the program's
    # warm-up launch, the solve
    assert LAUNCHES["pipeline"] - before == 5 + 1 + p.iters
    assert (tmp_path / "grid_final_gpu_shared.txt").exists()


# ------------------------------------------------ segmented scan (B6, B7)

T = segp.TILE


def _flags(n: int, pattern: str, rng) -> np.ndarray:
    f = np.zeros(n, np.int32)
    if pattern == "one":
        f[0] = 1
    elif pattern == "every":
        f[:] = 1
    elif pattern == "tile-edges":
        f[::T] = 1
    else:  # random starts, about one in 40
        f[rng.random(n) < 0.025] = 1
        f[0] = 1
    return f


@pytest.mark.parametrize("pattern", ["one", "every", "tile-edges", "random"])
@pytest.mark.parametrize("n", [1, 31, T - 1, T, T + 1, 3 * T + 5, 100_003])
def test_segscan_kernel_bitwise_vs_plain(cuda, n, pattern):
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    xx = torch.from_numpy(rng.uniform(-1.2, 1.2, n).astype(np.float32)
                          ).to(cuda)
    f = torch.from_numpy(_flags(n, pattern, rng)).to(cuda)
    before = dict(segp.LAUNCHES)
    out = segp.segmented_scan_pallas(v, f)
    fused = {it: segp.spmv_scan_pallas(v, xx, f, it) for it in (1, 8)}
    torch.cuda.synchronize()
    assert segp.LAUNCHES["segscan"] - before["segscan"] == 1
    assert segp.LAUNCHES["spmv_fused"] - before["spmv_fused"] == 9
    bits = lambda t: t.view(torch.int32)  # noqa: E731 (+0 and -0 differ)
    assert torch.equal(bits(out),
                       bits(segp.segmented_scan_pallas_plain(v, f)))
    for it, got in fused.items():
        assert torch.equal(
            bits(got), bits(segp.spmv_scan_pallas_plain(v, xx, f, it)))


def test_segscan_leaves_input_and_refuses_f64(cuda):
    v = torch.arange(5000, dtype=torch.float32, device=cuda)
    f = torch.zeros(5000, dtype=torch.int32, device=cuda)
    keep = v.clone()
    segp.spmv_scan_pallas(v, v, f, 2)
    assert torch.equal(v, keep)
    with pytest.raises(TypeError, match="float32"):
        segp.segmented_scan_pallas(v.double(), f)


def test_segscan_refused_launch_raises(cuda):
    v = torch.ones(3 * T, dtype=torch.float32, device=cuda)
    f = torch.zeros(3 * T, dtype=torch.int32, device=cuda)
    short = torch.zeros(2, dtype=torch.float32, device=cuda)  # needs 8 words
    with pytest.raises(FrameworkError, match="segmented_scan launch failed"):
        _kernels.segmented_scan(v, None, f, torch.empty_like(v), short, 1)


@pytest.mark.parametrize("epoch,offset", [(0, 0), (segp.MAX_EPOCH + 1, 0),
                                          (1, 1)],
                         ids=["epoch-0", "epoch-past-30-bits", "unaligned"])
def test_segscan_refuses_bad_epoch_or_workspace(cuda, epoch, offset):
    v = torch.ones(3 * T, dtype=torch.float32, device=cuda)
    f = torch.zeros(3 * T, dtype=torch.int32, device=cuda)
    ws = torch.zeros(10, dtype=torch.int32, device=cuda)[offset:offset + 8]
    with pytest.raises(FrameworkError, match="segmented_scan launch failed"):
        _kernels.segmented_scan(v, None, f, torch.empty_like(v), ws, epoch)


def test_segscan_geometry_matches_plain(cuda):
    assert _kernels.segmented_scan_geometry() == (
        segp.TILE_ITEMS, segp.TILE_THREADS, segp.WARP)


def _device_events(run):
    """Names of the device activities (kernels, copies) the profiler sees
    while ``run()`` runs; an empty first session is tried again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return names


def test_segscan_one_call_one_launch_a_scan(cuda):
    n = 50 * T + 7
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    f = torch.from_numpy(_flags(n, "random", rng)).to(cuda)
    segp.segmented_scan_pallas(v, f)  # the workspace is zeroed once, here
    segp.spmv_scan_pallas(v, v, f, 1)
    torch.cuda.synchronize()
    calls = {}

    def run(name, fn):
        before = segp.LAUNCHES[name]
        fn()
        calls[name] = segp.LAUNCHES[name] - before

    names = _device_events(
        lambda: run("segscan", lambda: segp.segmented_scan_pallas(v, f)))
    assert len(names) == 1 and "segscan_tiles" in names[0], names
    names = _device_events(
        lambda: run("spmv_fused", lambda: segp.spmv_scan_pallas(v, v, f, 5)))
    assert len([x for x in names if "segscan_tiles" in x]) == 5, names
    assert calls == {"segscan": 1, "spmv_fused": 5}


def test_segscan_deterministic_under_look_back(cuda):
    """One head over 2^24 elements (8192 tiles, the longest walks): 20 runs
    of B6 and of B7 are bitwise identical, and equal their plain
    versions."""
    n = 1 << 24
    rng = np.random.default_rng(24)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    xx = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(cuda)
    f = torch.zeros(n, dtype=torch.int32, device=cuda)
    f[0] = 1
    bits = lambda t: t.view(torch.int32)  # noqa: E731 (+0 and -0 differ)
    b6 = [bits(segp.segmented_scan_pallas(v, f)) for _ in range(20)]
    b7 = [bits(segp.spmv_scan_pallas(v, xx, f, 1)) for _ in range(20)]
    for runs in (b6, b7):
        assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert torch.equal(b6[0], bits(segp.segmented_scan_pallas_plain(v, f)))
    assert torch.equal(b7[0],
                       bits(segp.spmv_scan_pallas_plain(v, xx, f, 1)))


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n", [T - 1, T + 1, 2 * T - 1, 2 * T + 1,
                               7 * T + 13])
def test_segscan_ragged_tiles_bitwise_vs_plain(cuda, n, offset):
    rng = np.random.default_rng(n + offset)
    buf = rng.standard_normal(n + offset).astype(np.float32)
    v = torch.from_numpy(buf).to(cuda)[offset:]  # offset 1: off 16 bytes
    xx = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(cuda)
    f = torch.from_numpy(_flags(n, "random", rng)).to(cuda)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    assert torch.equal(bits(segp.segmented_scan_pallas(v, f)),
                       bits(segp.segmented_scan_pallas_plain(v, f)))
    assert torch.equal(bits(segp.spmv_scan_pallas(v, xx, f, 3)),
                       bits(segp.spmv_scan_pallas_plain(v, xx, f, 3)))


def test_segscan_workspace_grows_and_wraps_its_epoch(cuda):
    """The stream's workspace is made anew when a longer input needs more
    words, and when its epochs run out; every scan stays its plain
    version."""
    rng = np.random.default_rng(3)
    key = (torch.cuda.current_device(),
           torch.cuda.current_stream().cuda_stream)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    for n, wrap in ((3 * T, False), (40 * T + 3, False), (40 * T + 3, True),
                    (40 * T + 3, False), (2 * T, False)):
        if wrap:
            segp._WORKSPACES[key][1] = segp.MAX_EPOCH - 1
        v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             ).to(cuda)
        f = torch.from_numpy(_flags(n, "random", rng)).to(cuda)
        for _ in range(2):  # the second with a wrapped epoch
            assert torch.equal(bits(segp.segmented_scan_pallas(v, f)),
                               bits(segp.segmented_scan_pallas_plain(v, f)))
        ws, epoch = segp._WORKSPACES[key]
        assert ws.shape[0] >= 2 + 2 * -(-n // T)
        assert 1 <= epoch <= segp.MAX_EPOCH


@pytest.mark.parametrize("fused", [False, True], ids=["B6", "B7"])
def test_segscan_in_place_bitwise_vs_plain(cuda, fused):
    n = 9 * T + 100
    rng = np.random.default_rng(9)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    xx = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(cuda)
    f = torch.from_numpy(_flags(n, "random", rng)).to(cuda)
    ws = torch.zeros(2 + 2 * -(-n // T), dtype=torch.int32, device=cuda)
    work = v.clone()
    for epoch in (1, 2, 3):  # one workspace, a new epoch a call
        _kernels.segmented_scan(work, xx if fused else None, f, work, ws,
                                epoch)
    want = v
    for _ in range(3):
        want = segp.segmented_scan_pallas_plain(want * xx if fused else want,
                                                f)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    assert torch.equal(bits(work), bits(want))


@pytest.mark.parametrize("kernel", ["pallas", "pallas-fused"])
def test_run_spmv_scan_on_card(cuda, kernel):
    prob = spmv.generate_problem(50_000, 700, 500, iters=6, seed=3)
    name = "segscan" if kernel == "pallas" else "spmv_fused"
    _cold()
    before = dict(segp.LAUNCHES)
    out = spmv.run_spmv_scan(prob, kernel=kernel)
    # the gate's probe (a warm-up iteration and three), the program's
    # warm-up iteration, the solve
    assert segp.LAUNCHES[name] - before[name] == 4 + 1 + prob.iters
    other = "spmv_fused" if kernel == "pallas" else "segscan"
    assert segp.LAUNCHES[other] == before[other]
    errs = spmv.external_check(prob, out)
    assert errs["rel_l2"] <= 1e-5 and errs["rel_linf"] <= 1e-3


# ------------------------------------------------ shard kernel (B3)


def _shard_block(p, K, yi, xi, h, w, dtype, device, seed=0):
    """Shard (yi, xi) of an (h, w)-shard decomposition of ``p``'s seeded
    interior, ghost-padded to whole shards (top/right BCs), with K halo
    padded y first, then x, with the BC fills, as ``dist/heat`` assembles
    it; and its global offsets (gy0, gx0)."""
    b = p.border_size
    rng = np.random.default_rng(seed)
    ny_pad, nx_pad = -(-p.ny // h) * h, -(-p.nx // w) * w
    g = np.full((ny_pad, nx_pad), p.bc_top)
    g[:, p.nx:] = p.bc_right
    g[:p.ny, :p.nx] = p.ic + rng.uniform(0, 1, (p.ny, p.nx))
    g = np.pad(g, ((K, 0), (0, 0)), constant_values=p.bc_bottom)
    g = np.pad(g, ((0, K), (0, 0)), constant_values=p.bc_top)
    g = np.pad(g, ((0, 0), (K, 0)), constant_values=p.bc_left)
    g = np.pad(g, ((0, 0), (0, K)), constant_values=p.bc_right)
    blk = g[yi * h:(yi + 1) * h + 2 * K, xi * w:(xi + 1) * w + 2 * K]
    t = torch.from_numpy(np.ascontiguousarray(blk)).to(device, dtype)
    return t, yi * h + b - K, xi * w + b - K


@pytest.mark.parametrize("where", [(0, 0), (0, 1), (1, 1), (2, 2)],
                         ids=["corner", "edge", "interior", "ghost"])
@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_local_kernel_bitwise_vs_plain(cuda, where, order, k, dtype):
    # a 3x3 decomposition of 299x401: 100x134 shards, the last row and
    # column of shards ghost-padded
    p = SimParams(nx=401, ny=299, order=order, bc_top=1.5, bc_left=0.5,
                  bc_bottom=2.0, bc_right=0.25)
    K = k * p.border_size
    blk, gy0, gx0 = _shard_block(p, K, *where, 100, 134, dtype, cuda,
                                 seed=order * k)
    args = (gy0, gx0, p.ny, p.nx, order, p.xcfl, p.ycfl, p.bc)
    before = LAUNCHES["local"]
    out = stencil_local_multistep(blk, *args, k=k)
    torch.cuda.synchronize()
    assert LAUNCHES["local"] - before == 1
    ref = stencil_local_multistep_plain(blk, *args, k=k)
    torch.testing.assert_close(out[K:-K, K:-K], ref[K:-K, K:-K], rtol=0,
                               atol=0)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_local_kernel_nine_shards_in_one_launch(cuda, order, k, dtype):
    # every shard of a 3x3 mesh on one device (corner, edge, interior and
    # ghost shards among them) in one launch
    p = SimParams(nx=401, ny=299, order=order, bc_top=1.5, bc_left=0.5,
                  bc_bottom=2.0, bc_right=0.25)
    K = k * p.border_size
    shards = [_shard_block(p, K, yi, xi, 100, 134, dtype, cuda, seed=k)
              for yi in range(3) for xi in range(3)]
    blocks = [blk for blk, _, _ in shards]
    offsets = [(gy0, gx0) for _, gy0, gx0 in shards]
    args = (p.ny, p.nx, order, p.xcfl, p.ycfl, p.bc)
    before = LAUNCHES["local"]
    out = stencil_local_multistep_shards(blocks, offsets, *args, k=k)
    torch.cuda.synchronize()
    assert LAUNCHES["local"] - before == 1
    ref = stencil_local_multistep_shards_plain(blocks, offsets, *args, k=k)
    for got, want in zip(out, ref):
        torch.testing.assert_close(got[K:-K, K:-K], want[K:-K, K:-K],
                                   rtol=0, atol=0)


def test_local_kernel_splits_a_long_table(cuda):
    # 33 shards: two launches, the second of one shard
    p = SimParams(nx=401, ny=299, order=4)
    shards = [_shard_block(p, 4, 1, 1, 100, 134, torch.float32, cuda,
                           seed=s) for s in range(33)]
    blocks = [blk for blk, _, _ in shards]
    offsets = [(gy0, gx0) for _, gy0, gx0 in shards]
    args = (p.ny, p.nx, 4, p.xcfl, p.ycfl, p.bc)
    before = LAUNCHES["local"]
    out = stencil_local_multistep_shards(blocks, offsets, *args, k=2)
    assert LAUNCHES["local"] - before == 2
    for blk, got, (gy0, gx0) in zip(blocks, out, offsets):
        want = stencil_local_multistep_plain(blk, gy0, gx0, *args, k=2)
        torch.testing.assert_close(got[4:-4, 4:-4], want[4:-4, 4:-4],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kernel,k,overlap", [
    ("pallas", 1, False), ("pallas", 2, False), ("pallas", 3, False),
    ("pallas", 4, False), ("xla", 1, False), ("xla", 1, True),
    ("xla", 2, False)])
def test_distributed_2x2_virtual_mesh_equals_run_heat(cuda, kernel, k,
                                                      overlap):
    p = SimParams(nx=300, ny=200, order=8, iters=24, bc_top=1.5,
                  bc_left=0.5, bc_bottom=2.0, bc_right=0.25)
    mesh = make_mesh_2d(2, 2, devices=virtual_devices(4))
    _cold()
    before = LAUNCHES["local"]
    out = run_distributed_heat(p, mesh, overlap=overlap,
                               steps_per_exchange=k, local_kernel=kernel)
    launched = LAUNCHES["local"] - before
    # one launch a device (the four shards share one) a halo exchange,
    # after the gate's probe solve (4k steps, k a launch)
    assert launched == (4 + p.iters // k if kernel == "pallas" else 0)
    ref = run_heat(make_initial_grid(p, device=cuda), p.iters, p.order,
                   p.xcfl, p.ycfl).cpu().numpy()
    np.testing.assert_array_equal(out, ref)


def test_distributed_pallas_failed_build_raises(cuda, monkeypatch,
                                                tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")
    monkeypatch.setattr(_kernels, "_libs", {})
    p = SimParams(nx=64, ny=64, order=4, iters=2)
    mesh = make_mesh_1d(2, devices=virtual_devices(2))
    with pytest.raises(FrameworkError, match="nvcc failed"):
        run_distributed_heat(p, mesh, local_kernel="pallas")


# ------------------------------------------------ band-staged stencil (B4, B5)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_band_kernel_bitwise_vs_plain(cuda, order, k, dtype):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    # 200 x 261: a ragged last strip; tile_y 40, a tile of the sweeps
    p = SimParams(nx=261, ny=200, order=order, bc_top=1.5, bc_left=0.5,
                  bc_bottom=2.0, bc_right=0.25)
    u = _grid(p, dtype, cuda, seed=order * k + 1)
    args = (2 * k, order, p.xcfl, p.ycfl)
    before = dict(spl.LAUNCHES)
    out = spl.run_heat_multistep(u, *args, p.bc, k=k, tile_y=40)
    b4 = spl.run_heat_pallas(u, *args, tile_y=40)
    torch.cuda.synchronize()
    assert spl.LAUNCHES["multistep"] - before["multistep"] == 2
    assert spl.LAUNCHES["stencil_full"] - before["stencil_full"] == 2 * k
    torch.testing.assert_close(
        out, spl.run_heat_multistep_plain(u, *args, p.bc, k=k), rtol=0,
        atol=0)
    torch.testing.assert_close(b4, spl.run_heat_pallas_plain(u, *args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("order,k,dtype", [
    (8, 1, torch.float32), (4, 2, torch.float32), (2, 3, torch.float32),
    (8, 4, torch.float64), (2, 1, torch.float64)])
def test_band_kernel_awkward_shapes(cuda, order, k, dtype):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    # 255 x 121 at tile_y 85: a ragged row chunk (85 is no multiple of R)
    # and a ragged last strip; 3999 x 4001: rows not 16-byte aligned, so
    # the kernel stages and stores cell by cell
    for (ny, nx), ty in (((255, 121), 85), ((3999, 4001), 93)):
        p = SimParams(nx=nx, ny=ny, order=order, bc_top=1.5, bc_left=0.5,
                      bc_bottom=2.0, bc_right=0.25)
        u = _grid(p, dtype, cuda, seed=ny + k)
        args = (2 * k, order, p.xcfl, p.ycfl)
        out = spl.run_heat_multistep(u, *args, p.bc, k=k, tile_y=ty)
        torch.testing.assert_close(
            out, spl.run_heat_multistep_plain(u, *args, p.bc, k=k), rtol=0,
            atol=0)
        if k == 1:
            b4 = spl.run_heat_pallas(u, *args, tile_y=ty)
            torch.testing.assert_close(b4, spl.run_heat_pallas_plain(u, *args),
                                       rtol=0, atol=0)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_band_kernel_into_a_bare_array(cuda, order, dtype):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    # stencil_interior_pallas writes a bare (ny, nx) array: at orders 2 and
    # 4 its rows are not where a 16-byte store of a grid quad lands
    p = SimParams(nx=300, ny=240, order=order)
    u = _grid(p, dtype, cuda, seed=order)
    u[:2] -= 1.0  # a foreign halo
    before = spl.LAUNCHES["stencil_full"]
    one = spl.stencil_interior_pallas(u, order, p.xcfl, p.ycfl, tile_y=40)
    assert spl.LAUNCHES["stencil_full"] - before == 1
    torch.testing.assert_close(
        one, spl.stencil_interior_pallas_plain(u, order, p.xcfl, p.ycfl),
        rtol=0, atol=0)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("elem", [4, 8])
def test_band_occupancy_and_no_spills(cuda, order, k, elem):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    geo = spl.band_geometry(2000, 2000, 40, k, order, elem)
    blocks, regs, local = _kernels.heat_band_occupancy(cuda, elem, order, k,
                                                       geo.smem)
    assert local == 0, f"{regs} registers, {local} B of local memory"
    assert blocks >= 1
    d = spl.design(k, elem)
    assert _kernels.heat_band_design(elem, k) == (d.tile_x, d.threads,
                                                  d.rows, d.min_blocks)


def test_band_plan_cached_once_a_shape(cuda):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    p = SimParams(nx=250, ny=200, order=8)
    u = make_initial_grid(p, device=cuda)
    spl._PLANS.clear()
    for k in (1, 2, 4):
        before = dict(spl.LAUNCHES)
        for _ in range(3):
            if k == 1:
                spl.run_heat_pallas(u, 8, 8, p.xcfl, p.ycfl, tile_y=40)
            else:
                spl.run_heat_multistep(u, 8, 8, p.xcfl, p.ycfl, p.bc, k=k,
                                       tile_y=40)
        name = "stencil_full" if k == 1 else "multistep"
        assert spl.LAUNCHES[name] - before[name] == 3 * 8 // k
    assert len(spl._PLANS) == 3
    plan = spl.launch_plan(u, 2, 8, 40)
    assert plan is spl.launch_plan(u, 2, 8, 40)
    assert plan.blocks_per_sm >= 1


def test_band_kernel_keeps_a_foreign_halo(cuda):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    p = SimParams(nx=150, ny=120, order=8)
    u = _grid(p, torch.float32, cuda, seed=3)
    u[:4] = 7.0
    u[:, -4:] = -3.0
    out = spl.run_heat_pallas(u, 5, 8, p.xcfl, p.ycfl, tile_y=40)
    ref = spl.run_heat_pallas_plain(u, 5, 8, p.xcfl, p.ycfl)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    one = spl.stencil_interior_pallas(u, 8, p.xcfl, p.ycfl, tile_y=40)
    torch.testing.assert_close(
        one, spl.stencil_interior_pallas_plain(u, 8, p.xcfl, p.ycfl),
        rtol=0, atol=0)


@pytest.mark.parametrize("tile_y", [40, 80, 200, 400])
def test_band_kernel_at_the_sweeps_tiles(cuda, tile_y):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    p = SimParams(nx=2000, ny=2000, order=8)
    u = make_initial_grid(p, device=cuda)
    out = spl.run_heat_pallas(u, 4, 8, p.xcfl, p.ycfl, tile_y=tile_y)
    torch.testing.assert_close(out, run_heat(u, 4, 8, p.xcfl, p.ycfl),
                               rtol=0, atol=0)


def test_band_tile_that_fits_nowhere_raises(cuda):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    p = SimParams(nx=400, ny=400, order=8)
    u = make_initial_grid(p, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        spl.run_heat_multistep(u, 8, 8, p.xcfl, p.ycfl, p.bc, k=8,
                               tile_y=400)


def test_band_failed_build_raises(cuda, monkeypatch, tmp_path):
    from cme213_tpu_torch.ops import stencil_pallas as spl

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")
    monkeypatch.setattr(_kernels, "_libs", {})
    p = SimParams(nx=64, ny=64, order=4)
    u = make_initial_grid(p, device=cuda)
    with pytest.raises(FrameworkError, match="nvcc failed"):
        spl.run_heat_pallas(u, 2, 4, p.xcfl, p.ycfl, tile_y=32)


# ------------------------------------------------ tiled transpose (B8)


@pytest.mark.parametrize("shape", [(4096, 4096), (256, 512), (96, 160),
                                   (33, 70), (1, 3000)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                   torch.float32, torch.int32,
                                   torch.float64])
def test_transpose_kernel_bitwise(cuda, shape, dtype):
    from cme213_tpu_torch.ops import _kernels as kern
    from cme213_tpu_torch.ops import transpose as tp

    bits = torch.randint(0, 255, (shape[0], shape[1]
                                  * torch.empty(0, dtype=dtype)
                                  .element_size()),
                         dtype=torch.uint8, generator=torch.Generator()
                         .manual_seed(shape[0])).to(cuda)
    x = bits.view(dtype)
    if shape[0] % 32 == 0 and shape[1] % 32 == 0:
        before = tp.LAUNCHES["transpose"]
        out = tp.transpose_pallas(x, tile=32)
        assert tp.LAUNCHES["transpose"] - before == 1
    else:  # the kernel masks ragged edges; the wrapper keeps JAX's contract
        out = torch.empty(shape[::-1], dtype=dtype, device=cuda)
        kern.transpose_tiles(x, out)
    ref = x.t().contiguous()
    # flatten first: a (3000, 1) result is contiguous at stride 3000
    assert torch.equal(out.flatten().view(torch.uint8),
                       ref.flatten().view(torch.uint8))


# ------------------------------------------- runtime core and headline bench


def test_device_preflight_on_the_card(cuda):
    from cme213_tpu_torch.core import device_preflight

    assert device_preflight(60.0) is True
    assert device_preflight(60.0, device=cuda) is True


def test_real_out_of_memory_classifies_resource(cuda):
    from cme213_tpu_torch.core import FailureKind, classify_failure

    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        torch.empty(1 << 50, dtype=torch.uint8, device=cuda)
    assert classify_failure(info.value) == FailureKind.RESOURCE
    torch.cuda.synchronize()


def test_span_block_waits_for_a_cuda_tensor(cuda):
    from cme213_tpu_torch.core import trace

    trace.clear_events()
    x = torch.ones(8, device=cuda)
    torch.cuda.synchronize()
    with trace.span("unblocked"):
        torch.cuda._sleep(500_000_000)  # ~0.25 s of device time
        y = x * 2
    torch.cuda.synchronize()
    with trace.span("blocked") as s:
        torch.cuda._sleep(500_000_000)
        y = x * 2
        s.block(y)
    ends = {e["span"]: e["ms"] for e in trace.events("span-end")}
    assert ends["blocked"] > 100.0 > ends["unblocked"]
    trace.clear_events()


def test_doctor_names_the_card(cuda):
    from cme213_tpu_torch.core import diag

    rep = diag.health_report(timeout_s=120.0)
    assert rep["healthy"] and rep["platform"] == "cuda"
    assert rep["device_count"] == torch.cuda.device_count()
    devices = rep["stages"][0]["detail"]["devices"]
    assert devices[0]["kind"] == torch.cuda.get_device_name(0)
    assert devices[0]["capability"] == list(
        torch.cuda.get_device_capability(0))
    mem = rep["stages"][1]["detail"]["0"]
    assert mem["bytes_limit"] > mem["bytes_free"] > 0


@pytest.mark.parametrize("name", ["pipeline-k1", "pipeline-k4",
                                  "pipeline2d-k8"])
def test_headline_child_runs_the_kernel(cuda, monkeypatch, name):
    """A headline child at a small size: the row is ok and the kernel made
    every launch the calibration and the timed runs imply."""
    from cme213_tpu_torch.bench import headline
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    monkeypatch.setattr(headline, "SIZE", 256)
    entry = "pipeline2d" if name.startswith("pipeline2d") else "pipeline"
    k = int(name.split("-k")[1])
    before = sp.LAUNCHES[entry]
    row = headline.measure_one(name, "f32")
    assert row["ok"], row
    assert row["platform"] == "cuda"
    assert row["device_kind"] == torch.cuda.get_device_name(0)
    want = (2 * row["calibration_iters"]
            + row["final_runs"] * row["iters"]) // k
    assert sp.LAUNCHES[entry] - before == want
    assert row["launches"] == {entry: want}


# ------------------------------------------------ the guarded main path

@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_gate_admits_both_kernel_rungs_bitwise(cuda, order, k):
    """The heat gate's probe through the kernel on the card equals
    ``run_heat`` bit for bit, so both kernel rungs are admitted at every
    order and k; the probes launch the kernel."""
    from cme213_tpu_torch.core import conformance, trace
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    conformance.reset()
    trace.clear_events()
    before = dict(LAUNCHES)
    gate = sp._heat_conformance_gate(order, k, device=cuda)
    assert gate("pipeline") and gate("pipeline2d")
    probes = trace.events("conformance-probe")
    assert [(e["rung"], e["ok"]) for e in probes] == [("pipeline", True),
                                                     ("pipeline2d", True)]
    # a probe: one warm-up launch, then 4k steps in k-step launches
    assert LAUNCHES["pipeline"] - before["pipeline"] == 5
    assert LAUNCHES["pipeline2d"] - before["pipeline2d"] == 5


def test_repeated_resilient_solve_builds_and_probes_nothing(cuda):
    from cme213_tpu_torch.core import conformance, trace
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    conformance.reset()
    trace.clear_events()
    p = SimParams(nx=300, ny=260, order=8, iters=20)
    u = _grid(p, torch.float32, cuda, seed=3)
    first = sp.run_heat_resilient(u, 20, 8, p.xcfl, p.ycfl, p.bc)
    assert first.rung == "pipeline" and not first.demoted
    misses = len(trace.events("program-cache-miss"))
    probes = len(trace.events("conformance-probe"))
    before = LAUNCHES["pipeline"]
    second = sp.run_heat_resilient(u, 20, 8, p.xcfl, p.ycfl, p.bc)
    assert len(trace.events("program-cache-miss")) == misses
    assert len(trace.events("conformance-probe")) == probes
    assert LAUNCHES["pipeline"] - before == 20  # the solve alone
    torch.testing.assert_close(second.value, first.value, rtol=0, atol=0)
    torch.testing.assert_close(first.value,
                               run_heat(u, 20, 8, p.xcfl, p.ycfl),
                               rtol=0, atol=0)


def test_refused_kernel_rungs_raise_on_the_card(cuda):
    """On the card the heat ladder ends at its kernel rungs: with both
    probes perturbed it raises, and serves ``xla`` only when asked."""
    from cme213_tpu_torch.core import conformance, faults, trace
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    conformance.reset()
    trace.clear_events()
    p = SimParams(nx=64, ny=64, order=4, iters=4)
    u = _grid(p, torch.float32, cuda, seed=5)
    with faults.injected("wrong:heat,wrong:heat"):
        with pytest.raises(FrameworkError, match="all 2 rungs of heat"):
            sp.run_heat_resilient(u, 4, 4, p.xcfl, p.ycfl, p.bc)
    conformance.reset()
    with faults.injected("wrong:heat,wrong:heat"):
        res = sp.run_heat_resilient(u, 4, 4, p.xcfl, p.ycfl, p.bc,
                                    plain_fallback=True)
    assert res.rung == "xla"
    torch.testing.assert_close(res.value, run_heat(u, 4, 4, p.xcfl,
                                                   p.ycfl), rtol=0, atol=0)


def test_program_key_separates_the_card_from_the_cpu(cuda):
    from cme213_tpu_torch.core import programs, trace
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    trace.clear_events()
    p = SimParams(nx=64, ny=64, order=4, iters=4)
    u_card = _grid(p, torch.float32, cuda)
    u_cpu = u_card.cpu()
    run_card = sp._heat_program("pipeline", u_card, 4, 4, p.xcfl, p.ycfl,
                                p.bc, 1, 32)
    run_cpu = sp._heat_program("pipeline", u_cpu, 4, 4, p.xcfl, p.ycfl,
                               p.bc, 1, 32)
    assert run_card is not run_cpu
    devices = {k[4] for k in programs.keys()}
    assert devices == {"cpu", f"cuda:{torch.cuda.current_device()}"}
    torch.testing.assert_close(run_card(u_card).cpu(), run_cpu(u_cpu),
                               rtol=0, atol=0)


def test_tune_trial_synchronises_before_reading_the_clock(cuda):
    """Every clock read of a trial finds the device idle: the trial waited
    for the kernel, rather than timing its enqueue."""
    from cme213_tpu_torch.core import tune

    idle_at_read = []

    class Clock:
        def now(self):
            idle_at_read.append(torch.cuda.current_stream().query())
            return 0.0

        def sleep(self, seconds):
            pass

    x = torch.randn(4096, 4096, device=cuda)

    def runner():
        for _ in range(20):
            y = x @ x  # long enough to be in flight at an early read
        return y

    space = tune.TuneSpace("toy", "sc", "float32",
                           (tune.Candidate("mm", {}, lambda: runner),),
                           device=str(cuda))
    tune.run_space(space, clock=Clock(), runs=3, persist=False)
    assert idle_at_read == [True] * 6


# ---------------------------------- checkpointed and batched runners (A3)

def test_cuda_state_checkpoint_round_trip(cuda, tmp_path):
    """Leaves are saved from the host; a resumed CUDA solve equals the
    uninterrupted one bit for bit."""
    from cme213_tpu_torch.core import checkpoint

    g = torch.randn(33, 17, device=cuda)
    ck = str(tmp_path / "c.npz")
    checkpoint.save_state_checkpoint(ck, 4, {"grid": g, "halo": (g[0],)})
    step, arrays = checkpoint.load_checkpoint(ck)
    state = checkpoint._unflatten_state(arrays)
    assert step == 4
    np.testing.assert_array_equal(state["grid"], g.cpu().numpy())
    np.testing.assert_array_equal(state["halo"][0], g[0].cpu().numpy())

    p = SimParams(nx=200, ny=120, order=8, iters=40)
    whole = heat2d.run_heat_checkpointed(p, str(tmp_path / "w.npz"),
                                         every=10, device=cuda)
    half = SimParams(nx=200, ny=120, order=8, iters=20)
    heat2d.run_heat_checkpointed(half, str(tmp_path / "r.npz"), every=10,
                                 device=cuda)
    resumed = heat2d.run_heat_checkpointed(p, str(tmp_path / "r.npz"),
                                           every=10, device=cuda)
    ref = run_heat(make_initial_grid(p, device=cuda), 40, 8, p.xcfl,
                   p.ycfl).cpu().numpy()
    np.testing.assert_array_equal(whole, ref)
    np.testing.assert_array_equal(resumed, ref)


def test_cuda_checkpointed_solve_emits_progress(cuda, tmp_path):
    from cme213_tpu_torch.core import trace

    trace.clear_events()
    p = SimParams(nx=64, ny=64, order=4, iters=12)
    heat2d.run_heat_checkpointed(p, str(tmp_path / "p.npz"), every=4,
                                 device=cuda)
    evs = [e for e in trace.events("solver-progress") if e["op"] == "heat2d"]
    assert [e["step"] for e in evs] == [4, 8, 12]
    assert all(e["residual"] > 0 for e in evs)


def test_real_out_of_memory_reraises_without_halving(cuda, tmp_path):
    from cme213_tpu_torch.core import checkpoint, trace
    from cme213_tpu_torch.core.resilience import all_finite

    trace.clear_events()
    calls = []

    def step(state, k):
        calls.append(k)
        torch.empty(1 << 50, dtype=torch.uint8, device=cuda)  # a petabyte
        return state

    with pytest.raises(torch.cuda.OutOfMemoryError):
        checkpoint.run_with_checkpoints(
            step, torch.zeros(8, device=cuda), 16, str(tmp_path / "o.npz"),
            every=8, guard=all_finite, op="solve")
    assert calls == [8] and not trace.events("chunk-shrunk")


@pytest.mark.parametrize("b,n,order,iters", [(8, 24, 2, 4), (3, 130, 8, 12),
                                             (4, 97, 4, 7)])
def test_heat_batched_lanes_bitwise_on_card(cuda, b, n, order, iters):
    p = SimParams(nx=n, ny=n + 3, order=order)
    rng = np.random.default_rng(b * n)
    grids = [_grid(p, torch.float32, cuda, seed=i) for i in range(b)]
    xs = [p.xcfl * float(v) for v in rng.uniform(0.25, 1.0, b)]
    ys = [p.ycfl * float(v) for v in rng.uniform(0.25, 1.0, b)]
    outs = heat2d.run_heat_batched(grids, iters, order, xs, ys, device=cuda)
    for g, x, y, out in zip(grids, xs, ys, outs):
        np.testing.assert_array_equal(
            out, run_heat(g, iters, order, x, y).cpu().numpy())


@pytest.mark.parametrize("kernel", ["flat", "blocked", "auto"])
@pytest.mark.parametrize("b,n", [(8, 512), (8, 1024), (3, 5000),
                                 (2, 70001)])
def test_spmv_batched_lanes_bitwise_on_card(cuda, kernel, b, n):
    probs = [spmv.generate_problem(n, max(3, n // 64), 31, iters=4, seed=s)
             for s in range(b)]
    outs = spmv.run_spmv_scan_batched(probs, kernel=kernel, device=cuda)
    for prob, out in zip(probs, outs):
        a, xx, flags, _ = spmv.problem_tensors(prob, device=cuda)
        np.testing.assert_array_equal(
            out, spmv._iterate(a, xx, flags, 4, scan=kernel).cpu().numpy())


@pytest.mark.parametrize("kernel", ["flat", "blocked", "auto"])
def test_spmv_checkpointed_bitwise_on_card(cuda, kernel, tmp_path):
    prob = spmv.generate_problem(70001, 900, 899, iters=9, seed=2)
    out = spmv.run_spmv_scan_checkpointed(prob, str(tmp_path / "s.npz"),
                                          every=4, kernel=kernel,
                                          device=cuda)
    a, xx, flags, _ = spmv.problem_tensors(prob, device=cuda)
    np.testing.assert_array_equal(
        out, spmv._iterate(a, xx, flags, 9, scan=kernel).cpu().numpy())


@pytest.mark.parametrize("seed", [3_100_000_005, 3_300_000_004,
                                  3_200_000_005])
def test_pwtk_auto_within_the_check_on_card(cuda, seed):
    """pwtk's shape through the default ``auto`` path (the blocked scan),
    drawn as the benchmark's ``pwtk-spmv`` cell draws it, at the seeds
    where the blocked scan's float32 block sums once read rel L2
    1.09e-4–1.42e-4: within the configuration's 1e-4 of the float64
    reference."""
    from cme213_tpu_torch.ops import segmented
    from perfbench import inputs
    from perfbench.reference import compare
    from perfbench.reference import spmv as ref

    d = inputs.spmv_problem(n=11_634_424, p=217_919, q=217_918, iters=25,
                            seed=seed, device=cuda)
    prob = spmv.Problem(d["a"], d["s"], d["k"], d["x"], d["iters"])
    assert segmented.scan_form(prob.n) == "blocked"
    before = segmented.SCANS["blocked"]
    out = spmv.run_spmv_scan(prob, kernel="auto", device=cuda)
    assert segmented.SCANS["blocked"] - before >= prob.iters
    want = ref.solve(d["a"], d["s"], d["k"], d["x"], d["iters"], device=cuda)
    l2, linf = compare.relative_errors(want, out)
    assert l2 <= 1e-4 and linf <= 1e-3


# ------------------------------------------- the hw1, hw3 and hw4 workloads

def _packed_model(data: np.ndarray, shift: int) -> np.ndarray:
    """The reference's packed add in numpy: little-endian uint32 words
    plus ``s | s<<8 | s<<16 | s<<24``, wrapping."""
    s = np.uint32(shift & 0xFFFFFFFF)
    rep = np.uint32(0)
    for k in range(4):
        rep |= np.uint32((int(s) << (8 * k)) & 0xFFFFFFFF)
    return (data.view("<u4") + rep).view(np.uint8)


@pytest.mark.parametrize("shift", [0, 17, 255])
def test_cipher_variants_exact_on_card(cuda, shift):
    from cme213_tpu_torch.ops import shift_cipher, shift_cipher_packed
    from cme213_tpu_torch.verify import golden

    data = np.random.default_rng(shift).integers(0, 256, 1 << 16,
                                                 dtype=np.uint8)
    d = torch.from_numpy(data).to(cuda)
    np.testing.assert_array_equal(shift_cipher(d, shift).cpu().numpy(),
                                  golden.host_shift_cipher(data, shift))
    for width in (4, 8):
        np.testing.assert_array_equal(
            shift_cipher_packed(d, shift, width).cpu().numpy(),
            _packed_model(data, shift))


def test_pagerank_bitwise_golden_and_repeatable_on_card(cuda):
    from cme213_tpu_torch.apps.pagerank import build_graph, run_pagerank
    from cme213_tpu_torch.verify import golden

    g = build_graph(1 << 16, 8, seed=3)
    ref = golden.host_graph_iterate(g.indices, g.edges, g.rank0, g.inv_deg,
                                    6)
    first = run_pagerank(g, 6, device=cuda).cpu().numpy()
    np.testing.assert_array_equal(first, ref)
    np.testing.assert_array_equal(
        run_pagerank(g, 6, device=cuda).cpu().numpy(), first)


def test_csr_spmv_repeatable_and_reduceat_on_card(cuda):
    from cme213_tpu_torch.ops import csr_row_ids, csr_spmv

    rng = np.random.default_rng(4)
    lens = rng.integers(0, 120, 3000)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    cols = rng.integers(0, 500, indptr[-1])
    vals = rng.standard_normal(indptr[-1]).astype(np.float32)
    x = rng.standard_normal(500).astype(np.float32)
    rows = csr_row_ids(torch.from_numpy(indptr).to(cuda), indptr[-1])
    args = (rows, torch.from_numpy(cols).to(cuda),
            torch.from_numpy(vals).to(cuda), torch.from_numpy(x).to(cuda),
            3000)
    y = csr_spmv(*args).cpu().numpy()
    np.testing.assert_array_equal(csr_spmv(*args).cpu().numpy(), y)
    prod = (vals * x[cols]).astype(np.float32)
    full = lens > 0
    np.testing.assert_array_equal(
        y[full], np.add.reduceat(prod, indptr[:-1][full]))


@pytest.mark.parametrize("n", [1, 1000, (1 << 16) + 3])
def test_device_sorts_exact_on_card(cuda, n):
    from cme213_tpu_torch.ops import (bitonic_sort, radix_sort, sort,
                                      sort_pairs)

    keys = np.random.default_rng(n).integers(0, 2 ** 32, n, dtype=np.uint32)
    d = torch.from_numpy(keys).to(cuda)
    want = np.sort(keys)
    for out in (radix_sort(d, num_bits=8, block_size=2048),
                radix_sort(d, num_bits=4, block_size=512),
                radix_sort(d), bitonic_sort(d), sort(d)):
        assert out.dtype == torch.uint32
        np.testing.assert_array_equal(out.cpu().numpy(), want)
    k, v = sort_pairs(d, torch.arange(n, device=cuda))
    np.testing.assert_array_equal(k.cpu().numpy(), want)
    np.testing.assert_array_equal(keys[v.cpu().numpy()], want)


def test_vigenere_round_trip_on_card(cuda):
    from cme213_tpu_torch.apps import vigenere as vg
    from cme213_tpu_torch.apps.corpus import load_corpus

    clean, shifts, cipher = vg.create_cipher(load_corpus(1 << 18), 9,
                                             device=cuda)
    res = vg.crack(cipher, device=cuda)
    assert res.key_length == 9
    np.testing.assert_array_equal(res.shifts % 26, shifts % 26)
    np.testing.assert_array_equal(res.plain_text, clean)


@pytest.mark.parametrize("fn", ["histogram_sort", "histogram_onehot",
                                "histogram_segment"])
def test_histograms_on_card(cuda, fn):
    from cme213_tpu_torch import ops

    x = np.random.default_rng(5).integers(0, 26, 5000).astype(np.int32)
    out = getattr(ops, fn)(torch.from_numpy(x).to(cuda), 26)
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  np.bincount(x, minlength=26))


_GANG_WORKER = """
import numpy as np
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.dist import mesh_for_method, run_distributed_heat
from cme213_tpu_torch.dist.mesh import default_devices
from cme213_tpu_torch.dist.multihost import initialize_multihost, process_info
from cme213_tpu_torch.ops import LAUNCHES

initialize_multihost()
rank, world = process_info()
p = SimParams(**HEAT, grid_method=GridMethod.BLOCKS_2D)
mesh = mesh_for_method(p.grid_method, devices=default_devices())
assert all(d.type == "cuda" for d in mesh.local_devices())
g = run_distributed_heat(p, mesh, local_kernel="pallas")
print(f"rank {rank} local launches {LAUNCHES['local']}")
np.save(f"{sys.argv[1]}/gang-rank{rank}.npy", g)
# the overlap step (the exchange on a side stream) and k = 2 across ranks
for name, kw in (("overlap", dict(overlap=True)),
                 ("k2", dict(overlap=False, steps_per_exchange=2))):
    g = run_distributed_heat(p, mesh, conformance=False, **kw)
    np.save(f"{sys.argv[1]}/{name}-rank{rank}.npy", g)
"""


def test_gang_on_one_card_launches_b3_in_each_rank(cuda, tmp_path, capsys,
                                                   monkeypatch):
    """A 2-rank gang on one card (2 shards a rank, halos over gloo through
    the host): each rank launches B3 once a step for its two shards (plus
    the gate's probe), and both return ``run_heat``'s grid bit for bit, as
    the overlap step (its exchange on a side stream) and k = 2 do.  On a
    machine with more cards the ranks would get a card each and NCCL, so
    the gang asks for gloo."""
    from torch_gang import run_gang

    monkeypatch.setenv("CME213_DIST_BACKEND", "gloo")
    heat = dict(nx=64, ny=64, order=8, iters=6)
    rc = run_gang(tmp_path, _GANG_WORKER, HEAT=heat)
    out = capsys.readouterr().out
    assert rc == 0, out
    p = SimParams(**heat)
    want = run_heat(make_initial_grid(p, device=cuda), p.iters, p.order,
                    p.xcfl, p.ycfl).cpu().numpy()
    for rank in (0, 1):
        for name in ("gang", "overlap", "k2"):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"{name}-rank{rank}.npy"), want)
        assert f"rank {rank} local launches {p.iters + 4}" in out, out


def test_supervised_gang_on_one_card_recovers_bitwise(cuda, tmp_path,
                                                      monkeypatch, capsys):
    """``--supervised`` on the card as a 2-rank gang under
    ``rankkill:1:1``: the gang is condemned, relaunched and resumes; the
    final grid is ``run_heat``'s bit for bit."""
    import sys

    from cme213_tpu_torch.config import GridMethod
    from cme213_tpu_torch.dist.launch import launch_supervised
    from cme213_tpu_torch.grid import save_grid_to_file

    from torch_gang import ROOT

    p = SimParams(nx=64, ny=48, order=4, iters=12,
                  grid_method=GridMethod.BLOCKS_2D)
    path = str(tmp_path / "p.in")
    p.to_file(path, distributed=True)
    monkeypatch.setenv("CME213_FAULTS", "rankkill:1:1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.chdir(tmp_path)
    rc = launch_supervised(
        2, [sys.executable, "-m", "cme213_tpu_torch", "heat2d", path,
            "--distributed", "--supervised"], devices_per_proc=2,
        stall_timeout=120, max_restarts=1, ckpt_dir=str(tmp_path / "ck"),
        ckpt_every=4, timeout=600, backend="gloo")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "condemning the gang" in out and "gang restart" in out
    want = run_heat(make_initial_grid(p, device=cuda), p.iters, p.order,
                    p.xcfl, p.ycfl)
    save_grid_to_file(want, str(tmp_path / "want.txt"))
    assert (tmp_path / "grid_final.txt").read_text() == \
        (tmp_path / "want.txt").read_text()


@pytest.fixture
def four_cards(cuda):
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs four cards; this machine has {n}")
    return [torch.device("cuda", i) for i in range(4)]


#: (grid method, overlap, k, local kernel) of the four-card mesh cases
FOUR_CARD_CASES = [(1, False, 1, "xla"), (2, False, 1, "xla"),
                   (2, True, 1, "xla"), (1, False, 1, "pallas"),
                   (2, False, 1, "pallas"), (2, False, 4, "pallas")]


@pytest.mark.parametrize("method,overlap,k,kernel", FOUR_CARD_CASES)
def test_four_card_mesh_equals_four_shards_of_one_card(
        four_cards, method, overlap, k, kernel, monkeypatch):
    """One process, a mesh over ``cuda:0``-``cuda:3`` (halos peer to
    peer): bit for bit the same mesh on four shards of ``cuda:0`` and
    ``run_heat``; with ``pallas``, B3 launches on every card, once a card
    an exchange; every shard is still on its own card at the final
    gather."""
    from cme213_tpu_torch.config import GridMethod
    from cme213_tpu_torch.dist import heat as dheat
    from cme213_tpu_torch.dist import mesh_for_method
    from cme213_tpu_torch.ops import stencil_pipeline as sp

    placed = []
    gather = dheat._gather

    def recording(blocks, owners=None):
        placed.append([str(b.device) for row in blocks for b in row])
        return gather(blocks, owners)

    monkeypatch.setattr(dheat, "_gather", recording)
    p = SimParams(nx=130, ny=98, order=8, iters=8,
                  grid_method=GridMethod(method))
    kw = dict(overlap=overlap, steps_per_exchange=k, local_kernel=kernel,
              conformance=False)
    sp.LOCAL_LAUNCHES.clear()
    got = run_distributed_heat(p, mesh_for_method(p.grid_method,
                                                  devices=four_cards), **kw)
    launched = dict(sp.LOCAL_LAUNCHES)
    assert placed == [[str(d) for d in four_cards]]
    want = run_distributed_heat(
        p, mesh_for_method(p.grid_method, devices=virtual_devices(4)), **kw)
    np.testing.assert_array_equal(got, want)
    ref = run_heat(make_initial_grid(p, device=four_cards[0]), p.iters,
                   p.order, p.xcfl, p.ycfl).cpu().numpy()
    np.testing.assert_array_equal(got, ref)
    if kernel == "pallas":
        assert launched == {str(d): p.iters // k for d in four_cards}
    else:
        assert launched == {}


def test_four_card_sharded_scan_equals_four_shards_of_one_card(four_cards):
    from cme213_tpu_torch.dist import distributed_segmented_scan

    n = 4 * 50_000
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    f = torch.from_numpy((rng.uniform(0, 1, n) < 0.001).astype(np.int32))
    for mode in ("ring", "gather"):
        got = distributed_segmented_scan(v, f, make_mesh_1d(
            devices=four_cards), carry_mode=mode)
        want = distributed_segmented_scan(v, f, make_mesh_1d(
            4, devices=virtual_devices(4)), carry_mode=mode)
        assert got.device == four_cards[0]
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


_NCCL_WORKER = """
import numpy as np
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.dist import mesh_for_method, run_distributed_heat
from cme213_tpu_torch.dist.mesh import default_devices
from cme213_tpu_torch.dist.multihost import (backend, initialize_multihost,
                                             process_info)
from cme213_tpu_torch.ops import LAUNCHES

initialize_multihost()
rank, world = process_info()
for method in (2, 1):
    p = SimParams(**HEAT, grid_method=GridMethod(method))
    mesh = mesh_for_method(p.grid_method, devices=default_devices())
    assert [str(d) for d in mesh.local_devices()] == [f"cuda:{rank}"]
    g = run_distributed_heat(p, mesh, local_kernel="pallas")
    np.save(f"{sys.argv[1]}/m{method}-rank{rank}.npy", g)
print(f"rank {rank} backend {backend()} local launches {LAUNCHES['local']}")
"""


def test_nccl_gang_on_four_cards_bitwise(four_cards, tmp_path, capsys,
                                         monkeypatch):
    """A 4-rank gang, one rank a card: the layout takes NCCL, slabs go
    card to card, and every rank returns ``run_heat``'s grid bit for bit
    on the 2 x 2 and the 1-D mesh, B3 launching in every rank."""
    from torch_gang import run_gang

    monkeypatch.delenv("CME213_DIST_BACKEND", raising=False)
    heat = dict(nx=130, ny=98, order=8, iters=8)
    rc = run_gang(tmp_path, _NCCL_WORKER, np_procs=4, devices_per_proc=None,
                  backend="auto", HEAT=heat)
    out = capsys.readouterr().out
    assert rc == 0, out
    p = SimParams(**heat)
    want = run_heat(make_initial_grid(p, device=four_cards[0]), p.iters,
                    p.order, p.xcfl, p.ycfl).cpu().numpy()
    for rank in range(4):
        for method in (1, 2):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"m{method}-rank{rank}.npy"), want)
        # two solves of p.iters steps, each after its gate's probe
        assert f"rank {rank} backend nccl local launches " \
               f"{2 * (p.iters + 4)}" in out, out


def test_supervised_nccl_gang_on_four_cards_recovers_bitwise(
        four_cards, tmp_path, monkeypatch, capsys):
    """``--supervised`` as a 4-rank NCCL gang under ``rankkill:1:1``: the
    ranks blocked in a collective are ended with the gang, the next
    incarnation builds a fresh group and resumes; the final grid is
    ``run_heat``'s bit for bit."""
    import sys

    from cme213_tpu_torch.config import GridMethod
    from cme213_tpu_torch.dist.launch import launch_supervised
    from cme213_tpu_torch.grid import save_grid_to_file

    from torch_gang import ROOT

    p = SimParams(nx=64, ny=48, order=4, iters=12,
                  grid_method=GridMethod.BLOCKS_2D)
    path = str(tmp_path / "p.in")
    p.to_file(path, distributed=True)
    monkeypatch.delenv("CME213_DIST_BACKEND", raising=False)
    monkeypatch.setenv("CME213_FAULTS", "rankkill:1:1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.chdir(tmp_path)
    rc = launch_supervised(
        4, [sys.executable, "-m", "cme213_tpu_torch", "heat2d", path,
            "--distributed", "--supervised"], stall_timeout=120,
        max_restarts=1, ckpt_dir=str(tmp_path / "ck"), ckpt_every=4,
        timeout=600)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "condemning the gang" in out and "gang restart" in out
    assert out.count("torch.distributed backend nccl") == 8, out
    want = run_heat(make_initial_grid(p, device=four_cards[0]), p.iters,
                    p.order, p.xcfl, p.ycfl)
    save_grid_to_file(want, str(tmp_path / "want.txt"))
    assert (tmp_path / "grid_final.txt").read_text() == \
        (tmp_path / "want.txt").read_text()


def test_one_replica_fleet_on_the_card_serves_bitwise(cuda, monkeypatch):
    """A 1-replica fleet with no device named serves on ``cuda`` (the
    replica gets ``--device cuda``); every result is bit for bit the same
    request served by a server on the card in this process."""
    import threading

    from cme213_tpu_torch.serve import OK, Server
    from cme213_tpu_torch.serve.fleet import Fleet
    from cme213_tpu_torch.serve.loadgen import build_mix
    from cme213_tpu_torch.serve.transport import TransportClient

    from torch_gang import ROOT

    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.delenv("CME213_FAULTS", raising=False)
    specs = build_mix("cipher,sort,heat", 12, seed=3)
    local = Server(device=cuda)
    for spec in specs:
        local.submit(spec.op, spec.payload, tenant=spec.tenant)
    want = {r.rid: r.value for r in local.drain()}
    fleet = Fleet(replicas=1, mix="cipher,sort,heat", warm_requests=2,
                  max_batch=4).start()
    procs = list(fleet._procs.values())
    try:
        assert fleet.device == cuda
        assert "--device" in procs[0].proc.args and \
            procs[0].proc.args[procs[0].proc.args.index("--device") + 1] \
            == "cuda"
        got = [None] * len(specs)

        def client(i, spec):
            with TransportClient(fleet.addr, timeout_s=120.0) as c:
                got[i] = c.solve(spec.op, spec.payload, tenant=spec.tenant)

        threads = [threading.Thread(target=client, args=(i, s))
                   for i, s in enumerate(specs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
    finally:
        fleet.close()
    assert all(r is not None and r.status == OK for r in got)
    for i, r in enumerate(got):
        np.testing.assert_array_equal(np.asarray(r.value),
                                      np.asarray(want[i]))
        assert np.asarray(r.value).dtype == np.asarray(want[i]).dtype
    assert all(p.proc.poll() is not None for p in procs)


def test_chaos_campaign_on_the_card_holds_every_invariant(cuda, tmp_path):
    """An in-process campaign on ``cuda`` (the conformance check re-solves
    on the card), and the banked drift drill's fixture replays there."""
    from cme213_tpu_torch.core import chaos
    from cme213_tpu_torch.core.faults import FaultPlan

    res = chaos.run_campaign(
        "fail:serve.cipher.packed:1:2,slow:serve.sort:20.0:1:2,"
        "stage:serve.sort.radix:execute:1:1", backend="inproc",
        mix="cipher,sort,heat", requests=10, seed=3, device="cuda")
    assert res.ok, [v.as_dict() for v in res.violations]
    kw = dict(backend="inproc", mix="spmv", requests=6, seed=5,
              handicaps=("drift-compensation",), device="cuda")
    cocktail = "drift:serve.spmv_scan.blocked:0.001:1"
    drill = chaos.run_campaign(cocktail, **kw)
    assert {v.invariant for v in drill.violations} == {"conformance"}
    path = chaos.bank_fixture(drill, FaultPlan.parse(cocktail),
                              directory=str(tmp_path),
                              handicaps=("drift-compensation",))
    _, expected, observed = chaos.replay_fixture(path, device="cuda")
    assert expected == observed == ["conformance"]
