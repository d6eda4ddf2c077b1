"""Parity of the port's distributed heat solve (hw5) with the JAX package.

The JAX package runs on the test harness's 8 virtual CPU devices
(``tests/conftest.py``), its Pallas local kernel in interpret mode and
``conformance=False`` wherever a rung is pinned.  The port runs a mesh of
``virtual_devices(n, "cpu")``: n shards on the CPU, where the shard kernel
takes its plain version.  Tolerances:

- ULP-10 against JAX's ``run_distributed_heat`` (the hw2 checker): XLA:CPU
  contracts some multiply-adds into FMAs, which the port never does;
- bit for bit against the port's own ``run_heat`` and 1-shard solve: every
  scheme computes each cell with ``run_heat``'s expression, each operation
  rounded on its own;
- equality for mesh shapes, fallbacks, errors and halo contents.
"""

import numpy as np
import pytest
import torch

from cme213_tpu.apps import heat2d as j_heat2d
from cme213_tpu.config import GridMethod as JGridMethod
from cme213_tpu.config import SimParams as JSimParams
from cme213_tpu.dist import make_mesh_1d as j_mesh_1d
from cme213_tpu.dist import make_mesh_2d as j_mesh_2d
from cme213_tpu.dist import mesh_for_method as j_mesh_for_method
from cme213_tpu.dist import prepare_distributed_heat as j_prepare
from cme213_tpu.dist import run_distributed_heat as j_run_distributed_heat
from cme213_tpu_torch.apps import heat2d
from cme213_tpu_torch.config import GridMethod, SimParams
from cme213_tpu_torch.core import virtual_devices
from cme213_tpu_torch.dist import (distributed_heat_step, make_mesh_1d,
                                   make_mesh_2d, mesh_for_method,
                                   prepare_distributed_heat,
                                   run_distributed_heat)
from cme213_tpu_torch.dist import halo
from cme213_tpu_torch.dist import heat as dheat
from cme213_tpu_torch.dist.halo import exchange_halo_1d, pad_with_halos
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import LAUNCHES, run_heat
from cme213_tpu_torch.verify import check_ulp

CPU8 = virtual_devices(8, "cpu")
BCS = dict(bc_top=2.0, bc_left=0.5, bc_bottom=1.0, bc_right=3.0)
MESHES = {"1d4": (4,), "2d2x2": (2, 2), "2d4x2": (4, 2)}


def _meshes(kind):
    shape = MESHES[kind]
    if len(shape) == 1:
        return make_mesh_1d(shape[0], devices=CPU8), j_mesh_1d(shape[0])
    return make_mesh_2d(*shape, devices=CPU8), j_mesh_2d(*shape)


def _params(**kw):
    return SimParams(**kw), JSimParams(**kw)


def _run_heat(p: SimParams, iters: int | None = None) -> np.ndarray:
    iters = p.iters if iters is None else iters
    u0 = make_initial_grid(p, device="cpu")
    return run_heat(u0, iters, p.order, p.xcfl, p.ycfl).numpy()


# ---------------------------------------------------------------- meshes


@pytest.mark.parametrize("method", [GridMethod.STRIPES_1D,
                                    GridMethod.BLOCKS_2D])
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_for_method_shapes_match_reference(method, n):
    ours = mesh_for_method(method, n, devices=CPU8)
    ref = j_mesh_for_method(JGridMethod(int(method)), n)
    assert ours.devices.shape == ref.devices.shape
    assert ours.axis_names == tuple(ref.axis_names)
    assert all(d == torch.device("cpu") for d in ours.devices.flat)


def test_mesh_errors_match_reference():
    for ours, ref in ((lambda: make_mesh_1d(9, devices=CPU8),
                       lambda: j_mesh_1d(9)),
                      (lambda: make_mesh_2d(3, 3, devices=CPU8),
                       lambda: j_mesh_2d(3, 3))):
        with pytest.raises(ValueError) as ref_err:
            ref()
        with pytest.raises(ValueError, match=str(ref_err.value)):
            ours()


def test_no_cuda_entry_points_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = SimParams(nx=16, ny=16, order=2, iters=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh_1d()
    with pytest.raises(RuntimeError):
        mesh_for_method(GridMethod.BLOCKS_2D)
    with pytest.raises(RuntimeError):
        virtual_devices(2)
    with pytest.raises(RuntimeError):
        heat2d.run_distributed(p)
    assert virtual_devices(3, "cpu") == [torch.device("cpu")] * 3


# ---------------------------------------------------------------- halo


def test_exchange_halo_slabs_and_fills():
    blocks = [torch.arange(12.0).view(4, 3) + 100 * i for i in range(3)]
    halos = exchange_halo_1d(blocks, 2, -1.0, -2.0)
    assert torch.equal(halos[0][0], torch.full((2, 3), -1.0))
    assert torch.equal(halos[2][1], torch.full((2, 3), -2.0))
    for i in (1, 2):  # lo halo: the lower neighbour's last rows
        assert torch.equal(halos[i][0], blocks[i - 1][-2:])
    for i in (0, 1):  # hi halo: the upper neighbour's first rows
        assert torch.equal(halos[i][1], blocks[i + 1][:2])
    cols = pad_with_halos([b.T.contiguous() for b in blocks], 1, 7.0, 8.0,
                          dim=1)
    assert cols[1].shape == (3, 6)
    assert torch.equal(cols[1][:, 0], blocks[0][-1])
    assert torch.equal(cols[0][:, 0], torch.full((3,), 7.0))
    # a received slab is the receiver's own copy
    assert halos[1][0].data_ptr() != blocks[0].data_ptr()


@pytest.mark.parametrize("kind", ["2d2x2", "2d4x2", "1d4"])
@pytest.mark.parametrize("border", [4, 8])
def test_padded_blocks_are_windows_of_the_padded_grid(kind, border):
    """Every K-padded block — corners included — is the window of the
    whole interior padded y first, then x, with the BC fills: the corner
    halos hold the diagonal neighbour's cells, which the k ≥ 2 step
    reads."""
    p = SimParams(nx=40, ny=48, order=8, **BCS)
    mesh, _ = _meshes(kind)
    y_size, x_size, ny_loc, nx_loc = dheat._mesh_layout(p, mesh)
    u = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (p.ny, p.nx)).astype(np.float32))
    blocks = dheat._scatter(u, dheat._shard_devices(mesh, y_size, x_size),
                            ny_loc, nx_loc)
    padded = dheat._assemble_padded(blocks, p, border=border)
    K = border
    g = np.pad(u.numpy(), ((K, 0), (0, 0)), constant_values=p.bc_bottom)
    g = np.pad(g, ((0, K), (0, 0)), constant_values=p.bc_top)
    g = np.pad(g, ((0, 0), (K, 0)), constant_values=p.bc_left)
    g = np.pad(g, ((0, 0), (0, K)), constant_values=p.bc_right)
    for yi in range(y_size):
        for xi in range(x_size):
            window = g[yi * ny_loc:(yi + 1) * ny_loc + 2 * K,
                       xi * nx_loc:(xi + 1) * nx_loc + 2 * K]
            np.testing.assert_array_equal(padded[yi][xi].numpy(), window)


#: mesh shapes for the in-place assembly: (y, x), one shard, a row, a
#: column, a square
PAD_MESHES = [(1, 1), (1, 4), (4, 1), (2, 2)]


def _nan_pair(blocks, K):
    """``_padded_pair`` with every cell NaN, so a ring cell the assembly
    leaves unwritten shows."""
    pair = dheat._padded_pair(blocks, K, 4)
    for p in pair[0].own + pair[1].own:
        p.fill_(float("nan"))
    return pair


@pytest.mark.parametrize("shape", PAD_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ny,nx", [(48, 40), (46, 37)],
                         ids=["divides", "ragged"])
@pytest.mark.parametrize("kk", [1, 2], ids=["K=border", "K=2border"])
def test_in_place_assembly_equals_assemble_padded(shape, ny, nx, kk):
    """The K-padded blocks written in place (``_assemble_in_place``: the
    block into its buffer's interior, the halos into its ring) equal
    ``_assemble_padded``'s concatenated blocks bit for bit, corners
    included, on buffers poisoned with NaN.  A second assembly, whose
    blocks already are the other buffer's interiors (as after a B3 step),
    places nothing and rewrites that buffer's whole ring."""
    p = SimParams(nx=nx, ny=ny, order=8, **BCS)
    K = kk * p.border_size
    mesh = make_mesh_2d(*shape, devices=CPU8)
    y_size, x_size, ny_loc, nx_loc = dheat._mesh_layout(p, mesh)
    devices = dheat._shard_devices(mesh, y_size, x_size)
    rng = np.random.default_rng(7)

    def blocks_of(seed_shift):
        u = dheat._pad_interior_for_mesh(
            rng.uniform(0, 1, (p.ny, p.nx)).astype(np.float32) + seed_shift,
            p, y_size, x_size)
        return dheat._scatter(torch.from_numpy(u), devices, ny_loc, nx_loc)

    first = blocks_of(0)
    src, dst = _nan_pair(first, K)
    before = dict(halo.PADS)
    dheat._assemble_in_place(first, src, p)
    want = dheat._assemble_padded(first, p, border=K)
    for g, w in zip(src.own, dheat._own(want)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # the next step's blocks live in dst's interior, its ring still NaN
    second = blocks_of(10)
    for q, b in zip(dheat._own(dst.inner), dheat._own(second)):
        q.copy_(b)
    dheat._assemble_in_place(dst.inner, dst, p)
    want = dheat._assemble_padded(second, p, border=K)
    for g, w in zip(dst.own, dheat._own(want)):
        assert not torch.isnan(g).any()
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert halo.PADS["in_place"] - before["in_place"] == 2
    assert halo.PADS["cat"] - before["cat"] == 2  # the two references


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (3, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("k", [1, 2])
def test_in_place_steps_equal_the_plain_steps(shape, k):
    """Several steps of B3's in-place path (``_in_place_steps``: one pair
    of NaN-poisoned buffers a shard, swapped each step) equal as many
    plain k-step steps (``_multistep_local_step``) bit for bit, on a grid
    that divides over neither axis; every step's blocks are views of the
    pair and each step counts one in-place assembly and no ``cat``."""
    p = SimParams(nx=50, ny=46, order=8, **BCS)
    mesh = make_mesh_2d(*shape, devices=virtual_devices(9, "cpu"))
    y_size, x_size, ny_loc, nx_loc = dheat._mesh_layout(p, mesh)
    u = dheat._pad_interior_for_mesh(
        np.random.default_rng(3).uniform(0, 1, (p.ny, p.nx)).astype(
            np.float32), p, y_size, x_size)
    blocks = dheat._scatter(torch.from_numpy(u), dheat._shard_devices(
        mesh, y_size, x_size), ny_loc, nx_loc)
    K = k * p.border_size
    pair = _nan_pair(blocks, K)
    storages = {q.untyped_storage().data_ptr()
                for side in pair for q in side.own}
    got = want = blocks
    before = dict(halo.PADS)
    for step in range(3):
        got = dheat._multistep_local_step_pallas(got, p, k, pads=pair)
        pair = pair[::-1]
        want = dheat._multistep_local_step(want, p, k)
        for g, w in zip(dheat._own(got), dheat._own(want)):
            assert g.untyped_storage().data_ptr() in storages
            np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                          err_msg=f"step {step}")
    assert halo.PADS["in_place"] - before["in_place"] == 3
    assert halo.PADS["cat"] - before["cat"] == 3  # the plain steps' own
    # a solve through `_run` counts one in-place assembly a step
    before = dict(halo.PADS)
    out = run_distributed_heat(SimParams(nx=50, ny=46, order=8, iters=4 * k,
                                         **BCS), mesh, steps_per_exchange=k,
                               local_kernel="pallas", conformance=False)
    np.testing.assert_array_equal(
        out, _run_heat(SimParams(nx=50, ny=46, order=8, iters=4 * k, **BCS)))
    assert halo.PADS["in_place"] - before["in_place"] == 4
    assert halo.PADS["cat"] == before["cat"]


def test_pads_go_to_the_exit_snapshot(monkeypatch):
    """At exit the padded assemblies join the metrics registry as
    ``dist.pads.<path>`` counters, beside the exchanges' counters, also
    in a process that exchanged nothing across ranks; a process that
    assembled nothing adds none."""
    from cme213_tpu_torch.core import metrics

    monkeypatch.setitem(halo.EXCHANGE, "messages", 0)
    for pads, want in (({"in_place": 0, "cat": 0}, {}),
                       ({"in_place": 400, "cat": 0},
                        {"dist.pads.in_place": 400})):
        monkeypatch.setattr(halo, "PADS", pads)
        before = metrics.snapshot()
        halo._record_exchanges()
        assert metrics.delta(before, metrics.snapshot())["counters"] == want


# ---------------------------------------------------------------- solves


def _cases():
    cases = []
    for kind in ("1d4", "2d2x2", "2d4x2"):
        for order in (2, 4, 8):
            for overlap in (False, True):
                cases.append((kind, order, overlap, 1, "xla"))
            cases.append((kind, order, False, 1, "pallas"))
        for k in (2, 4):
            for kernel in ("xla", "pallas"):
                cases.append((kind, 8, False, k, kernel))
    return cases


@pytest.mark.parametrize("kind,order,overlap,k,kernel", _cases())
def test_solve_ulp10_vs_jax_and_bitwise_vs_run_heat(kind, order, overlap, k,
                                                    kernel):
    # 64 rows over ≤ 4 stripes keep ≥ K = 4·4 rows a shard: k is used
    p, jp = _params(nx=64 if k > 1 else 40, ny=64 if k > 1 else 48,
                    order=order, iters=8, **BCS)
    mesh, jmesh = _meshes(kind)
    _, ov, ku = prepare_distributed_heat(p, mesh, overlap=overlap,
                                         steps_per_exchange=k,
                                         local_kernel=kernel)
    _, jov, jku = j_prepare(jp, jmesh, overlap=overlap, steps_per_exchange=k,
                            local_kernel=kernel)
    assert (ov, ku) == (jov, jku) == (overlap and kernel == "xla", k)
    out = run_distributed_heat(p, mesh, overlap=overlap,
                               steps_per_exchange=k, local_kernel=kernel)
    ref = j_run_distributed_heat(jp, jmesh, overlap=overlap,
                                 steps_per_exchange=k, local_kernel=kernel,
                                 conformance=False)
    res = check_ulp(ref, out, max_ulps=10, label=f"{kind}-o{order}-k{k}")
    assert res, res.message
    np.testing.assert_array_equal(out, _run_heat(p))


@pytest.mark.parametrize("overlap,k,kernel", [
    (False, 1, "xla"), (True, 1, "xla"), (False, 1, "pallas"),
    (False, 2, "pallas"), (False, 2, "xla")])
def test_uneven_shards_vs_jax(overlap, k, kernel):
    """30 rows over 4 stripes (and 21 columns over 2 on the 2-D mesh):
    ghost rows and columns held at the top/right BCs, with the kernel
    given the true ny, nx."""
    for kind, nx in (("1d4", 24), ("2d2x2", 21)):
        p, jp = _params(nx=nx, ny=30, order=2, iters=8, **BCS)
        mesh, jmesh = _meshes(kind)
        out = run_distributed_heat(p, mesh, overlap=overlap,
                                   steps_per_exchange=k, local_kernel=kernel)
        ref = j_run_distributed_heat(jp, jmesh, overlap=overlap,
                                     steps_per_exchange=k,
                                     local_kernel=kernel, conformance=False)
        res = check_ulp(ref, out, max_ulps=10, label=f"uneven-{kind}")
        assert res, res.message
        np.testing.assert_array_equal(out, _run_heat(p))


@pytest.mark.parametrize("k,kernel", [(1, "xla"), (2, "xla"), (1, "pallas"),
                                      (2, "pallas"), (4, "pallas")])
def test_n_shards_equal_one_shard_and_run_heat(k, kernel):
    p = SimParams(nx=48, ny=64, order=4, iters=8, **BCS)
    one = run_distributed_heat(p, make_mesh_1d(1, devices=CPU8),
                               steps_per_exchange=k, local_kernel=kernel)
    np.testing.assert_array_equal(one, _run_heat(p))
    for kind in ("1d4", "2d2x2", "2d4x2"):
        mesh, _ = _meshes(kind)
        np.testing.assert_array_equal(
            run_distributed_heat(p, mesh, steps_per_exchange=k,
                                 local_kernel=kernel), one)
        np.testing.assert_array_equal(
            run_distributed_heat(p, mesh, overlap=True), one)
    assert LAUNCHES["local"] == 0  # CPU shards take the plain version


@pytest.mark.parametrize("k", [1, 2])
def test_pallas_step_is_one_batched_call_equal_to_run_heat(monkeypatch, k):
    # a 3x3 mesh over a grid that does not divide: the last row and column
    # of shards hold ghost lines
    p = SimParams(nx=50, ny=46, order=8, iters=4, **BCS)
    mesh = make_mesh_2d(3, 3, devices=virtual_devices(9, "cpu"))
    calls = []
    batched = dheat.stencil_local_multistep_shards

    def spy(blocks, offsets, *a, **kw):
        calls.append(len(blocks))
        return batched(blocks, offsets, *a, **kw)

    # the first gated solve runs the conformance probes; their verdict is
    # cached, so the spied solve below is the solve alone
    run_distributed_heat(p, mesh, steps_per_exchange=k,
                         local_kernel="pallas")
    monkeypatch.setattr(dheat, "stencil_local_multistep_shards", spy)
    out = run_distributed_heat(p, mesh, steps_per_exchange=k,
                               local_kernel="pallas")
    np.testing.assert_array_equal(out, _run_heat(p))
    assert calls == [9] * (p.iters // k)  # every shard in one call
    # the step itself, against the plain per-shard k steps
    y_size, x_size, ny_loc, nx_loc = dheat._mesh_layout(p, mesh)
    u = dheat._pad_interior_for_mesh(
        np.random.default_rng(1).uniform(0, 1, (p.ny, p.nx)), p, y_size,
        x_size)
    blocks = dheat._scatter(torch.from_numpy(u), dheat._shard_devices(
        mesh, y_size, x_size), ny_loc, nx_loc)
    got = dheat._multistep_local_step_pallas(blocks, p, k)
    want = dheat._multistep_local_step(blocks, p, k)
    for grow, wrow in zip(got, want):
        for g, w in zip(grow, wrow):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert LAUNCHES["local"] == 0  # CPU shards take the plain version


def test_f64_solve_bitwise_vs_run_heat():
    p = SimParams(nx=40, ny=48, order=8, iters=8, **BCS)
    mesh, _ = _meshes("2d2x2")
    u0 = make_initial_grid(p, dtype=torch.float64, device="cpu")
    ref = run_heat(u0, 8, 8, p.xcfl, p.ycfl).numpy()
    for kernel, k in (("xla", 1), ("pallas", 2)):
        out = run_distributed_heat(p, mesh, dtype=torch.float64,
                                   steps_per_exchange=k, local_kernel=kernel)
        assert out.dtype == np.float64
        np.testing.assert_array_equal(out, ref)


def test_step_function_is_one_iteration():
    p = SimParams(nx=40, ny=48, order=4, iters=1, **BCS)
    mesh, _ = _meshes("2d2x2")
    b = p.border_size
    u = make_initial_grid(p, device="cpu")[b:-b, b:-b]
    for overlap in (False, True):
        step = distributed_heat_step(p, mesh, overlap=overlap)
        np.testing.assert_array_equal(step(u).numpy(),
                                      _run_heat(p, 1)[b:-b, b:-b])


# ---------------------------------------------------------------- fallbacks


@pytest.mark.parametrize("kw,mesh_kind,prep", [
    # ny_loc = 4: ≥ border but < 2·border — overlap falls back to sync
    (dict(nx=24, ny=32, order=8, iters=3), ("1d", 8), dict(overlap=True)),
    # 6-row stripes < K = 8: k falls back to 1
    (dict(nx=48, ny=48, order=8, iters=4), ("1d", 8),
     dict(steps_per_exchange=2)),
    # iters % k: k falls back to 1
    (dict(nx=48, ny=48, order=4, iters=6), ("1d", 2),
     dict(steps_per_exchange=4)),
    # overlap with k > 1: k falls back to 1
    (dict(nx=48, ny=48, order=4, iters=8), ("2d", 4),
     dict(overlap=True, steps_per_exchange=2)),
    # pallas: overlap off, k kept, also with synchronous=False params
    (dict(nx=40, ny=48, order=8, iters=8, synchronous=False), ("1d", 2),
     dict(steps_per_exchange=2, local_kernel="pallas")),
    (dict(nx=40, ny=48, order=8, iters=8, synchronous=False), ("1d", 2),
     dict()),
    (dict(nx=40, ny=48, order=2, iters=8), ("2d", 8),
     dict(overlap=True, local_kernel="pallas", steps_per_exchange=4)),
])
def test_prepare_resolves_like_reference(kw, mesh_kind, prep):
    p, jp = _params(**kw)
    dim, n = mesh_kind
    method = GridMethod.STRIPES_1D if dim == "1d" else GridMethod.BLOCKS_2D
    mesh = mesh_for_method(method, n, devices=CPU8)
    jmesh = j_mesh_for_method(JGridMethod(int(method)), n)
    _, ov, k = prepare_distributed_heat(p, mesh, **prep)
    _, jov, jk = j_prepare(jp, jmesh, **prep)
    assert (ov, k) == (jov, jk)
    out = run_distributed_heat(p, mesh, **prep)
    np.testing.assert_array_equal(out, _run_heat(p))


def test_errors_match_reference():
    p, jp = _params(nx=24, ny=16, order=8, iters=3)  # ny_loc 2 < border 4
    with pytest.raises(ValueError) as ref_err:
        j_prepare(jp, j_mesh_1d(8))
    with pytest.raises(ValueError, match="thinner than the stencil border"):
        run_distributed_heat(p, make_mesh_1d(8, devices=CPU8))
    assert "thinner than the stencil border" in str(ref_err.value)
    p, jp = _params(nx=40, ny=48, order=8, iters=8)
    with pytest.raises(ValueError, match="local_kernel") as ours:
        prepare_distributed_heat(p, make_mesh_1d(2, devices=CPU8),
                                 local_kernel="Pallas")
    with pytest.raises(ValueError) as ref_err:
        j_prepare(jp, j_mesh_1d(2), local_kernel="Pallas")
    assert str(ours.value) == str(ref_err.value)


def test_iterate_times_and_repeats():
    p = SimParams(nx=40, ny=48, order=4, iters=4, **BCS)
    iterate, _, _ = prepare_distributed_heat(p, make_mesh_1d(4,
                                                             devices=CPU8))
    s1, out1 = iterate()
    s2, out2 = iterate()
    assert s1 >= 0 and s2 >= 0
    assert out1.shape == (p.ny, p.nx)
    assert torch.equal(out1, out2)


# ---------------------------------------------------------------- CLI


def _dump_values(path) -> np.ndarray:
    rows = [line.split() for line in open(path) if line.strip()]
    return np.array(rows, dtype=np.float64)


def _same_dumps(ours_dir, ref_dir):
    names = {f.name for f in ref_dir.iterdir()}
    assert {f.name for f in ours_dir.iterdir()} == names
    for name in names:
        # dumps print 3 significant digits
        np.testing.assert_allclose(_dump_values(ours_dir / name),
                                   _dump_values(ref_dir / name),
                                   rtol=1e-2, atol=0)


def test_cli_distributed_pallas_matches_reference_dumps(tmp_path,
                                                       monkeypatch, capsys):
    kw = dict(nx=40, ny=36, alpha=0.5, iters=8, order=4, ic=1.0,
              grid_method=JGridMethod.BLOCKS_2D, synchronous=True, **BCS)
    path = tmp_path / "p.in"
    JSimParams(**kw).to_file(str(path), distributed=True)
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    ours_dir.mkdir()
    ref_dir.mkdir()
    monkeypatch.chdir(ours_dir)
    assert heat2d.main(["heat2d", str(path), "--distributed",
                        "--local-kernel=pallas", "--device=cpu"]) == 0
    assert "distributed computation took" in capsys.readouterr().out
    ref = j_heat2d.run_distributed(JSimParams.from_file(str(path),
                                                        distributed=True),
                                   num_devices=1, save_files=True,
                                   out_dir=str(ref_dir),
                                   local_kernel="pallas")
    _same_dumps(ours_dir, ref_dir)
    assert sorted(f.name for f in ours_dir.iterdir()) == [
        "grid0_final.txt", "grid_final.txt", "grid_init.txt"]
    ours = SimParams.from_file(str(path), distributed=True)
    assert ref.shape == (ours.gy, ours.gx)


@pytest.mark.parametrize("method,synchronous,kernel", [
    (JGridMethod.BLOCKS_2D, True, "pallas"),
    (JGridMethod.STRIPES_1D, False, "xla")])
def test_run_distributed_four_shards_vs_reference(tmp_path, method,
                                                  synchronous, kernel):
    kw = dict(nx=40, ny=36, alpha=0.5, iters=8, order=8, ic=1.0,
              grid_method=method, synchronous=synchronous, **BCS)
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    ours_dir.mkdir()
    ref_dir.mkdir()
    out = heat2d.run_distributed(SimParams(**kw), save_files=True,
                                 out_dir=str(ours_dir), local_kernel=kernel,
                                 devices=virtual_devices(4, "cpu"))
    ref = j_heat2d.run_distributed(JSimParams(**kw), num_devices=4,
                                   save_files=True, out_dir=str(ref_dir),
                                   local_kernel=kernel)
    res = check_ulp(ref, out, max_ulps=10, label="run_distributed")
    assert res, res.message
    _same_dumps(ours_dir, ref_dir)
    assert len(list(ours_dir.iterdir())) == 6  # init, final, 4 ranks
    np.testing.assert_array_equal(out, _run_heat(SimParams(**kw)))

