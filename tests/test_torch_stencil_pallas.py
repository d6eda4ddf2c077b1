"""The port's band-staged heat stencil (B4, B5) against the JAX package.

Every case of ``tests/test_stencil_pallas.py``, on inputs made from a seed
with numpy: the JAX kernels run in Pallas interpret mode, the port's
wrappers on the CPU take their plain versions.  Tolerance: ULP-10, the hw2
checker (XLA:CPU contracts some multiply-adds into FMAs; the port rounds
every operation on its own).  The port is also held bit for bit to its
plain versions and to ``ops.stencil.run_heat``: B4 on any halo (it imposes
no boundary value), B5 on grids whose bands hold ``bc``.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Its decomposition — strips of TX columns from grid
column 0, runs of tile_y-row tiles per block, one or two staging windows,
4 × R micro-tiles over ragged row chunks whose side loads wrap into the
neighbouring row, the sub-steps' ping-pong through buffers that keep stale
values, window cells outside the grid reading 0, band code skipped tile by
tile, only interior cells written — is modelled in numpy
(``test_torch_pipeline._kernel_model`` with ``band=True``, the model of
the tile body both heat kernels share) and held bitwise to the plain
version at each compiled design.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu.config import SimParams as JSimParams
from cme213_tpu.grid import make_initial_grid as j_make_initial_grid
from cme213_tpu.ops.stencil_pallas import pick_tile as j_pick_tile
from cme213_tpu.ops.stencil_pallas import run_heat_multistep as j_multistep
from cme213_tpu.ops.stencil_pallas import run_heat_pallas as j_heat_pallas
from cme213_tpu.ops.stencil_pallas import \
    stencil_interior_pallas as j_interior_pallas
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import _kernels, run_heat, stencil_interior
from cme213_tpu_torch.ops import stencil_pallas as spl
from cme213_tpu_torch.ops.stencil import BORDER_FOR_ORDER
from cme213_tpu_torch.ops.stencil_pipeline import SMEM_BUDGET_BYTES
from cme213_tpu_torch.verify import check_ulp
from test_torch_pipeline import _kernel_model

BC = (1.5, 0.5, 2.0, 0.25)


def _assert_ulp10(ref, out):
    res = check_ulp(np.asarray(ref), out.numpy(), max_ulps=10)
    assert res, res.message


def _grid(nx, ny, order, seed, bc=BC, dtype=np.float32):
    """Initial grid with a seeded interior; its bands hold ``bc``."""
    p = SimParams(nx=nx, ny=ny, order=order, bc_top=bc[0], bc_left=bc[1],
                  bc_bottom=bc[2], bc_right=bc[3])
    u = make_initial_grid(p, dtype=torch.float64, device="cpu").numpy()
    b = p.border_size
    u[b:-b, b:-b] += np.random.default_rng(seed).uniform(0, 1, (ny, nx))
    return p, u.astype(dtype)


# ------------------------------------------------ tests/test_stencil_pallas


@pytest.mark.parametrize("order", [2, 4, 8])
def test_single_step_matches_jax(order):
    # the JAX test's input: a ramp over the whole grid, so the halo does
    # not hold the boundary values
    p = SimParams(nx=32, ny=32, order=order)
    u = (make_initial_grid(p, device="cpu")
         + 0.01 * torch.arange(p.gy * p.gx, dtype=torch.float32
                               ).reshape(p.gy, p.gx))
    ty = spl.pick_tile(p.ny, 16)
    ref = j_interior_pallas(jnp.array(u.numpy()), order, p.xcfl, p.ycfl,
                            tile_y=ty, interpret=True)
    out = spl.stencil_interior_pallas(u, order, p.xcfl, p.ycfl, tile_y=ty)
    _assert_ulp10(ref, out)
    assert torch.equal(out, spl.stencil_interior_pallas_plain(
        u, order, p.xcfl, p.ycfl))
    assert torch.equal(out, stencil_interior(u, order, p.xcfl, p.ycfl))


def test_iterated_matches_jax():
    p = SimParams(nx=24, ny=24, order=4, iters=6)
    u0 = make_initial_grid(p, device="cpu")
    ty = spl.pick_tile(p.ny, 8)
    ref = j_heat_pallas(jnp.array(u0.numpy()), 6, 4, p.xcfl, p.ycfl,
                        tile_y=ty, interpret=True)
    out = spl.run_heat_pallas(u0, 6, 4, p.xcfl, p.ycfl, tile_y=ty)
    _assert_ulp10(ref, out)
    assert torch.equal(out, run_heat(u0, 6, 4, p.xcfl, p.ycfl))


@pytest.mark.parametrize("order", [2, 8])
@pytest.mark.parametrize("k", [2, 3])
def test_multistep_matches_jax(order, k):
    p = SimParams(nx=32, ny=32, order=order, iters=6)
    u0 = make_initial_grid(p, device="cpu")
    ref = j_multistep(jnp.array(u0.numpy()), 6, order, p.xcfl, p.ycfl, p.bc,
                      k=k, tile_y=8, interpret=True)
    out = spl.run_heat_multistep(u0, 6, order, p.xcfl, p.ycfl, p.bc, k=k,
                                 tile_y=8)
    _assert_ulp10(ref, out)
    assert torch.equal(out, run_heat(u0, 6, order, p.xcfl, p.ycfl))


def test_multistep_nonuniform_state():
    """k fused steps on a seeded interior, non-square (JAX's 24 x 48)."""
    p = SimParams(nx=24, ny=48, order=4, iters=4)
    u0 = make_initial_grid(p, device="cpu").numpy()
    b = p.border_size
    u0[b:-b, b:-b] += np.random.default_rng(3).standard_normal(
        (p.ny, p.nx)).astype(np.float32)
    ref = j_multistep(jnp.array(u0), 4, 4, p.xcfl, p.ycfl, p.bc, k=4,
                      tile_y=12, interpret=True)
    out = spl.run_heat_multistep(torch.from_numpy(u0), 4, 4, p.xcfl, p.ycfl,
                                 p.bc, k=4, tile_y=12)
    _assert_ulp10(ref, out)
    assert torch.equal(out, run_heat(torch.from_numpy(u0), 4, 4, p.xcfl,
                                     p.ycfl))


def test_pick_tile():
    assert spl.pick_tile(4000, 256) == 200  # 8-aligned divisor preferred
    assert spl.pick_tile(256, 256) == 256
    assert spl.pick_tile(4000, 450) == 400
    assert spl.pick_tile(30, 16) == 15      # no 8-aligned divisor: fall back
    assert spl.pick_tile(7, 16) == 7
    for ny in range(1, 130):
        for target in (8, 16, 100, 200, 256):
            assert spl.pick_tile(ny, target) == j_pick_tile(ny, target)


# ------------------------------------------------ the port's own contract


@pytest.mark.parametrize("order,k", [(2, 1), (4, 2), (8, 3), (8, 4)])
def test_wrappers_bitwise_vs_plain_and_jax_uneven_bc(order, k):
    """Distinct boundary values on all four sides, a seeded interior, a
    non-square grid: B5 (and B4 at k = 1) equals its plain version and
    ``run_heat`` bit for bit, and JAX within ULP-10."""
    p, u0 = _grid(36, 40, order, seed=order * 10 + k)
    iters = 2 * k
    u = torch.from_numpy(u0)
    args = (iters, order, p.xcfl, p.ycfl)
    out = spl.run_heat_multistep(u, *args, p.bc, k=k, tile_y=8)
    assert torch.equal(out, spl.run_heat_multistep_plain(u, *args, p.bc,
                                                         k=k))
    assert torch.equal(out, run_heat(u, *args))
    _assert_ulp10(j_multistep(jnp.array(u0), *args, p.bc, k=k, tile_y=8,
                              interpret=True), out)
    b4 = spl.run_heat_pallas(u, *args, tile_y=20)
    assert torch.equal(b4, run_heat(u, *args))
    _assert_ulp10(j_heat_pallas(jnp.array(u0), *args, tile_y=20,
                                interpret=True), b4)
    np.testing.assert_array_equal(u.numpy(), u0)  # the input is untouched


def test_b4_leaves_a_foreign_halo_as_given():
    """B4 imposes no boundary value: a halo that does not hold ``bc``
    passes through, as in the JAX kernel."""
    p, u0 = _grid(16, 24, 4, seed=1)
    b = p.border_size
    u0[:b] = 7.0
    u0[:, -b:] = -3.0
    out = spl.run_heat_pallas(torch.from_numpy(u0), 3, 4, p.xcfl, p.ycfl,
                              tile_y=8)
    np.testing.assert_array_equal(out.numpy()[:b], u0[:b])
    np.testing.assert_array_equal(out.numpy()[:, -b:], u0[:, -b:])
    _assert_ulp10(j_heat_pallas(jnp.array(u0), 3, 4, p.xcfl, p.ycfl,
                                tile_y=8, interpret=True), out)


def test_f64_bitwise_vs_run_heat():
    p, u0 = _grid(20, 24, 8, seed=5, dtype=np.float64)
    u = torch.from_numpy(u0)
    out = spl.run_heat_multistep(u, 8, 8, p.xcfl, p.ycfl, p.bc, k=4,
                                 tile_y=8)
    assert out.dtype == torch.float64
    assert torch.equal(out, run_heat(u, 8, 8, p.xcfl, p.ycfl))


def test_jax_initial_grid_is_the_ports():
    p = SimParams(nx=20, ny=12, order=8)
    jp = JSimParams(nx=20, ny=12, order=8)
    np.testing.assert_array_equal(
        make_initial_grid(p, device="cpu").numpy(),
        np.asarray(j_make_initial_grid(jp)))


def test_wrappers_refuse_what_the_jax_package_asserts():
    p, u0 = _grid(16, 24, 4, seed=2)
    u = torch.from_numpy(u0)
    with pytest.raises(ValueError, match="tile_y"):
        spl.run_heat_pallas(u, 2, 4, p.xcfl, p.ycfl, tile_y=7)
    with pytest.raises(ValueError, match="tile_y"):
        spl.stencil_interior_pallas(u, 4, p.xcfl, p.ycfl, tile_y=5)
    with pytest.raises(ValueError, match="divide by k"):
        spl.run_heat_multistep(u, 6, 4, p.xcfl, p.ycfl, p.bc, k=4,
                               tile_y=8)
    with pytest.raises(TypeError):
        spl.run_heat_pallas(u.half(), 2, 4, p.xcfl, p.ycfl, tile_y=8)
    with pytest.raises(ValueError, match="no kernel"):
        spl.run_heat_pallas(u.to("meta"), 2, 4, p.xcfl, p.ycfl, tile_y=8)
    assert spl.LAUNCHES == {"stencil_full": 0, "multistep": 0}


# ------------------------------------------------ the kernel's geometry


#: (ny, tile_y, k, dtype bytes) -> (TX, nbuf, run), at order 8 on a card of
#: DEFAULT_SMS SMs with the blocks an SM estimated from the menu
SWEEP_CELLS = {(2000, 40, 1, 4): (96, 2, 2), (2000, 80, 1, 4): (96, 2, 1),
               (2000, 200, 1, 4): (96, 2, 2), (2000, 400, 1, 4): (96, 1, 1),
               (4000, 200, 1, 4): (96, 2, 7), (4000, 200, 2, 4): (48, 1, 1),
               (4000, 200, 4, 4): (32, 1, 1), (4000, 200, 8, 4): (32, 1, 1),
               (4000, 200, 3, 4): (32, 1, 1), (2000, 80, 1, 8): (64, 2, 4),
               (2000, 80, 2, 8): (32, 1, 1), (2000, 80, 8, 8): (32, 1, 1)}


@pytest.mark.parametrize("cell", list(SWEEP_CELLS), ids=str)
def test_band_geometry_at_the_sweeps_cells(cell):
    n, ty, k, elem = cell
    geo = spl.band_geometry(n, n, ty, k, 8, elem)
    d = spl.design(k, elem)
    assert (geo.tile_x, geo.nbuf, geo.run) == SWEEP_CELLS[cell]
    assert (geo.tile_x, geo.threads, geo.rows) == (d.tile_x, d.threads,
                                                   d.rows)
    assert geo.smem == spl.band_smem_bytes(ty, k, 8, geo.nbuf, elem) \
        <= SMEM_BUDGET_BYTES
    strips, splits = geo.grid
    assert strips == -(-(n + 4) // geo.tile_x)  # grid columns [0, b + nx)
    ntiles = n // ty
    assert (splits - 1) * geo.run < ntiles <= splits * geo.run
    assert geo.blocks_per_sm == spl.estimated_blocks_per_sm(geo.smem, d)
    # two buffers and runs of tiles where the design prefetches and they
    # fit; else one window and one tile a block
    two = spl.band_smem_bytes(ty, k, 8, 2, elem)
    assert geo.nbuf == (2 if d.prefetch and two <= SMEM_BUDGET_BYTES else 1)
    assert geo.run == (spl.balanced_run(strips, ntiles, spl.DEFAULT_SMS
                                        * geo.blocks_per_sm)
                       if geo.nbuf == 2 else 1)


def test_balanced_run():
    # 4000² at k = 1: 32 strips x 20 tiles on 132 slots, runs of 5 fill
    # 128 of them in one round (the shortest makespan, 5 tiles)
    assert spl.balanced_run(32, 20, 132) == 5
    # 84 strips x 20 tiles: one run a strip leaves 48 SMs idle (20 tiles);
    # runs of 7 take 2 rounds (14 tiles) against 13 for single tiles
    assert spl.balanced_run(84, 20, 132) == 7
    # fewer strips than slots, one tile each: one round
    assert spl.balanced_run(16, 1, 264) == 1
    for strips, ntiles, slots in [(126, 20, 132), (16, 50, 264),
                                  (63, 25, 264), (5, 3, 7)]:
        r = spl.balanced_run(strips, ntiles, slots)

        def makespan(q):
            return -(-strips * -(-ntiles // q) // slots) * q
        best = min(makespan(q) for q in range(1, ntiles + 1))
        assert makespan(r) <= 1.1 * best
        assert all(makespan(q) > 1.1 * best for q in range(r + 1,
                                                            ntiles + 1))


def test_band_geometry_numbers_in_the_design_note():
    # the 4000^2 pallas-roll cell: two 208 x 104 windows (173,056 B) a
    # block, one block an SM, 42 strips x 3 runs of 7 tiles
    geo = spl.band_geometry(4000, 4000, 200, 1, 8)
    assert (geo.grid, geo.run, geo.smem, geo.blocks_per_sm, geo.nbuf) == \
        ((42, 3), 7, 2 * 208 * 104 * 4, 1, 2)
    # one window would leave two blocks an SM, one tile each
    one = spl.band_geometry(4000, 4000, 200, 1, 8, nbuf=1)
    assert (one.blocks_per_sm, one.run, one.grid) == (2, 1, (42, 20))
    # k = 2: one 216 x 64 window and the scratch, two blocks an SM, one tile
    # a block
    geo = spl.band_geometry(4000, 4000, 200, 2, 8)
    assert (geo.grid, geo.smem, geo.blocks_per_sm, geo.nbuf) == \
        ((84, 20), 2 * 216 * 64 * 4, 2, 1)
    # k = 8 at tile_y 200: three 264 x 96 windows fit at no width, two do
    assert spl.band_smem_bytes(200, 8, 8, 1) == 2 * 264 * 96 * 4
    assert spl.band_smem_bytes(200, 8, 8, 2) > SMEM_BUDGET_BYTES
    # no window fits: a 400-row window at k = 8 is 464 rows
    with pytest.raises(ValueError, match="shared memory"):
        spl.band_geometry(2000, 2000, 400, 8, 8)
    with pytest.raises(ValueError, match="shared memory"):
        spl.band_geometry(4000, 4000, 200, 8, 8, nbuf=2)
    # ragged row chunks and slack: order 2 at R = 8 keeps one micro-tile of
    # slack rows; tile_y 85 rounds up to 88 rows
    assert spl.band_smem_bytes(85, 1, 2, 1) == (88 + 2 + 8) * 104 * 4
    # strips cover grid columns [0, b + nx): 1 + 4032 columns need 43
    assert spl.band_geometry(40, 4032, 8, 1, 2).grid[0] == 43
    assert spl.band_geometry(40, 4031, 8, 1, 2).grid[0] == 42
    # a forced single buffer
    assert spl.band_geometry(2000, 2000, 40, 1, 8, nbuf=1).nbuf == 1


def test_design_menu_mirrors_the_source():
    """``DESIGNS`` is the menu compiled into ``csrc/heat_band.cu``."""
    import re
    from cme213_tpu_torch.ops._kernels import SOURCES

    text = SOURCES["heat_band"].read_text()
    for (elem, kc), d in spl.DESIGNS.items():
        name = f"HEAT_BAND_F{8 * elem}_K{kc}"
        m = re.search(rf"#define {name} (\d+), (\d+), (\d+), (\d+)", text)
        assert m, name
        assert tuple(map(int, m.groups())) == (d.tile_x, d.threads, d.rows,
                                               d.min_blocks)
        assert d.prefetch == (kc == 1)
        assert d.tile_x % 4 == 0 and d.threads % 32 == 0
    assert spl.design(8) == spl.design(3) == spl.DESIGNS[(4, 3)]
    with pytest.raises(ValueError, match="k=0"):
        spl.design(0)


def test_band_launchers_refuse_bad_arguments():
    u = torch.zeros(16, 16)
    kw = dict(order=2, k=1, tile_y=8, run=1, nbuf=1,
              smem_bytes=spl.band_smem_bytes(8, 1, 2, 1), xcfl=0.1, ycfl=0.1,
              bc=BC)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.heat_band_launchers([(u, torch.zeros(14, 14))], **kw)
    assert spl.LAUNCHES == {"stencil_full": 0, "multistep": 0}


def _band_model(u: np.ndarray, iters: int, order: int, xcfl, ycfl, bc, k,
                tile_y: int, tile_x: int, rows: int, run: int, nbuf: int,
                halo: str) -> np.ndarray:
    """numpy model of ``run_heat_pallas`` (``halo="copy"``) and
    ``run_heat_multistep`` (``halo="bc"``) on the card: the two grids the
    wrapper ping-pongs between (NaN where nothing was written), halo set
    once, and one ``csrc/heat_band.cu`` launch per k steps, modelled block
    by block with the block's shared-memory buffers (stale NaN where
    nothing was written) by ``test_torch_pipeline._kernel_model``."""
    b = BORDER_FOR_ORDER[order]
    bufs = [np.full_like(u, np.nan), np.full_like(u, np.nan)]
    for g in bufs:
        if halo == "copy":
            g[:b], g[-b:], g[:, :b], g[:, -b:] = \
                u[:b], u[-b:], u[:, :b], u[:, -b:]
        else:
            g[:b], g[-b:], g[:, :b], g[:, -b:] = bc[2], bc[0], bc[1], bc[3]
    src = u
    for launch in range(iters // k):
        dst = bufs[launch % 2]
        _kernel_model(src, order, xcfl, ycfl, bc, k, tile_y, tile_x, rows,
                      run, band=True, nbuf=nbuf, out=dst)
        src = dst
    return src


def _plain(u0, iters, order, p, k):
    u = torch.from_numpy(u0)
    if k == 1:
        return spl.run_heat_pallas_plain(u, iters, order, p.xcfl, p.ycfl)
    return spl.run_heat_multistep_plain(u, iters, order, p.xcfl, p.ycfl,
                                        p.bc, k=k)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("geometry", [
    dict(tile_x=32, rows=8, run=1, nbuf=2),   # ragged last strip
    dict(tile_x=32, rows=4, run=3, nbuf=2),   # a run of 3 tiles, then 1
    dict(tile_x=64, rows=2, run=2, nbuf=1),   # one strip, no prefetch
    dict(tile_x=16, rows=8, run=4, nbuf=1),   # one block a strip
], ids=["tx32-run1", "tx32-run3", "tx64-nbuf1", "tx32-run4-nbuf1"])
def test_kernel_decomposition_bitwise_vs_plain(k, geometry):
    """Order 8, a non-square grid (ny = 160, nx = 52), tile_y = 40 (a tile
    of ``pallas_tile_sweep``); k = 1 on a halo that does not hold the
    boundary values (B4), k ≥ 2 with the bands re-imposed (B5), where the
    window reaches K − b cells past the grid."""
    p, u0 = _grid(52, 160, 8, seed=k)
    iters = 2 * k
    if k == 1:
        u0[:4] += 1.0  # a foreign halo: B4 must not touch it
    model = _band_model(u0, iters, 8, p.xcfl, p.ycfl, p.bc, k, 40,
                        halo="copy" if k == 1 else "bc", **geometry)
    np.testing.assert_array_equal(model, _plain(u0, iters, 8, p, k).numpy())


@pytest.mark.parametrize("k", [1, 2, 4])
def test_kernel_decomposition_at_band_geometry(k):
    """The model at the geometry ``band_geometry`` picks for a one-SM card
    (several tiles a block, or several blocks a strip)."""
    p, u0 = _grid(70, 120, 8, seed=10 + k)
    geo = spl.band_geometry(p.ny, p.nx, 24, k, 8, sms=1)
    assert geo.run > 1 or geo.grid[1] > 1
    model = _band_model(u0, 2 * k, 8, p.xcfl, p.ycfl, p.bc, k, 24,
                        geo.tile_x, geo.rows, geo.run, geo.nbuf,
                        halo="copy" if k == 1 else "bc")
    np.testing.assert_array_equal(model, _plain(u0, 2 * k, 8, p, k).numpy())


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(120, 77, 40), (255, 121, 85)],
                         ids=["120x77-tile40", "255x121-tile85"])
def test_kernel_model_at_the_compiled_designs(shape, dtype, order, k):
    """Each compiled design, at the runs and buffers ``band_geometry``
    gives a small card (2 SMs), on non-square grids whose tile_y (40, 85)
    is not a multiple of every micro-tile height (a ragged row chunk) and
    whose width is no multiple of a strip; orders 2 and 4 put the interior
    off the 16-byte grid and wrap side loads at k > 1."""
    ny, nx, ty = shape
    p, u0 = _grid(nx, ny, order, seed=order * 7 + k, dtype=dtype)
    elem = np.dtype(dtype).itemsize
    if k == 1:
        u0[:, -BORDER_FOR_ORDER[order]:] -= 2.0  # a foreign halo (B4)
    geo = spl.band_geometry(ny, nx, ty, k, order, elem, sms=2)
    model = _band_model(u0, 2 * k, order, p.xcfl, p.ycfl, p.bc, k, ty,
                        geo.tile_x, geo.rows, geo.run, geo.nbuf,
                        halo="copy" if k == 1 else "bc")
    np.testing.assert_array_equal(model,
                                  _plain(u0, 2 * k, order, p, k).numpy())


def test_model_catches_a_missing_band():
    """The model is not vacuous: without the re-imposed bands the k-step
    result differs from the plain version."""
    p, u0 = _grid(40, 80, 8, seed=7)
    bad = (9.0, 9.0, 9.0, 9.0)
    model = _band_model(u0, 4, 8, p.xcfl, p.ycfl, bad, 2, 40, 32, 4, 1, 2,
                        halo="bc")
    model[:4], model[-4:], model[:, :4], model[:, -4:] = \
        p.bc[2], p.bc[0], p.bc[1], p.bc[3]  # the halo the wrapper sets
    plain = spl.run_heat_multistep_plain(torch.from_numpy(u0), 4, 8, p.xcfl,
                                         p.ycfl, p.bc, k=2)
    assert not np.array_equal(model, plain.numpy())
