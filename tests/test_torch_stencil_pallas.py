"""The port's band-staged heat stencil (B4, B5) against the JAX package.

Every case of ``tests/test_stencil_pallas.py``, on inputs made from a seed
with numpy: the JAX kernels run in Pallas interpret mode, the port's
wrappers on the CPU take their plain versions.  Tolerance: ULP-10, the hw2
checker (XLA:CPU contracts some multiply-adds into FMAs; the port rounds
every operation on its own).  The port is also held bit for bit to its
plain versions and to ``ops.stencil.run_heat``: B4 on any halo (it imposes
no boundary value), B5 on grids whose bands hold ``bc``.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Its decomposition — strips of TX columns, runs of
tile_y-row tiles per block, the prefetch buffer, the sub-steps' ping-pong
through buffers that keep stale values, window cells outside the grid
reading 0 — is modelled in numpy below and held bitwise to the plain
version.
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
from cme213_tpu_torch.ops import run_heat, stencil_interior
from cme213_tpu_torch.ops import stencil_pallas as spl
from cme213_tpu_torch.ops.stencil import BORDER_FOR_ORDER, STENCIL_COEFFS
from cme213_tpu_torch.ops.stencil_pipeline import SMEM_BUDGET_BYTES
from cme213_tpu_torch.verify import check_ulp

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


#: (ny, tile_y, k, dtype bytes) -> (TX, nbuf), the table in the source note
#: of csrc/heat_band.cu, at order 8
SWEEP_CELLS = {(2000, 40, 1, 4): (128, 2), (2000, 80, 1, 4): (128, 2),
               (2000, 200, 1, 4): (128, 2), (2000, 400, 1, 4): (32, 2),
               (4000, 200, 1, 4): (128, 2), (4000, 200, 2, 4): (64, 2),
               (4000, 200, 4, 4): (32, 2), (4000, 200, 8, 4): (32, 1)}


@pytest.mark.parametrize("cell", list(SWEEP_CELLS), ids=str)
def test_band_geometry_at_the_sweeps_cells(cell):
    n, ty, k, elem = cell
    geo = spl.band_geometry(n, n, ty, k, 8, elem)
    assert (geo.tile_x, geo.nbuf) == SWEEP_CELLS[cell]
    assert geo.smem == spl.band_smem_bytes(ty, geo.tile_x, k, 8, geo.nbuf,
                                           elem) <= SMEM_BUDGET_BYTES
    strips, splits = geo.grid
    assert strips == -(-n // geo.tile_x)
    ntiles = n // ty
    assert (splits - 1) * geo.run < ntiles <= splits * geo.run
    # about one wave: the blocks fit in the resident slots, or each strip
    # is one block
    assert strips * splits <= spl.DEFAULT_SMS * geo.blocks_per_sm \
        or splits == 1


def test_band_geometry_numbers_in_the_design_note():
    # the 4000^2 pallas-roll cell: 32 strips x 4 runs of 5 tiles, one wave
    geo = spl.band_geometry(4000, 4000, 200, 1, 8)
    assert (geo.grid, geo.run, geo.smem, geo.blocks_per_sm) == \
        ((32, 4), 5, 226_304, 1)
    # no strip fits: a 400-row window at k = 8 is 464 rows
    with pytest.raises(ValueError, match="shared memory"):
        spl.band_geometry(2000, 2000, 400, 8, 8)
    # narrow grids get a narrow strip
    assert spl.band_geometry(40, 20, 8, 1, 2).tile_x == 32


def _band_model(u: np.ndarray, iters: int, order: int, xcfl, ycfl, bc, k,
                tile_y: int, tile_x: int, run: int, nbuf: int,
                halo: str) -> np.ndarray:
    """numpy model of ``run_heat_pallas`` (``halo="copy"``) and
    ``run_heat_multistep`` (``halo="bc"``) on the card: the two grids the
    wrapper ping-pongs between, and one ``csrc/heat_band.cu`` launch per k
    steps, block by block, with the block's shared-memory buffers (stale
    NaN where nothing was written) as the kernel uses them."""
    f = u.dtype.type
    b = BORDER_FOR_ORDER[order]
    K = k * b
    H, W = u.shape
    ny, nx = H - 2 * b, W - 2 * b
    coeffs = [f(c) for c in STENCIL_COEFFS[order]]
    top, left, bottom, right = (f(v) for v in bc)
    xcfl, ycfl = f(xcfl), f(ycfl)
    WY, WX = tile_y + 2 * K, tile_x + 2 * K
    ntiles = -(-ny // tile_y)
    strips, splits = -(-nx // tile_x), -(-ntiles // run)

    bufs = [np.full_like(u, np.nan), np.full_like(u, np.nan)]
    for g in bufs:
        if halo == "copy":
            g[:b], g[-b:], g[:, :b], g[:, -b:] = \
                u[:b], u[-b:], u[:, :b], u[:, -b:]
        else:
            g[:b], g[-b:], g[:, :b], g[:, -b:] = bottom, top, left, right

    def update(win, ys, xs):
        accx = np.zeros((ys.stop - ys.start, xs.stop - xs.start), u.dtype)
        accy = np.zeros_like(accx)
        for kk, c in enumerate(coeffs):
            accx = accx + c * win[ys, xs.start + kk - b:xs.stop + kk - b]
            accy = accy + c * win[ys.start + kk - b:ys.stop + kk - b, xs]
        return win[ys, xs] + xcfl * accx + ycfl * accy

    src = u
    for launch in range(iters // k):
        dst = bufs[launch % 2]
        for sx in range(strips):
            col0 = sx * tile_x + b - K
            cols = np.arange(col0, col0 + WX)
            ci = (cols >= 0) & (cols < W)
            for sp in range(splits):
                smem = np.full((nbuf + (k > 1), WY, WX), np.nan, u.dtype)
                staged = [smem[0], smem[nbuf - 1]]
                scratch = smem[nbuf] if k > 1 else None

                def stage(t, win):
                    rows = np.arange(t * tile_y + b - K,
                                     t * tile_y + b - K + WY)
                    ri = (rows >= 0) & (rows < H)
                    win[:] = 0  # cells outside the grid read 0
                    win[np.ix_(ri, ci)] = src[np.ix_(rows[ri], cols[ci])]

                t0, t1 = sp * run, min(sp * run + run, ntiles)
                if nbuf == 2 and t0 < t1:
                    stage(t0, staged[0])
                for t in range(t0, t1):
                    row0 = t * tile_y + b - K
                    win = staged[(t - t0) & 1]
                    if nbuf == 2:
                        if t + 1 < t1:
                            stage(t + 1, staged[(t + 1 - t0) & 1])
                    else:
                        stage(t, win)
                    out = scratch
                    for s in range(1, k):
                        lo = s * b
                        ys, xs = slice(lo, WY - lo), slice(lo, WX - lo)
                        new = update(win, ys, xs)
                        gr = np.arange(row0 + lo, row0 + WY - lo)[:, None]
                        gc = np.arange(col0 + lo, col0 + WX - lo)[None, :]
                        new = np.where(gr < b, bottom, new)
                        new = np.where(gr >= b + ny, top, new)
                        new = np.where(gc < b, left, new)
                        new = np.where(gc >= b + nx, right, new)
                        out[ys, xs] = new  # the rim keeps stale values
                        win, out = out, win
                    h = min(tile_y, ny - t * tile_y)
                    w = min(tile_x, nx - sx * tile_x)
                    r, c = b + t * tile_y, b + sx * tile_x
                    dst[r:r + h, c:c + w] = update(
                        win, slice(K, K + h), slice(K, K + w))
        src = dst
    return src


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("geometry", [
    dict(tile_x=32, run=1, nbuf=2),    # ragged last strip (52 = 32 + 20)
    dict(tile_x=32, run=3, nbuf=2),    # a run of 3 tiles, then 1
    dict(tile_x=64, run=2, nbuf=1),    # one strip, no prefetch
    dict(tile_x=32, run=4, nbuf=1),    # one block a strip
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
        model = _band_model(u0, iters, 8, p.xcfl, p.ycfl, p.bc, 1, 40,
                            halo="copy", **geometry)
        plain = spl.run_heat_pallas_plain(torch.from_numpy(u0), iters, 8,
                                          p.xcfl, p.ycfl)
    else:
        model = _band_model(u0, iters, 8, p.xcfl, p.ycfl, p.bc, k, 40,
                            halo="bc", **geometry)
        plain = spl.run_heat_multistep_plain(torch.from_numpy(u0), iters, 8,
                                             p.xcfl, p.ycfl, p.bc, k=k)
    np.testing.assert_array_equal(model, plain.numpy())


@pytest.mark.parametrize("k", [1, 2, 4])
def test_kernel_decomposition_at_band_geometry(k):
    """The model at the geometry ``band_geometry`` picks for a one-SM card
    (several runs a strip)."""
    p, u0 = _grid(70, 120, 8, seed=10 + k)
    geo = spl.band_geometry(p.ny, p.nx, 24, k, 8, sms=1)
    assert geo.run > 1
    model = _band_model(u0, 2 * k, 8, p.xcfl, p.ycfl, p.bc, k, 24,
                        geo.tile_x, geo.run, geo.nbuf,
                        halo="copy" if k == 1 else "bc")
    plain = spl.run_heat_multistep_plain(torch.from_numpy(u0), 2 * k, 8,
                                         p.xcfl, p.ycfl, p.bc, k=k)
    np.testing.assert_array_equal(model, plain.numpy())


def test_model_catches_a_missing_band():
    """The model is not vacuous: without the re-imposed bands the k-step
    result differs from the plain version."""
    p, u0 = _grid(40, 80, 8, seed=7)
    bad = (9.0, 9.0, 9.0, 9.0)
    model = _band_model(u0, 4, 8, p.xcfl, p.ycfl, bad, 2, 40, 32, 1, 2,
                        halo="bc")
    plain = spl.run_heat_multistep_plain(torch.from_numpy(u0), 4, 8, p.xcfl,
                                         p.ycfl, p.bc, k=2)
    assert not np.array_equal(model, plain.numpy())
