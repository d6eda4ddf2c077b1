"""The port's temporally blocked heat stencil against the JAX package.

On the CPU ``run_heat_pipeline``/``run_heat_pipeline2d`` take their plain
version (``run_heat_pipeline_plain``); the JAX kernels run in Pallas
interpret mode, as the JAX package's own tests run them here.  Tolerance:
ULP-10, the hw2 checker, at ≤ 32 iterations (XLA:CPU contracts some
multiply-adds into FMAs; the measured gap is 1-4 ULP), and bitwise against
the numpy golden, which rounds as the port does.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Its decomposition — strips walked in runs of tiles,
windows staged with quad-aligned column halos, 4 × R micro-tiles that
cover each sub-step's region in whole quads and row chunks and so read
margin, slack and stale cells, bands skipped in blocks that lie inside the
interior, the tile written to a second grid — is modelled in numpy below,
buffers initialised to NaN and kept from tile to tile, and held bitwise
against the plain version.  The same model, with ``band=True``, is
``csrc/heat_band.cu``'s (``tests/test_torch_stencil_pallas.py``), which
shares the tile body.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu.ops.stencil_pipeline import run_heat_pipeline as j_pipeline
from cme213_tpu.ops.stencil_pipeline import \
    run_heat_pipeline2d as j_pipeline2d
from cme213_tpu.verify.golden import host_heat
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import FrameworkError
from cme213_tpu_torch.grid import make_initial_grid
from cme213_tpu_torch.ops import (LAUNCHES, pick_pipeline_tile,
                                  run_heat_pipeline, run_heat_pipeline2d,
                                  run_heat_pipeline_plain,
                                  stencil_local_multistep,
                                  stencil_local_multistep_plain,
                                  stencil_local_multistep_shards,
                                  stencil_local_multistep_shards_plain)
from cme213_tpu_torch.ops import _kernels
from cme213_tpu_torch.ops import stencil_pipeline as sp
from cme213_tpu_torch.ops.stencil import BORDER_FOR_ORDER, STENCIL_COEFFS
from cme213_tpu_torch.verify import check_ulp

BC = (1.5, 0.5, 2.0, 0.25)


def _probe(order: int, ny: int = 40, nx: int = 44, seed: int = 0,
           dtype=np.float32):
    p = SimParams(nx=nx, ny=ny, order=order, iters=1, bc_top=BC[0],
                  bc_left=BC[1], bc_bottom=BC[2], bc_right=BC[3])
    u0 = make_initial_grid(p, dtype=torch.float64, device="cpu").numpy()
    b = p.border_size
    u0[b:-b, b:-b] += np.random.default_rng(seed).uniform(0.0, 1.0, (ny, nx))
    return p, u0.astype(dtype)


def _jax_tile_y(order: int, k: int) -> int:
    kpad = -(-k * BORDER_FOR_ORDER[order] // 8) * 8  # the TPU's ceil8 quantum
    return max(kpad, 16 // kpad * kpad)


@pytest.mark.parametrize("entry", ["pipeline", "pipeline2d"])
@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_pipeline_ulp10_vs_jax_and_bitwise_vs_golden(entry, order, k):
    iters = 4 * k  # ≤ 32
    p, u0 = _probe(order, seed=10 * order + k)
    args = (iters, order, p.xcfl, p.ycfl, p.bc)
    if entry == "pipeline":
        ref = j_pipeline(jnp.array(u0), *args, k=k,
                         tile_y=_jax_tile_y(order, k), interpret=True)
        out = run_heat_pipeline(torch.from_numpy(u0), *args, k=k)
    else:
        ref = j_pipeline2d(jnp.array(u0), *args, k=k,
                           tile_y=_jax_tile_y(order, k), tile_x=128,
                           interpret=True)
        out = run_heat_pipeline2d(torch.from_numpy(u0), *args, k=k)
    res = check_ulp(np.asarray(ref), out.numpy(), max_ulps=10)
    assert res, res.message
    np.testing.assert_array_equal(
        out.numpy(), host_heat(u0, iters, order, p.xcfl, p.ycfl))


@pytest.mark.parametrize("k", [1, 2])
def test_pipeline_awkward_shape_vs_jax(k):
    p, u0 = _probe(8, ny=257, nx=121, seed=k)
    args = (8 * k, 8, p.xcfl, p.ycfl, p.bc)
    ref = j_pipeline(jnp.array(u0), *args, k=k, tile_y=_jax_tile_y(8, k),
                     interpret=True)
    out = run_heat_pipeline(torch.from_numpy(u0), *args, k=k)
    res = check_ulp(np.asarray(ref), out.numpy(), max_ulps=10)
    assert res, res.message
    out2d = run_heat_pipeline2d(torch.from_numpy(u0), *args, k=k)
    np.testing.assert_array_equal(out2d.numpy(), out.numpy())


@pytest.mark.parametrize("order", [2, 8])
def test_pipeline_f64_bitwise_vs_golden(order):
    p, u0 = _probe(order, ny=33, nx=50, seed=4, dtype=np.float64)
    out = run_heat_pipeline(torch.from_numpy(u0), 16, order, p.xcfl, p.ycfl,
                            p.bc, k=4)
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(
        out.numpy(), host_heat(u0, 16, order, p.xcfl, p.ycfl))


def test_pipeline_leaves_input_and_checks_k():
    p, u0 = _probe(4)
    u = torch.from_numpy(u0.copy())
    run_heat_pipeline(u, 4, 4, p.xcfl, p.ycfl, p.bc, k=2)
    np.testing.assert_array_equal(u.numpy(), u0)
    with pytest.raises(ValueError, match="divide"):
        run_heat_pipeline(u, 6, 4, p.xcfl, p.ycfl, p.bc, k=4)
    with pytest.raises(ValueError, match="divide"):
        run_heat_pipeline2d(u, 3, 4, p.xcfl, p.ycfl, p.bc, k=2)
    with pytest.raises(TypeError):
        run_heat_pipeline(u.half(), 4, 4, p.xcfl, p.ycfl, p.bc)
    assert LAUNCHES == {"pipeline": 0, "pipeline2d": 0, "local": 0}


# ------------------------------------------------ tiles and shared memory


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype_bytes", [4, 8])
def test_pick_pipeline_tile_fits_shared_memory(order, k, dtype_bytes):
    d = sp.design(k, dtype_bytes)
    for tile_x in (None, sp.PIPELINE2D_TILE_BYTES // dtype_bytes):
        ty = pick_pipeline_tile(4008, k, order, tile_x=tile_x,
                                dtype_bytes=dtype_bytes)
        assert 1 <= ty <= d.tile_y
        assert sp.smem_bytes(ty, k, order, dtype_bytes) \
            <= sp.SMEM_BUDGET_BYTES
    assert pick_pipeline_tile(20, k, order, dtype_bytes=dtype_bytes) <= 20


def test_tile_sizes_worked_in_the_design_note():
    # k=1 f32: two 72x144 windows of a 64x128 tile, two blocks an SM
    assert sp.smem_bytes(64, 1, 8) == 2 * 72 * 144 * 4 == 82_944
    assert 2 * (82_944 + 1024) <= 233_472
    # k=2 f32: three 64x88 windows of a 48x64 tile (R = 2), three an SM
    assert pick_pipeline_tile(4008, 2, 8) == 48
    assert sp.smem_bytes(48, 2, 8) == 3 * 64 * 88 * 4 == 67_584
    assert 3 * (67_584 + 1024) <= 233_472
    # k=4 f32: three 88x104 windows of a 56x64 tile, two blocks an SM;
    # k=8: three 120x136 windows, one
    assert pick_pipeline_tile(4008, 4, 8) == 56
    assert sp.smem_bytes(56, 4, 8) == 3 * 88 * 104 * 4 == 109_824
    assert 2 * (109_824 + 1024) <= 233_472
    assert pick_pipeline_tile(4008, 8, 8) == 56
    assert sp.smem_bytes(56, 8, 8) == 3 * 120 * 136 * 4 == 195_840
    assert pick_pipeline_tile(4008, 8, 8, dtype_bytes=8) == 28
    # order 2 at R = 8 keeps one micro-tile of slack rows, and rounds the
    # column halo up to a quad
    assert sp.smem_bytes(64, 1, 2) == 2 * (64 + 2 + 8) * (128 + 16) * 4
    assert sp.smem_bytes(32, 2, 4) == 3 * (32 + 8) * (64 + 16) * 4


def test_design_menu_maps_both_widths_to_one_design():
    for elem in (4, 8):
        for k in (1, 2, 3, 8):
            d = sp.design(k, elem)
            assert sp.design(k, elem, sp.PIPELINE_TILE_BYTES // elem) == d
            assert sp.design(k, elem, sp.PIPELINE2D_TILE_BYTES // elem) == d
            assert d == sp.DESIGNS[(elem, min(k, 3))]
            assert d.tile_x % 4 == 0 and d.threads % 32 == 0
    with pytest.raises(ValueError, match="tile_x=1024"):
        sp.design(8, 4, 1024)
    u = torch.zeros(20, 20)
    with pytest.raises(ValueError, match="tile_x=96"):
        run_heat_pipeline2d(u, 2, 2, 0.1, 0.1, BC, k=1, tile_x=96)
    with pytest.raises(ValueError, match="k=0"):
        sp.design(0)


def test_pipeline_geometry_fills_one_wave():
    # the 2x2 pallas path at 2000^2: four 1008^2 blocks, one launch of 8
    # strips x 8 runs of 2 tiles x 4 shards = 256 blocks at 2 an SM (0.97
    # of a wave of 264)
    g = sp.pipeline_geometry(1008, 1008, 4, 1, 8, 64, 4, 132, 2)
    assert (g.tile_x, g.run, g.grid) == (128, 2, (8, 8, 4))
    assert g.smem == 82_944 and g.threads == 256
    # the headline 4008^2 grid: 32 strips x 8 runs of 8 tiles
    g = sp.pipeline_geometry(4008, 4008, 1, 1, 8, 64, 4, 132, 2)
    assert (g.run, g.grid) == (8, (32, 8, 1))
    # a grid smaller than one tile: one block
    g = sp.pipeline_geometry(10, 10, 1, 2, 8, 32, 4, 132, 4)
    assert (g.run, g.grid) == (1, (1, 1, 1))
    # nine shards of a 3x3 mesh in one launch
    g = sp.pipeline_geometry(677, 677, 9, 1, 8, 64, 4, 132, 2)
    assert g.grid[2] == 9 and g.grid[0] * g.grid[1] * 9 <= 132 * 2 * 2
    with pytest.raises(ValueError, match="shared memory"):
        sp.pipeline_geometry(4008, 4008, 1, 16, 8, 8, 4, 132, 1)


def test_kernel_wrapper_refuses_bad_arguments():
    u = torch.zeros(16, 16)
    kw = dict(order=2, k=1, tile_y=8, tile_x=128, run=1,
              smem_bytes=sp.smem_bytes(8, 1, 2), ny=14, nx=14, xcfl=0.1,
              ycfl=0.1, bc=BC)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.heat_ksteps([(u, torch.zeros(16, 16), 0, 0)], **kw)
    with pytest.raises(ValueError, match="in place"):
        _kernels.heat_ksteps([(u, u, 0, 0)], **kw)
    with pytest.raises(ValueError, match="in place"):
        v = torch.zeros(16, 16)
        _kernels.heat_ksteps([(u, v, 0, 0), (v, torch.zeros(16, 16), 0, 0)],
                             **kw)
    with pytest.raises(ValueError, match="one shape"):
        _kernels.heat_ksteps([(u, torch.zeros(16, 16), 0, 0),
                              (torch.zeros(16, 17), torch.zeros(16, 17), 0,
                               0)], **kw)
    with pytest.raises(TypeError, match="one dtype"):
        _kernels.heat_ksteps([(u, torch.zeros(16, 16, dtype=torch.float64),
                               0, 0)], **kw)
    with pytest.raises(ValueError, match="1 to 32 shards"):
        _kernels.heat_ksteps([(u, torch.zeros(16, 16), 0, 0)] * 33, **kw)


def _loop_case(case):
    """(src, bufs, launches, error type, message) of one refusal of
    ``heat_ksteps_loop``."""
    u = torch.zeros(16, 16)
    v, w = torch.zeros(16, 16), torch.zeros(16, 16)
    return {
        "buffer-is-src": (u, (u, w), 2, ValueError, "in place"),
        "buffer-views-src": (u, (v, u[:]), 2, ValueError, "in place"),
        "buffers-share": (u, (v, v), 2, ValueError, "in place"),
        "buffers-share-views": (u, (v, v.view(16, 16)), 2, ValueError,
                                "in place"),
        "mixed-shape": (u, (torch.zeros(16, 17), w), 2, ValueError,
                        "one shape"),
        "mixed-dtype": (u, (v, torch.zeros(16, 16, dtype=torch.float64)), 2,
                        TypeError, "one dtype"),
        "non-contiguous": (u, (torch.zeros(16, 16).t(), w), 2, ValueError,
                           "contiguous"),
        "not-2d": (torch.zeros(256), (torch.zeros(256), torch.zeros(256)),
                   2, ValueError, "2-D"),
        "int-grid": (u.int(), (v.int(), w.int()), 2, TypeError,
                     "float32 or float64"),
        "one-buffer": (u, (v,), 2, ValueError, "two buffers"),
        "no-launches": (u, (v, w), 0, ValueError, "at least one launch"),
        "negative-launches": (u, (v, w), -1, ValueError,
                              "at least one launch"),
        "cpu-grids": (u, (v, w), 2, ValueError, "CUDA"),
    }[case]


@pytest.mark.parametrize("case", ["buffer-is-src", "buffer-views-src",
                                  "buffers-share", "buffers-share-views",
                                  "mixed-shape", "mixed-dtype",
                                  "non-contiguous", "not-2d", "int-grid",
                                  "one-buffer", "no-launches",
                                  "negative-launches", "cpu-grids"])
def test_loop_wrapper_refuses_bad_arguments(monkeypatch, case):
    """``heat_ksteps_loop`` checks a solve's grids once, before it loads
    the library, so every refusal is reached without a card."""
    def no_library(name):
        raise AssertionError(f"loaded {name} before the checks")

    monkeypatch.setattr(_kernels, "library", no_library)
    src, bufs, launches, exc, match = _loop_case(case)
    kw = dict(order=2, k=1, tile_y=8, tile_x=128, run=1,
              smem_bytes=sp.smem_bytes(8, 1, 2), ny=14, nx=14, xcfl=0.1,
              ycfl=0.1, bc=BC)
    with pytest.raises(exc, match=match):
        _kernels.heat_ksteps_loop(src, bufs, launches, **kw)


@pytest.mark.parametrize("entry", ["pipeline", "pipeline2d"])
def test_cpu_grid_takes_the_plain_version_and_no_loop(entry):
    p, u0 = _probe(8)
    u = torch.from_numpy(u0)
    run = run_heat_pipeline if entry == "pipeline" else run_heat_pipeline2d
    launches, loops = dict(sp.LAUNCHES), dict(sp.LAUNCH_LOOPS)
    out = run(u, 6, 8, p.xcfl, p.ycfl, p.bc, k=2)
    assert sp.LAUNCHES == launches and sp.LAUNCH_LOOPS == loops
    torch.testing.assert_close(
        out, run_heat_pipeline_plain(u, 6, 8, p.xcfl, p.ycfl, p.bc, k=2),
        rtol=0, atol=0)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")
    with pytest.raises(FrameworkError, match="nvcc failed"):
        _kernels.build()
    lib = _kernels.library_path("heat_stencil")
    assert (tmp_path / lib.with_suffix(".log").name).exists()
    assert not lib.exists()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path))
    # every candidate root, /usr/local/cuda included, holds no nvcc
    monkeypatch.setattr(_kernels, "Path", lambda root: tmp_path / "none")
    with pytest.raises(FrameworkError, match="nvcc not found"):
        _kernels._nvcc()


def test_library_path_keys_on_source_and_flags(monkeypatch):
    a = _kernels.library_path("heat_stencil")
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-g",))
    assert _kernels.library_path("heat_stencil") != a
    assert a.parent == _kernels.BUILD_DIR


def test_library_path_keys_on_headers(monkeypatch, tmp_path):
    for name in _kernels.SOURCES:
        (tmp_path / f"{name}.cu").write_bytes(
            _kernels.SOURCES[name].read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    monkeypatch.setattr(_kernels, "SOURCES", {
        name: tmp_path / f"{name}.cu" for name in _kernels.SOURCES})
    before = {name: _kernels.library_path(name) for name in _kernels.SOURCES}
    (tmp_path / "tile.cuh").write_text("// a shared tile body\n")
    after = {name: _kernels.library_path(name) for name in _kernels.SOURCES}
    assert all(after[n] != before[n] for n in before)  # every tag moves
    (tmp_path / "tile.cuh").write_text("// another tile body\n")
    assert _kernels.library_path("heat_stencil") != after["heat_stencil"]


# ------------------------------------------------ the kernel's decomposition


def _kernel_model(u: np.ndarray, order: int, xcfl, ycfl, bc, k: int,
                  tile_y: int, tile_x: int, rows: int, run: int,
                  gy0: int = 0, gx0: int = 0, ny: int | None = None,
                  nx: int | None = None, band: bool = False, nbuf: int = 2,
                  out: np.ndarray | None = None) -> np.ndarray:
    """numpy model of one launch of the register-blocked tile body on one
    grid: ``csrc/heat_stencil.cu`` (every shard of a launch is decomposed
    alike) or, with ``band``, ``csrc/heat_band.cu``.  ``(tile_x, rows)``:
    the strip width and micro-tile height of the k class's design; ``run``:
    the tiles a block walks.  ``(gy0, gx0)``: global halo-grid coordinates
    of ``u[0, 0]``; ``(ny, nx)``: the global interior extents (default:
    ``u`` is the whole grid).

    ``heat_stencil.cu``: tiles of ``tile_y`` grid rows from row 0, windows
    with a 4-column margin on each side, the bands after every sub-step
    (band code skipped where a block's whole run lies inside the
    interior), every cell of a new grid written (cells the launch does not
    write are NaN).  ``heat_band.cu``: tiles of ``tile_y`` interior rows
    from row ``border``, ``nbuf`` staging windows with no margin (a
    region's outermost side loads wrap into the neighbouring row), the
    bands after every sub-step but the last (skipped tile by tile), only
    the interior written, into ``out`` (default: a NaN grid)."""
    f = u.dtype.type
    b = BORDER_FOR_ORDER[order]
    K = k * b
    KA = -(-K // 4) * 4
    H, W = u.shape
    ny = H - 2 * b if ny is None else ny
    nx = W - 2 * b if nx is None else nx
    coeffs = [f(c) for c in STENCIL_COEFFS[order]]
    top, left, bottom, right = (f(v) for v in bc)
    xcfl, ycfl = f(xcfl), f(ycfl)
    typ = -(-tile_y // rows) * rows
    WY = typ + 2 * K
    slack = 0 if (2 * b) % rows == 0 else rows
    WS = tile_x + 2 * KA
    margin = 0 if band else 4
    WB = WS + 2 * margin
    row0 = b if band else 0           # grid row of tile 0's first row
    tiles = -(-(ny if band else H) // tile_y)
    cols_end = b + nx if band else W  # strips cover grid columns [0, end)

    def substep(buf, r0, c0, nr, nc):
        # the cells [r0, r0+nr) x [c0, c0+nc) of a window; the kernel loads
        # whole quads, columns c0-4 .. c0+nc+3 (in the flat buffer: the
        # outermost ones may wrap into the neighbouring rows), and rows
        # r0-b .. r0+nr+b-1
        flat = buf.reshape(-1)
        assert r0 - b >= 0 and r0 + nr + b <= buf.shape[0]
        assert c0 % 4 == 0 and nc % 4 == 0 and nr % rows == 0
        assert c0 >= 0 and c0 + nc <= WB
        assert r0 * WB + c0 - 4 >= 0
        assert (r0 + nr - 1) * WB + c0 + nc + 4 <= flat.size
        at = (np.arange(r0, r0 + nr)[:, None] * WB
              + np.arange(c0, c0 + nc)[None, :])
        accx = np.zeros((nr, nc), u.dtype)
        accy = np.zeros_like(accx)
        for kk, c in enumerate(coeffs):
            accx = accx + c * flat[at + kk - b]
            accy = accy + c * flat[at + (kk - b) * WB]
        return flat[at] + xcfl * accx + ycfl * accy

    def bands(new, grow, gcol):
        gr = grow + np.arange(new.shape[0])[:, None]
        gc = gcol + np.arange(new.shape[1])[None, :]
        new = np.where(gr < b, bottom, new)
        new = np.where(gr >= b + ny, top, new)
        new = np.where(gc < b, left, new)
        return np.where(gc >= b + nx, right, new)

    dst = np.full_like(u, np.nan) if out is None else out
    for tc in range(0, cols_end, tile_x):
        for t0 in range(0, tiles, run):
            t1 = min(t0 + run, tiles)
            # uninitialised shared memory, kept from tile to tile
            bufs = [np.full((WY + slack, WB), np.nan, u.dtype)
                    for _ in range(3)]
            gcol0 = tc - KA - margin + gx0

            def inside(ta, tb):  # tiles ta .. tb hold no band cell
                return (row0 + ta * tile_y - K + gy0 >= b
                        and row0 + tb * tile_y - K + WY + slack + gy0
                        <= b + ny
                        and gcol0 >= b and gcol0 + WB <= b + nx)

            for t in range(t0, t1):
                # heat_stencil.cu tests a block's run, heat_band.cu a tile
                edge = not (inside(t, t) if band else inside(t0, t1 - 1))
                cur = bufs[(t - t0) & 1 if nbuf == 2 else 0]
                rws = np.arange(row0 + t * tile_y - K,
                                row0 + t * tile_y - K + WY)
                cls = np.arange(tc - KA, tc - KA + WS)
                ri = (rws >= 0) & (rws < H)
                ci = (cls >= 0) & (cls < W)
                win = np.zeros((WY, WS), u.dtype)  # 0 outside the grid
                win[np.ix_(ri, ci)] = u[np.ix_(rws[ri], cls[ci])]
                cur[:WY, margin:margin + WS] = win
                grow0 = row0 + t * tile_y - K + gy0
                src, nxt = cur, bufs[2]
                for s in range(1, k):
                    E = -(-((k - s) * b) // 4) * 4
                    nr = -(-(typ + 2 * (k - s) * b) // rows) * rows
                    r0, c0 = s * b, margin + KA - E
                    new = substep(src, r0, c0, nr, tile_x + 2 * E)
                    if edge:
                        new = bands(new, grow0 + r0, gcol0 + c0)
                    nxt[r0:r0 + nr, c0:c0 + tile_x + 2 * E] = new
                    src, nxt = nxt, src
                new = substep(src, K, margin + KA, typ, tile_x)
                if band:  # the tile's interior cells, no band
                    h = min(tile_y, ny - t * tile_y)
                    lo, hi = max(tc, b), min(tc + tile_x, b + nx)
                    r = b + t * tile_y
                    dst[r:r + h, lo:hi] = new[:h, lo - tc:hi - tc]
                    continue
                if edge:
                    new = bands(new, grow0 + K, gcol0 + 4 + KA)
                h, w = min(tile_y, H - t * tile_y), min(tile_x, W - tc)
                dst[t * tile_y:t * tile_y + h, tc:tc + w] = new[:h, :w]
    return dst


def _model_iters(u, iters, order, xcfl, ycfl, bc, k, tile_y, tile_x, rows,
                 run):
    for _ in range(iters // k):
        u = _kernel_model(u, order, xcfl, ycfl, bc, k, tile_y, tile_x, rows,
                          run)
    return u


@pytest.mark.parametrize("order,k,tile_y,tile_x,rows,run",
                         [(2, 1, 8, 16, 8, 1), (4, 2, 5, 8, 4, 2),
                          (8, 2, 16, 8, 8, 3), (8, 4, 8, 32, 8, 1),
                          (2, 8, 3, 12, 2, 4), (4, 3, 7, 12, 8, 2),
                          (2, 3, 9, 20, 4, 3)])
def test_kernel_decomposition_bitwise_vs_plain(order, k, tile_y, tile_x,
                                               rows, run):
    # 29 x 37 interiors: no tile size divides the grid, and W (39, 41, 45)
    # is not a multiple of 4
    p, u0 = _probe(order, ny=29, nx=37, seed=order + k)
    iters = 2 * k
    model = _model_iters(u0, iters, order, p.xcfl, p.ycfl, p.bc, k, tile_y,
                         tile_x, rows, run)
    plain = run_heat_pipeline_plain(torch.from_numpy(u0), iters, order,
                                    p.xcfl, p.ycfl, p.bc, k=k)
    np.testing.assert_array_equal(model, plain.numpy())


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_model_at_the_compiled_designs(order, k, dtype):
    # the designs the kernel is built with, at their default tiles and the
    # runs pipeline_geometry gives a small card (2 SMs): a 70 x 150
    # interior spans several strips and runs, and one tile of 4 x 9
    p, u0 = _probe(order, ny=70, nx=150, seed=5 * order + k, dtype=dtype)
    elem = np.dtype(dtype).itemsize
    d = sp.design(k, elem)
    for u in (u0, u0[:4 + 2 * p.border_size, :9 + 2 * p.border_size]):
        ty = pick_pipeline_tile(u.shape[0], k, order, dtype_bytes=elem)
        geo = sp.pipeline_geometry(*u.shape, 1, k, order, ty, elem, 2, 1)
        model = _kernel_model(np.ascontiguousarray(u), order, p.xcfl, p.ycfl,
                              p.bc, k, ty, d.tile_x, d.rows, geo.run)
        plain = run_heat_pipeline_plain(torch.from_numpy(
            np.ascontiguousarray(u)), k, order, p.xcfl, p.ycfl, p.bc, k=k)
        np.testing.assert_array_equal(model, plain.numpy())


# ------------------------------------------------ the shard kernel (B3)


def _padded_window(g: np.ndarray, p, K: int, y0: int, x0: int, h: int,
                   w: int) -> np.ndarray:
    """Rows [y0, y0 + h) and columns [x0, x0 + w) of the interior ``g``
    with K halo on every side, padded y first, then x, with the BC fills
    (what ``dist/heat._assemble_padded`` gives a shard)."""
    g = np.pad(g, ((K, 0), (0, 0)), constant_values=p.bc_bottom)
    g = np.pad(g, ((0, K), (0, 0)), constant_values=p.bc_top)
    g = np.pad(g, ((0, 0), (K, 0)), constant_values=p.bc_left)
    g = np.pad(g, ((0, 0), (0, K)), constant_values=p.bc_right)
    return g[y0:y0 + h + 2 * K, x0:x0 + w + 2 * K]


def _ghost_padded(u: np.ndarray, p, ny_pad: int, nx_pad: int) -> np.ndarray:
    """The interior of halo grid ``u`` ghost-padded to (ny_pad, nx_pad)
    with the top/right BC values (``dist/heat._pad_interior_for_mesh``)."""
    b = p.border_size
    g = np.full((ny_pad, nx_pad), p.bc_top, u.dtype)
    g[:, p.nx:] = p.bc_right
    g[:p.ny, :p.nx] = u[b:-b, b:-b]
    return g


#: (yi, xi) of a shard of a 3x3 mesh over a 62x74 interior (21x25 shards;
#: the last row and column of shards hold one ghost row / column)
SHARDS = {"corner": (0, 0), "edge": (0, 1), "interior": (1, 1),
          "ghost": (2, 2)}


@pytest.mark.parametrize("where", list(SHARDS))
@pytest.mark.parametrize("order,k,tile_y,tile_x",
                         [(2, 1, 8, 16), (4, 2, 5, 8), (8, 2, 16, 8),
                          (8, 4, 8, 32), (2, 4, 3, 12)])
def test_shard_plain_bitwise_vs_kernel_model_and_run_heat(where, order, k,
                                                          tile_y, tile_x):
    p, u0 = _probe(order, ny=62, nx=74, seed=3 * order + k)
    b = p.border_size
    K = k * b
    yi, xi = SHARDS[where]
    h, w = 21, 25
    g = _ghost_padded(u0, p, 3 * h, 3 * w)
    blk = _padded_window(g, p, K, yi * h, xi * w, h, w)
    gy0, gx0 = yi * h + b - K, xi * w + b - K
    args = (p.ny, p.nx, order, p.xcfl, p.ycfl, p.bc)
    plain = stencil_local_multistep_plain(torch.from_numpy(blk), gy0, gx0,
                                          *args, k=k).numpy()
    model = _kernel_model(blk, order, p.xcfl, p.ycfl, p.bc, k, tile_y,
                          tile_x, 4, 2, gy0=gy0, gx0=gx0, ny=p.ny, nx=p.nx)
    valid = (slice(K, K + h), slice(K, K + w))
    np.testing.assert_array_equal(model[valid], plain[valid])
    # the whole grid k steps on, cut to the shard: the same cells
    whole = host_heat(u0, k, order, p.xcfl, p.ycfl)
    np.testing.assert_array_equal(
        plain[valid], _ghost_padded(whole, p, 3 * h, 3 * w)[
            yi * h:(yi + 1) * h, xi * w:(xi + 1) * w])
    # on the CPU the wrapper is the plain version and launches nothing
    out = stencil_local_multistep(torch.from_numpy(blk), gy0, gx0, *args,
                                  k=k)
    np.testing.assert_array_equal(out.numpy(), plain)
    assert LAUNCHES["local"] == 0


def test_shard_wrapper_refuses_bad_arguments():
    p = torch.zeros(16, 16)
    args = (0, 0, 14, 14, 2, 0.1, 0.1, BC)
    with pytest.raises(TypeError):
        stencil_local_multistep(p.half(), *args)
    with pytest.raises(TypeError):
        stencil_local_multistep(p[0], *args)
    with pytest.raises(ValueError, match="no kernel"):
        stencil_local_multistep(p.to("meta"), *args)


def _mesh_shards(p, K, h, w, mesh=3):
    """Every K-padded shard block of a ``mesh`` x ``mesh`` decomposition of
    ``p``'s probe into h x w shards, with its offsets (gy0, gx0)."""
    b = p.border_size
    _, u0 = _probe(p.order, ny=p.ny, nx=p.nx, seed=7)
    g = _ghost_padded(u0, p, mesh * h, mesh * w)
    blocks, offsets = [], []
    for yi in range(mesh):
        for xi in range(mesh):
            blocks.append(torch.from_numpy(np.ascontiguousarray(
                _padded_window(g, p, K, yi * h, xi * w, h, w))))
            offsets.append((yi * h + b - K, xi * w + b - K))
    return u0, blocks, offsets


@pytest.mark.parametrize("order,k", [(2, 1), (4, 2), (8, 1), (8, 3)])
def test_shards_wrapper_equals_per_shard_plain(order, k):
    p, _ = _probe(order, ny=62, nx=74)
    K = k * p.border_size
    u0, blocks, offsets = _mesh_shards(p, K, 21, 25)
    args = (p.ny, p.nx, order, p.xcfl, p.ycfl, p.bc)
    out = stencil_local_multistep_shards(blocks, offsets, *args, k=k)
    ref = stencil_local_multistep_shards_plain(blocks, offsets, *args, k=k)
    assert len(out) == len(ref) == 9
    whole = _ghost_padded(host_heat(u0, k, order, p.xcfl, p.ycfl), p, 63, 75)
    for (gy0, gx0), got, want in zip(offsets, out, ref):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        y0, x0 = gy0 + K - p.border_size, gx0 + K - p.border_size
        np.testing.assert_array_equal(got[K:-K, K:-K].numpy(),
                                      whole[y0:y0 + 21, x0:x0 + 25])
    # the table of one is the single-shard entry point
    one = stencil_local_multistep(blocks[4], *offsets[4], *args, k=k)
    np.testing.assert_array_equal(one.numpy(), ref[4].numpy())
    assert LAUNCHES["local"] == 0  # CPU shards take the plain version


def test_shards_wrapper_refuses_mixed_shards():
    a = torch.zeros(16, 16)
    args = (14, 14, 2, 0.1, 0.1, BC)
    with pytest.raises(ValueError, match="mixed shapes"):
        stencil_local_multistep_shards([a, torch.zeros(16, 17)],
                                       [(0, 0), (0, 14)], *args)
    with pytest.raises(TypeError, match="mixed dtypes"):
        stencil_local_multistep_shards([a, a.double()], [(0, 0), (0, 14)],
                                       *args)
    with pytest.raises(ValueError, match="offsets"):
        stencil_local_multistep_shards([a, a], [(0, 0)], *args)
    with pytest.raises(ValueError, match="offsets"):
        stencil_local_multistep_shards([], [], *args)
    with pytest.raises(ValueError, match="destinations"):
        stencil_local_multistep_shards([a, a], [(0, 0), (0, 14)], *args,
                                       out=[a])
    for bad in (torch.zeros(16, 17), a.double(), torch.zeros(16, 32)[:, ::2]):
        with pytest.raises(ValueError, match="destination 0"):
            stencil_local_multistep_shards([a], [(0, 0)], *args, out=[bad])


@pytest.mark.parametrize("order,k", [(4, 2), (8, 1)])
def test_shards_wrapper_writes_given_destinations(order, k):
    """With ``out`` the k steps of each shard land in its destination,
    which is returned, equal to the wrapper's own blocks bit for bit."""
    p, _ = _probe(order, ny=62, nx=74)
    K = k * p.border_size
    _, blocks, offsets = _mesh_shards(p, K, 21, 25)
    args = (p.ny, p.nx, order, p.xcfl, p.ycfl, p.bc)
    dst = [torch.full_like(b, float("nan")) for b in blocks]
    out = stencil_local_multistep_shards(blocks, offsets, *args, k=k,
                                         out=dst)
    ref = stencil_local_multistep_shards(blocks, offsets, *args, k=k)
    for got, d, want in zip(out, dst, ref):
        assert got is d
        np.testing.assert_array_equal(got.numpy(), want.numpy())
