"""Parity of the PyTorch port's heat solve with the JAX package, on the CPU.

The same inputs, made with numpy, go through the JAX function and its
counterpart in the port.  Tolerances:
- bitwise for config, the initial grid, ULP distances and cost models;
- bitwise for the port's ``run_heat`` against the numpy golden
  (``cme213_tpu.verify.golden.host_heat``): both round every product and
  sum on its own;
- ULP-10 (the hw2 checker) against JAX's ``run_heat``: XLA:CPU contracts
  some multiply-adds into FMAs, which the port never does.  Measured gap
  1-4 ULP at ≤ 32 iterations (9 at 128 iterations, order 8), so the
  parity tests stay at ≤ 32 iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu.config import SimParams as JSimParams
from cme213_tpu.core.compare import ulp_distance as j_ulp_distance
from cme213_tpu.core.roofline import heat_cost as j_heat_cost
from cme213_tpu.grid import make_initial_grid as j_make_initial_grid
from cme213_tpu.ops import run_heat as j_run_heat
from cme213_tpu.ops.stencil import flops_per_point as j_flops_per_point
from cme213_tpu.verify import golden as j_golden
from cme213_tpu_torch import convert
from cme213_tpu_torch.apps import heat2d
from cme213_tpu_torch.config import SimParams
from cme213_tpu_torch.core import (FrameworkError, PhaseTimer, check_op,
                                   resolve_device, time_fn)
from cme213_tpu_torch.core.compare import almost_equal_ulps, ulp_distance
from cme213_tpu_torch.core.roofline import (attribute, bound_ms, heat_cost,
                                            peak_for)
from cme213_tpu_torch.grid import make_initial_grid, save_grid_to_file
from cme213_tpu_torch.ops import (LAUNCHES, flops_per_point, heat_step,
                                  run_heat)
from cme213_tpu_torch.verify import check_ulp, golden

BC = (1.5, 0.5, 2.0, 0.25)


def _fields(p) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def _probe(order: int, ny: int = 40, nx: int = 44, seed: int = 0,
           dtype=np.float32):
    """(params, u0): the conformance-probe layout (distinct BCs on all four
    sides) with a seeded random interior."""
    p = SimParams(nx=nx, ny=ny, order=order, iters=1, bc_top=BC[0],
                  bc_left=BC[1], bc_bottom=BC[2], bc_right=BC[3])
    u0 = make_initial_grid(p, dtype=torch.float64, device="cpu").numpy()
    b = p.border_size
    rng = np.random.default_rng(seed)
    u0[b:-b, b:-b] += rng.uniform(0.0, 1.0, (ny, nx))
    return p, u0.astype(dtype)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("order", [2, 4, 8])
def test_simparams_match_reference(order, tmp_path):
    kw = dict(nx=37, ny=29, lx=1.3, ly=0.7, alpha=0.4, iters=12,
              order=order, ic=3.0, bc_top=1.0, bc_left=2.0, bc_bottom=3.0,
              bc_right=4.0)
    ref = JSimParams(**kw)
    assert _fields(SimParams(**kw)) == _fields(ref)
    init = {f.name: getattr(ref, f.name)
            for f in dataclasses.fields(ref) if f.init}
    assert _fields(convert.params_from_reference(init)) == _fields(ref)
    path = tmp_path / "params.in"
    ref.to_file(str(path))
    assert _fields(SimParams.from_file(str(path))) == _fields(
        JSimParams.from_file(str(path)))


def test_simparams_from_example_file():
    path = "examples/params.in"
    ours, ref = SimParams.from_file(path), JSimParams.from_file(path)
    assert _fields(ours) == _fields(ref)
    assert (ours.dt, ours.xcfl, ours.ycfl) == (ref.dt, ref.xcfl, ref.ycfl)


def test_params_from_reference_rejects_unknown_fields():
    with pytest.raises(ValueError, match="xcfl"):
        convert.params_from_reference({"nx": 10, "xcfl": 0.1})


# ---------------------------------------------------------------- grid


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_initial_grid_bitwise(order, dtype):
    kw = dict(nx=23, ny=17, order=order, ic=0.1, bc_top=1.1, bc_left=2.3,
              bc_bottom=0.7, bc_right=4.9)
    ours = make_initial_grid(SimParams(**kw), dtype=getattr(torch, dtype),
                             device="cpu").numpy()
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        ref = np.asarray(j_make_initial_grid(JSimParams(**kw),
                                             dtype=getattr(jnp, dtype)))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert ours.dtype == ref.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(ours, ref)


def test_grid_from_reference_keeps_dtype_and_values():
    for dt in (np.float32, np.float64):
        u = np.random.default_rng(1).standard_normal((7, 9)).astype(dt)
        t = convert.grid_from_reference(u, "cpu")
        assert t.dtype == torch.from_numpy(u).dtype
        np.testing.assert_array_equal(t.numpy(), u)


def test_save_grid_matches_reference_format(tmp_path):
    from cme213_tpu.grid import save_grid_to_file as j_save

    p, u0 = _probe(4, ny=9, nx=11)
    save_grid_to_file(torch.from_numpy(u0), str(tmp_path / "ours.txt"))
    j_save(jnp.asarray(u0), str(tmp_path / "ref.txt"))
    assert (tmp_path / "ours.txt").read_text() == \
        (tmp_path / "ref.txt").read_text()


# ---------------------------------------------------------------- compare


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ulp_distance_matches_reference(dtype):
    rng = np.random.default_rng(7)
    a = rng.standard_normal(4096).astype(dtype)
    b = (a * (1 + rng.standard_normal(4096) * 1e-6)).astype(dtype)
    b[:64] = -b[:64]  # sign crossings
    b[64:80] = a[64:80]
    np.testing.assert_array_equal(ulp_distance(a, b), j_ulp_distance(a, b))
    assert almost_equal_ulps(a[64:80], b[64:80], 0).all()


@pytest.mark.parametrize("name", ["check_exact", "check_ulp",
                                  "check_abs_tol", "l2_distance",
                                  "relative_l2_error", "relative_linf_error"])
def test_checkers_match_reference(name):
    import cme213_tpu.verify.checkers as j_verify

    from cme213_tpu_torch import verify

    rng = np.random.default_rng(11)
    a = rng.standard_normal((6, 5)).astype(np.float32)
    for b in (a.copy(), a + np.float32(1e-6), a + np.float32(0.5)):
        ours = getattr(verify, name)(a, torch.from_numpy(b))
        ref = getattr(j_verify, name)(a, b)
        if name.startswith("check_"):
            assert (ours.ok, ours.message, ours.num_bad) == \
                (ref.ok, ref.message, ref.num_bad)
        else:
            assert ours == ref


# ---------------------------------------------------------------- stencil


def test_flops_and_cost_match_reference():
    for order in (2, 4, 8):
        assert flops_per_point(order) == j_flops_per_point(order)
        assert heat_cost(300, 200, order=order, iters=7, dtype="float32") \
            == heat_cost(300, 200, order=order, iters=7, dtype=torch.float32)
        ref = j_heat_cost(300, 200, order=order, iters=7, dtype="f32")
        ours = heat_cost(300, 200, order=order, iters=7)
        assert (ours.nbytes, ours.flops) == (ref.nbytes, ref.flops)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_run_heat_bitwise_vs_golden(order, dtype):
    p, u0 = _probe(order, seed=order, dtype=dtype)
    ref = j_golden.host_heat(u0, 32, order, p.xcfl, p.ycfl)
    out = run_heat(torch.from_numpy(u0), 32, order, p.xcfl, p.ycfl)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        golden.host_heat(u0, 32, order, p.xcfl, p.ycfl), ref)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("iters", [1, 8, 32])
def test_run_heat_ulp10_vs_jax(order, iters):
    p, u0 = _probe(order, seed=iters)
    ref = np.asarray(j_run_heat(jnp.array(u0), iters, order, p.xcfl, p.ycfl))
    out = run_heat(torch.from_numpy(u0), iters, order, p.xcfl, p.ycfl)
    res = check_ulp(ref, out.numpy(), max_ulps=10, label=f"o{order}")
    assert res, res.message


def test_run_heat_awkward_shape_ulp10_vs_jax():
    p, u0 = _probe(8, ny=257, nx=121, seed=3)
    ref = np.asarray(j_run_heat(jnp.array(u0), 16, 8, p.xcfl, p.ycfl))
    out = run_heat(torch.from_numpy(u0), 16, 8, p.xcfl, p.ycfl)
    res = check_ulp(ref, out.numpy(), max_ulps=10)
    assert res, res.message


@pytest.mark.parametrize("order", [4, 8])
def test_run_heat_f64_ulp10_vs_jax(order):
    """float64, with JAX's x64 mode on for this test only (as
    tests/test_heat_single.py does)."""
    jax.config.update("jax_enable_x64", True)
    try:
        p, u0 = _probe(order, seed=5, dtype=np.float64)
        ref = np.asarray(j_run_heat(jnp.array(u0), 16, order, p.xcfl,
                                    p.ycfl))
        assert ref.dtype == np.float64
    finally:
        jax.config.update("jax_enable_x64", False)
    out = run_heat(torch.from_numpy(u0), 16, order, p.xcfl, p.ycfl)
    assert out.dtype == torch.float64
    res = check_ulp(ref, out.numpy(), max_ulps=10)
    assert res, res.message


def test_heat_step_is_one_iteration_and_leaves_input():
    p, u0 = _probe(4, seed=2)
    u = torch.from_numpy(u0.copy())
    one = heat_step(u, 4, p.xcfl, p.ycfl)
    np.testing.assert_array_equal(u.numpy(), u0)
    np.testing.assert_array_equal(
        one.numpy(), run_heat(u, 1, 4, p.xcfl, p.ycfl).numpy())
    b = p.border_size
    np.testing.assert_array_equal(one.numpy()[:b], u0[:b])


# ---------------------------------------------------------------- driver


def _write_params(path, **kw):
    JSimParams(**kw).to_file(str(path))
    return str(path)


def _dump_values(path) -> np.ndarray:
    rows = [line.split() for line in open(path) if line.strip()]
    return np.array(rows, dtype=np.float64)


def test_run_single_cpu_matches_jax_dumps(tmp_path):
    from cme213_tpu.apps import heat2d as j_heat2d

    kw = dict(nx=100, ny=100, alpha=0.5, iters=50, order=8, ic=1.0,
              bc_top=1.0, bc_left=3.0, bc_bottom=0.5, bc_right=2.0)
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    ours_dir.mkdir()
    ref_dir.mkdir()
    res = heat2d.run_single(SimParams(**kw), check_cpu=True, save_files=True,
                            out_dir=str(ours_dir), device="cpu")
    assert res.ok
    assert [r.split(":")[0] for r in res.reports] == ["torch", "pipeline"]
    names = {"grid_init.txt", "grid_final_cpu.txt",
             "grid_final_gpu_global.txt", "grid_final_gpu_shared.txt"}
    assert {f.name for f in ours_dir.iterdir()} == names
    ref = j_heat2d.run_single(JSimParams(**kw), check_cpu=True,
                              save_files=True, out_dir=str(ref_dir))
    assert ref.ok
    for name in names:
        a = _dump_values(ours_dir / name)
        b = _dump_values(ref_dir / name)
        # dumps print 3 significant digits: agreement within one unit of
        # the %5.3g print precision
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=0)
    np.testing.assert_array_equal(
        _dump_values(ours_dir / "grid_init.txt"),
        _dump_values(ref_dir / "grid_init.txt"))
    assert LAUNCHES == {"pipeline": 0, "pipeline2d": 0, "local": 0}


def test_cli_runs_on_cpu_when_asked(tmp_path, monkeypatch, capsys):
    path = _write_params(tmp_path / "p.in", nx=24, ny=20, iters=6, order=4)
    monkeypatch.chdir(tmp_path)
    assert heat2d.main(["heat2d", path, "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "gpu computation shared took" in out
    assert out.count("GB/s") == 2
    assert (tmp_path / "grid_final_gpu_shared.txt").exists()


def test_cli_module_entry(tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    path = _write_params(tmp_path / "p.in", nx=16, ny=12, iters=4, order=2)
    proc = subprocess.run(
        [sys.executable, "-m", "cme213_tpu_torch", "heat2d", path,
         "--device=cpu"], cwd=tmp_path, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(root)), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "pipeline:" in proc.stdout


def test_cli_supervised_not_ported(tmp_path, monkeypatch, capsys):
    """``--supervised`` (once refused here) runs the supervised solve: its
    epochs commit into ``--ckpt-dir`` and its ``grid_final.txt`` is the
    unsupervised distributed solve's."""
    import json

    path = str(tmp_path / "p.in")
    SimParams(nx=16, ny=12, iters=4, order=2).to_file(path, distributed=True)
    monkeypatch.chdir(tmp_path)
    ckpt = tmp_path / "ckpt"
    assert heat2d.main(["heat2d", path, "--distributed", "--supervised",
                        f"--ckpt-dir={ckpt}", "--ckpt-every=2",
                        "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "supervised solve complete: 4 iters" in out
    assert json.loads((ckpt / "COMMIT").read_text())["step"] == 4
    supervised = (tmp_path / "grid_final.txt").read_text()
    assert heat2d.main(["heat2d", path, "--distributed",
                        "--device=cpu"]) == 0
    assert (tmp_path / "grid_final.txt").read_text() == supervised


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = SimParams(nx=16, ny=12, iters=2, order=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        heat2d.run_single(p)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        make_initial_grid(p)
    with pytest.raises(RuntimeError):
        convert.grid_from_reference(np.zeros((3, 3), np.float32), None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert LAUNCHES == {"pipeline": 0, "pipeline2d": 0, "local": 0}


def test_golden_failure_makes_run_not_ok(monkeypatch, capsys):
    p = SimParams(nx=16, ny=12, iters=3, order=2)
    real = golden.host_heat

    def skewed(*a):
        return real(*a) + np.float32(1.0)

    monkeypatch.setattr(golden, "host_heat", skewed)
    res = heat2d.run_single(p, device="cpu")
    assert not res.ok
    assert "mismatches" in capsys.readouterr().out


# ---------------------------------------------------------------- core


def test_phase_timer_and_time_fn():
    timer = PhaseTimer()
    with timer.phase("a") as ph:
        ph.block(torch.ones(3))
    with timer.phase("a"):
        pass
    assert len(timer.records) == 2
    assert timer.ms("a") == pytest.approx(sum(r.ms for r in timer.records))
    assert timer.last_ms("a") == timer.records[-1].ms
    with pytest.raises(KeyError):
        timer.last_ms("b")
    assert time_fn(torch.add, torch.ones(8), torch.ones(8)) >= 0.0
    t = torch.zeros(2)
    assert check_op("x", t) is t
    assert issubclass(FrameworkError, RuntimeError)


def test_roofline_peaks_and_bound():
    sxm = peak_for("NVIDIA H100 80GB HBM3")
    assert sxm.name == "h100-sxm" and sxm.gbs == 3350.0
    assert peak_for("NVIDIA H100 PCIe").name == "h100-pcie"
    assert peak_for("cpu") is None
    cost = heat_cost(4000, order=8, iters=1)
    ms, by = bound_ms(cost, sxm, torch.float32)
    assert by == "bytes" and ms == pytest.approx(128e6 / 3350e9 * 1e3)
    cost8 = heat_cost(4000, order=8, iters=8)
    ms8, by8 = bound_ms(dataclasses.replace(cost8, nbytes=cost.nbytes), sxm,
                        torch.float32)
    assert by8 == "operations"
    assert ms8 == pytest.approx(38 * 16e6 * 8 / 33.5e12 * 1e3)
    att = attribute(1675.0, 100.0, device="NVIDIA H100 80GB HBM3")
    assert att["pct_peak"] == 50.0 and att["bound"] == "memory"
    assert attribute(10.0, device="cpu")["pct_peak"] is None
