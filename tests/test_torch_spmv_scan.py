"""Parity of the port's SpMV-scan engine (hw_final) with the JAX package, on
the CPU.

The same problems, made with numpy from a seed, go through the JAX package's
engine and the port's.  Tolerances: array for array equality for problem
generation, the matrix reader and the file formats; bitwise for the
``flat`` engine; rel L2 ≤ 1e-5 for the other kernels (the conformance
tolerance of ``apps/spmv_scan.py``: they associate the sums differently).
The JAX Pallas kernels run in interpret mode, as their own tests run them.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cme213_tpu.apps import matrix_market as j_mm
from cme213_tpu.apps import spmv_scan as j_spmv
from cme213_tpu.core import errors as j_errors
from cme213_tpu.core import roofline as j_roofline
from cme213_tpu_torch import convert, models
from cme213_tpu_torch.apps import matrix_market as mm
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.core import DataValidationError, data_error, roofline
from cme213_tpu_torch.ops import segmented_pallas as segp
from cme213_tpu_torch.verify.checkers import relative_l2_error

ROOT = Path(__file__).resolve().parent.parent
GR_30_30 = str(ROOT / "examples" / "gr_30_30.mtx")


def _same_problem(a, b) -> None:
    for name in ("a", "s", "k", "x"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.iters == b.iters


# ---------------------------------------------------------------- problems


@pytest.mark.parametrize("n,p,q,iters,seed", [
    (2048, 48, 47, 3, 1234), (3000, 80, 64, 5, 21), (100_000, 1_000, 999,
                                                     None, 0),
    (50, 3, 2, None, 7)])
def test_generate_problem_matches_reference(n, p, q, iters, seed):
    _same_problem(spmv.generate_problem(n, p, q, iters, seed=seed),
                  j_spmv.generate_problem(n, p, q, iters, seed=seed))


@pytest.mark.parametrize("name,scale", [("pwtk", 0.002), ("jonheart", 0.05),
                                        ("dense2", 0.001),
                                        ("webbase-1M", 0.0001)])
def test_suite_problem_matches_reference(name, scale):
    assert spmv.BELL_GARLAND_SUITE == j_spmv.BELL_GARLAND_SUITE
    _same_problem(spmv.suite_problem(name, seed=3, scale=scale),
                  j_spmv.suite_problem(name, seed=3, scale=scale))


def test_dense2_problem_matches_reference():
    ours = mm.dense2_problem(iters=10, seed=0)
    _same_problem(ours, j_mm.dense2_problem(iters=10, seed=0))
    assert (ours.n, ours.p, ours.iters) == (4_000_000, 2001, 10)


def test_real_instance_specs_match_reference():
    ours = mm.real_instance_specs()
    ref = j_mm.real_instance_specs()
    assert [(n, label) for n, label, _ in ours] == \
        [(n, label) for n, label, _ in ref]
    _same_problem(ours[0][2](), ref[0][2]())  # gr_30_30, N = 50


def test_problem_from_mtx_matches_reference():
    _same_problem(mm.problem_from_mtx(GR_30_30, seed=4),
                  j_mm.problem_from_mtx(GR_30_30, seed=4))
    _same_problem(mm.problem_from_mtx(GR_30_30, iters=9, seed=1),
                  j_mm.problem_from_mtx(GR_30_30, iters=9, seed=1))


def test_reconstructed_gr_30_30_matches_reference(tmp_path):
    ours, ref = tmp_path / "ours.mtx", tmp_path / "ref.mtx"
    ours.write_text(mm.gr_30_30_mtx())
    ref.write_text(j_mm.gr_30_30_mtx())
    for x, y in zip(mm.csr_from_mtx(str(ours)), j_mm.csr_from_mtx(str(ref))):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("text", [
    "not a matrix\n1 1 1\n1 1 1.0\n",
    "%%MatrixMarket matrix array real general\n1 1\n1.0\n",
    "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 nan\n",
    "%%MatrixMarket matrix coordinate real symmetric\n2 2 1\n1 2 1.0\n",
    "%%MatrixMarket matrix coordinate real general\nx y z\n",
], ids=["banner", "format", "field", "entry-count", "index-bounds",
        "value-finiteness", "symmetry", "size-line"])
def test_reader_rejects_like_reference(tmp_path, text):
    path = tmp_path / "bad.mtx"
    path.write_text(text)
    with pytest.raises(DataValidationError) as ours:
        mm.read_matrix_market(str(path))
    with pytest.raises(j_errors.DataValidationError) as ref:
        j_mm.read_matrix_market(str(path))
    assert str(ours.value) == str(ref.value)
    assert ours.value.record["invariant"] == ref.value.record["invariant"]


def test_data_error_carries_its_record():
    """The record is the emitted ``data-validation`` trace event: its
    fields, plus the process tags every trace record carries."""
    err = data_error("f.mtx", "banner", "x" * 400)
    ref = j_errors.data_error("f.mtx", "banner", "x" * 400)
    assert isinstance(err, DataValidationError)
    tags = ("t", "pid", "rank", "incarnation", "trace")
    assert {k: v for k, v in err.record.items() if k not in tags} == \
        {"event": "data-validation", "source": "f.mtx",
         "invariant": "banner", "detail": "x" * 300}
    assert sorted(err.record) == sorted(ref.record)
    assert str(err) == str(ref)


def test_problem_files_cross_both_ways(tmp_path):
    prob = j_spmv.generate_problem(3000, 80, 64, iters=5, seed=21)
    a, x = str(tmp_path / "a.txt"), str(tmp_path / "x.txt")
    j_spmv.save_problem(prob, a, x)
    _same_problem(spmv.load_problem(a, x), prob)
    spmv.save_problem(spmv.load_problem(a, x), a + "2", x + "2")
    assert Path(a + "2").read_text() == Path(a).read_text()
    assert Path(x + "2").read_text() == Path(x).read_text()
    _same_problem(j_spmv.load_problem(a + "2", x + "2", use_native=False),
                  prob)


def test_problem_validation_and_padding_match_reference():
    prob = j_spmv.generate_problem(300, 9, 7, iters=2, seed=5)
    ours = convert.problem_from_reference(prob.a, prob.s, prob.k, prob.x,
                                          prob.iters)
    _same_problem(ours, prob)
    assert np.array_equal(ours.xx, prob.xx)
    _same_problem(spmv.pad_problem(ours, 512), j_spmv.pad_problem(prob, 512))
    with pytest.raises(ValueError, match="pad"):
        spmv.pad_problem(ours, 100)
    bad = spmv.Problem(ours.a, ours.s, ours.k.copy(), ours.x, 2)
    bad.k[0] = ours.q
    with pytest.raises(ValueError, match="gather index"):
        bad.validate()
    with pytest.raises(ValueError, match="sentinel"):
        convert.problem_from_reference(prob.a, prob.s[:-1], prob.k, prob.x, 2)


def test_costs_match_reference():
    for n, iters in ((1000, 3), (11_634_424, 25)):
        for dt, jdt in ((torch.float32, "f32"), (torch.float64, "f64"),
                        ("f32", "f32")):
            ours = roofline.spmv_scan_cost(n, iters, dtype=dt)
            ref = j_roofline.spmv_scan_cost(n, iters, dtype=jdt)
            assert (ours.nbytes, ours.flops) == (ref.nbytes, ref.flops)
            assert roofline.scan_cost(n, dtype=dt).nbytes == \
                j_roofline.scan_cost(n, dtype=jdt).nbytes
        assert spmv.bytes_moved(n, iters) == j_spmv.bytes_moved(n, iters)
    assert roofline.spmv_scan_cost(100, 1).nbytes == 16 * 100
    assert roofline.segmented_scan_cost(100).nbytes == 12 * 100


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def engine_problem():
    return j_spmv.generate_problem(3000, 80, 64, iters=5, seed=21)


@pytest.mark.parametrize("kernel", spmv.KERNELS)
def test_run_spmv_scan_cpu_matches_reference(engine_problem, kernel, capsys):
    prob = engine_problem
    ref = j_spmv.run_spmv_scan(prob, kernel=kernel, fallback=False)
    ours = convert.problem_from_reference(prob.a, prob.s, prob.k, prob.x,
                                          prob.iters)
    before = dict(segp.LAUNCHES)
    got = spmv.run_spmv_scan(ours, kernel=kernel, device="cpu")
    assert segp.LAUNCHES == before  # the CPU runs the plain versions
    assert got.dtype == np.float32 and got.shape == (prob.n,)
    if kernel == "flat":
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    else:
        assert relative_l2_error(ref, got) <= 1e-5
    errs = spmv.external_check(ours, got)
    ref_errs = j_spmv.external_check(prob, got)
    assert errs == ref_errs and errs["rel_l2"] <= 1e-5
    assert "The running time of my code for 5 iterations is:" in \
        capsys.readouterr().out


def test_run_spmv_scan_large_n_takes_blocked(capsys):
    prob = spmv.generate_problem(70_000, 500, 300, iters=2, seed=1)
    auto = spmv.run_spmv_scan(prob, kernel="auto", device="cpu")
    blocked = spmv.run_spmv_scan(prob, kernel="blocked", device="cpu")
    assert np.array_equal(auto, blocked)


def test_run_spmv_scan_refuses_unknown_kernel():
    prob = spmv.generate_problem(100, 5, 4, iters=1)
    with pytest.raises(ValueError, match="unknown kernel"):
        spmv.run_spmv_scan(prob, kernel="cusparse", device="cpu")


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = spmv.generate_problem(100, 5, 4, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spmv.run_spmv_scan(prob, kernel="pallas-fused")
    with pytest.raises(RuntimeError):
        spmv.run_spmv_scan(prob, kernel="auto", device="cuda")


# --------------------------------------------------------------------- CLI


def _b(path: Path) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float32)


@pytest.mark.parametrize("kernel", ["pallas-fused", "pallas", "auto"])
def test_cli_gen_run_cpu_check(tmp_path, monkeypatch, capsys, kernel):
    monkeypatch.chdir(tmp_path)
    assert spmv.main(["spmv_scan", "gen", "a.txt", "x.txt", "3000", "80",
                      "64", "5", "--seed=21"]) == 0
    assert spmv.main(["spmv_scan", "a.txt", "x.txt", "cpu_check",
                      f"--kernel={kernel}", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "Worked!" in out and "iterations is:" in out
    prob = spmv.load_problem("a.txt", "x.txt")
    expect = spmv.run_spmv_scan(prob, kernel=kernel, device="cpu")
    assert np.array_equal(_b(tmp_path / "b.txt"), expect)
    assert _b(tmp_path / "b_cpu.txt").shape == (3000,)


def test_cli_gen_default_writes_the_reference_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert spmv.main(["spmv_scan", "gen", "a.txt", "x.txt"]) == 0
    assert j_spmv.main(["spmv_scan", "gen", "ra.txt", "rx.txt"]) == 0
    assert Path("a.txt").read_bytes() == Path("ra.txt").read_bytes()
    assert Path("x.txt").read_bytes() == Path("rx.txt").read_bytes()


def test_cli_mtx_and_errors(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert spmv.main(["spmv_scan", "mtx", GR_30_30, "cpu_check",
                      "--kernel=pallas-fused", "--device=cpu"]) == 0
    assert "Worked!" in capsys.readouterr().out
    assert spmv.main(["spmv_scan", "a.txt", "x.txt", "--kernel=nope"]) == 2
    assert spmv.main(["spmv_scan", "a.txt", "x.txt", "--fast"]) == 2
    assert spmv.main(["spmv_scan", "missing.txt", "x.txt",
                      "--device=cpu"]) == 2
    assert spmv.main(["spmv_scan", "mtx", "missing.mtx",
                      "--device=cpu"]) == 2
    assert spmv.main(["spmv_scan", "gen", "a.txt"]) == 2
    # --canonical is an accepted flag now (tests/test_torch_programs.py
    # holds its solve); a missing file is still an error
    assert spmv.main(["spmv_scan", "missing.txt", "x.txt", "--canonical",
                      "--device=cpu"]) == 2


def test_cli_module_entry(tmp_path):
    assert "spmv_scan" in models.WORKLOADS
    proc = subprocess.run(
        [sys.executable, "-m", "cme213_tpu_torch", "spmv_scan", "gen",
         "a.txt", "x.txt", "400", "9", "7", "3"], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "n=400 p=9 q=7 N=3" in proc.stdout
