"""Parity of the port's native host library (``cme213_tpu_torch/native``)
with the JAX package's (``cme213_tpu/native``), on the CPU.

Exact throughout: each sort equals ``np.sort`` and the reference library's
output on the same keys, at 1 and 4 OpenMP threads; the OpenMP SpMV-scan
equals the reference library's and the serial golden bit for bit; the
problem-file tokenizers (native and Python) give bitwise-equal problems,
and the writers the same text.
"""

import numpy as np
import pytest

from cme213_tpu import native as j_native
from cme213_tpu_torch import native
from cme213_tpu_torch.apps import spmv_scan as spmv
from cme213_tpu_torch.core import FrameworkError, trace
from cme213_tpu_torch.core.platform import BUILD_DIR
from cme213_tpu_torch.native import build
from cme213_tpu_torch.verify import golden


@pytest.fixture(params=[1, 4], ids=["1-thread", "4-threads"])
def threads(request):
    prev_port, prev_ref = native.thread_count(), j_native.thread_count()
    native.set_threads(request.param)
    j_native.set_threads(request.param)
    yield request.param
    native.set_threads(prev_port)
    j_native.set_threads(prev_ref)


def _i32(n, seed):
    return np.random.default_rng(seed).integers(
        -(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)


def _u32(n, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def test_library_builds_into_the_port_build_dir():
    path = build.build_library()
    assert path.parent == BUILD_DIR and path.name.startswith("native-")
    assert path.exists() and "cme213_tpu_torch" in str(path)
    assert all(src.parent == build.HERE for src in build.SOURCES)


def test_failed_build_raises_framework_error(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(FrameworkError, match="g\\+\\+ not found"):
        build.build_library()
    monkeypatch.setattr(build.shutil, "which", lambda name: "/bin/false")
    with pytest.raises(FrameworkError, match="g\\+\\+ failed"):
        build.build_library()
    assert not list(tmp_path.iterdir())  # nothing half-written left


@pytest.mark.parametrize("n", [0, 1, 100, 10_000, 1_000_003])
def test_merge_sort(threads, n):
    x = _i32(n, n or 7)
    out = native.merge_sort(x.copy())
    np.testing.assert_array_equal(out, np.sort(x))
    np.testing.assert_array_equal(out, j_native.merge_sort(x.copy()))


def test_merge_sort_thresholds():
    x = np.random.default_rng(1).integers(0, 1000, 50_000).astype(np.int32)
    for st, mt in [(64, 64), (1024, 333), (100_000, 100_000)]:
        np.testing.assert_array_equal(native.merge_sort(x.copy(), st, mt),
                                      np.sort(x))


@pytest.mark.parametrize("n", [0, 1, 257, 100_000])
@pytest.mark.parametrize("num_bits", [4, 8, 11])
def test_radix_sort(threads, n, num_bits):
    x = _u32(n, n + num_bits)
    out = native.radix_sort(x.copy(), num_bits)
    np.testing.assert_array_equal(out, np.sort(x))
    np.testing.assert_array_equal(out, j_native.radix_sort(x.copy(),
                                                           num_bits))
    np.testing.assert_array_equal(native.radix_sort_serial(x.copy(),
                                                           num_bits), out)


def test_radix_sort_16bit_large():
    x = _u32(3_000_000, 16)
    np.testing.assert_array_equal(native.radix_sort(x.copy(), num_bits=16),
                                  np.sort(x))


def test_thread_control():
    prev = native.thread_count()
    try:
        native.set_threads(2)
        assert native.thread_count() == 2
        native.set_threads(4)
        assert native.thread_count() == 4
    finally:
        native.set_threads(prev)


def test_sum_and_saxpy_are_the_reference(threads):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(100_001).astype(np.float32)
    y = rng.standard_normal(100_001).astype(np.float32)
    assert native.parallel_sum(x) == j_native.parallel_sum(x)
    a, b = y.copy(), y.copy()
    native.saxpy(1.5, x, a)
    j_native.saxpy(1.5, x, b)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        native.saxpy(1.5, x, y.astype(np.float64))


def _random_problem(rng, n=5000, p=64):
    starts = np.sort(rng.choice(np.arange(1, n), size=p - 1, replace=False))
    s = np.concatenate([[0], starts]).astype(np.int32)
    a = rng.standard_normal(n).astype(np.float32)
    xx = rng.uniform(-1, 1, n).astype(np.float32)
    return a, s, xx


@pytest.mark.parametrize("n,p", [(5000, 64), (20_000, 37), (100, 1)])
def test_spmv_scan_cpu_bitwise(threads, n, p):
    a, s, xx = _random_problem(np.random.default_rng(n), n, p)
    for iters in (1, 5):
        out = native.spmv_scan_cpu(a, s, xx, iters)
        np.testing.assert_array_equal(out,
                                      golden.host_spmv_scan(a, s, xx, iters))
        np.testing.assert_array_equal(out,
                                      j_native.spmv_scan_cpu(a, s, xx, iters))


def test_loader_tokenizers_give_bitwise_equal_problems(tmp_path):
    prob = spmv.generate_problem(30_000, 300, 299, iters=7, seed=3)
    a_txt, x_txt = str(tmp_path / "a.txt"), str(tmp_path / "x.txt")
    spmv.save_problem(prob, a_txt, x_txt)
    trace.clear_events()
    fast = spmv.load_problem(a_txt, x_txt)
    slow = spmv.load_problem(a_txt, x_txt, use_native=False)
    for got in (fast, slow):
        for name in ("a", "s", "k", "x"):
            x, y = getattr(got, name), getattr(prob, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert got.iters == prob.iters
    loads = [(e["tokenizer"], "error" in e) for e in trace.events("span-end")
             if e.get("span") == "spmv_scan.load"]
    assert loads == [("native", False), ("python", False)]


def test_loader_falls_back_when_the_library_cannot_build(tmp_path,
                                                         monkeypatch):
    prob = spmv.generate_problem(4000, 40, 39, iters=3, seed=4)
    a_txt, x_txt = str(tmp_path / "a.txt"), str(tmp_path / "x.txt")
    spmv.save_problem(prob, a_txt, x_txt)

    def broken():
        raise FrameworkError("g++ failed")

    monkeypatch.setattr(native, "_load", broken)
    trace.clear_events()
    got = spmv.load_problem(a_txt, x_txt)
    assert np.array_equal(got.a, prob.a) and np.array_equal(got.k, prob.k)
    loads = [(e["tokenizer"], "error" in e) for e in trace.events("span-end")
             if e.get("span") == "spmv_scan.load"]
    assert loads == [("native", True), ("python", False)]
    spmv._write_floats(str(tmp_path / "py.txt"), prob.a)  # Python writer
    monkeypatch.undo()
    spmv._write_floats(str(tmp_path / "c.txt"), prob.a)   # native writer
    assert (tmp_path / "py.txt").read_text() == \
        (tmp_path / "c.txt").read_text()


def test_malformed_problem_raises_from_the_native_tokenizer(tmp_path):
    (tmp_path / "a.txt").write_text("10 3 2 4\n1 2 3\n")
    (tmp_path / "x.txt").write_text("1 2\n")
    with pytest.raises(ValueError):
        spmv.load_problem(str(tmp_path / "a.txt"), str(tmp_path / "x.txt"))


def test_writers_are_the_reference(tmp_path):
    v = np.random.default_rng(5).standard_normal(999).astype(np.float32)
    v[:3] = [np.inf, -0.0, 1e-45]
    native.write_floats(str(tmp_path / "p.txt"), v)
    j_native.write_floats(str(tmp_path / "j.txt"), v)
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    np.testing.assert_array_equal(
        native.read_floats(str(tmp_path / "p.txt"), 999), v)
    with pytest.raises(ValueError, match="expected 1000"):
        native.read_floats(str(tmp_path / "p.txt"), 1000)
    with pytest.raises(OSError):
        native.read_floats(str(tmp_path / "missing.txt"), 1)
