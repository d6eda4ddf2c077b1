"""What a run loads: the program's package and never JAX or the JAX
package (top-level names compared whole); the reference loads nothing of
the program; no result without a card or without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from perfbench import harness

ROOT = str(harness.ROOT)


def _child(code: str, cwd: str = ROOT, **kw):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300, **kw)


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import json, sys\n"
        "from perfbench import harness, run, gang, rank, controls\n"
        "spec = harness.spec()\n"
        "for w in spec['workloads']:\n"
        "    harness.load_module('drivers', harness.Cell.load(w['name'])"
        ".workload['driver'])\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    harness.load_module('metrics', m['name'])\n"
        "from perfbench.tests.tiny import run_cell\n"
        "run_cell('heat512-o8', trace=True)\n"
        "run_cell('pwtk-spmv')\n"
        "print(json.dumps([harness.forbidden_loaded(),\n"
        "                  'cme213_tpu_torch' in sys.modules]))\n")
    proc = _child(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [[], True]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cme213_tpu_torchx", object())
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "cme213_tpu", raising=False)
    assert "cme213_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_loaded()


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import perfbench.reference.heat, perfbench.reference.spmv\n"
            "import perfbench.reference.compare, perfbench.reference.costs\n"
            "import perfbench.inputs, perfbench.controls\n"
            "print(sorted(m for m in sys.modules "
            "if m.partition('.')[0].startswith('cme213')))\n")
    proc = _child(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # this machine has a card: the card tests cover the run
    proc = _child("from perfbench.run import main; raise SystemExit(main("
                  "['--workload', 'heat512-o8', '--seed', '1', '--seconds', "
                  "'1']))")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_no_result_beside_nothing_but_the_benchmark(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("from perfbench import harness\n"
            "from perfbench.tests.tiny import run_cell\n"
            "run_cell('heat512-o8')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                               "PYTHONPATH": str(tmp_path)})
    assert proc.returncode != 0 and "{" not in proc.stdout
    assert "cme213_tpu_torch" in proc.stderr
