"""The PyTorch port stands alone: no import of JAX or of the JAX package.

``"cme213_tpu_torch".startswith("cme213_tpu")`` is true, so imports are
judged by their first dotted component.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "cme213_tpu"}
PORT_FILES = sorted((ROOT / "cme213_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_native_sources_are_the_port_s_own():
    """The port builds its own copy of the C++ sources and never loads or
    reads the JAX package's library or sources."""
    from cme213_tpu_torch.native import build

    for src in build.SOURCES:
        assert src.parent == ROOT / "cme213_tpu_torch" / "native"
        assert src.read_bytes() == (ROOT / "cme213_tpu" / "native"
                                    / src.name).read_bytes()
    for path in (ROOT / "cme213_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cpp", ".cu", ".cuh"):
            assert "_libsorts" not in path.read_text(), path


def test_first_component_rule(tmp_path):
    """The check itself: a JAX-package import is caught, the port's own
    absolute and relative imports are not."""
    src = tmp_path / "m.py"
    src.write_text("import cme213_tpu_torch.ops\nfrom . import grid\n"
                   "from cme213_tpu.core import x\n")
    assert _imported_roots(src) & FORBIDDEN == {"cme213_tpu"}


def test_import_leaves_jax_unloaded():
    code = ("import sys, cme213_tpu_torch.apps.heat2d, cme213_tpu_torch.convert,"
            " cme213_tpu_torch.apps.spmv_scan, cme213_tpu_torch.apps.matrix_market,"
            " cme213_tpu_torch.models, cme213_tpu_torch.dist,"
            " cme213_tpu_torch.bench.run_all, cme213_tpu_torch.ops.stencil_pallas,"
            " cme213_tpu_torch.bench.headline, cme213_tpu_torch.doctor_cli,"
            " cme213_tpu_torch.core.metrics, cme213_tpu_torch.core.trace,"
            " cme213_tpu_torch.core.faults, cme213_tpu_torch.core.diag,"
            " cme213_tpu_torch.core.resilience, cme213_tpu_torch.core.flight,"
            " cme213_tpu_torch.core.numerics,"
            " cme213_tpu_torch.core.checkpoint,"
            " cme213_tpu_torch.core.admission,"
            " cme213_tpu_torch.core.roofline, cme213_tpu_torch.core.collector,"
            " cme213_tpu_torch.trace_cli, cme213_tpu_torch.top_cli,"
            " cme213_tpu_torch.numerics_cli, cme213_tpu_torch.bench.regress,"
            " cme213_tpu_torch.bench.report, cme213_tpu_torch.bench.batch,"
            " cme213_tpu_torch.dist.supervisor, cme213_tpu_torch.native,"
            " cme213_tpu_torch.native.build, cme213_tpu_torch.ops.elementwise,"
            " cme213_tpu_torch.ops.gather, cme213_tpu_torch.ops.spmv,"
            " cme213_tpu_torch.ops.histogram, cme213_tpu_torch.ops.sort,"
            " cme213_tpu_torch.apps.corpus, cme213_tpu_torch.apps.cipher,"
            " cme213_tpu_torch.apps.pagerank, cme213_tpu_torch.apps.vigenere,"
            " cme213_tpu_torch.apps.sorts, cme213_tpu_torch.bench.sweeps,"
            " cme213_tpu_torch.core.tune, cme213_tpu_torch.tune_cli,"
            " cme213_tpu_torch.dist.multihost, cme213_tpu_torch.dist.launch,"
            " cme213_tpu_torch.dist.ckpt, cme213_tpu_torch.dist.halo,"
            " cme213_tpu_torch.dist.heat, cme213_tpu_torch.dist.scan,"
            " cme213_tpu_torch.dist.mesh, cme213_tpu_torch.serve,"
            " cme213_tpu_torch.serve.request, cme213_tpu_torch.serve.slo,"
            " cme213_tpu_torch.serve.workloads, cme213_tpu_torch.serve.server,"
            " cme213_tpu_torch.serve.wire, cme213_tpu_torch.serve.shm,"
            " cme213_tpu_torch.serve.transport, cme213_tpu_torch.serve.jobs,"
            " cme213_tpu_torch.serve.loadgen, cme213_tpu_torch.serve.warmup,"
            " cme213_tpu_torch.bench.transport_sweep;"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'cme213_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [
    "cme213_tpu_torch.core", "cme213_tpu_torch.core.faults",
    "cme213_tpu_torch.core.trace", "cme213_tpu_torch.dist",
    "cme213_tpu_torch.dist.supervisor", "cme213_tpu_torch.dist.launch",
    "cme213_tpu_torch.dist.multihost", "cme213_tpu_torch.serve",
    "cme213_tpu_torch.serve.request", "cme213_tpu_torch.serve.wire",
    "cme213_tpu_torch.serve.shm"])
def test_light_modules_leave_torch_unloaded(module):
    """The package ``__init__``s resolve their names on first access, so a
    supervised rank's heartbeat path (and the launcher) import no torch,
    and neither does ``import cme213_tpu_torch.serve`` nor its codecs."""
    code = (f"import sys, {module}; "
            "sys.exit(1 if 'torch' in sys.modules or ("
            f"{module!r}.endswith('.serve') and 'socket' in sys.modules)"
            " else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lazy_package_names_resolve():
    """Every public name of the lazy ``core``, ``dist`` and ``serve`` packages
    resolves to its submodule's object."""
    import cme213_tpu_torch.core as core
    import cme213_tpu_torch.dist as dist
    import cme213_tpu_torch.serve as serve

    for pkg in (core, dist, serve):
        for name in pkg.__all__:
            assert getattr(pkg, name) is not None, (pkg.__name__, name)
        assert set(pkg.__all__) <= set(dir(pkg))
    from cme213_tpu_torch.dist import heat, run_distributed_heat_supervised

    assert run_distributed_heat_supervised is \
        heat.run_distributed_heat_supervised
