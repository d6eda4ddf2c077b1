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
            " cme213_tpu_torch.dist.supervisor;"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'cme213_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
