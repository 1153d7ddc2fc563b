"""Nothing the benchmark runs imports JAX or the JAX package: top-level
module names are compared whole, since the port's name begins with the JAX
package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.tests.conftest import ROOT


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        tops = _imports(path)
        assert "gtcrn_micro_tpu_torch" not in tops and not tops & set(FORBIDDEN), path


def test_names_are_compared_whole():
    assert forbidden_modules(["gtcrn_micro_tpu_torch", "gtcrn_micro_tpu_torch.serve"]) == []
    assert forbidden_modules(["gtcrn_micro_tpu.ops", "jaxlib", "jax_x"]) == [
        "gtcrn_micro_tpu", "jaxlib"]


def test_a_run_loads_no_jax():
    """Importing every driver, reader and the program modules they use loads
    none of the forbidden modules."""
    code = (
        "import sys, importlib, pathlib\n"
        "import benchmark.run as r\n"
        "for p in sorted(pathlib.Path('benchmark').glob('*/*.py')):\n"
        "    if p.parent.name in ('traffic', 'metrics'):\n"
        "        r.load_module(p, 'm_' + p.stem.replace('.', '_'))\n"
        "import gtcrn_micro_tpu_torch.serve, gtcrn_micro_tpu_torch.eval.infer\n"
        "import gtcrn_micro_tpu_torch.train.trainer, gtcrn_micro_tpu_torch.train.dataloader\n"
        "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
