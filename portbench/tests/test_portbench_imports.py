"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "kubetpu"}


def _imports(path: Path) -> set:
    """Top-level names of every module *path* imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(PKG)} imports {bad}"


def test_top_level_names_compared_whole():
    # the port's name begins with the JAX package's: it is allowed
    assert "kubetpu_torch" not in FORBIDDEN
    assert "kubetpu_torch".split(".")[0] != "kubetpu"


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        names = _imports(path)
        assert "kubetpu_torch" not in names, path
        assert names <= {"__future__", "typing", "torch", "numpy",
                         "portbench"}, (path, names)
    # and what the reference takes from the harness is the inputs alone
    assert _imports(PKG / "inputs.py") <= {"__future__", "typing", "numpy",
                                           "torch"}


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, 'portbench/tests');"
            "import torch; from conftest import tiny_cell;"
            "from portbench import run;"
            "run.run_served(tiny_cell('mistral-7b-v0.2.code'), 3, 0.5, False,"
            " torch.device('cpu'));"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
