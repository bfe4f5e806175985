"""Nothing under the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: every import statement's
top-level module name is compared whole."""

import ast
from pathlib import Path

import pytest

from conftest import CHECKOUT

ROOT = CHECKOUT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "openmeasure_tpu"}


def top_names(path: Path):
    """The top-level module name (before the first dot) of every import
    in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not top_names(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((ROOT / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_names(path)
    assert "openmeasure_torch" not in names
    assert names <= {"__future__", "contextlib", "dataclasses", "math",
                     "torch"}


def test_names_are_compared_whole(tmp_path):
    """The port's name begins with the JAX package's: only a whole
    top-level name matches."""
    p = tmp_path / "probe.py"
    p.write_text("import openmeasure_torch.serving\n"
                 "from openmeasure_tpux import a\nimport jax.numpy\n")
    assert top_names(p) & JAX == {"jax"}


def test_run_checks_loaded_modules_by_whole_name():
    from benchmark import run
    assert set(run.FORBIDDEN) == JAX
    loaded = ["openmeasure_torch", "openmeasure_torch.serving", "jaxtyping"]
    assert not {m.split(".")[0] for m in loaded} & set(run.FORBIDDEN)
    assert {m.split(".")[0] for m in ["jax.numpy"]} & set(run.FORBIDDEN)
