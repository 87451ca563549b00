"""Nothing under ``perfbench/`` imports JAX or the JAX package: every
import's top-level name is compared whole, so ``repro_torch`` is not taken
for ``repro``."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not top_level_imports(path.read_text()) & FORBIDDEN


def test_whole_names_are_compared():
    src = "import repro_torch.models\nfrom repro_torch import convert\nimport jaxtyping\n"
    assert not top_level_imports(src) & FORBIDDEN
    assert top_level_imports("from repro.models import x\n") & FORBIDDEN
    assert top_level_imports("import jax.numpy as jnp\n") & FORBIDDEN
    assert top_level_imports("importlib.import_module('repro.core')\n") & FORBIDDEN
