"""No module under bench/ imports JAX or the JAX package, and none under
bench/reference/ imports the program: top-level module names are
compared whole, so the port's ``repro_torch`` is not taken for the JAX
package ``repro``."""
from __future__ import annotations

import ast

import pytest

from bench.harness import common

FILES = sorted(p for p in common.BENCH.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(common.ROOT).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.parts],
    ids=lambda p: p.relative_to(common.ROOT).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "bench" not in top_level_imports(path) or all(
        n.startswith("bench.reference") for n in _bench_imports(path))


def _bench_imports(path) -> list:
    tree = ast.parse(path.read_text())
    return [n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level == 0 and
            n.module.split(".")[0] == "bench"]


def test_whole_name_comparison():
    assert "repro_torch".split(".")[0] not in common.FORBIDDEN_MODULES
    assert "repro.core".split(".")[0] in common.FORBIDDEN_MODULES
