"""Nothing under portbench/ imports JAX or the JAX package, comparing each import's
top-level name whole; the reference imports nothing of the program."""

import ast

import pytest

from portbench.lib import common

FILES = sorted(common.BENCH.rglob("*.py"))


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(common.BENCH)))
def test_no_jax(path):
    assert not imported(path) & set(common.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((common.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {"repro_torch", "portbench"}


def test_names_compared_whole():
    assert "repro_torch" not in common.FORBIDDEN and "repro" in common.FORBIDDEN
