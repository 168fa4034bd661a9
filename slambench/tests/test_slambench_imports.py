"""What the benchmark may import: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``gsorb_slam_tpu`` (the JAX package; names are
compared whole, so ``gsorb_slam_tpu_torch`` is not it), and in the plain
reference nothing of the program (``gsorb_slam_tpu_torch``) either."""

import ast
from pathlib import Path

import pytest

from slambench.lib.harness import FORBIDDEN

SB = Path(__file__).resolve().parents[1]


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in SB.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(SB)))
def test_no_jax_import(path):
    assert not imported_tops(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((SB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "gsorb_slam_tpu_torch" not in tops
    assert tops <= {"__future__", "math", "dataclasses", "torch", "numpy", "slambench"}


def test_whole_name_comparison():
    assert "gsorb_slam_tpu_torch".split(".")[0] not in FORBIDDEN
