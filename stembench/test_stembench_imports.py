"""Nothing the benchmark imports is JAX or the JAX package (compared by
whole top-level names), and its yardstick imports nothing of the port."""
import ast

import pytest

from stembench import harness

SOURCES = sorted(harness.HERE.rglob("*.py"))
# the yardstick: generators, reference, judgement, counts, peaks, trace
YARDSTICK = ("arabic.py", "generate.py", "reference.py", "check.py",
             "stemwork.py", "peaks.py", "trace.py")


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not top_level_imports(path) & harness.FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(name):
    assert "repro_torch" not in top_level_imports(harness.HERE / name)


def test_prefix_names_are_not_jax():
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN
    assert "repro.core".split(".")[0] in harness.FORBIDDEN
