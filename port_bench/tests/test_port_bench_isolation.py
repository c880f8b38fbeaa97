"""Nothing under port_bench/ imports JAX or the JAX package, and nothing
under port_bench/reference/ imports the program: each import's top-level
name compared whole."""
import ast
import pathlib

import pytest

from port_bench import harness

FILES = sorted(harness.HERE.rglob("*.py"))


def imported(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not imported(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(harness.HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {"tts_arabic_torch", "port_bench"}


def test_forbidden_modules_are_named(monkeypatch):
    import sys
    import types
    assert "tts_arabic_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "tts_arabic_tpu.text",
                        types.ModuleType("tts_arabic_tpu.text"))
    assert harness.forbidden_loaded() == ["tts_arabic_tpu"]
