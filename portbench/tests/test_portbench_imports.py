"""What the benchmark imports: nothing of JAX or the JAX package anywhere
under ``portbench/`` (top-level names compared whole: ``mindaudio_torch``
begins with ``mindaudio_t``), and nothing of the port in the reference."""

import ast

import pytest

from portbench.harness import FORBIDDEN_MODULES, HERE

SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "mindaudio_torch" not in names and "portbench" not in names


def test_whole_names_compared():
    """A module whose name merely begins like a forbidden one is allowed."""
    import sys

    from portbench.harness import forbidden_modules

    sys.modules["jaxonomy_probe"] = sys
    try:
        assert "jaxonomy_probe" not in forbidden_modules()
    finally:
        del sys.modules["jaxonomy_probe"]
