"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
reference imports nothing of the program."""
import ast
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in _imports(path), path


def test_the_scan_sees_a_planted_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom repro.core import digest\n"
                 "import jax.numpy\nimport repro_torch\n")
    assert _imports(f) & FORBIDDEN == {"repro", "jax"}


def test_the_run_names_a_loaded_jax_package(monkeypatch):
    from bench import harness
    for name in [m for m in sys.modules
                 if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch.core",
                        types.ModuleType("repro_torch.core"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]
