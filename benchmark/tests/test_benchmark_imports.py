"""The import guard: nothing the benchmark runs loads JAX or the JAX
package, and the reference loads nothing of the package it judges.
Top-level module names are compared whole (``particlesystem_tpu_torch``
is the port, ``particlesystem_tpu`` the JAX package)."""

import ast
import subprocess
import sys

import pytest

from benchmark import harness

from .conftest import ROOT

HERE = ROOT / "benchmark"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_forbidden_import(path):
    assert not set(top_level_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    allowed = {"__future__", "dataclasses", "math", "numpy", "torch"}
    assert set(top_level_imports(path)) <= allowed


def test_a_run_loads_no_forbidden_module():
    """Every module the harness, its drivers and readers and the port
    import, in a fresh interpreter: no top-level name is forbidden."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import benchmark, benchmark.drivers, benchmark.metrics\n"
        "for pkg in (benchmark, benchmark.drivers, benchmark.metrics):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        if m.name != 'tests':\n"
        "            importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "import particlesystem_tpu_torch\n"
        "from benchmark.harness import loaded_forbidden\n"
        "print(loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_guard_compares_whole_names(monkeypatch):
    import particlesystem_tpu_torch  # noqa: F401  (the port: allowed)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.loaded_forbidden() == ["jaxlib"]
