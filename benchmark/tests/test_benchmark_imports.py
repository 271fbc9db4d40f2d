"""What the benchmark imports: no module of it (the tests aside) names
``jax``, ``jaxlib``, ``flax``, ``optax`` or the JAX package ``cfpnet_tpu`` by
its top-level name, compared whole (``cfpnet_torch`` is not ``cfpnet_tpu``),
the reference imports nothing of the system under test either, and the
harness's model-agnostic modules import no model: neither a family, nor the
reference beyond its precision contexts (the controls), nor the port beyond
its kernels' build."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cfpnet_tpu"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def dotted_imports(path: Path):
    """The dotted names that ``path`` imports (``from a import b`` as
    ``a.b``), relative ones resolved against its package."""
    package = ["benchmark", *path.relative_to(HERE).parent.parts]
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            names |= {f"{module}.{a.name}" for a in node.names}
    return names


@pytest.mark.parametrize("name", ["calibrate.py", "drivers.py", "run.py", "spec.py", "trace.py",
                                  "weights.py"])
def test_model_agnostic_modules_import_no_model(name):
    for imported in dotted_imports(HERE / name):
        assert not imported.startswith("benchmark.families"), imported
        assert (not imported.startswith("benchmark.reference")
                or imported == "benchmark.reference.precision"), imported
        assert (not imported.startswith("cfpnet_torch")
                or imported.startswith("cfpnet_torch.kernels")), imported


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert "cfpnet_torch" not in top_level_imports(path)


def test_prefix_is_not_a_match(monkeypatch):
    monkeypatch.setitem(sys.modules, "cfpnet_tpu_extra", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "cfpnet_tpu" not in run.leaked_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.leaked_modules() == ["jax"]
