"""Nothing of the benchmark imports JAX, Flax or the JAX package (by whole
top-level name: `repro_torch` is not `repro`), nor reads the JAX era's
benchmark; the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from perfbench_testing import ROOT

from perfbench import run as R

HERE = ROOT / "perfbench"
FILES = sorted(HERE.rglob("*.py"))
# the reference and what it reads
PLAIN = [HERE / "reference", HERE / "weights.py", HERE / "roofline"]


def imported(path: Path) -> set[str]:
    """Top-level names of the absolute imports, and "program" where the
    file imports the benchmark's adapter to the program."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
            names |= {"program" for a in node.names
                      if a.name.endswith(".program")}
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level == 0:
                names.add(mod.split(".")[0])
            if mod.endswith("program") or any(
                    a.name == "program" for a in node.names):
                names.add("program")
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro"}
    if path.name != Path(__file__).name:
        text = path.read_text()
        for word in ("benchmarks/", "BENCH_spinnaker", "chip_smoke"):
            assert word not in text


def test_reference_imports_nothing_of_the_program():
    for root in PLAIN:
        for path in ([root] if root.is_file() else root.rglob("*.py")):
            assert not imported(path) & {"repro_torch", "program"}, path


def test_forbidden_module_check_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType(
        "repro_torch_fake"))
    assert "repro_torch_fake" not in R.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("x"))
    assert "repro.fake" in R.loaded_forbidden()
