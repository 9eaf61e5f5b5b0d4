"""The benchmark imports no JAX and nothing of the JAX package (compared
by whole top-level module name: mic_tpu_torch begins with mic_tpu), its
plain reference imports nothing of the program, and nothing of it reads
the JAX package's benchmark folder."""

import ast
import inspect
from pathlib import Path

import pytest

from portbench import harness

from .conftest import REPO

PB = REPO / "portbench"
JAX = {"jax", "jaxlib", "flax", "mic_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _sources():
    return sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


def _scanned():
    """Every file of the benchmark but this test, which names what it
    looks for."""
    return [p for p in [*_sources(), *PB.rglob("*.json")] if p != Path(__file__).resolve()]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & JAX, f"{path} imports {tops & JAX}"
    for path in _scanned():
        text = path.read_text()
        for name in ("import_module(", "__import__("):
            assert name not in text, f"{path} imports by name"


def test_the_reference_takes_nothing_of_the_program():
    for module in ("reference.py", "studies.py", "roofline.py"):
        tops = {n.split(".")[0] for n in _imports(PB / module)}
        assert tops <= {"__future__", "struct", "json", "pathlib", "numpy"}, (module, tops)
    assert {n.split(".")[0] for n in _imports(PB / "check.py")} <= {
        "__future__", "struct", "sys", "numpy", "torch"}


@pytest.mark.parametrize("name", sorted(p.stem for p in (PB / "paths").glob("*.py")))
def test_each_paths_reference_takes_nothing_of_the_program(name):
    """A request path's plain decoder lives in a module that imports
    nothing of the program (the path itself calls the program)."""
    decode = harness.load_path(name).reference_decode
    source = Path(inspect.getsourcefile(decode))
    assert source.parent == PB or source.parent == PB / "paths", source
    tops = {n.split(".")[0] for n in _imports(source)}
    assert "mic_tpu_torch" not in tops and not tops & JAX, (source, tops)


def test_nothing_reads_the_jax_benchmarks():
    for path in _scanned():
        text = path.read_text()
        assert "benchmarks/" not in text and "bench.py" not in text, path
        assert "BASELINE" not in text and "BENCH_r0" not in text, path
    assert "benchmarks" not in {n.split(".")[0] for p in _sources() for n in _imports(p)}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    assert "mic_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mic_tpu_torchx", types.ModuleType("mic_tpu_torchx"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mic_tpu.ops", types.ModuleType("mic_tpu.ops"))
    assert harness.forbidden_modules() == ["mic_tpu"]
