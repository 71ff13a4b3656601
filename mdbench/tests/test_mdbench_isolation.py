"""The benchmark's isolation: the reference imports neither JAX, the JAX
package nor the port; the harness's check compares whole top-level names;
nothing in the benchmark's files imports JAX or the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

import run

HERE = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "openmm_tpu"}


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.classical; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/")
    tops = set(eval(out.stdout))
    assert not tops & (JAX_NAMES | {"openmm_tpu_torch"}), tops


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "openmm_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "openmm_tpu.fake", sys)
    assert run.forbidden_modules() == ["openmm_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & JAX_NAMES, (path, tops & JAX_NAMES)
