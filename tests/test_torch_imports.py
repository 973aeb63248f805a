"""Import hygiene of the PyTorch port: ``src/repro_torch``,
``chip_smoke.py`` and ``tools/host_cost_ab.py`` import neither JAX nor the
reference package, nor Triton (every kernel is CUDA C++), and name no
file ``ref.py`` under ``kernels/`` (that name is the reference's oracle
table, which the speclint meta rule looks up by file name)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "tools" / "host_cost_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(tree):
    """(module name, node) for every absolute import in the file."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text())
    bad = [name for name, _ in _imports(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_triton_is_imported_only_at_launch(path):
    tree = ast.parse(path.read_text())
    top = [name for node in tree.body
           if isinstance(node, (ast.Import, ast.ImportFrom))
           for name, _ in _imports(ast.Module(body=[node], type_ignores=[]))]
    assert not [n for n in top if n.split(".")[0] == "triton"]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_triton_is_left(path):
    """Not at the top, not inside a function: no kernel is Triton."""
    bad = [name for name, _ in _imports(ast.parse(path.read_text()))
           if name.split(".")[0] == "triton"]
    assert not bad, f"{path.name} imports {bad}"


def test_no_ref_py_under_port_kernels():
    assert FILES and not (PORT / "kernels" / "ref.py").exists()
    assert not list(PORT.rglob("kernels/ref.py"))
