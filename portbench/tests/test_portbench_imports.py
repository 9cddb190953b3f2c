"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (``diart_tpu_torch`` begins with ``diart_tpu`` and is
another package), and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

from portbench.run import FORBIDDEN, forbidden_modules

PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.relative_to(PKG).parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert top_level_imports(path) <= {"__future__", "contextlib", "importlib", "itertools", "math",
                                       "re", "typing", "numpy", "scipy", "torch"}


def test_whole_name_comparison():
    import sys
    import types

    sys.modules.setdefault("diart_tpu_torch_probe", types.ModuleType("diart_tpu_torch_probe"))
    assert "diart_tpu" not in forbidden_modules() or "diart_tpu" in {m.split(".")[0] for m in sys.modules}
    assert "diart_tpu_torch_probe" not in forbidden_modules()
