"""Nothing under portbench/ imports jax, jaxlib, flax or the JAX package,
and reference/ imports nothing of the port: every import statement's
top-level module name compared whole (the port's name begins with the
JAX package's)."""
import ast

import pytest

from portbench import layout
from portbench.run import FORBIDDEN, forbidden_modules

PORT = "lsdradixsort_tpu_torch"
SOURCES = sorted(layout.HERE.rglob("*.py"))


def _imported(path):
    """Top-level names of every module the file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(layout.HERE))
                              for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not _imported(path) & set(FORBIDDEN)


def test_references_import_nothing_of_the_port():
    for path in (layout.HERE / "reference").glob("*.py"):
        assert PORT not in _imported(path), path.name
        # of the benchmark, the references' own helpers only
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), \
                    (path.name, node.module)


def test_the_names_are_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "lsdradixsort_tpu_torch_like",
                        types.ModuleType("x"))
    assert "lsdradixsort_tpu_torch_like" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "lsdradixsort_tpu.core",
                        types.ModuleType("y"))
    assert "lsdradixsort_tpu.core" in forbidden_modules()
