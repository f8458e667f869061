"""Nothing the harness or its reference runs imports JAX or the JAX
package. Top-level module names are compared whole: the port,
describealign_tpu_torch, begins with the JAX package's name and is
allowed."""
import ast
import os

from conftest import BENCH_DIR
from harness.core import FORBIDDEN


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {(os.path.relpath(p, BENCH_DIR), m) for p in _sources()
           for m in _imports(p) if m in FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    refs = os.path.join(BENCH_DIR, "references")
    for f in os.listdir(refs):
        if f.endswith(".py"):
            mods = set(_imports(os.path.join(refs, f)))
            assert mods <= {"contextlib", "numpy", "math", "torch"}, (f, mods)


def test_whole_names_are_compared():
    from harness import core
    import sys
    sys.modules.setdefault("describealign_tpu_torch_probe", sys)
    try:
        assert "describealign_tpu_torch_probe" not in core.forbidden_modules()
    finally:
        del sys.modules["describealign_tpu_torch_probe"]
    assert "describealign_tpu" in FORBIDDEN and "jax" in FORBIDDEN
