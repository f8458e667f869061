"""The port runs where jax is absent: the card machine has no jax,
sortedcontainers, matplotlib or platformdirs, and the port imports nothing
of the JAX package. A subprocess blocks those modules and the JAX package
and runs the port's align_from_pcm on a small pair on the CPU.
chip_smoke.py imports only the port, torch and numpy."""
import ast
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "sortedcontainers", "matplotlib", "platformdirs",
           "describealign_tpu")

_SCRIPT = f"""
import sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
import numpy as np
from describealign_tpu_torch import align_from_pcm
from describealign_tpu_torch.alignment.native import native_lib
from describealign_tpu_torch.bench_pair import build_scale_pair
from describealign_tpu_torch.utils.synthmedia import build_pair
video, audio, _ = build_pair(content_seconds=14.0, narration=(),
                             lead_in=2.0, seed=3)
v = np.clip(video, -32768, 32767).astype(np.int16)
a = np.clip(audio, -32768, 32767).astype(np.int16)
out = align_from_pcm(v, a, device="cpu")
assert len(out) == 6, len(out)
assert abs(float(out[0][0] - out[1][0]) - 2.0) < 0.05, out[0][0] - out[1][0]
loaded = [m for m in sys.modules
          if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
assert not loaded, loaded
print("JAXFREE_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JAXFREE_OK" in proc.stdout


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "describealign_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_chip_smoke_imports_only_the_port():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, node.module
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert "describealign_tpu_torch" in tops
    assert tops <= {"describealign_tpu_torch", "torch", "numpy", "contextlib",
                    "io", "json", "os", "subprocess", "threading",
                    "time"}, tops


def _imported_tops(path):
    """Top-level names of every module `path` imports (relative imports
    resolve inside their own package and are skipped)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_port_never_imports_the_jax_package():
    """No module of the port, nor chip_smoke.py, nor the card tests, names
    the JAX package as an import (the top-level name, not a prefix:
    describealign_tpu_torch is the port itself)."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "test_torch_cuda.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "describealign_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        assert "describealign_tpu" not in _imported_tops(path), path
