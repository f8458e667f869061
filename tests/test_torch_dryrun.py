"""The port's twin of __graft_entry__.py::dryrun_multichip
(scripts/torch_dryrun_multichip.py) against the JAX dryrun, on the CPU.

The JAX dryrun runs its (data x seq) mesh on the conftest's virtual CPU
devices; the port on ['cpu'] * n. Both use the same 16-s pairs. What is
held, and why:
- the sharded features' interior frames (all but 8 at either end) are
  bit-equal to the port's unsharded extractor on the same device (the
  halo exchange makes every interior frame the unsharded computation's);
- the printed line - mesh shape, quals shape and candidate count - equals
  the JAX dryrun's (the candidates are the fine pass's, through the u8
  quality grid, so a count off by one would be a candidate lost or made).
"""
import importlib.util
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def twin():
    spec = importlib.util.spec_from_file_location(
        "torch_dryrun_multichip",
        os.path.join(REPO, "scripts", "torch_dryrun_multichip.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape_is_the_jax_dryrun_s(twin, n):
    seq = 2 if (n % 2 == 0 and n >= 4) else 1     # __graft_entry__.py:71
    assert twin.mesh_shape(n) == (n // seq, seq)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_matches_jax(twin, n, capsys):
    import __graft_entry__

    got = twin.dryrun(["cpu"] * n)
    data, seq = twin.mesh_shape(n)
    assert (got["data"], got["seq"]) == (data, seq)
    assert got["interior"] == {(r, t): True for r in range(data)
                               for t in ("video", "audio")}
    assert got["quals"].dtype == torch.float16
    assert got["candidates"] > 0
    capsys.readouterr()
    __graft_entry__.dryrun_multichip(n)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert twin.summary(got) == want
