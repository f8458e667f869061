"""Port parity: the data-parallel batch (parallel/batch.py,
api._align_batch_sharded, pipeline._auto_mesh), JAX vs torch on the CPU.

The JAX package matches the pairs over a jax.sharding.Mesh of the
conftest's 8 virtual CPU devices (shard_map of the vmapped matcher); the
port over a list of devices, here ['cpu'] * 8 and ['cpu'] * 2. Inputs are
tests/test_parallel.py's synthetic pairs, made from seeds with numpy.

Tolerances, and why:
- device_align_step on one pair: the u8 quality codes, offsets and starts
  equal; the margin within rtol 1e-5 (the coarse score map's GEMMs sum in
  other orders in torch and XLA);
- align_batch_from_pcm(mesh=...): nodes within atol 1e-6 s and similarity
  within 1e-9 of the JAX sharded call, as tests/test_parallel.py:163-165
  holds the JAX sharded call to the serial one.
"""
import numpy as np
import pytest
import torch

from describealign_tpu.alignment import api as japi
from describealign_tpu.ops.features import extract_features
from describealign_tpu.parallel import batch as jbatch
from describealign_tpu.utils.synthmedia import build_pair
from describealign_tpu_torch import pipeline as tpipe
from describealign_tpu_torch.alignment import api as tapi
from describealign_tpu_torch.alignment import matching as tm
from describealign_tpu_torch.parallel import batch as tbatch

N_DEV = 8


def _stack(pcm, npad):
    fs = [np.asarray(f) for f in extract_features(pcm)]
    n = min(len(f) for f in fs)
    out = np.zeros((5, npad), np.float32)
    for j, f in enumerate(fs):
        out[j, :n] = f[:n]
    return out, n


@pytest.fixture(scope='module')
def one_pair():
    # tests/test_parallel.py:17-34's first pair (seed 0), f16 as uploaded
    video, audio, _ = build_pair(content_seconds=14.0, narration=(),
                                 lead_in=2.0, seed=0)
    fa, na = _stack(audio, 210 * 20)
    fv, nv = _stack(video, 210 * 20)
    return fa.astype(np.float16), na, fv.astype(np.float16), nv


def _codes(q):
    return tm._qual_quantize_u8(torch.as_tensor(np.asarray(q, np.float32)))


def test_device_align_step_matches_jax(one_pair):
    fa, na, fv, nv = one_pair
    want = jbatch.device_align_step(fa, na, fv, nv)
    got = tbatch.device_align_step(torch.from_numpy(fa), na,
                                   torch.from_numpy(fv), nv)
    assert got[0].dtype == torch.float16 and got[1].dtype == torch.int16
    assert got[0].shape == tuple(np.asarray(want[0]).shape)
    assert torch.equal(_codes(got[0].float()), _codes(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)
    # the batch and sharded forms: the pairs one by one
    stacked = tbatch.batched_match(torch.from_numpy(np.stack([fa, fa])),
                                   [na, na],
                                   torch.from_numpy(np.stack([fv, fv])),
                                   [nv, nv])
    sharded = tbatch.sharded_match(['cpu'] * 3, [torch.from_numpy(fa)] * 2,
                                   [na, na], [torch.from_numpy(fv)] * 2,
                                   [nv, nv])
    for k in range(4):
        assert stacked[k].shape[0] == 2
        for j in range(2):
            assert torch.equal(stacked[k][j], got[k])
            assert torch.equal(sharded[j][k], got[k])


@pytest.fixture(scope='module')
def three_pairs():
    # tests/test_parallel.py:146-165: 3 pairs (seeds 31-33) on the 8-device
    # mesh (a ragged group), the JAX sharded call
    pairs, lens = [], []
    for seed in (31, 32, 33):
        video, audio, _ = build_pair(content_seconds=16.0, narration=(),
                                     lead_in=2.0 + seed % 3, seed=seed)
        v = np.clip(video, -32768, 32767).astype(np.int16)
        a = np.clip(audio, -32768, 32767).astype(np.int16)
        pairs.append((v, a))
        lens.append((v.shape[1], a.shape[1]))
    want = japi.align_batch_from_pcm(
        pairs, true_samples=lens, mesh=jbatch.make_mesh(N_DEV, axis='data'))
    return pairs, lens, want


@pytest.mark.parametrize("slots", [N_DEV, 2])
def test_align_batch_sharded_matches_jax(three_pairs, slots):
    """8 slots: one group of 3; 2 slots: groups of 2 and 1 (the ragged
    tail the JAX code fills by repeating its last pair)."""
    pairs, lens, want = three_pairs
    got = tapi.align_batch_from_pcm(pairs, true_samples=lens,
                                    mesh=['cpu'] * slots)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == 6
        np.testing.assert_allclose(g[0], w[0], atol=1e-6)   # audio times
        np.testing.assert_allclose(g[1], w[1], atol=1e-6)   # video times
        assert abs(g[2] - w[2]) < 1e-9                      # similarity
        assert abs(g[4] - w[4]) < 1e-9                      # median slope
        np.testing.assert_allclose(g[5], w[5], rtol=1e-5)   # f32 margin
    # the pairs in input order: their planted lead-ins
    for (v, a), g, seed in zip(pairs, got, (31, 32, 33)):
        assert abs(float(g[0][0] - g[1][0]) - (2.0 + seed % 3)) < 0.05


@pytest.mark.parametrize("case", ["device_features", "empty"])
def test_mesh_misuse_raises(three_pairs, case):
    pairs, lens, _ = three_pairs
    kw = {"device_features": dict(mesh=['cpu'] * 2, features='device'),
          "empty": dict(mesh=[])}[case]
    with pytest.raises(ValueError, match="mesh="):
        tapi.align_batch_from_pcm(pairs, true_samples=lens, **kw)


def test_auto_mesh_none_without_cards():
    assert torch.cuda.device_count() <= 1
    assert tpipe._auto_mesh() is None
    assert tbatch.make_mesh() == []


def test_auto_mesh_only_for_the_bare_cuda_device(monkeypatch):
    """On a host of four cards (device_count patched; make_mesh only names
    the devices) the directory batch takes every card for the bare
    'cuda', and the named card alone for 'cuda:1'."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tpipe._auto_mesh() == [torch.device('cuda', i) for i in range(4)]
    assert tpipe._auto_mesh(torch.device('cuda')) == tbatch.make_mesh()
    assert tpipe._auto_mesh('cuda:1') is None
    assert tpipe._auto_mesh('cpu') is None
    assert tbatch.make_mesh(3) == tbatch.make_mesh()[:3]
