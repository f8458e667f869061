"""Port parity: sequence-sharded features (parallel/seqshard.py), JAX vs
torch on the CPU.

The JAX package shards the PCM over a mesh axis of the conftest's 8
virtual CPU devices (shard_map, halos by ppermute); the port over a list
of devices, here ['cpu'] * 8. Both keep the JAX sharded semantics,
edge-frame smear included (tests/test_parallel.py:48-55): the band
cascade squares a smoothed signal that reaches into a zero halo.

Tolerances, and why:
- sharded features vs the JAX sharded call, every frame: rtol 2e-5 /
  atol 2e-5, tests/test_parallel.py:54-55's bar (XLA on the CPU contracts
  the shift-add's `out + tap * x` into fused multiply-adds, the port
  rounds each product and add);
- the plain kill_crossing_at vs the JAX zero_crossing_feature: the bars of
  tests/test_features.py:40 (rtol 2e-5 / atol 2e-5); the counts before
  smoothing, and cancel_crossing against the plain kill, bit-equal;
- one shard vs the port's unsharded extractor: interior frames bit-equal.
"""
import numpy as np
import pytest
import torch

from describealign_tpu.ops import features as jfeat
from describealign_tpu.parallel.batch import make_mesh
from describealign_tpu.parallel.seqshard import \
    sequence_sharded_features as jax_sharded
from describealign_tpu.utils.synthmedia import build_pair
from describealign_tpu_torch.ops import features as tfeat
from describealign_tpu_torch.parallel import seqshard

N_DEV = 8


def _video(n_shards):
    # tests/test_parallel.py:37-46's 14-s input, cut to the shard contract
    video, _, _ = build_pair(content_seconds=14.0, narration=(),
                             lead_in=2.0, seed=0)
    s = video.shape[1] - video.shape[1] % (210 * n_shards)
    return video[:, :s]


def test_sharded_matches_jax_every_frame():
    pcm = _video(N_DEV)
    want = np.asarray(jax_sharded(pcm, make_mesh(N_DEV, axis='seq')))
    got = seqshard.sequence_sharded_features(pcm, ['cpu'] * N_DEV)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (5, pcm.shape[1] // 210)
    for j in range(5):
        np.testing.assert_allclose(got[j].numpy(), want[j], rtol=2e-5,
                                   atol=2e-5, err_msg=f"feature {j}")
    # interior frames are the unsharded computation's
    n = pcm.shape[1] // 210
    whole = tfeat.extract_features(pcm, device='cpu')
    for j in range(5):
        assert torch.equal(got[j][8:n - 8], whole[j][8:n - 8])


def _ends_negative(channels):
    """PCM whose last data sample is negative on every channel, then a
    zero halo: the data-to-zero crossing at `at` is the artificial one."""
    rng = np.random.default_rng(50 + channels)
    data = (rng.standard_normal((channels, 210 * 40)) * 3000).astype(
        np.float32)
    data[:, -1] = -1234.0
    at = data.shape[1]
    pcm = np.concatenate([data, np.zeros((channels, seqshard.HALO),
                                         np.float32)], axis=1)
    return pcm, at


@pytest.mark.parametrize("channels", [1, 2])
def test_kill_crossing_plain_matches_jax(channels):
    pcm, at = _ends_negative(channels)
    t = torch.from_numpy(pcm)
    for enabled in (True, False):
        _, counts, _, _ = tfeat.pcm_frontend_plain(
            t, kill_crossing_at=at, kill_enabled=enabled)
        got = tfeat.polyphase_blur_plain(counts, 1, tfeat.SMOOTH)
        want = np.asarray(jfeat.zero_crossing_feature(
            pcm, kill_crossing_at=at, kill_enabled=enabled))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # the kill matters here: one crossing per channel, x2 for mono
    _, kept, _, _ = tfeat.pcm_frontend_plain(t)
    _, killed, _, _ = tfeat.pcm_frontend_plain(t, kill_crossing_at=at)
    diff = (kept - killed).numpy()
    assert diff[at // 210] == (2 if channels == 1 else channels)
    assert np.count_nonzero(diff) == 1
    # the CUDA path's repair between K1 and K2, bit-equal to the plain kill
    assert torch.equal(tfeat.cancel_crossing(kept, t, at), killed)


CANCEL_CASES = {
    # sample `at`: (its value, the value before it); a crossing is a
    # sign-bit change between the two
    "halo_zero": (210 * 3 + 17, 0.0, -500.0),
    "negative_at": (210 * 3 + 17, -700.0, 500.0),
    "two_negatives": (210 * 3 + 17, -700.0, -500.0),
    "two_positives": (210 * 3 + 17, 700.0, 500.0),
    "first_sample": (0, -300.0, None),
    "part_frame": (210 * 6 + 40, -700.0, 500.0),
}


@pytest.mark.parametrize("case", sorted(CANCEL_CASES))
@pytest.mark.parametrize("channels", [1, 2])
def test_cancel_crossing_equals_plain_kill(case, channels):
    """cancel_crossing (the CUDA path's repair between K1 and K2) equals
    the plain kill at any sample, not only at a halo's zero: the count of
    `at`'s frame loses `at`'s crossing where there is one, else nothing."""
    at, value, before = CANCEL_CASES[case]
    rng = np.random.default_rng(70 + channels)
    pcm = (rng.standard_normal((channels, 210 * 6 + 50)) * 3000).astype(
        np.float32)
    pcm[:, at] = value
    if before is not None:
        pcm[:, at - 1] = before
    t = torch.from_numpy(pcm)
    _, kept, _, _ = tfeat.pcm_frontend_plain(t)
    _, killed, _, _ = tfeat.pcm_frontend_plain(t, kill_crossing_at=at)
    assert torch.equal(tfeat.cancel_crossing(kept, t, at), killed)


def test_one_shard_and_the_shard_contract():
    pcm = _video(1)
    n = pcm.shape[1] // 210
    one = seqshard.sequence_sharded_features(pcm, ['cpu'])
    whole = tfeat.extract_features(pcm, device='cpu')
    assert one.shape == (5, n)
    for j in range(5):
        assert torch.equal(one[j][8:n - 8], whole[j][8:n - 8])
        # energy and crossings read no halo values at the edges either
        if j < 2:
            assert torch.equal(one[j], whole[j][:n])
    with pytest.raises(ValueError, match="multiple of 210"):
        seqshard.sequence_sharded_features(pcm[:, :-210], ['cpu'] * 2)
    with pytest.raises(ValueError, match="halo"):
        seqshard.sequence_sharded_features(pcm[:, :210 * 4], ['cpu'] * 2)
