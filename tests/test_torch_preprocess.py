"""Port parity: preprocess (mean-subtract, norms, masks), JAX vs torch on
the CPU. The mean-subtract and norms are the same shift-add sums in the
same order, but XLA's CPU code may contract a multiply-add into an FMA, so
they agree to 1e-6 rather than bit for bit. The local mean is a 41-term sum
of values up to the stream's largest feature, so its rounding is bounded
relative to that scale, and ms = feature - mean can cancel it to a small
value: ms is held to 1e-6 of the stream's feature scale (norms, sums of
squares, to rtol 1e-6 as they are). The masks are integer logic and must
be bit-equal."""
import numpy as np
import pytest
import torch

from describealign_tpu.alignment import preprocess as jpre
from describealign_tpu.alignment.api import host_features_padded
from describealign_tpu.utils.synthmedia import build_pair
from describealign_tpu_torch.alignment import preprocess as tpre


def _assert_ms_close(ms_t, ms_j, feats):
    scale = np.abs(feats).max(axis=1, keepdims=True)
    err = np.abs(ms_t - ms_j) / (scale + 1.0)
    assert err.max() <= 1e-6, err.max()


def _feature_stack(seed):
    """(5, Npad) f16-rounded host features of a small synthetic pair (the
    matcher's real input) and the true frame count."""
    video, _, _ = build_pair(content_seconds=14.0, narration=(),
                             lead_in=0.0, seed=seed)
    pcm = np.clip(video, -32768, 32767).astype(np.int16)
    feats, n = host_features_padded(pcm, npad=210 * 20)
    return feats.astype(np.float16).astype(np.float32), n


@pytest.mark.parametrize("seed", [0, 5])
def test_preprocess_features_parity(seed):
    feats, _ = _feature_stack(seed)
    ms_j, norms_j = (np.asarray(a) for a in jpre.preprocess_features(feats))
    ms_t, norms_t = tpre.preprocess_features(torch.from_numpy(feats))
    _assert_ms_close(ms_t.numpy(), ms_j, feats)
    np.testing.assert_allclose(norms_t.numpy(), norms_j, rtol=1e-6,
                               atol=1e-6)


def test_preprocess_random_features_parity():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((5, 4096)).astype(np.float32)
    ms_j, norms_j = (np.asarray(a) for a in jpre.preprocess_features(feats))
    ms_t, norms_t = tpre.preprocess_features(torch.from_numpy(feats))
    _assert_ms_close(ms_t.numpy(), ms_j, feats)
    np.testing.assert_allclose(norms_t.numpy(), norms_j, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 5])
def test_masks_bit_equal(seed):
    feats, n = _feature_stack(seed)
    energy = feats[0]
    for true_len in (n, n - 300):
        a_j = np.asarray(jpre.valid_audio_mask(energy, true_len))
        v_j = np.asarray(jpre.valid_video_mask(energy, true_len))
        a_t = tpre.valid_audio_mask(torch.from_numpy(energy), true_len)
        v_t = tpre.valid_video_mask(torch.from_numpy(energy), true_len)
        np.testing.assert_array_equal(a_t.numpy(), a_j)
        np.testing.assert_array_equal(v_t.numpy(), v_j)
        assert v_j.sum() > 0


def test_mean_sub_taps_equal():
    np.testing.assert_array_equal(tpre.mean_sub_taps(),
                                  jpre.mean_sub_taps())
    assert tpre.WINDOW == jpre.WINDOW
    assert tpre.SAMPLES_PER_NODE == jpre.SAMPLES_PER_NODE
