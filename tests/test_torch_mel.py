"""Port parity: the mel frontend (ops/mel.py), JAX vs torch on the CPU.

The JAX package chooses the frontend with DESCRIBEALIGN_FRONTEND=mel (set
here by monkeypatch for the JAX calls only); the port takes frontend='mel'
as an argument. Inputs are made from a seed with numpy.

Tolerances, and why:
- the filterbank, the host mel bands, the host energy and zero-crossing
  streams and extract_features_host(frontend='mel'): bit-equal (the same
  numpy and scipy calls in the same order);
- the device version on the CPU (torch.fft against XLA's FFT): rtol 1e-5
  / atol 1e-6 (two FFTs round differently, ~1e-7 relative);
- align_from_pcm(frontend='mel'): the LIS path equal and the fit nodes
  within 1e-6 s.
"""
import numpy as np
import pytest
import torch

import describealign_tpu_torch
from describealign_tpu.alignment import api as japi
from describealign_tpu.ops import host_features as jhost
from describealign_tpu.ops import mel as jmel
from describealign_tpu import pipeline as jpipe
from describealign_tpu.utils.synthmedia import build_pair
from describealign_tpu_torch.alignment import api as tapi
from describealign_tpu_torch.ops import host_features as thost
from describealign_tpu_torch.ops import mel as tmel
from describealign_tpu_torch import pipeline as tpipe
from describealign_tpu_torch.utils import aligncache


def _pcm(channels, seconds=5, seed=4):
    # tests/test_mel_frontend.py:18-27's input (stereo, 5 s, seed 4)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((channels, int(44100 * seconds)))
            * 6000).astype(np.int16)


def _int16_pair(**kw):
    video, audio, _ = build_pair(**kw)
    return (np.clip(video, -32768, 32767).astype(np.int16),
            np.clip(audio, -32768, 32767).astype(np.int16))


def test_filterbank_and_host_mel_bit_equal():
    assert np.array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    pcm16 = _pcm(2).astype(np.float16)
    got = tmel.mel_band_features_host(pcm16)
    want = jmel.mel_band_features_host(pcm16)
    assert len(got) == 3 and len(got[0]) == 5 * 210
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    for g, w in zip(thost._numpy_energy_zcr(pcm16),
                    jhost._numpy_energy_zcr(pcm16)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("channels", [1, 2])
def test_extract_features_host_mel_bit_equal(monkeypatch, channels):
    # rows past |x| = 2048 lose bits on the f16 grid; the true length cuts
    # inside a frame, so the trim and the 210-multiple rounding are used
    pcm = _pcm(channels, seconds=3.1, seed=10 + channels)
    true = pcm.shape[1] - 1000
    got = thost.extract_features_host(pcm, true, frontend='mel')
    monkeypatch.setenv("DESCRIBEALIGN_FRONTEND", "mel")
    want = jhost.extract_features_host(pcm, true)
    monkeypatch.delenv("DESCRIBEALIGN_FRONTEND")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # the cascade frontend is another result
    cascade = thost.extract_features_host(pcm, true)
    assert not np.allclose(cascade[2], got[2])


def test_device_mel_on_cpu_matches_jax():
    import jax.numpy as jnp
    pcm = _pcm(2)
    x = jnp.asarray(pcm, jnp.float32).astype(jnp.float16).astype(jnp.float32)
    want = [np.asarray(b) for b in jmel.mel_band_features(x)]
    got = tmel.mel_band_features(torch.from_numpy(np.array(x)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def test_features_for_mel_matches_jax(monkeypatch):
    """pipeline.features_for(frontend='mel') (the device extractor's CPU
    path: the plain K1 and K2 for energy and crossings, the torch mel
    bands) against the JAX package's with DESCRIBEALIGN_FRONTEND=mel."""
    pcm = _pcm(1, seconds=7.3, seed=8)
    got, n = tpipe.features_for(pcm, device='cpu', frontend='mel')
    monkeypatch.setenv("DESCRIBEALIGN_FRONTEND", "mel")
    want, n_j = jpipe.features_for(pcm)
    monkeypatch.delenv("DESCRIBEALIGN_FRONTEND")
    assert n == n_j and len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_align_from_pcm_mel_matches_jax(monkeypatch):
    # tests/test_mel_frontend.py:33-38's 30-s pair
    vi, ai = _int16_pair(content_seconds=30.0, narration=(), lead_in=4.0,
                         seed=19)
    got = tapi.align_from_pcm(vi, ai, device='cpu', frontend='mel')
    monkeypatch.setenv("DESCRIBEALIGN_FRONTEND", "mel")
    want = japi.align_from_pcm(vi, ai)
    monkeypatch.delenv("DESCRIBEALIGN_FRONTEND")
    assert np.array_equal(got[3], want[3])                  # the path
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    assert abs(got[2] - want[2]) < 1e-9
    assert abs(float(got[0][0] - got[1][0]) - 4.0) < 0.3
    cascade = tapi.align_from_pcm(vi, ai, device='cpu')
    assert not np.array_equal(cascade[3], got[3])


@pytest.mark.parametrize("entry", ["align_from_pcm", "align_batch_from_pcm",
                                   "combine", "unknown_frontend"])
def test_mel_with_device_features_raises(entry, tmp_path):
    pcm = _pcm(1, seconds=1)
    calls = {
        "align_from_pcm": lambda: tapi.align_from_pcm(
            pcm, pcm, device='cpu', features='device', frontend='mel'),
        "align_batch_from_pcm": lambda: tapi.align_batch_from_pcm(
            [(pcm, pcm)], device='cpu', features='device', frontend='mel'),
        "combine": lambda: describealign_tpu_torch.combine(
            [str(tmp_path)], [str(tmp_path)], yes=True, device='cpu',
            features='device', frontend='mel'),
        "unknown_frontend": lambda: tapi.align_from_pcm(
            pcm, pcm, device='cpu', frontend='stft'),
    }
    with pytest.raises(ValueError, match="frontend="):
        calls[entry]()


def test_tf32_off():
    # describealign_tpu_torch/__init__.py: no TF32 for the mel bands'
    # (F, 257) x (257, 3) product, nor anywhere else
    assert describealign_tpu_torch.__version__
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_aligncache_key_holds_the_frontend(tmp_path):
    video = tmp_path / "v.wav"
    audio = tmp_path / "a.wav"
    video.write_bytes(b"v" * 64)
    audio.write_bytes(b"a" * 64)
    outputs = (np.arange(3.0), np.arange(3.0) + 1, 50.0, np.zeros((3, 2)),
               1.0, 0.5)
    aligncache.save(str(tmp_path), str(video), str(audio), outputs)
    assert aligncache.load(str(tmp_path), str(video), str(audio)) is not None
    assert aligncache.load(str(tmp_path), str(video), str(audio),
                           frontend='mel') is None
    aligncache.save(str(tmp_path), str(video), str(audio), outputs,
                    frontend='mel')
    assert aligncache.load(str(tmp_path), str(video), str(audio),
                           frontend='mel') is not None
    assert aligncache.load(str(tmp_path), str(video), str(audio)) is None
