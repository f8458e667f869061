"""The optional mel-filterbank frontend, the port of
describealign_tpu/ops/mel.py.

The default frontend is the reference's 3-band downsample cascade
(ops/features.py, ops/host_features.py). frontend='mel' replaces streams
2-4 with three wide mel-spaced STFT band energies at the same 210 fps grid
and the same log compression, so every later stage (preprocess, matcher,
fit) runs unchanged; the energy and zero-crossing streams stay the
reference's. It is not parity-preserving with the reference by
construction and is off by default. The JAX package reads
DESCRIBEALIGN_FRONTEND; the port takes `frontend=` as an argument.

- mel_band_features_host: numpy on the host, a copy of the JAX package's
  (the PCM on the f16 grid, scipy's rFFT on f32);
- mel_band_features: torch on the tensor's device, f32 throughout (no f16
  rounding, as the JAX device version): frames by one unfold, a window,
  torch.fft.rfft (cuFFT on the card), power, a (F, 257) x (257, 3) product
  in IEEE fp32 (TF32 is off, see the package's __init__) and the log. No
  hand kernel: a library FFT and a thin product, six launches or so.
"""
import numpy as np
import torch

SR = 44100
HOP = 210                 # one frame per 210 samples = 210 fps
N_FFT = 512
N_BANDS = 3
FMIN, FMAX = 100.0, 8000.0
FRONTENDS = ('cascade', 'mel')


def check_frontend(frontend):
    """frontend itself, or a ValueError naming the accepted ones."""
    if frontend not in FRONTENDS:
        raise ValueError(f"frontend={frontend!r}: expected one of "
                         f"{FRONTENDS}")
    return frontend


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, float) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, float) / 2595.0) - 1.0)


def mel_filterbank(n_bands=N_BANDS, n_fft=N_FFT, sr=SR, fmin=FMIN,
                   fmax=FMAX):
    """(n_bands, n_fft//2+1) triangular filters on the mel scale."""
    edges_mel = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_bands + 2)
    edges_hz = _mel_to_hz(edges_mel)
    bins_hz = np.arange(n_fft // 2 + 1) * sr / n_fft
    fb = np.zeros((n_bands, n_fft // 2 + 1), np.float32)
    for b in range(n_bands):
        lo, mid, hi = edges_hz[b], edges_hz[b + 1], edges_hz[b + 2]
        up = (bins_hz - lo) / max(mid - lo, 1e-9)
        down = (hi - bins_hz) / max(hi - mid, 1e-9)
        fb[b] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


def mel_band_features_host(pcm_f16):
    """Three mel band log energies at 210 fps (numpy host version).

    pcm_f16: (C, S). Returns a list of 3 float32 arrays of length S//210.
    """
    import scipy.fft
    arr = (np.mean(pcm_f16, axis=0) if pcm_f16.shape[0] > 1
           else pcm_f16[0]).astype(np.float32)
    n = len(arr) - len(arr) % HOP
    n_frames = n // HOP
    window = np.hanning(N_FFT).astype(np.float32)
    pad = np.zeros(n + N_FFT, np.float32)
    pad[:n] = arr[:n]
    idx = (np.arange(n_frames) * HOP)[:, None] + np.arange(N_FFT)[None, :]
    spec = scipy.fft.rfft(pad[idx] * window, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2) / N_FFT
    bands = power @ mel_filterbank().T                  # (F, 3)
    bands = np.log10(1.0 + bands / 32768.0) / 2.0       # int16-scale comp.
    return [bands[:, b].astype(np.float32) for b in range(N_BANDS)]


def mel_band_features(pcm):
    """The device version (mel.py:77-91): pcm (C, S) f32 tensor. Returns a
    list of 3 f32 tensors of length S//210 on pcm's device.

    Peak memory: the windowed frames (F x 512 f32) and the rFFT's output
    (F x 257 complex64) side by side, ~4.1 KiB per frame: 4.9 GB for a
    95-min film's 1.2 M frames."""
    arr = pcm.mean(dim=0) if pcm.shape[0] > 1 else pcm[0]
    arr = arr.float()
    n = arr.shape[0] - arr.shape[0] % HOP
    n_frames = n // HOP
    window = torch.from_numpy(np.hanning(N_FFT).astype(np.float32)).to(
        arr.device)
    pad = torch.nn.functional.pad(arr[:n], (0, N_FFT))
    frames = pad.unfold(0, N_FFT, HOP)[:n_frames] * window
    spec = torch.view_as_real(torch.fft.rfft(frames, dim=1))
    del frames
    power = (spec[..., 0] ** 2 + spec[..., 1] ** 2) / N_FFT
    del spec
    fb = torch.from_numpy(np.ascontiguousarray(mel_filterbank().T)).to(
        arr.device)
    bands = torch.log10(1.0 + power @ fb / 32768.0) / 2.0
    return list(bands.T.contiguous())
