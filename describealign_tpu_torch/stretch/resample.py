"""Pitch-shifting resampler, on the host or on the device
(describealign_tpu/stretch/resample.py).

Replaces the reference's chunked scipy quadratic-spline interpolator
(describealign.py:233-244): evaluates the description waveform at uniformly
spaced fractional sample positions, changing pitch with rate. Used when the
pitch shift is imperceptible (<=0.5%), the offset is tiny (<30 samples), or
--no_pitch_correction is set. A 3-point quadratic Lagrange weighting:

- backend='host' (the JAX package's default): float64 sample positions, in
  one pass of the host library's `resample_quad` (csrc/features.cpp);
- backend='device': the JAX package's `_resample_full` in torch on
  `device` - float32 positions start + step * i (one rounding, as XLA's
  fused multiply-add computes them), half-to-even rounding,
  bases clipped to [1, pad - 2] of the JAX program's zero-padded bucket -
  one gather plus weights (~10 launches per segment, no hand kernel). The
  bucket is not allocated: samples past the array's end read as zeros, as
  they do in the bucket.
"""
import ctypes

import numpy as np
import torch

from ..alignment.native import native_lib
from ..constants import AUDIO_SAMPLE_RATE

MIN_BUCKET = AUDIO_SAMPLE_RATE * 2  # segments are >= 2 s by the rules
RESAMPLE_BACKENDS = ('host', 'device')


def _bucket(n):
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


def _resample_host(audio_arr, x_start, x_end, num_out):
    a = np.ascontiguousarray(audio_arr, np.float32)
    out = np.empty((a.shape[0], num_out), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = native_lib().resample_quad(
        a.ctypes.data_as(fp), ctypes.c_int64(a.shape[0]),
        ctypes.c_int64(a.shape[1]), ctypes.c_double(float(x_start)),
        ctypes.c_double(float(x_end)), ctypes.c_int64(int(num_out)),
        out.ctypes.data_as(fp))
    if rc != 0:
        raise ValueError(f"native resample_quad failed ({rc})")
    return out


def _resample_device(audio_arr, x_start, x_end, num_out, device):
    """resample_segment's device half (resample.py:106-116 with
    `_resample_full`, 34-46, of the JAX package) on `device`."""
    device = torch.device(device)
    c = audio_arr.shape[0]
    step = (x_end - x_start) / num_out
    in0 = max(int(np.floor(x_start)) - 4, 0)
    n_in = int(np.ceil(x_end - in0)) + 8
    pad = _bucket(max(n_in, num_out))             # the JAX program's bucket
    hi = min(in0 + pad, audio_arr.shape[1])
    # start + step * i with one rounding to f32, as the JAX program's
    # fused multiply-add gives it (the f64 product of two f32 is exact)
    pos = (float(np.float32(x_start - in0)) + float(np.float32(step))
           * torch.arange(num_out, dtype=torch.float64, device=device)
           ).to(torch.float32)
    base = torch.clamp(torch.round(pos).to(torch.int64), 1, pad - 2)
    t = pos - base.to(torch.float32)              # in [-.5, .5]
    w_m1 = 0.5 * t * (t - 1.0)
    w_0 = (1.0 - t) * (1.0 + t)
    w_p1 = 0.5 * t * (t + 1.0)
    # the bucket's samples: the array from in0, zeros past its end
    seg = torch.zeros((c, max(hi - in0, int(base[-1]) + 2)),
                      dtype=torch.float32, device=device)
    if hi > in0:
        seg[:, :hi - in0] = torch.from_numpy(np.ascontiguousarray(
            audio_arr[:, in0:hi], np.float32)).to(device)
    out = (w_m1 * seg[:, base - 1] + w_0 * seg[:, base]
           + w_p1 * seg[:, base + 1])
    return out.half().float().cpu().numpy()


def resample_segment(audio_arr, x_start, x_end, num_out, backend='host',
                     device='cuda'):
    """Stretch audio_arr[:, x_start:x_end] to num_out samples.

    Mirrors the reference's sample_points = linspace(x_start, x_end,
    num_out, endpoint=False) evaluation (describealign.py:412-414).
    backend: 'host' (the default, as in the JAX package) or 'device' (on
    `device`). Returns (C, num_out) float32 on the f16 grid (like the
    reference's f16 write-back).
    """
    if backend not in RESAMPLE_BACKENDS:
        raise ValueError(f"unknown resampler backend: {backend!r} "
                         f"(expected one of {RESAMPLE_BACKENDS})")
    if backend == 'host':
        return _resample_host(audio_arr, x_start, x_end, num_out)
    return _resample_device(np.asarray(audio_arr), x_start, x_end, num_out,
                            device)
