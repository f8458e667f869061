"""Pitch-shifting resampler, the host path of
describealign_tpu/stretch/resample.py (its default).

Replaces the reference's chunked scipy quadratic-spline interpolator
(describealign.py:233-244): evaluates the description waveform at uniformly
spaced fractional sample positions, changing pitch with rate. Used when the
pitch shift is imperceptible (<=0.5%), the offset is tiny (<30 samples), or
--no_pitch_correction is set. A 3-point quadratic Lagrange weighting at
float64 sample positions, in one pass of the host library's
`resample_quad` (csrc/features.cpp). The device resampler of the JAX
package is not ported.
"""
import ctypes

import numpy as np

from ..alignment.native import native_lib


def resample_segment(audio_arr, x_start, x_end, num_out):
    """Stretch audio_arr[:, x_start:x_end] to num_out samples.

    Mirrors the reference's sample_points = linspace(x_start, x_end,
    num_out, endpoint=False) evaluation (describealign.py:412-414).
    Returns (C, num_out) float32 on the f16 grid (like the reference's f16
    write-back).
    """
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
