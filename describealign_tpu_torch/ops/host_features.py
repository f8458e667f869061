"""Host-side feature extraction through the native C++ extractor
(csrc/features.cpp): the reference's 5 streams (describealign.py:545-593)
at 210 fps from int16 PCM.

A copy of describealign_tpu/ops/host_features.py's native path. The port
has neither the numpy fallback nor the mel frontend: a failed build of the
host library raises, and a failed extraction raises.
"""
import ctypes

import numpy as np

from ..alignment.native import native_lib


def extract_features_host(pcm_i16, true_samples=None, out=None):
    """5 feature streams at 210fps from int16 PCM, on the host CPU.

    pcm_i16: (channels, samples) int16 (may carry bucket padding);
    true_samples: real sample count (padding beyond is ignored; the input
    is consumed up to the next 210 multiple so boundary frames match the
    device extractor exactly).

    Returns a list of 5 float32 arrays (lengths may differ by one frame
    between streams, like the reference).

    out: optional caller-zeroed C-contiguous (5, stride) f32 buffer with
    stride >= s//210 + 2; the native extractor then writes the streams
    in place (no intermediate allocation/copy) and the returned arrays
    are row views into it.
    """
    c, s = pcm_i16.shape
    if true_samples is not None:
        s = min(s, -(-int(true_samples) // 210) * 210)
        pcm_i16 = pcm_i16[:, :s]
    # contiguity AFTER the trim: a column slice of a padded stereo array is
    # a strided view, and the ctypes call below hands C++ the raw buffer
    pcm_i16 = np.ascontiguousarray(pcm_i16, np.int16)

    min_stride = s // 210 + 2
    if (out is not None and out.shape[0] == 5
            and out.shape[1] >= min_stride
            and out.dtype == np.float32
            and out.flags['C_CONTIGUOUS']):
        buf, stride = out, out.shape[1]
    else:
        buf, stride = np.zeros((5, min_stride), np.float32), min_stride
    lens = np.zeros(5, np.int64)
    rc = native_lib().extract_features_i16(
        pcm_i16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(c), ctypes.c_int64(s),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(stride),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        if buf is out:
            out[:] = 0.0          # failed write must not leave partial rows
        raise RuntimeError(f"native extract_features_i16 failed ({rc})")
    return [buf[j, :lens[j]] for j in range(5)]
