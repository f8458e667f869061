"""Window helpers shared by preprocess, the continuity filter and the
feature extractor (a copy of describealign_tpu/ops/windows.py)."""
import numpy as np


def hann_window(n):
    """scipy.signal.windows.hann(n) without the scipy dependency.

    Symmetric hann, endpoints zero (matches scipy's default sym=True).
    """
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))


def hann_taps(n_plus_2, dtype=np.float32):
    """The reference's canonical smoothing taps: hann(n+2) with the zero
    endpoints dropped, normalized to unit sum (describealign.py:551-552);
    a copy of describealign_tpu/ops/windows.py's, so the f32 values (and
    numpy's pairwise sum) are the JAX package's bit for bit."""
    w = hann_window(n_plus_2)[1:-1].astype(dtype)
    return w / np.sum(w)
