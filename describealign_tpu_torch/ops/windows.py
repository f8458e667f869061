"""Window helper shared by preprocess and the continuity filter (a copy of
describealign_tpu/ops/windows.py's hann_window)."""
import numpy as np


def hann_window(n):
    """scipy.signal.windows.hann(n) without the scipy dependency.

    Symmetric hann, endpoints zero (matches scipy's default sym=True).
    """
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))
