"""Continuity filtering and path compression (host numpy + native C++).

Jax-free twin of describealign_tpu/alignment/continuity.py, whose import
of SAMPLES_PER_NODE from its preprocess module reaches jax. Same code and
reference semantics (describealign.py:702-767):
- get_continuity_err: distance of each point to the better of its past
  and future half-hann-smoothed local linear fits;
- continuity_filter: drop points with continuity error >= 3;
- compress_path: runs of 70 well-fit points collapse to their mean;
  duplicate audio indices are deduped by averaging their video indices.
"""
import ctypes

import numpy as np

from ..ops.windows import hann_window
from .native import native_lib
from .preprocess import SAMPLES_PER_NODE

_HALF = SAMPLES_PER_NODE // 2              # 10
_FIT_DELAY = SAMPLES_PER_NODE + _HALF - 2  # 29
_F64P = ctypes.POINTER(ctypes.c_double)


def _conv(x, taps, mode):
    """np.convolve(x, taps, mode) for f64 data via the native tap-major
    kernel; numpy for inputs shorter than the taps."""
    lib = native_lib()
    if len(x) >= len(taps):
        x = np.ascontiguousarray(x, np.float64)
        taps = np.ascontiguousarray(taps, np.float64)
        same = 1 if mode == 'same' else 0
        out = np.empty(len(x) if same else len(x) - len(taps) + 1)
        if len(out) > 0 and lib.conv_f64(
                x.ctypes.data_as(_F64P), ctypes.c_longlong(len(x)),
                taps.ctypes.data_as(_F64P), ctypes.c_longlong(len(taps)),
                ctypes.c_int(same), out.ctypes.data_as(_F64P)) == 0:
            return out
    return np.convolve(x, taps, mode=mode)


def _half_hann_taps():
    w = hann_window(2 * SAMPLES_PER_NODE + 1)[1:-1]
    w = w / np.sum(w)
    half = w[:SAMPLES_PER_NODE - 1]
    return half / np.sum(half)


def get_continuity_err(x, y, deriv=False):
    """Distance of each point to its local (past or future) linear fit."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    taps = _half_hann_taps()

    def diff_by(arr, offset=_HALF):
        return arr[offset:] - arr[:-offset]

    x_fut = _conv(x, taps, 'valid')
    y_fut = _conv(y, taps, 'valid')
    slopes_fut = diff_by(y_fut) / diff_by(x_fut)
    offsets_fut = y_fut[:-_HALF] - x_fut[:-_HALF] * slopes_fut

    x_past = _conv(x, taps[::-1], 'valid')
    y_past = _conv(y, taps[::-1], 'valid')
    slopes_past = diff_by(y_past) / diff_by(x_past)
    offsets_past = y_past[_HALF:] - x_past[_HALF:] * slopes_past

    err = np.full(len(x) - (1 if deriv else 0), np.inf)
    fd = _FIT_DELAY - (1 if deriv else 0)
    err[:-fd] = np.abs(slopes_fut * x[:-_FIT_DELAY]
                       + offsets_fut - y[:-_FIT_DELAY])
    err[fd:] = np.minimum(err[fd:],
                          np.abs(slopes_past * x[_FIT_DELAY:]
                                 + offsets_past - y[_FIT_DELAY:]))
    return err


def continuity_filter(x, y, threshold=3.0):
    """Keep the points whose continuity error is below threshold (one fused
    native pass, bit-equal to the numpy chain it falls back to)."""
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    lib = native_lib()
    if len(x) == len(y):
        taps = np.ascontiguousarray(_half_hann_taps(), np.float64)
        out_x = np.empty_like(x)
        out_y = np.empty_like(y)
        out_n = ctypes.c_longlong(0)
        rc = lib.continuity_filter_f64(
            x.ctypes.data_as(_F64P), y.ctypes.data_as(_F64P),
            ctypes.c_longlong(len(x)), taps.ctypes.data_as(_F64P),
            ctypes.c_longlong(len(taps)), ctypes.c_longlong(_HALF),
            ctypes.c_double(threshold), out_x.ctypes.data_as(_F64P),
            out_y.ctypes.data_as(_F64P), ctypes.byref(out_n))
        if rc == 0:
            m = out_n.value
            return out_x[:m].copy(), out_y[:m].copy()
    keep = get_continuity_err(x, y) < threshold
    return x[keep], y[keep]


def _smooth_mean(arr):
    """41-tap hann local mean (reference get_mean, 596-599)."""
    w = hann_window(2 * SAMPLES_PER_NODE + 1)[1:-1]
    w = w / np.sum(w)
    return _conv(np.asarray(arr, np.float64), w, 'same')[:len(arr)]


def compress_path(x, y, run=70, err_threshold=3.0):
    """Collapse well-fit runs to their means; dedupe repeated audio indices.

    Returns (x_nodes f64, y_nodes f64) with strictly increasing x.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    smooth_x = _smooth_mean(x)
    smooth_y = _smooth_mean(y)
    slopes = np.diff(smooth_y) / np.diff(smooth_x)
    offsets = smooth_y[:-1] - smooth_x[:-1] * slopes
    err_y = slopes * x[:-1] + offsets - y[:-1]

    # the element sequence matches the reference loop exactly, including its
    # tail handling when the loop body is empty
    starts = np.arange(10, max(len(x) - run - 10, 10), run)
    if len(starts):
        ok = np.abs(err_y) < err_threshold
        csum = np.concatenate([[0], np.cumsum(ok)])
        flags = (csum[starts + run] - csum[starts]) == run
        fstarts = starts[flags]
        if len(fstarts):
            idx = fstarts[:, None] + np.arange(run)[None, :]
            mean_x = np.mean(x[idx], axis=1)
            mean_y = np.mean(y[idx], axis=1)
        last = starts[-1]
        # flagged runs write one mean; unflagged runs copy their points
        pos = np.empty(len(starts) + 1, np.int64)
        pos[0] = 10
        np.cumsum(np.where(flags, 1, run), out=pos[1:])
        pos[1:] += 10
        tail_n = len(x[last + run:last + 2 * run])
        cx = np.empty(pos[-1] + tail_n)
        cy = np.empty_like(cx)
        cx[:10] = x[:10]
        cy[:10] = y[:10]
        fpos = pos[:-1][flags]
        if len(fstarts):
            cx[fpos] = mean_x
            cy[fpos] = mean_y
        for k in np.flatnonzero(~flags):
            p, s = pos[k], starts[k]
            cx[p:p + run] = x[s:s + run]
            cy[p:p + run] = y[s:s + run]
        cx[pos[-1]:] = x[last + run:last + 2 * run]
        cy[pos[-1]:] = y[last + run:last + 2 * run]
    else:
        last = 10 - run
        cx = np.concatenate([x[:10], x[last + run:last + 2 * run]])
        cy = np.concatenate([y[:10], y[last + run:last + 2 * run]])
    # dedupe: average video indices of equal audio indices in
    # first-occurrence order (reference 760-767)
    if len(cx) > 1 and np.all(np.diff(cx) >= 0):
        # non-decreasing cx: equal values are contiguous groups
        starts_g = np.concatenate(
            [[0], np.flatnonzero(np.diff(cx) != 0) + 1])
        sums = np.add.reduceat(cy, starts_g)
        counts = np.diff(np.concatenate([starts_g, [len(cx)]]))
        return cx[starts_g], sums / counts
    x_unique, first_idx, inverse = np.unique(cx, return_index=True,
                                             return_inverse=True)
    sums = np.zeros(len(x_unique))
    counts = np.zeros(len(x_unique))
    np.add.at(sums, inverse, cy)
    np.add.at(counts, inverse, 1)
    means = sums / counts
    order = np.argsort(first_idx)
    return x_unique[order], means[order]
