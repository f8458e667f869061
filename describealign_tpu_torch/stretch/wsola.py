"""WSOLA-style pitch-preserving splicer, a copy of
describealign_tpu/stretch/wsola.py (the JAX package's default stretcher).

The reference's pitch-corrected stretch (describealign.py:296-387) does not
resample: it repeats or skips ~512-sample spans of the original waveform at
maximally self-similar positions (chosen by a DP over Pearson
autocorrelations) and splices with Hann crossfades, preserving pitch and
timbre exactly.

Host implementation: the windowed autocorrelations are vectorized numpy
(the cumulative-sum trick of describealign.py:272-291, computed in bounded
chunks), and the window-by-window DP runs as a Python loop over numpy rows
like the reference's.
"""
import numpy as np

from ..constants import MIN_STRETCH_OFFSET
from ..ops.windows import hann_window

WINDOW_SIZE = 512
MAX_DRIFT = 512 * 3


def _pearson_corrs(signal, negative, jumps, window_size=WINDOW_SIZE,
                   chunk_windows=50):
    """Yield per-window (window_size, len(jumps)) Pearson correlation rows.

    Streaming equivalent of the reference's recursive generator
    (describealign.py:251-294): correlation of each window with the window
    `jump` samples before (negative=True) or after it, via cumulative sums
    of lagged products; memory bounded by `chunk_windows`.
    """
    n = signal.shape[1]
    num_windows = n // window_size
    jumps = np.asarray(list(jumps))
    start_w = 0
    while start_w < num_windows:
        end_w = min(start_w + chunk_windows, num_windows)
        # samples needed: the windows plus max(jump) lookback/ahead + window
        lo = max(0, start_w * window_size - int(jumps.max()) - window_size)
        hi = min(n, end_w * window_size + int(jumps.max()) + window_size)
        seg = signal[:, lo:hi].astype(np.float32)
        m = seg.shape[1]
        self_corr = np.sum(seg * seg, axis=0)
        cs = np.cumsum(self_corr, dtype=np.float64)
        cs[window_size:] -= cs[:-window_size].copy()
        window_rms = cs[window_size - 1:]
        epsilon = 1e-4 * max(1, np.max(window_rms))
        window_rms = np.sqrt(window_rms + epsilon)
        corrs = np.full((len(jumps), m - window_size + 1), -np.inf)
        for ji, jump in enumerate(jumps):
            ac = np.sum(seg[:, jump:] * seg[:, :m - jump], axis=0)
            acs = np.cumsum(ac, dtype=np.float64)
            acs[window_size:] -= acs[:-window_size].copy()
            vals = acs[window_size - 1:] + epsilon
            if negative:
                corrs[ji, jump:] = vals / window_rms[:len(window_rms) - jump]
            else:
                corrs[ji, :corrs.shape[1] - jump] = vals / window_rms[jump:]
        corrs = (corrs / window_rms[None, :]).T
        for w in range(start_w, end_w):
            s = w * window_size - lo
            yield corrs[s:s + window_size]
        start_w = end_w


def _jump_menu(total_offset, window_size):
    """Behavioral constants of the reference splicer (describealign.py:
    301-308): the default self-similarity lags, widened (or replaced by the
    full lag range) when the requested offset is small enough that the
    Frobenius coin problem makes it unreachable from the default menu."""
    menu = [506, 451, 284, 410, 480, 379, 308, 430, 265, 494]
    if abs(total_offset) >= 10000:
        return menu
    if abs(total_offset) > 1000:
        return menu + [MIN_STRETCH_OFFSET + (1 << p) - 1 for p in range(8)]
    return list(range(MIN_STRETCH_OFFSET, window_size))


def _shifted(row, k, width):
    """dst[d] = row[d + k] with +inf outside; the DP's drift re-labeling."""
    out = np.full(width, np.inf)
    if k >= 0:
        out[:width - k] = row[k:]
    else:
        out[-k:] = row[:width + k]
    return out


def wsola_stretch(input_seg, output, window_size=WINDOW_SIZE,
                  max_drift=MAX_DRIFT):
    """Fill `output` (C, n_out) with a pitch-preserving stretch of
    `input_seg` (C, n_in) by repeating/skipping self-similar spans.

    Reference semantics (describealign.py:296-387): a DP over (window,
    accumulated drift from the nominal linear schedule) chooses where to
    repeat or skip a lag-sized span; chosen joins are spliced with Hann
    crossfades. Output longer than input -> repeats; shorter -> skips.
    """
    n_in = input_seg.shape[1]
    n_out = output.shape[1]
    total_offset = n_out - n_in
    width = max_drift * 2 + 1
    jumps = _jump_menu(total_offset, window_size)
    num_windows = n_in // window_size

    def scheduled(w):
        """Nominal (monotone) drift after window w."""
        w = min(num_windows - 1, max(0, w))
        return (total_offset * w) // (num_windows - 1)

    def sched_step(w):
        return abs(scheduled(w) - scheduled(w - 1))

    # forward DP. State: accumulated |drift - schedule| axis (index
    # max_drift = on schedule). A jump must come from TWO windows back so
    # crossfades never overlap (ref 340-343); hence two rolling rows.
    choice = np.zeros((num_windows, width), np.int16)      # 0=stay, 1+ji=jump
    jump_at = np.zeros((num_windows, len(jumps)), np.int16)
    prev = np.full(width, np.inf)        # cum loss, window w-1
    prev2 = np.full(width, np.inf)       # cum loss, window w-2
    prev[max_drift] = prev2[max_drift] = 0.0
    step_prev = 0
    corr_stream = _pearson_corrs(input_seg, total_offset > 0, jumps)
    lane = np.arange(width)
    for w in range(num_windows):
        corrs = next(corr_stream)                     # (window, n_jumps)
        best_loc = np.argmax(corrs, axis=0)
        jump_at[w] = best_loc
        jump_loss = 1.0 - corrs[best_loc, np.arange(len(jumps))]
        step = sched_step(w)
        two_step = step + step_prev
        cands = np.empty((1 + len(jumps), width))
        cands[0] = _shifted(prev, step, width)        # follow the schedule
        for ji, jump in enumerate(jumps):
            row = _shifted(prev2, two_step - jump, width) + jump_loss[ji]
            row[:jump] = np.inf                       # drift cannot go
            cands[1 + ji] = row                       # below the jump size
        pick = np.argmin(cands, axis=0)
        choice[w] = pick
        cur = cands[pick, lane]
        prev2, prev = prev, cur
        step_prev = step

    # backtrace: walk the drift axis back through the schedule, collecting
    # (position, lag) for every window where a jump was taken
    joins = []
    d = max_drift
    w = num_windows - 1
    while w >= 0:
        d += sched_step(w + 1)
        ji = int(choice[w, d]) - 1
        if ji < 0:
            w -= 1
            continue
        lag = jumps[ji]
        joins.append((w * window_size + int(jump_at[w, ji]), lag))
        d -= lag
        w -= 2          # the jump consumed the in-between window too
        d += sched_step(w + 2)
    joins.reverse()

    sign = -1 if total_offset > 0 else 1
    cut_end = np.array([p for p, _ in joins] + [n_in], np.int64)
    cut_start = np.array([0] + [p + sign * lag for p, lag in joins], np.int64)

    # splice: bulk-copy each span, then Hann-crossfade at every join
    # (head + tail of hann(2W+1) sum to 1, so the first span is exact)
    out_end = np.cumsum(cut_end - cut_start)
    out_start = out_end - (cut_end - cut_start)
    bump = hann_window(2 * window_size + 1)
    head, tail = bump[:window_size], bump[window_size:-1]
    output[:, :window_size] = input_seg[:, :window_size]
    for k in range(len(cut_start)):
        si, ei, so, eo = cut_start[k], cut_end[k], out_start[k], out_end[k]
        if k > 0:
            prev_ei = cut_end[k - 1]
            output[:, so:so + window_size] = (
                input_seg[:, prev_ei:prev_ei + window_size] * tail
                + input_seg[:, si:si + window_size] * head)
        output[:, so + window_size:eo + window_size] = \
            input_seg[:, si + window_size:ei + window_size]
