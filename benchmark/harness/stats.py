"""The arithmetic of the end-to-end and per-layer metrics."""
import numpy as np


def rate(count, window_s):
    """Work per second over the whole window."""
    return count / window_s


def percentile(values, q):
    """The q-th percentile of values, linear between order statistics
    (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def merge(intervals):
    """The union of (start, end) intervals as a sorted list of disjoint
    intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy(intervals, lo, hi):
    """Seconds of [lo, hi] that the union of intervals covers: a device's
    busy time, each moment counted once however many operations overlap."""
    return sum(e - s for s, e in clip(merge(intervals), lo, hi))


def gaps(intervals, lo, hi):
    """The (start, end) gaps of [lo, hi] that the union leaves free."""
    out, cursor = [], lo
    for s, e in clip(merge(intervals), lo, hi):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        out.append((cursor, hi))
    return out
