"""Seconds per alignment: the window over the alignments completed in it
(one pair a request)."""
from harness import stats


def read(run):
    n = sum(len(req) for req in run.pairs_done)
    return 1.0 / stats.rate(n, run.window_s) if n else None
