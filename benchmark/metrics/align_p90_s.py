"""The 90th percentile of every alignment's wall time in the window (the
count is the result's `attempted`)."""
from harness import stats


def read(run):
    return stats.percentile(run.durations, 90) if run.durations else None
