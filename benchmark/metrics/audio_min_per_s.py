"""Description audio-minutes of the batches completed in the window, per
second of the window."""
from harness import stats


def read(run):
    minutes = sum(p.audio_s for req in run.pairs_done for p in req) / 60.0
    return stats.rate(minutes, run.window_s) if run.pairs_done else None
