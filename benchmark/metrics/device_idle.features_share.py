"""The traced window's share, in %, in which a card is idle while some
thread extracts host features (the program's `features.host` spans),
averaged over the cell's cards."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    if sp is None or not run.trace.ops:
        return None
    return spans_reader.idle_share(run, sp.union(("features.host",)))
