"""The traced window's share, in %, in which a card is idle while some
thread is in the host tail (the program's `tail.*` spans: fetches, LIS,
pass 1, pass 2, retry) and none extracts host features, averaged over the
cell's cards: disjoint from device_idle.features_share."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    if sp is None or not run.trace.ops:
        return None
    tail = spans_reader.minus(sp.union(prefix="tail."),
                              sp.union(("features.host",)))
    return spans_reader.idle_share(run, tail)
