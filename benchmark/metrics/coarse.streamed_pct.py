"""The share, in %, of the traced alignments' coarse passes that ran the
streamed DP: of the passes counted `coarse.streamed` or
`coarse.materialized` (alignment/matching.py::_coarse_tracks, one count a
pass, the 5-stream retry's included) on the traced entries' requests and
their pairs', those counted `coarse.streamed`. None where no pass counted
either, as with a program without the counters."""
from harness import spans_reader

STREAMED, MATERIALIZED = "coarse.streamed", "coarse.materialized"


def read(run):
    sp = spans_reader.load(run)
    if sp is None or not sp.entries:
        return None
    counts = [sp.counters.get(i, {}) for i in sp.requests]
    streamed = sum(c.get(STREAMED, 0) for c in counts)
    passes = streamed + sum(c.get(MATERIALIZED, 0) for c in counts)
    if not passes:
        return None
    return 100.0 * streamed / passes
