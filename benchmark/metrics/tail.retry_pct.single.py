"""The share of the traced alignments, in %, that ran the 5-stream coarse
retry (alignment/api.py::_coarse_retry): those whose request counted a
`retry.*` (a margin below the floor, or a path too short)."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    if sp is None or not sp.entries:
        return None
    ids = [e.request for e in sp.entries]
    return 100.0 * sp.retried(ids) / len(ids)
