"""The share of the traced batches' pairs, in %, that ran the 5-stream
coarse retry (alignment/api.py::_coarse_retry, on a pool thread): the
pairs whose request counted a `retry.*`."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    pairs = sp.pairs() if sp is not None else []
    if not pairs:
        return None
    return 100.0 * sp.retried(pairs) / len(pairs)
