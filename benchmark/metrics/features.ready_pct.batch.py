"""The share of the traced batches' pairs, in %, whose two host feature
streams were both extracted when the dispatching thread asked for them:
the pairs whose request counted `features.ready` rather than
`features.waited` (alignment/api.py::_upload_pair_features, fed by the
batch's feature pool). None where no pair counted either, as in a program
without the feature pool."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    pairs = sp.pairs() if sp is not None else []
    counts = [sp.counters.get(i, {}) for i in pairs]
    ready = sum(c.get("features.ready", 0) for c in counts)
    asked = ready + sum(c.get("features.waited", 0) for c in counts)
    if not asked:
        return None
    return 100.0 * ready / asked
