"""The share of the traced alignments, in %, whose features were computed
on the card: those whose request counted `features.device`
(alignment/api.py: the device branch of align_from_pcm, once per pair in
_align_batch_device's dispatch). None where no traced alignment counted
it, as with a program without the counter; in a cell that lists this
metric, its absence from a traced run's line is itself the alarm that the
traffic took the host route."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    if sp is None or not sp.entries:
        return None
    ids = [e.request for e in sp.entries]
    hit = sum(1 for i in ids
              if sp.counters.get(i, {}).get("features.device", 0))
    if not hit:
        return None
    return 100.0 * hit / len(ids)
