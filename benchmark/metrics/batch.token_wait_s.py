"""Seconds per batch that threads wait for the host-core token
(alignment/api.py::_HOST_TOKEN, the program's `batch.token_wait` spans),
summed over the calling thread and the pool threads."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    batches = [e for e in sp.entries if e.name == "batch"] if sp else []
    if not batches:
        return None
    waited = sum(r.t1 - r.t0 for r in sp.named("batch.token_wait"))
    return waited / len(batches)
