"""The calling thread's share of the traced batches' wall, in %, spent
waiting for an in-flight slot (alignment/api.py::_pipelined, the
program's `batch.slot_wait` spans): how long the device's bound on
outstanding pairs holds the dispatching thread back."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    batches = [e for e in sp.entries if e.name == "batch"] if sp else []
    if not batches:
        return None
    callers = {e.thread for e in batches}
    waited = sum(r.t1 - r.t0 for r in sp.named("batch.slot_wait")
                 if r.thread in callers)
    return 100.0 * waited / sum(e.t1 - e.t0 for e in batches)
