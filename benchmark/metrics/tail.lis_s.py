"""Seconds per alignment in the native LIS (alignment/api.py::
_consume_stream, alignment/lis.py::lis_from_match): the self time of the
program's `tail.lis` spans, less the device-to-host fetches inside them,
over the traced alignments."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    if sp is None or not sp.entries or not sp.named("tail.lis"):
        return None
    return sp.total_self_s("tail.lis") / len(sp.entries)
