"""Seconds per alignment in the host tail's pass 1 (continuity filter,
rescale, compression, L1 fit: alignment/api.py::
_host_stages_from_path_inner): the self time of the program's `tail.pass1`
spans over the traced alignments."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    if sp is None or not sp.entries or not sp.named("tail.pass1"):
        return None
    return sp.total_self_s("tail.pass1") / len(sp.entries)
