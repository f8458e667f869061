"""Seconds per alignment in the host tail's pass 2 (line clusters, points,
the refine DP, similarity and nodes: alignment/api.py::
_host_stages_from_path_inner): the self time of the program's `tail.pass2`
spans over the traced alignments."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    if sp is None or not sp.entries or not sp.named("tail.pass2"):
        return None
    return sp.total_self_s("tail.pass2") / len(sp.entries)
