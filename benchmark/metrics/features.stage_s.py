"""Seconds per alignment that the calling thread spends staging the int16
PCM of the device-feature route into its pinned upload buffer, the zero
tail included (alignment/api.py::_pcm_to_device): the self time of the
program's `features.stage` spans over the traced alignments. None where
the program records no such span (a host-feature route, or a program
without it)."""
from harness import spans_reader


def read(run):
    sp = spans_reader.load(run)
    if sp is None or not sp.entries or not sp.named("features.stage"):
        return None
    return sp.total_self_s("features.stage") / len(sp.entries)
