"""Seconds per alignment of the native LIS and the host tail
(alignment/lis.py, native.py, refine*.py, continuity.py, fit.py,
outputs.py): the program's own timings= split 'lis_tail', averaged over
the traced alignments."""


def read(run):
    vals = [t["lis_tail"] for t in run.timings if "lis_tail" in t]
    return sum(vals) / len(vals) if vals else None
