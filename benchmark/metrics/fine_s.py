"""Seconds per alignment of the fine pass (ops/fine_kernel.py): the
program's own timings= split 'fine', averaged over the traced
alignments."""


def read(run):
    vals = [t["fine"] for t in run.timings if "fine" in t]
    return sum(vals) / len(vals) if vals else None
