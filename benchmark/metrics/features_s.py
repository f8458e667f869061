"""Seconds per alignment of the host features and their upload
(alignment/api.py::host_features_padded, ops/host_features.py,
csrc/features.cpp; in the film the stacking and the f16 upload): the
program's own timings= split 'features', averaged over the traced
alignments."""


def read(run):
    vals = [t["features"] for t in run.timings if "features" in t]
    return sum(vals) / len(vals) if vals else None
