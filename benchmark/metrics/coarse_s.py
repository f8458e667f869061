"""Seconds per alignment of the coarse stage (alignment/matching.py,
ops/coarse_map.py, ops/coarse_dp.py): the program's own timings= splits
'coarse_map' + 'coarse_dp', averaged over the traced alignments."""


def read(run):
    vals = [t["coarse_map"] + t["coarse_dp"] for t in run.timings
            if "coarse_map" in t and "coarse_dp" in t]
    return sum(vals) / len(vals) if vals else None
