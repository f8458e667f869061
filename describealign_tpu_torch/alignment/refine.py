"""Pass-2 refinement: colinear clustering, per-line refit, dense scoring.

Jax-free twin of describealign_tpu/alignment/refine.py's native path
(reference describealign.py:860-944), without its sortedcontainers import
and pure-Python fallbacks. build_line_clusters groups smooth-path points
into colinear clusters and refits each line; build_points_flat applies the
sub-frame offset correction and scores every audio frame in each cluster's
(+/-30 s extended) range in C++. The cluster-switch DP that follows is
refine_native.refine_dp_flat.
"""
import ctypes
from collections import defaultdict

import numpy as np

from .native import native_lib

EXTEND_RADIUS = 210 * 30

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)


def _round6(arr):
    """Per-element Python round(v, 6) (correctly-rounded decimal,
    half-to-even on decimal ties) via glibc's %.6f/strtod in C++."""
    arr = np.ascontiguousarray(arr, np.float64)
    out = np.empty_like(arr)
    if native_lib().round_decimals6_f64(arr.ctypes.data_as(_F64P),
                                        ctypes.c_longlong(arr.size),
                                        out.ctypes.data_as(_F64P)) != 0:
        raise RuntimeError("native round_decimals6_f64 failed")
    return out.tolist()


def build_line_clusters(smooth_path, slopes):
    """Colinear clustering + merge + least-squares refit (reference
    860-893). Returns [(x points, offset, slope)] per kept cluster."""
    slopes_plus_ends = np.hstack((slopes[:1], slopes, slopes[-1:]))
    px_arr = np.asarray([p[0] for p in smooth_path], float)
    py_arr = np.asarray([p[1] for p in smooth_path], float)
    n = len(px_arr)
    # both candidate lines per point; append order stays point-major like
    # the reference (the merge reads cluster endpoints)
    ks = []
    for s_arr in (slopes_plus_ends[:n], slopes_plus_ends[1:n + 1]):
        ks.append((_round6(s_arr),
                   np.rint(py_arr - s_arr * px_arr).astype(
                       np.int64).tolist(),
                   ((s_arr >= .1) & (s_arr <= 10)).tolist()))
    colinear = defaultdict(list)
    pts = list(zip(px_arr.tolist(), py_arr.tolist()))
    for i in range(n):
        for keys_s, keys_o, ok in ks:
            if ok[i]:
                colinear[(keys_s[i], keys_o[i])].append(pts[i])

    line_clusters = []
    added = set()
    for (slope, offset), pts in sorted(colinear.items(),
                                       key=lambda kv: -len(kv[1])):
        if (slope, offset) in added:
            continue
        line_clusters.append(pts)
        added.add((slope, offset))
        del colinear[(slope, offset)]
        for (slope2, offset2), pts2 in list(colinear.items()):
            if (abs(pts2[0][1] - (pts2[0][0] * slope + offset)) < 3
                    and abs(pts2[-1][1] - (pts2[-1][0] * slope + offset)) < 3):
                line_clusters[-1].extend(colinear[(slope2, offset2)])
                added.add((slope2, offset2))
                del colinear[(slope2, offset2)]
    line_clusters = [sorted(c) for c in line_clusters]
    line_clusters = [c for c in line_clusters
                     if (abs(c[0][0] - c[-1][0]) > 10) and len(c) > 5]

    refit = []
    for cluster in line_clusters:
        cx, cy = np.array(cluster).T
        design = np.hstack((np.ones((len(cx), 1)), cx[:, None]))
        coef = np.linalg.lstsq(design, cy, rcond=None)[0]
        refit.append((cx, coef[0], coef[1]))  # (x points, offset, slope)
    return refit


def _cluster_limits(cx, offset, slope, na, nv, extend_horiz=EXTEND_RADIUS,
                    buffer_vert=4):
    limits = (max(int(cx[0]) - extend_horiz, 0),
              min(int(cx[-1]) + extend_horiz, na - 1))
    return (max(limits[0], int(np.ceil((buffer_vert - offset) / slope))),
            min(limits[1],
                int(np.floor((nv - buffer_vert - offset) / slope))))


def _offset_correction(lib, limits, slope, offset, audio_scaled,
                       video_scaled):
    """Sub-frame offset correction via the feature time-derivative
    (reference 916-930) from the native pass's sufficient statistics: for
    a rank-1 design, lstsq's solution and residual are num/den and
    sq - num^2/den."""
    valid = ctypes.c_longlong(0)
    num = ctypes.c_double(0.0)
    den = ctypes.c_double(0.0)
    sq = ctypes.c_double(0.0)
    rc = lib.refine_offset_stats(
        audio_scaled.ctypes.data_as(_F32P),
        ctypes.c_longlong(len(audio_scaled)),
        video_scaled.ctypes.data_as(_F32P),
        ctypes.c_longlong(len(video_scaled)),
        ctypes.c_double(slope), ctypes.c_double(offset),
        ctypes.c_longlong(limits[0]), ctypes.c_longlong(limits[1]),
        ctypes.byref(valid), ctypes.byref(num), ctypes.byref(den),
        ctypes.byref(sq))
    if rc != 0:
        raise RuntimeError("native refine_offset_stats failed")
    if valid.value > 50 and den.value > 0 and sq.value > 0:
        lin_fit = num.value / den.value
        residual = sq.value - num.value * num.value / den.value
        explained = 1.0 - residual / sq.value
        stds_above = np.sqrt(max(explained, 0.0)
                             * (3.0 * valid.value)) - 1.0
        if stds_above > 8 and abs(lin_fit) < 2:
            return offset + lin_fit
    return offset


def build_points_flat(line_clusters, audio_scaled, video_scaled):
    """Per-frame candidate points of every cluster line, as flat arrays for
    the native DP (reference 895-944).

    audio_scaled, video_scaled: (N, 3) f32 C-contiguous. Returns (pj, pc,
    pq, offsets): points sorted by (audio frame, video pos, cluster, qual);
    offsets[i]..offsets[i+1] index frame i's points. The first-processed
    cluster wins duplicate (frame, int(video)) points.
    """
    lib = native_lib()
    na = len(audio_scaled)
    nv = len(video_scaled)
    amax = float(np.max(audio_scaled[:, 0]))
    vmax = float(np.max(video_scaled[:, 0]))

    all_i, all_j, all_c, all_q = [], [], [], []
    for cluster_index, (cx, offset, slope) in enumerate(line_clusters):
        limits = _cluster_limits(cx, offset, slope, na, nv, extend_horiz=0)
        if limits[1] < limits[0] + 5:
            continue
        if limits[1] > limits[0] + 100:
            offset = _offset_correction(lib, limits, slope, offset,
                                        audio_scaled, video_scaled)
        limits = _cluster_limits(cx, offset, slope, na, nv)
        xs = np.arange(*limits)
        quals = np.empty(limits[1] - limits[0], np.float64)
        rc = lib.refine_score_cluster(
            audio_scaled.ctypes.data_as(_F32P), ctypes.c_longlong(na),
            video_scaled.ctypes.data_as(_F32P), ctypes.c_longlong(nv),
            ctypes.c_double(slope), ctypes.c_double(offset),
            ctypes.c_longlong(limits[0]), ctypes.c_longlong(limits[1]),
            ctypes.c_double(amax), ctypes.c_double(vmax),
            quals.ctypes.data_as(_F64P))
        if rc != 0:
            raise RuntimeError("native refine_score_cluster failed")
        all_i.append(xs)
        all_j.append(slope * xs + offset)
        all_c.append(np.full(len(xs), cluster_index, np.int64))
        all_q.append(quals)
    if not all_i:
        return (np.empty(0), np.empty(0, np.int64), np.empty(0),
                np.zeros(na + 1, np.int64))
    pi = np.concatenate(all_i).astype(np.int64)
    pj = np.concatenate(all_j)
    pc = np.concatenate(all_c)
    pq = np.concatenate(all_q)
    # one stable sort on the (frame, int(video)) key dedupes (first
    # occurrence in cluster order wins) and yields the final order
    keys = pi * np.int64(nv + 2) + pj.astype(np.int64)
    order = np.argsort(keys, kind='stable')
    keys = keys[order]
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    sel = order[first]
    pi, pj, pc, pq = pi[sel], pj[sel], pc[sel], pq[sel]
    offsets = np.zeros(na + 1, np.int64)
    np.cumsum(np.bincount(pi, minlength=na), out=offsets[1:])
    return pj, pc, pq, offsets
