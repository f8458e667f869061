"""ctypes bridge for the native pass-2 refinement DP (csrc/dp.cpp): a copy
of describealign_tpu/alignment/refine_native.py's refine_dp_flat without
the pure-Python fallback."""
import ctypes

import numpy as np

from .native import native_lib


def refine_dp_flat(pj, pc, pq, offsets, num_clusters, num_video):
    """Run the pass-2 DP on flat per-frame point arrays.

    pj (video pos f64), pc (cluster i64), pq (qual f64) sorted by
    (frame, video, cluster, qual); offsets (num_audio+1,) frame index
    boundaries. Returns the (M, 5) path rows (video, audio, cluster, qual,
    cum_qual).
    """
    pj = np.ascontiguousarray(pj, np.float64)
    pc = np.ascontiguousarray(pc, np.int64)
    pq = np.ascontiguousarray(pq, np.float64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    total = len(pj)
    out_path = np.empty((total + 1, 5), np.float64)
    out_len = ctypes.c_longlong(0)
    rc = native_lib().refine_dp(
        pj.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pc.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        pq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.c_longlong(len(offsets) - 1),
        ctypes.c_longlong(num_clusters),
        ctypes.c_longlong(num_video),
        out_path.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError("native refine_dp failed")
    return out_path[:out_len.value].copy()
