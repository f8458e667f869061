"""Weighted LIS over the matcher's output (native only): streaming over the
packed chunks, or single-shot over the unquantized candidates.

Twin of describealign_tpu/alignment/lis.py's `LisStream` (lis.py:134-345)
and `lis_from_match` (lis.py:86-131) without the sortedcontainers import
and the pure-Python fallbacks: the port always calls the native C++
(csrc/dp.cpp). Exact reference
semantics (describealign.py:654-699): candidates in (audio, video, qual) order, a frontier keyed by
video index holding the best cumulative quality, dominated entries pruned,
backpointers reconstruct the chain.
"""
import ctypes

import numpy as np

from ..utils import spans
from .native import native_lib

# dp.cpp lis_stream_new rejects caps over 2^28 keys (~355 h of video)
LIS_STREAM_KEY_CAP = 1 << 28

_F32P = ctypes.POINTER(ctypes.c_float)
_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_longlong)


def lis_from_match(quals, offs, starts):
    """Fused flatten + sort + LIS straight off the single-shot matcher's
    output (the JAX package's native branch).

    quals: (B, 210, S) f32, 0 marks empty; offs: (B, 210, S) int16 band
    offsets; starts: (B, G) int32 band starts. The S slots split into G
    equal groups: slot j's video frame is starts[b, j // (S // G)] + off
    (a 1-D starts is one group). Exact duplicates from overlapping bands
    collapse like the reference's per-frame candidate sets. Returns the
    (video_path, audio_path) int64 chain."""
    with spans.span('tail.lis'):
        quals = np.ascontiguousarray(quals, np.float32)
        offs = np.ascontiguousarray(offs, np.int16)
        starts = np.ascontiguousarray(starts, np.int32)
        if starts.ndim == 1:
            starts = starts[:, None]
        nb, blk, k = quals.shape
        cap = nb * blk * k + 1
        out_v = np.empty(cap, np.int64)
        out_a = np.empty(cap, np.int64)
        out_len = ctypes.c_longlong(0)
        rc = native_lib().lis_from_match(
            quals.ctypes.data_as(_F32P), offs.ctypes.data_as(_I16P),
            starts.ctypes.data_as(_I32P), ctypes.c_longlong(nb),
            ctypes.c_longlong(blk), ctypes.c_longlong(k),
            ctypes.c_longlong(starts.shape[1]), out_v.ctypes.data_as(_I64P),
            out_a.ctypes.data_as(_I64P), ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError("native lis_from_match failed")
        m = out_len.value
        return out_v[:m].copy(), out_a[:m].copy()


class LisStream:
    """Feed packed chunks in audio order, then finish() returns the
    (video_path, audio_path) int64 chain."""

    def __init__(self, max_video_key):
        self._ctx = None
        self._lib = native_lib()
        if max_video_key + 2 > LIS_STREAM_KEY_CAP:
            raise ValueError(f"video key range {max_video_key} exceeds the "
                             f"native LIS cap {LIS_STREAM_KEY_CAP}")
        self._ctx = self._lib.lis_stream_new(
            ctypes.c_longlong(int(max_video_key) + 2))
        if not self._ctx:
            raise RuntimeError("lis_stream_new failed")

    def feed_packed(self, packed, starts, a_base, blk, k1, k2):
        """Feed one chunk's (nb, W) int16 transport rows (the layout of
        matching.match_fine_chunk) with its (nb, G) band starts; a_base is
        the chunk's first audio frame."""
        packed = np.ascontiguousarray(packed, np.int16)
        starts = np.ascontiguousarray(starts, np.int32)
        rc = self._lib.lis_stream_feed_packed(
            ctypes.c_void_p(self._ctx), packed.ctypes.data_as(_I16P),
            starts.ctypes.data_as(_I32P),
            ctypes.c_longlong(packed.shape[0]), ctypes.c_longlong(blk),
            ctypes.c_longlong(k1), ctypes.c_longlong(k2),
            ctypes.c_longlong(starts.shape[1]),
            ctypes.c_longlong(int(a_base)))
        if rc != 0:
            raise RuntimeError("lis_stream_feed_packed failed")

    def finish(self):
        cap = int(self._lib.lis_stream_count(ctypes.c_void_p(self._ctx))) + 1
        out_v = np.empty(cap, np.int64)
        out_a = np.empty(cap, np.int64)
        out_len = ctypes.c_longlong(0)
        rc = self._lib.lis_stream_finish(
            ctypes.c_void_p(self._ctx), out_v.ctypes.data_as(_I64P),
            out_a.ctypes.data_as(_I64P), ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError("lis_stream_finish failed")
        m = out_len.value
        return out_v[:m].copy(), out_a[:m].copy()

    def close(self):
        if self._ctx:
            self._lib.lis_stream_free(ctypes.c_void_p(self._ctx))
            self._ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
