"""The host C++ library of the port: csrc/dp.cpp + csrc/features.cpp (LIS
stream, L1 fit cascade, continuity errors, pass-2 refinement, feature
extraction and rescale).

Built with g++ at first use into build/describealign_tpu_torch/ (see
ops/_build.py) and rebuilt when its sources or the host CPU change. The
port has no pure-Python fallback: a failed build raises with g++'s
stderr. Every module of the port reaches the library through
`native_lib`.
"""
import ctypes
import threading

from ..ops._build import build_host_library

SOURCES = ('dp.cpp', 'features.cpp')

_LOCK = threading.Lock()
_LIB = None


def _declare(lib):
    """restype/argtypes of the entry points that need more than int."""
    lib.weighted_lis.restype = ctypes.c_int
    lib.lis_from_match.restype = ctypes.c_int
    lib.lis_stream_new.restype = ctypes.c_void_p
    lib.lis_stream_new.argtypes = [ctypes.c_longlong]
    lib.lis_stream_free.restype = None
    lib.lis_stream_free.argtypes = [ctypes.c_void_p]
    lib.lis_stream_feed.restype = ctypes.c_int
    lib.lis_stream_feed_u8.restype = ctypes.c_int
    lib.lis_stream_feed_split.restype = ctypes.c_int
    lib.lis_stream_feed_packed.restype = ctypes.c_int
    lib.lis_stream_feed_packed_strided.restype = ctypes.c_int
    lib.lis_stream_feed_compact.restype = ctypes.c_int
    lib.lis_stream_count.restype = ctypes.c_longlong
    lib.lis_stream_count.argtypes = [ctypes.c_void_p]
    lib.lis_stream_finish.restype = ctypes.c_int
    lib.refine_dp.restype = ctypes.c_int
    lib.refine_score_cluster.restype = ctypes.c_int
    lib.refine_offset_stats.restype = ctypes.c_int
    lib.tv1d_weighted.restype = ctypes.c_int
    lib.extract_features_i16.restype = ctypes.c_int
    lib.conv_f64.restype = ctypes.c_int
    lib.continuity_filter_f64.restype = ctypes.c_int
    lib.round_decimals6_f64.restype = ctypes.c_int
    lib.pv_phase_lock.restype = ctypes.c_int
    lib.pv_phase_lock_carry.restype = ctypes.c_int
    lib.resample_quad.restype = ctypes.c_int


def native_lib():
    """The loaded ctypes library, built on first use; raises if g++
    fails."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build_host_library('dadp', SOURCES))
                _declare(lib)
                _LIB = lib
    return _LIB


__all__ = ['native_lib']
