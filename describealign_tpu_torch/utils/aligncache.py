"""Alignment result cache: makes mux-only reruns free (a copy of
describealign_tpu/utils/aligncache.py).

The reference's only resume mechanism is output-file existence
(describealign.py:1087-1089). We additionally cache the alignment solution
(fit nodes, similarity, path, median slope) keyed by the input files'
identity (path, size, mtime) and the algorithm version hash, so re-running
with different mux settings (or after a failed mux) skips the entire
alignment compute. The port's key also holds the feature frontend (the
JAX package's omits it, so there a cached cascade alignment answers a mel
request).
"""
import hashlib
import os

import numpy as np

from .hashing import get_version_hash


def _pair_key(video_file, audio_file, num_channels, frontend='cascade'):
    h = hashlib.sha1()
    for f in (video_file, audio_file):
        st = os.stat(f)
        h.update(f"{os.path.abspath(f)}|{st.st_size}|{st.st_mtime_ns}".encode())
    # the decode channel count follows the mode (1 default / 2 stretch,
    # reference describealign.py:1096) and changes the feature numerics
    # (ZCR doubling, channel-mean bands), so it is part of the key
    h.update(f"|ch{int(num_channels)}|".encode())
    # the frontend makes streams 2-4, so it changes the alignment too
    h.update(f"{frontend}|".encode())
    h.update(get_version_hash().encode())
    return h.hexdigest()[:16]


def cache_path(alignment_dir, video_file):
    stem = os.path.splitext(os.path.split(video_file)[1])[0]
    return os.path.join(alignment_dir, f"{stem}.aligncache.npz")


def load(alignment_dir, video_file, audio_file, num_channels=1,
         frontend='cascade'):
    """Return the cached align() outputs or None."""
    path = cache_path(alignment_dir, video_file)
    if not os.path.exists(path):
        return None
    try:
        data = np.load(path, allow_pickle=False)
        if str(data['key']) != _pair_key(video_file, audio_file,
                                         num_channels, frontend):
            return None
        # coarse margin: optional 6th element (None on caches written
        # before the low-confidence guard; nan encodes a missing margin)
        margin = None
        if 'coarse_margin' in data:
            m = float(data['coarse_margin'])
            margin = None if np.isnan(m) else m
        return (data['audio_times'], data['video_times'],
                float(data['similarity']), data['path'],
                float(data['median_slope']), margin)
    except Exception:
        return None


def save(alignment_dir, video_file, audio_file, outputs, num_channels=1,
         frontend='cascade'):
    audio_times, video_times, similarity, path, median_slope = outputs[:5]
    margin = outputs[5] if len(outputs) > 5 else None
    try:
        np.savez_compressed(
            cache_path(alignment_dir, video_file),
            key=_pair_key(video_file, audio_file, num_channels, frontend),
            audio_times=audio_times, video_times=video_times,
            similarity=similarity, path=path, median_slope=median_slope,
            coarse_margin=np.nan if margin is None else float(margin))
    except Exception:
        pass  # cache is best-effort
