"""The bench pair: a synthetic 22-min video and 27-min description.

The same pair as bench.py's build_scale_pair (the reference's headline
benchmark scale): 1320 s of speech-like content, a 202 s lead-in and 8
narration inserts of 12 s, seed 42. It is built by the port's copy of the
synthetic media generator (utils/synthmedia.py).
"""
import os

import numpy as np

CONTENT_SECONDS = 1320.0
LEAD_IN_SECONDS = 202.0
NARRATION = tuple((120.0 + 150.0 * k, 12.0) for k in range(8))
SEED = 42


def build_scale_pair(cache=None):
    """(video, audio) int16 PCM of shape (channels, samples).

    cache: an optional .npz path. A pair found there is loaded; otherwise
    the pair is generated (about a minute of host time) and saved there.
    """
    if cache and os.path.exists(cache):
        z = np.load(cache)
        return z["video"], z["audio"]
    from .utils import synthmedia
    video, audio, _ = synthmedia.build_pair(
        content_seconds=CONTENT_SECONDS, narration=NARRATION,
        lead_in=LEAD_IN_SECONDS, seed=SEED)
    video = np.clip(video, -32768, 32767).astype(np.int16)
    audio = np.clip(audio, -32768, 32767).astype(np.int16)
    if cache:
        os.makedirs(os.path.dirname(os.path.abspath(cache)), exist_ok=True)
        np.savez(cache, video=video, audio=audio)
    return video, audio
