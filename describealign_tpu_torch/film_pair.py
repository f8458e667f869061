"""The feature-film pair: a 95-minute film and a 101.4-minute description,
built at the feature level.

The generator of scripts/dryrun_longmedia.py (the JAX package's long-media
dry run), cut to a film: 5,700 s of content, a 202 s lead-in and 12
narration inserts of 15 s. It makes the (5, frames) feature streams
directly, since synthesizing ~3 GB of 44.1 kHz PCM would dominate a run and
prove nothing about the matcher. Npad 1,290,240, so the coarse score map
has nb x kv = 6,143 x 61,438 = 377.4 M elements, above COARSE_STREAM_ELEMS:
the first input that takes the streamed coarse DP on the CPU, and on a card
whose free memory cannot hold the materialized map.

The arithmetic is chosen to give the same bits on every machine, so a
checksum written beside the JAX package's result can refuse a pair that
differs: uniform noise from the counter-based generator (no libm in the
sampler), the 15-tap smoothing as a fixed-order shift-and-add in float32
(no BLAS dot products), and the theoretical standard deviation of the
smoothed noise in place of a measured one (no reduction order).
"""
import hashlib

import numpy as np

FPS = 210
CONTENT_SECONDS = 5700.0
LEAD_IN_SECONDS = 202.0
N_INSERTS = 12
INSERT_SECONDS = 15.0
SEED = 5

# ~8-frame smoothing: a correlation length shorter than the 41-frame match
# window, so descriptors are selective
_TAPS = np.hanning(17)[1:-1].astype(np.float32)
_TAPS /= _TAPS.sum()
_SMOOTH_STD = np.float32(np.sqrt(np.sum(_TAPS.astype(np.float64) ** 2)))


def synth_feature_stream(n_frames, seed):
    """(5, n_frames) f32 feature streams: smoothed unit-variance noise at
    4 +/- 2 (above the 0.5 quiet gate)."""
    rng = np.random.default_rng(seed)
    half = len(_TAPS) // 2
    out = np.empty((5, n_frames), np.float32)
    for j in range(5):
        x = ((rng.random(n_frames) - 0.5) * np.sqrt(12.0)).astype(np.float32)
        xp = np.pad(x, (half, half))
        sm = np.zeros(n_frames, np.float32)
        for m, tap in enumerate(_TAPS):
            sm += tap * xp[m:m + n_frames]
        out[j] = 4.0 + 2.0 * (sm / _SMOOTH_STD)
    return out


def build_film_features(seed=SEED):
    """(video (5, nv), audio (5, na)) f32 features of the film pair. The
    description holds the film's content with the lead-in first and the
    12 inserts at evenly spaced cuts."""
    n_content = int(CONTENT_SECONDS * FPS)
    content = synth_feature_stream(n_content, seed)
    pieces = [synth_feature_stream(int(LEAD_IN_SECONDS * FPS), seed + 94)]
    cuts = np.linspace(0, n_content, N_INSERTS + 2).astype(int)[1:-1]
    prev = 0
    for i, c in enumerate(cuts):
        pieces.append(content[:, prev:c])
        pieces.append(synth_feature_stream(int(INSERT_SECONDS * FPS),
                                           seed + 995 + i))
        prev = c
    pieces.append(content[:, prev:])
    return content, np.concatenate(pieces, axis=1)


def checksum(video, audio):
    """sha256 (first 16 hex digits) of both feature stacks' bytes."""
    h = hashlib.sha256()
    for f in (video, audio):
        h.update(np.ascontiguousarray(f, np.float32).tobytes())
    return h.hexdigest()[:16]
