"""The bench pair and the bench batch: synthetic 22-min videos with 27-min
descriptions.

The same pair as bench.py's build_scale_pair (the reference's headline
benchmark scale): 1320 s of speech-like content, a 202 s lead-in and 8
narration inserts of 12 s, seed 42. It is built by the port's copy of the
synthetic media generator (utils/synthmedia.py). build_batch_pairs gives
bench.py's 8 distinct pairs of that scale for the batch path.
"""
import hashlib
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


def _narr(first, spacing, dur, count):
    return tuple((first + spacing * k, dur) for k in range(count))


BATCH_SPECS = (
    (42, 1320.0, _narr(120.0, 150.0, 12.0, 8), 202.0),
    (101, 1320.0, _narr(100.0, 200.0, 20.0, 6), 180.0),
    (202, 1320.0, _narr(90.0, 125.0, 10.0, 10), 250.0),
    (303, 1320.0, _narr(200.0, 300.0, 25.0, 4), 120.0),
    (404, 1320.0, _narr(80.0, 160.0, 15.0, 8), 90.0),
    "lowsim",
    "rate",
    (707, 1320.0, _narr(150.0, 250.0, 24.0, 5), 60.0),
)


def _to_i16(x):
    return np.clip(x, -32768, 32767).astype(np.int16)


def build_batch_pair(k):
    """Pair k of build_batch_pairs: (video int16, audio int16, planted
    offset in seconds, kind)."""
    from .utils.synthmedia import SR, build_pair, speech_like
    spec = BATCH_SPECS[k]
    if spec == "rate":
        from scipy.signal import resample_poly
        content = speech_like(1320.0, seed=606)
        slowed = resample_poly(content, 103, 100)
        lead = speech_like(180.0, seed=1606, amp=5000.0)
        tail = speech_like(80.0, seed=2606, amp=5000.0)
        v = _to_i16(np.round(content))[None, :]
        a = _to_i16(np.round(np.concatenate([lead, slowed, tail])))[None, :]
        return v, a, 180.0, "rate"
    if spec == "lowsim":
        content = speech_like(1320.0, seed=505)
        # the audio describes only video 330..990 s (six 110-s chunks with
        # narration between and around them); its length matches the
        # video's, so both coverage fractions land at ~50%
        pieces = [speech_like(150.0, seed=1505, amp=5000.0)]
        for j in range(6):
            a0, a1 = 330.0 + j * 110.0, 330.0 + (j + 1) * 110.0
            pieces.append(content[int(a0 * SR):int(a1 * SR)])
            if j < 5:
                pieces.append(speech_like(90.0, seed=2505 + j, amp=5000.0))
        pieces.append(speech_like(60.0, seed=3505, amp=5000.0))
        v = _to_i16(np.round(content))[None, :]
        a = _to_i16(np.round(np.concatenate(pieces)))[None, :]
        return v, a, 150.0 - 330.0, "lowsim"     # the first described chunk
    seed, content_s, narr, lead = spec
    v, a, _ = build_pair(content_seconds=content_s, narration=narr,
                         lead_in=lead, seed=seed)
    return _to_i16(v), _to_i16(a), lead, "plain"


def build_batch_pairs(workers=1):
    """bench.py's build_batch_pairs on the port's generator: 8 ~22-min /
    ~27-min pairs with distinct content, all in one audio shape bucket.

    - pairs 0-4 and 7: ordinary pairs (22-min content, varying lead-ins and
      narration layouts);
    - pair 5: ~50% similarity, only the middle half of the video is
      described;
    - pair 6: a description slowed by 3% (scipy.signal.resample_poly).

    workers: threads that generate pairs side by side (each holds a few GB
    while it runs). Returns (pairs of int16 (video, audio), true sample
    counts, planted offsets in seconds, kinds).
    """
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as pool:
        built = list(pool.map(build_batch_pair, range(len(BATCH_SPECS))))
    pairs = [(v, a) for v, a, _, _ in built]
    lens = [(v.shape[1], a.shape[1]) for v, a in pairs]
    return pairs, lens, [b[2] for b in built], [b[3] for b in built]


def checksum(video, audio):
    """sha256 (first 16 hex digits) of one pair's PCM bytes."""
    h = hashlib.sha256()
    for x in (video, audio):
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()[:16]
