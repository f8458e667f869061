"""The bench pair and the bench batch: synthetic 22-min videos with 27-min
descriptions.

The same pair as bench.py's build_scale_pair (the reference's headline
benchmark scale): 1320 s of speech-like content, a 202 s lead-in and 8
narration inserts of 12 s, seed 42. It is built by the port's copy of the
synthetic media generator (utils/synthmedia.py). build_batch_pairs gives
bench.py's 8 distinct pairs of that scale for the batch path.
build_campaign_case gives the JAX package's eight edge-case structures of
tests/test_reference_parity.py (music beds, PAL rate, silences, ...).
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


# The edge-case structures of tests/test_reference_parity.py:123-320, each a
# regression pinned by an earlier round (see the docstrings there), in the
# order they stand there
CAMPAIGN_CASES = ("skip_heavy", "long_mixed", "noninteger_offsets",
                  "low_similarity", "music_bed_short_segments",
                  "music_bed_short_first_segment",
                  "quiet_silence_boundary_skip", "pal_rate")


def _quantize(x):
    return _to_i16(np.round(x))[None, :]


def _cut_and_insert(content, lead, cuts, inserts):
    """lead, then content with inserts[k] placed at cuts[k] seconds."""
    from .utils.synthmedia import SR
    pieces, cursor = [lead], 0.0
    for cut, insert in zip(cuts, inserts):
        pieces.append(content[int(cursor * SR):int(cut * SR)])
        pieces.append(insert)
        cursor = cut
    pieces.append(content[int(cursor * SR):])
    return np.concatenate(pieces)


def build_campaign_case(name):
    """(video, audio) int16 PCM of shape (1, samples) of one of
    CAMPAIGN_CASES, built from the same seeds and draws as the JAX
    package's test (its _quantize, as int16)."""
    from scipy.signal import resample_poly

    from .utils.synthmedia import SR, music_bed, speech_like
    if name == "skip_heavy":
        content = speech_like(80.0, seed=34)
        cuts = (12.0, 25.0, 37.0, 52.0, 64.0, 71.0)
        audio = _cut_and_insert(
            content, speech_like(5.0, seed=1034, amp=5000.0), cuts,
            [speech_like(2.0 + (k % 3), seed=4034 + k, amp=5000.0)
             for k in range(len(cuts))])
        return _quantize(content), _quantize(audio)
    if name == "long_mixed":
        content = speech_like(240.0, seed=36)
        # the video plays the second half 2% fast
        half = int(120 * SR)
        video = np.concatenate([content[:half],
                                resample_poly(content[half:], 100, 102)])
        cuts = (40.0, 95.0, 150.0, 205.0)
        audio = _cut_and_insert(
            content, speech_like(12.0, seed=1036, amp=5000.0), cuts,
            [speech_like(3.0 + k, seed=6036 + k, amp=5000.0)
             for k in range(len(cuts))])
        return _quantize(video), _quantize(audio)
    if name == "noninteger_offsets":
        content = speech_like(100.312, seed=503)
        cuts, durs = (35.14, 55.67, 79.24), (5.24, 3.85, 3.82)
        audio = _cut_and_insert(
            content, speech_like(17.4376, seed=503 + 9001, amp=5000.0), cuts,
            [speech_like(d, seed=503 + 9100 + k, amp=5000.0)
             for k, d in enumerate(durs)])
        return _quantize(content), _quantize(audio)
    if name == "low_similarity":
        shared = speech_like(40.0, seed=35)
        video = np.concatenate([shared[:int(20 * SR)],
                                speech_like(20.0, seed=5035),
                                shared[int(20 * SR):]])
        audio = np.concatenate([speech_like(6.0, seed=1035, amp=5000.0),
                                shared])
        return _quantize(video), _quantize(audio)
    if name == "music_bed_short_segments":
        content = speech_like(62.0, seed=77) + 0.67 * music_bed(62.0,
                                                                seed=577)
        cuts = (10.3, 22.6, 43.0)
        audio = _cut_and_insert(
            content, speech_like(9.0, seed=1077, amp=5000.0), cuts,
            [speech_like(d, seed=s, amp=5000.0)
             for d, s in ((7.1, 2077), (6.6, 3077), (7.1, 4077))])
        return _quantize(content), _quantize(audio)
    if name == "music_bed_short_first_segment":
        content = speech_like(86.15, seed=917) + 0.41 * music_bed(86.15,
                                                                  seed=1417)
        audio = _cut_and_insert(
            content, speech_like(5.06, seed=2417, amp=5000.0), (10.02,),
            [speech_like(5.57, seed=3417, amp=5000.0)])
        return _quantize(content), _quantize(audio)
    if name == "quiet_silence_boundary_skip":
        content = speech_like(160.0, seed=911)
        # near-silent spans faded in and out; the second ends at the first
        # cut
        for at, dur in ((42.0, 9.0), (104.0, 16.0), (131.0, 8.0)):
            i0, i1 = int(at * SR), int((at + dur) * SR)
            fade = min(2205, (i1 - i0) // 4)
            ramp = np.linspace(1.0, 0.0, fade)
            content[i0:i0 + fade] *= ramp
            content[i0 + fade:i1 - fade] *= 0.0
            content[i1 - fade:i1] *= ramp[::-1]
        cuts, durs = (120.3, 142.9), (5.9, 3.3)
        audio = _cut_and_insert(
            content, speech_like(18.5, seed=1911, amp=5000.0), cuts,
            [speech_like(d, seed=2911 + k, amp=5000.0)
             for k, d in enumerate(durs)])
        return _quantize(content), _quantize(audio)
    if name == "pal_rate":
        # 25/24 under a 0.6-ratio music bed
        content = speech_like(60.0, seed=47) + 0.6 * music_bed(60.0,
                                                               seed=547)
        slowed = resample_poly(content, 25, 24)
        audio = np.concatenate([speech_like(5.0, seed=1047, amp=5000.0),
                                slowed[:int(30 * SR)],
                                speech_like(4.0, seed=2047, amp=5000.0),
                                slowed[int(30 * SR):]])
        return _quantize(content), _quantize(audio)
    raise ValueError(f"unknown campaign case {name!r}; one of "
                     f"{CAMPAIGN_CASES}")
