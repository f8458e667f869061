"""Synthetic audio-description pair generator (tests + benchmarks), a copy
of describealign_tpu/utils/synthmedia.py without the music bed.

Builds a "video soundtrack" of speech-like modulated noise plus a
"description track" containing the same content with narration segments
inserted (and optional rate change), together with the ground-truth
piecewise-linear audio-time -> video-time mapping.
"""
import numpy as np

SR = 44100


def speech_like(seconds, seed, amp=6000.0):
    """Broadband noise with syllable-rate amplitude modulation and a slowly
    wandering spectral tilt - plenty of texture for all 5 features."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    white = rng.standard_normal(n + 1)
    t = np.arange(n) / SR
    # one-pole lowpass with a seed-dependent wandering coefficient
    tilt = (0.6 + 0.3 * np.sin(2 * np.pi * t / rng.uniform(1.2, 2.4)
                               + rng.uniform(0, 6.28)))
    x = white[1:] + tilt * white[:-1]
    # syllable-ish + phrase envelopes, seed-dependent rates/phases, never silent
    syl_rate = rng.uniform(2.8, 4.6)
    phrase_rate = rng.uniform(0.25, 0.55)
    env = (0.35 + 0.65 * (0.5 + 0.5 * np.sin(
        2 * np.pi * syl_rate * t + rng.uniform(0, 6.28)
        + np.cumsum(rng.standard_normal(n)) * 2e-4)))
    env *= 0.55 + 0.45 * np.sin(2 * np.pi * phrase_rate * t
                                + rng.uniform(0, 6.28)) ** 2
    return (amp * env * x / np.std(x)).astype(np.float64)


def build_pair(content_seconds=45.0, narration=((20.0, 3.0),), lead_in=0.0,
               seed=0, channels=1):
    """Return (video_pcm, audio_pcm, segments).

    narration: tuple of (video_time, duration) insertions, ascending.
    lead_in: seconds of narration prepended before the content starts.
    segments: list of (audio_start, audio_end, video_start, video_end) in
    seconds - the ground-truth mapping of content segments.
    """
    content = speech_like(content_seconds, seed)
    video = content.copy()

    pieces = []
    segments = []
    cursor_v = 0.0
    cursor_a = lead_in
    if lead_in > 0:
        pieces.append(speech_like(lead_in, seed + 1000, amp=5000.0))
    for (v_time, dur) in narration:
        seg = content[int(cursor_v * SR):int(v_time * SR)]
        pieces.append(seg)
        segments.append((cursor_a, cursor_a + len(seg) / SR,
                         cursor_v, v_time))
        cursor_a += len(seg) / SR
        pieces.append(speech_like(dur, seed + 2000 + int(v_time), amp=5000.0))
        cursor_a += dur
        cursor_v = v_time
    seg = content[int(cursor_v * SR):]
    pieces.append(seg)
    segments.append((cursor_a, cursor_a + len(seg) / SR,
                     cursor_v, content_seconds))

    audio = np.concatenate(pieces)

    def quantize(x):
        x = np.clip(np.round(x), -32768, 32767).astype(np.int16)
        return np.tile(x[None, :], (channels, 1)).astype(np.float16).astype(np.float32)

    return quantize(video), quantize(audio), segments


def mapping_from_segments(segments):
    """Return f(audio_seconds) -> video_seconds (nan in narration gaps)."""
    def f(a_times):
        a_times = np.atleast_1d(np.asarray(a_times, float))
        out = np.full_like(a_times, np.nan)
        for (a0, a1, v0, v1) in segments:
            sel = (a_times >= a0) & (a_times <= a1)
            out[sel] = v0 + (a_times[sel] - a0) * (v1 - v0) / (a1 - a0)
        return out
    return f
