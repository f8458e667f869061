"""Audio decode: any container -> (channels, samples) PCM at 44.1 kHz (a
copy of describealign_tpu/media/decode.py).

Contract follows the reference decode (describealign.py:149-157): first audio
track only, `aresample=async=1:first_pts=0` so gaps are silence-filled and
timestamps are faithful, s16le output, requested channel count, values kept
with float16 quantization (the reference stores PCM as float16; we store
float32 *quantized through* float16 so all downstream numerics match the
reference bit-for-bit while staying in a device-friendly dtype).

A built-in WAV path handles .wav files without ffmpeg (useful for tests and
environments without ffmpeg binaries).
"""
import os
import wave

import numpy as np

from ..constants import AUDIO_SAMPLE_RATE
from .ffmpeg import get_ffmpeg, is_ffmpeg_installed, run_ffmpeg_command


def _as_reference_dtype(int16_arr):
    # reference: np.frombuffer(..., np.int16).astype(np.float16)
    return int16_arr.astype(np.float16).astype(np.float32)


def _decode_wav_int16(media_file, num_channels):
    with wave.open(media_file, 'rb') as w:
        n_ch = w.getnchannels()
        rate = w.getframerate()
        width = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if width != 2:
        raise RuntimeError(f"Built-in WAV reader supports 16-bit PCM only: {media_file}")
    arr = np.frombuffer(frames, np.int16).reshape(-1, n_ch).T  # (ch, samples)
    # channel count adaptation (ffmpeg -ac semantics: mix down / duplicate)
    if n_ch > num_channels:
        arr = np.mean(arr.astype(np.float32), axis=0, keepdims=True)
        arr = np.repeat(arr, num_channels, axis=0)
        arr = np.clip(np.round(arr), -32768, 32767).astype(np.int16)
    elif n_ch < num_channels:
        arr = np.repeat(arr, num_channels // n_ch + 1, axis=0)[:num_channels]
    if rate != AUDIO_SAMPLE_RATE:
        from scipy.signal import resample_poly
        from math import gcd
        g = gcd(AUDIO_SAMPLE_RATE, rate)
        arr = resample_poly(arr.astype(np.float32), AUDIO_SAMPLE_RATE // g,
                            rate // g, axis=1)
        arr = np.clip(np.round(arr), -32768, 32767).astype(np.int16)
    return np.ascontiguousarray(arr)


def parse_audio_int16(media_file, num_channels=2):
    """Decode the first audio track to (num_channels, samples) int16@44.1k.

    Preferred for the device pipeline: int16 uploads at half the float32
    size and the float16-grid cast happens on device (bit-identical to the
    reference's storage dtype).
    """
    media_file = str(media_file)
    if media_file.lower().endswith('.wav') and not is_ffmpeg_installed():
        return _decode_wav_int16(media_file, num_channels)
    args = ['-i', media_file,
            '-map', '0:a:0',
            '-af', 'aresample=async=1:first_pts=0',
            '-f', 's16le', '-acodec', 'pcm_s16le',
            '-ac', str(num_channels), '-ar', str(AUDIO_SAMPLE_RATE),
            '-loglevel', 'error',
            '-']
    out, _ = run_ffmpeg_command(args, f"parse audio from input file: {media_file}")
    return np.ascontiguousarray(np.frombuffer(out, np.int16)
                                .reshape(-1, num_channels).T)


def parse_audio_from_file(media_file, num_channels=2):
    """Decode the first audio track to (num_channels, samples) float32@44.1k
    on the float16 grid (the reference's storage dtype)."""
    return _as_reference_dtype(parse_audio_int16(media_file, num_channels))


def int16_view(pcm_f32):
    """Exact int16 of a float16-grid f32 array (fullscale 32768 clips to
    32767, which rounds back to 32768 on the f16 grid - lossless)."""
    return np.clip(pcm_f32, -32768, 32767).astype(np.int16)


def write_wav(path, media_arr, sample_rate=AUDIO_SAMPLE_RATE):
    """Write (channels, samples) array as 16-bit PCM WAV (test/tooling helper)."""
    arr = np.asarray(media_arr)
    int16 = np.clip(np.round(arr), -32768, 32767).astype(np.int16)
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(int16.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(int16.T.tobytes())
