#!/usr/bin/env python
"""Write the JAX package's results on its eight edge-case structures, the
fixture that tests/test_torch_campaign.py and chip_smoke.py phase 10 hold
the PyTorch port against.

The structures are those of tests/test_reference_parity.py:123-320 (skip
heavy, a 4.5-min mix with a 2 % rate change, non-integer offsets, low
similarity, two music-bed ridge cases, a skip at the end of a silent span,
PAL 25/24 under a music bed), built here with the JAX package's
speech_like / music_bed and scipy's resample_poly, quantised to int16 and
run through the JAX package's align_from_pcm on the CPU (host features).
The structures are written out here apart from the port's
bench_pair.build_campaign_case, so the input hashes catch a drift in
either copy.
Per case the fixture holds the int16 inputs' hashes and lengths (the port
rebuilds the inputs from the same seeds with its own generator and checks
them against these), the fit nodes, similarity, median slope, coarse
margin, the hash and length of the streamed matcher's LIS chain (integer
frame pairs) and of the returned path (floats from the host tail),
whether the 5-stream retry ran, and the printed progress lines. The PCM
itself is not stored.

Run from the repo root (about a minute on a CPU):

    python scripts/torch_expected_campaign.py
"""
import contextlib
import hashlib
import io
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_campaign_expected.json")
SR = 44100


def _quantize(sig):
    import numpy as np
    return np.clip(np.round(sig), -32768, 32767).astype(np.int16)[None, :]


def cases():
    """{name: (video int16, audio int16)}, the structures of
    tests/test_reference_parity.py in its order."""
    import numpy as np
    from scipy.signal import resample_poly

    from describealign_tpu.utils.synthmedia import music_bed, speech_like
    out = {}

    content = speech_like(80.0, seed=34)
    pieces = [speech_like(5.0, seed=1034, amp=5000.0)]
    cursor = 0.0
    for k, cut in enumerate((12.0, 25.0, 37.0, 52.0, 64.0, 71.0)):
        pieces.append(content[int(cursor * SR):int(cut * SR)])
        pieces.append(speech_like(2.0 + (k % 3), seed=4034 + k, amp=5000.0))
        cursor = cut
    pieces.append(content[int(cursor * SR):])
    out["skip_heavy"] = (_quantize(content),
                         _quantize(np.concatenate(pieces)))

    content = speech_like(240.0, seed=36)
    half = int(120 * SR)
    video = np.concatenate([content[:half],
                            resample_poly(content[half:], 100, 102)])
    pieces = [speech_like(12.0, seed=1036, amp=5000.0)]
    cursor = 0.0
    for k, cut in enumerate((40.0, 95.0, 150.0, 205.0)):
        pieces.append(content[int(cursor * SR):int(cut * SR)])
        pieces.append(speech_like(3.0 + k, seed=6036 + k, amp=5000.0))
        cursor = cut
    pieces.append(content[int(cursor * SR):])
    out["long_mixed"] = (_quantize(video), _quantize(np.concatenate(pieces)))

    content = speech_like(100.312, seed=503)
    pieces = [speech_like(17.4376, seed=503 + 9001, amp=5000.0)]
    cursor = 0.0
    for k, (cut, dur) in enumerate(((35.14, 5.24), (55.67, 3.85),
                                    (79.24, 3.82))):
        pieces.append(content[int(cursor * SR):int(cut * SR)])
        pieces.append(speech_like(dur, seed=503 + 9100 + k, amp=5000.0))
        cursor = cut
    pieces.append(content[int(cursor * SR):])
    out["noninteger_offsets"] = (_quantize(content),
                                 _quantize(np.concatenate(pieces)))

    shared = speech_like(40.0, seed=35)
    video = np.concatenate([shared[:int(20 * SR)],
                            speech_like(20.0, seed=5035),
                            shared[int(20 * SR):]])
    audio = np.concatenate([speech_like(6.0, seed=1035, amp=5000.0), shared])
    out["low_similarity"] = (_quantize(video), _quantize(audio))

    content = speech_like(62.0, seed=77) + 0.67 * music_bed(62.0, seed=577)
    pieces = [speech_like(9.0, seed=1077, amp=5000.0),
              content[:int(10.3 * SR)],
              speech_like(7.1, seed=2077, amp=5000.0),
              content[int(10.3 * SR):int(22.6 * SR)],
              speech_like(6.6, seed=3077, amp=5000.0),
              content[int(22.6 * SR):int(43.0 * SR)],
              speech_like(7.1, seed=4077, amp=5000.0),
              content[int(43.0 * SR):]]
    out["music_bed_short_segments"] = (_quantize(content),
                                       _quantize(np.concatenate(pieces)))

    content = speech_like(86.15, seed=917) + 0.41 * music_bed(86.15,
                                                              seed=1417)
    pieces = [speech_like(5.06, seed=2417, amp=5000.0),
              content[:int(10.02 * SR)],
              speech_like(5.57, seed=3417, amp=5000.0),
              content[int(10.02 * SR):]]
    out["music_bed_short_first_segment"] = (
        _quantize(content), _quantize(np.concatenate(pieces)))

    content = speech_like(160.0, seed=911)
    for at, dur in ((42.0, 9.0), (104.0, 16.0), (131.0, 8.0)):
        i0, i1 = int(at * SR), int((at + dur) * SR)
        fade = min(2205, (i1 - i0) // 4)
        ramp = np.linspace(1.0, 0.0, fade)
        content[i0:i0 + fade] *= ramp
        content[i0 + fade:i1 - fade] *= 0.0
        content[i1 - fade:i1] *= ramp[::-1]
    pieces = [speech_like(18.5, seed=1911, amp=5000.0)]
    cursor = 0.0
    for k, (cut, dur) in enumerate(zip((120.3, 142.9), (5.9, 3.3))):
        pieces.append(content[int(cursor * SR):int(cut * SR)])
        pieces.append(speech_like(dur, seed=2911 + k, amp=5000.0))
        cursor = cut
    pieces.append(content[int(cursor * SR):])
    out["quiet_silence_boundary_skip"] = (
        _quantize(content), _quantize(np.concatenate(pieces)))

    content = speech_like(60.0, seed=47) + 0.6 * music_bed(60.0, seed=547)
    slowed = resample_poly(content, 25, 24)
    pieces = [speech_like(5.0, seed=1047, amp=5000.0),
              slowed[:int(30 * SR)],
              speech_like(4.0, seed=2047, amp=5000.0),
              slowed[int(30 * SR):]]
    out["pal_rate"] = (_quantize(content), _quantize(np.concatenate(pieces)))
    return out


def pcm_hash(x):
    """sha256 (first 16 hex digits) of an int16 array's bytes."""
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(x, np.int16).tobytes()
                          ).hexdigest()[:16]


def path_hash(path):
    """sha256 (first 16 hex digits) of the returned path as float64."""
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(path, np.float64).tobytes()
                          ).hexdigest()[:16]


def lis_chain(video, audio):
    """The streamed matcher's LIS chain, (2, n) int64 (video, audio
    frames), as align_from_pcm's host-feature path builds it."""
    import numpy as np

    from describealign_tpu.alignment import api
    sv, sa = video.shape[1], audio.shape[1]
    npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
    fv, nv = api.host_features_padded(video, sv, npad)
    fa, na = api.host_features_padded(audio, sa, npad)
    y, x, _ = api._streamed_lis(fa.astype(np.float16), na,
                                fv.astype(np.float16), nv)
    return np.stack([np.asarray(y), np.asarray(x)]).astype(np.int64)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")

    from describealign_tpu.alignment.api import align_from_pcm
    t0 = time.time()
    built = cases()
    build_s = time.time() - t0
    result = {
        "source": "describealign_tpu.alignment.api.align_from_pcm (JAX, "
                  "CPU backend, host features) on the structures of "
                  "tests/test_reference_parity.py:123-320, int16",
        "seconds_to_build": round(build_s, 1),
        "cases": {},
    }
    for name, (video, audio) in built.items():
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            x, y, sim, path, slope, margin = align_from_pcm(video, audio)
        align_s = time.time() - t0
        printed = out.getvalue()
        chain = lis_chain(video, audio)
        result["cases"][name] = {
            "video_samples": int(video.shape[1]),
            "audio_samples": int(audio.shape[1]),
            "video_sha256_16": pcm_hash(video),
            "audio_sha256_16": pcm_hash(audio),
            "audio_times_s": [float(v) for v in x],
            "video_times_s": [float(v) for v in y],
            "similarity_percent": float(sim),
            "median_slope": float(slope),
            "margin": float(margin),
            "lis_rows": int(chain.shape[1]),
            "lis_sha256_16": hashlib.sha256(chain.tobytes()).hexdigest()[:16],
            "path_rows": int(len(path)),
            "path_sha256_16": path_hash(path),
            "retry": "rechecking alignment" in printed,
            "printed": printed,
            "align_seconds_cpu": round(align_s, 2),
        }
        print(json.dumps({"case": name, "nodes": len(x),
                          "similarity": float(sim), "slope": float(slope),
                          "margin": float(margin),
                          "retry": result["cases"][name]["retry"],
                          "align_s": round(align_s, 2)}), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
