#!/usr/bin/env python
"""Write the JAX package's result on the bench pair, the fixture that
chip_smoke.py holds the PyTorch port against.

Runs `describealign_tpu.alignment.api.align_from_pcm` (JAX, CPU backend)
on `bench.build_scale_pair()` - the 22-min video / 27-min description pair
with a 202 s lead-in and 8 narration inserts - and writes the fit nodes,
similarity, median slope, coarse margin and recovered start offset to
tests/data/torch_bench_pair_expected.json. The card machine has no JAX, so
this file is how the port's full-size run is compared with the reference.

Run from the repo root (several minutes on a CPU):

    python scripts/torch_expected_bench_pair.py
"""
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_bench_pair_expected.json")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import bench
    from describealign_tpu.alignment.api import align_from_pcm

    # keep the pair cache inside the checkout's ignored build directory
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    bench.BENCH_PAIR_CACHE = os.path.join(REPO, "build", "bench_pair.npz")
    t0 = time.time()
    video, audio, _ = bench.build_scale_pair()
    video = np.clip(video, -32768, 32767).astype(np.int16)
    audio = np.clip(audio, -32768, 32767).astype(np.int16)
    gen_s = time.time() - t0

    t0 = time.time()
    x, y, sim, path, slope, margin = align_from_pcm(video, audio)
    align_s = time.time() - t0
    result = {
        "source": "describealign_tpu.alignment.api.align_from_pcm (JAX, "
                  "CPU backend) on bench.build_scale_pair()",
        "video_samples": int(video.shape[1]),
        "audio_samples": int(audio.shape[1]),
        "audio_times_s": [float(v) for v in x],
        "video_times_s": [float(v) for v in y],
        "similarity_percent": float(sim),
        "median_slope": float(slope),
        "margin": float(margin),
        "start_offset_s": float(x[0] - y[0]),
        "path_rows": int(len(path)),
        "pair_seconds_to_build": round(gen_s, 1),
        "align_seconds_cpu": round(align_s, 1),
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps({k: result[k] for k in (
        "similarity_percent", "median_slope", "margin", "start_offset_s",
        "pair_seconds_to_build", "align_seconds_cpu")}))


if __name__ == "__main__":
    main()
