#!/usr/bin/env python
"""Write the JAX package's batch result on the 8 bench-batch pairs, the
fixture that chip_smoke.py holds the PyTorch port's batch path against.

Runs `describealign_tpu.alignment.api.align_batch_from_pcm` (JAX, CPU
backend, dense transport: DESCRIBEALIGN_COMPACT=0 in this process, so the
margin travels as an f16 word as it does in the port's batch path) on
`describealign_tpu_torch.bench_pair.build_batch_pairs()` - bench.py's 8
distinct ~22-min / ~27-min pairs, one of ~50 % similarity and one slowed by
3 % - and writes each pair's fit nodes, similarity, median slope, margin,
start offset, planted offset, kind, sample counts and PCM checksum to
tests/data/torch_batch8_expected.json. The card machine has no JAX, so
this file is how the port's batch run is compared with the reference.

Run from the repo root (about ten minutes and several GB on a CPU):

    python scripts/torch_expected_batch8.py
"""
import json
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["DESCRIBEALIGN_COMPACT"] = "0"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_batch8_expected.json")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")

    from describealign_tpu.alignment.api import align_batch_from_pcm
    from describealign_tpu_torch import bench_pair

    t0 = time.time()
    pairs, lens, planted, kinds = bench_pair.build_batch_pairs()
    gen_s = time.time() - t0
    t0 = time.time()
    results = align_batch_from_pcm(pairs, true_samples=lens)
    align_s = time.time() - t0
    out = {
        "source": "describealign_tpu.alignment.api.align_batch_from_pcm "
                  "(JAX, CPU backend, DESCRIBEALIGN_COMPACT=0) on "
                  "describealign_tpu_torch.bench_pair.build_batch_pairs()",
        "pairs_seconds_to_build": round(gen_s, 1),
        "batch_seconds_cpu": round(align_s, 1),
        "peak_rss_gib": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
        "pairs": [],
    }
    for (v, a), ln, off, kind, r in zip(pairs, lens, planted, kinds,
                                        results):
        x, y, sim, path, slope, margin = r
        out["pairs"].append({
            "kind": str(kind),
            "planted_offset_s": float(off),
            "video_samples": int(ln[0]),
            "audio_samples": int(ln[1]),
            "checksum": bench_pair.checksum(v, a),
            "audio_times_s": [float(t) for t in x],
            "video_times_s": [float(t) for t in y],
            "similarity_percent": float(sim),
            "median_slope": float(slope),
            "margin": float(margin),
            "start_offset_s": float(x[0] - y[0]),
            "path_rows": int(len(path)),
        })
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: out[k] for k in (
        "pairs_seconds_to_build", "batch_seconds_cpu", "peak_rss_gib")}))
    for p in out["pairs"]:
        print(p["kind"], p["planted_offset_s"], p["start_offset_s"],
              p["similarity_percent"], p["median_slope"], p["margin"],
              len(p["audio_times_s"]))


if __name__ == "__main__":
    main()
