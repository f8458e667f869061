#!/usr/bin/env python
"""Write the JAX package's result on the feature-film pair, the fixture
that chip_smoke.py phase 5 holds the PyTorch port against.

Builds the 95-min film / 101.4-min description pair at the feature level
(describealign_tpu_torch.film_pair, numpy only), then runs the JAX
package's streamed matcher and host tail on it on the CPU backend
(`api._streamed_lis` + `api._host_stages_from_path`, the route of
scripts/dryrun_longmedia.py; path-equivalent to `align()`, and it also
returns the coarse margin). At this size the coarse pass takes the
streamed DP (`matching._coarse_dp_streamed`). Writes the fit nodes,
similarity, median slope, margin, start offset, the features' checksum,
the wall time and the peak RSS to tests/data/torch_film_pair_expected.json.

Run from the repo root (minutes on an 8-core CPU; several GB of RAM):

    python scripts/torch_expected_film_pair.py
"""
import json
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_film_pair_expected.json")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from describealign_tpu.alignment import api, matching
    from describealign_tpu_torch import film_pair

    t0 = time.time()
    video, audio = film_pair.build_film_features()
    gen_s = time.time() - t0
    nv, na = video.shape[1], audio.shape[1]
    npad = max(api._bucket_pad(na), api._bucket_pad(nv))
    fa = api._stack_padded(audio, na, npad)
    fv = api._stack_padded(video, nv, npad)
    kv = (npad - 41 - max(matching.SUB_LANE_SHIFTS)) // matching.COARSE_STRIDE + 1
    nb = matching.nb_for(npad)
    assert nb * kv > matching.COARSE_STREAM_ELEMS, "not on the streamed branch"

    t0 = time.time()
    y, x, margin = api._streamed_lis(fa.astype(np.float16), na,
                                     fv.astype(np.float16), nv)
    res = api._host_stages_from_path(y, x, fa, fv, na, nv, 'native',
                                     margin=margin)
    align_s = time.time() - t0
    ax, vy, sim, path, slope, margin = res
    result = {
        "source": "describealign_tpu.alignment.api._streamed_lis + "
                  "_host_stages_from_path (JAX, CPU backend) on "
                  "describealign_tpu_torch.film_pair.build_film_features()",
        "checksum": film_pair.checksum(video, audio),
        "video_frames": int(nv),
        "audio_frames": int(na),
        "npad": int(npad),
        "nb": int(nb),
        "kv": int(kv),
        "audio_times_s": [float(v) for v in ax],
        "video_times_s": [float(v) for v in vy],
        "similarity_percent": float(sim),
        "median_slope": float(slope),
        "margin": float(margin),
        "start_offset_s": float(ax[0] - vy[0]),
        "path_rows": int(len(path)),
        "features_seconds_to_build": round(gen_s, 1),
        "align_seconds_cpu": round(align_s, 1),
        "peak_rss_gib": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps({k: result[k] for k in (
        "checksum", "nb", "kv", "similarity_percent", "median_slope",
        "margin", "start_offset_s", "align_seconds_cpu", "peak_rss_gib")}))


if __name__ == "__main__":
    main()
