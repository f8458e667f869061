#!/usr/bin/env python
"""Write the JAX package's device-fit result on the bench pair, the
fixture that chip_smoke.py holds the PyTorch port's `fit_backend='device'`
against.

Runs `describealign_tpu.alignment.api.align_from_pcm` (JAX, CPU backend)
with DESCRIBEALIGN_FIT_BACKEND=device on `bench.build_scale_pair()` - the
22-min video / 27-min description pair with a 202 s lead-in and 8
narration inserts - so the piecewise-linear fit is the ADMM of
`alignment/fit_device.py` (f32, 800 iterations per stage). Records the fit
nodes, similarity, median slope, margin and start offset, and of the fit
itself: the compressed nodes it was given, each stage's problem size and
power-of-two bucket, the number of slope breaks, its median slope and
whether its convergence guard passed. Written to
tests/data/torch_fit_device_expected.json.

Run from the repo root (a few minutes and a few GiB on a CPU):

    python scripts/torch_expected_fit_device.py
"""
import json
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["DESCRIBEALIGN_FIT_BACKEND"] = "device"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_fit_device_expected.json")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import bench
    from describealign_tpu.alignment import fit_device
    from describealign_tpu.alignment.api import align_from_pcm

    fits, stages = [], []
    real_fit, real_lasso = (fit_device.solve_l1_fit_device,
                            fit_device.fused_lasso_l1_device)

    def record_fit(x, y):
        result = real_fit(x, y)
        fits.append((np.asarray(x), np.asarray(y), result))
        return result

    def record_lasso(b, data_cost, kappa, **kw):
        n = len(b)
        stages.append({"n": n,
                       "n_pad": 1 << max(4, int(np.ceil(np.log2(max(n, 2)))))})
        return real_lasso(b, data_cost, kappa, **kw)

    fit_device.solve_l1_fit_device = record_fit
    fit_device.fused_lasso_l1_device = record_lasso

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
    if len(fits) != 1:
        raise SystemExit(f"expected one device fit, saw {len(fits)}")
    cx, cy, res = fits[0]
    result = {
        "source": "describealign_tpu.alignment.api.align_from_pcm (JAX, "
                  "CPU backend, DESCRIBEALIGN_FIT_BACKEND=device) on "
                  "bench.build_scale_pair()",
        "video_samples": int(video.shape[1]),
        "audio_samples": int(audio.shape[1]),
        "audio_times_s": [float(v) for v in x],
        "video_times_s": [float(v) for v in y],
        "similarity_percent": float(sim),
        "median_slope": float(slope),
        "margin": float(margin),
        "start_offset_s": float(x[0] - y[0]),
        "path_rows": int(len(path)),
        # the guard of fit.solve_l1_fit (fit.py:158-160)
        "converged": bool(np.isfinite(res["smooth_y"]).all()
                          and np.isfinite(res["slopes"]).all()
                          and np.median(np.abs(res["fit_err"])) < 50.0),
        "stages": stages,
        "slope_breaks": int(np.sum(np.diff(res["slopes"]) != 0)),
        "fit_median_slope": float(res["median_slope"]),
        "nodes_x": [float(v) for v in cx],
        "nodes_y": [float(v) for v in cy],
        "pair_seconds_to_build": round(gen_s, 1),
        "align_seconds_cpu": round(align_s, 1),
        "peak_rss_gib": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps({k: result[k] for k in (
        "similarity_percent", "median_slope", "start_offset_s", "converged",
        "stages", "slope_breaks", "pair_seconds_to_build",
        "align_seconds_cpu", "peak_rss_gib")}))


if __name__ == "__main__":
    main()
