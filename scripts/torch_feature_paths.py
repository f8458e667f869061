#!/usr/bin/env python
"""The bench pair through the PyTorch port's two feature paths, on a CUDA
device: align_from_pcm with features='host' (the native C++ extractor, the
f16 upload, the streamed matcher) and features='device' (int16 PCM
upload, the two feature kernels, the single-shot matcher).

For each path: one warm-up, --runs timed end-to-end runs and --splits runs
with the per-stage split (timings=...). A tree whose port has no
features= argument (an earlier commit) runs the host path only, so one
call can time a parent and a change side by side:

    python scripts/torch_feature_paths.py [--root DIR] [--runs 5] [--splits 2]

--root: the checkout whose describealign_tpu_torch is imported (default:
this one); the bench pair is cached in this checkout's build/ either way.
Prints one line per path starting with FEATURE_PATHS: the card (nvidia-smi
name and power limit), the root, each run's e2e seconds and their median,
each split, and the max distance of the fit nodes from the first run's.
"""
import argparse
import contextlib
import inspect
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--splits", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from describealign_tpu_torch.alignment import api
    from describealign_tpu_torch.bench_pair import build_scale_pair

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    v, a = build_scale_pair(os.path.join(REPO, "build", "bench_pair_i16.npz"))
    paths = (("host", "device")
             if "features" in inspect.signature(api.align_from_pcm).parameters
             else ("host",))
    for path in paths:
        kw = {} if path == "host" and len(paths) == 1 else {"features": path}

        def run(timings=None):
            with contextlib.redirect_stdout(io.StringIO()):
                return api.align_from_pcm(v, a, device="cuda",
                                          timings=timings, **kw)

        first = run()
        times = []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = run()
            times.append(time.perf_counter() - t0)
        splits = []
        for _ in range(args.splits):
            split = {}
            run(split)
            splits.append({k: round(t, 4) for k, t in split.items()})
        drift = float(np.max(np.abs(np.interp(first[0], result[0], result[1])
                                    - first[1])))
        print("FEATURE_PATHS " + json.dumps({
            "card": smi, "root": root, "features": path,
            "e2e_s": [round(t, 4) for t in times],
            "e2e_median_s": round(float(np.median(times)), 4),
            "splits_s": splits, "node_drift_s": drift,
            "similarity": float(result[2]),
            "start_offset_s": float(result[0][0] - result[1][0])}),
            flush=True)


if __name__ == "__main__":
    main()
