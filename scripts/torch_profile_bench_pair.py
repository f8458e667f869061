#!/usr/bin/env python
"""Where the PyTorch port's time goes on the bench pair, on a CUDA device.

Runs describealign_tpu_torch's align_from_pcm on the 22-min video /
27-min description bench pair: one warm-up, --runs timed end-to-end runs,
--splits runs with the per-stage split (align_from_pcm(timings=...)), then
one run under torch.profiler. Run from the repo root on a machine with an
NVIDIA GPU:

    python scripts/torch_profile_bench_pair.py [--runs 5] [--splits 3]

Prints lines starting with PROFILE: the card (nvidia-smi name and power
limit), each run's e2e seconds and their median, each split, the profiled
run's device time summed over its kernels and copies with that time's share
of the e2e median, the number of device launches, and the top kernels by
device time. It writes nothing but the bench pair's cache under build/.
"""
import argparse
import contextlib
import io
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _device_us(evt):
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else evt.self_cuda_time_total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--splits", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from describealign_tpu_torch.alignment import api
    from describealign_tpu_torch.bench_pair import build_scale_pair

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"PROFILE card {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda}", flush=True)
    v, a = build_scale_pair(os.path.join(REPO, "build", "bench_pair_i16.npz"))

    def run(**kw):
        with contextlib.redirect_stdout(io.StringIO()):
            api.align_from_pcm(v, a, device="cuda", **kw)
        torch.cuda.synchronize()

    run()                                               # warm-up
    times = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    e2e = float(np.median(times))
    print(f"PROFILE e2e runs {[round(t, 3) for t in times]} median "
          f"{e2e:.3f} s", flush=True)
    for _ in range(args.splits):
        split = {}
        run(timings=split)
        print("PROFILE split " + ", ".join(f"{k} {s:.3f} s"
                                           for k, s in split.items()),
              flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev.sort(key=_device_us, reverse=True)
    total_s = sum(_device_us(e) for e in dev) / 1e6
    launches = sum(e.count for e in dev)
    print(f"PROFILE profiled run: wall {wall:.3f} s (profiler on), device "
          f"time {total_s:.4f} s over {launches} launches of {len(dev)} "
          f"kernels and copies, {100 * total_s / e2e:.1f} % of the e2e "
          f"median", flush=True)
    for e in dev[:args.top]:
        print(f"PROFILE {_device_us(e) / 1e3:10.2f} ms  calls {e.count:7d}  "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()
