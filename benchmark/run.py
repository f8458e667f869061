#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 benchmark/run.py --workload episode-single --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. --trace 0 prints the cell's end-to-end metrics, --trace 1
its per-layer metrics from a traced window. Every run judges the answers
of its window against the reference and prints each compared number
beside its limit, last on standard error and under "checks" in the
result. Without the cards, or with jax or the JAX package loaded, it
exits non-zero and prints no result.
"""
import os
import sys
import time


def _process_start():
    """The process's start on the wall clock, from /proc (falls back to
    now): set-up counts from there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_PROC = _process_start()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "triton_cache"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import core
    cell = core.Cell(ROOT, args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    run, result = core.execute(cell, args.seed, args.seconds, args.trace,
                               devices, torch.cuda.get_device_name(0),
                               T_PROC)
    found = core.forbidden_modules()
    if found:
        print(f"loaded modules the run may not load: {found}",
              file=sys.stderr)
        return 3
    for pair, err in run.failures[:3]:
        print(f"failed request: {err}", file=sys.stderr)
    if run.durations:
        d = sorted(run.durations)
        print(f"requests {len(d)}: min {d[0]:.4f} median "
              f"{d[len(d) // 2]:.4f} max {d[-1]:.4f} s", file=sys.stderr)
    print(f"widest gap {run.widest_gap_ms!r} ms (not compared)",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
