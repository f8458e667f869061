#!/usr/bin/env python
"""The coarse-DP CUDA kernels against their plain versions on synthetic
score maps, on one card.

    python scripts/torch_dp_kernel.py [--ptxas] [--quick]

Builds csrc/coarse_dp.cu with the port's nvcc flags (--ptxas prints ptxas's
registers, shared memory and spills), then for each shape runs dp_forward
and dp_backtrace and their plain torch loops on the same map and requires
bit-equal rows and equal paths. The maps are made to tie: scores quantized
to 1/8, a suppressed band of -1e30 around a diagonal, a block of equal
rows. Shapes: the smallest the wrappers take (n 1, D 11), widths that are
no multiple of a warp, the bench pair's (1,663 x 16,630) and one 64-row
film tile (D 61,438) from a non-zero first row and a given last lane.
Times by CUDA events beside the bytes bound (3.35 TB/s); --quick skips the
bench-sized map. Needs a CUDA device and nvcc.
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from describealign_tpu_torch.ops import _build, coarse_dp  # noqa: E402

HBM_BYTES_S = 3.35e12
REPS = 5


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_report(path):
    proc = subprocess.run(
        [_build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
         '-std=c++17', '-O3', '-cubin', '-Xptxas', '-v', '-o', os.devnull,
         path], capture_output=True, text=True, check=True)
    return [ln.strip() for ln in proc.stderr.splitlines()
            if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]


def tie_heavy_map(n, d, seed):
    """(n, D) f32 scores on a 1/8 grid with a -1e30 band and equal rows."""
    rng = np.random.default_rng(seed)
    m = (rng.integers(0, 24, (n, d)) / 8).astype(np.float32)
    lanes = np.arange(d)[None, :]
    diag = (np.arange(n) * 10 % max(d - 1, 1))[:, None]
    m[np.abs(lanes - diag) <= 25] = -1e30
    m[n // 2:n // 2 + 3] = m[n // 2]
    return m


def cuda_ms(fn):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def check(n, d, seed, first_row, given_lane, smi, time_plain):
    dev = torch.device('cuda')
    scores = torch.from_numpy(tie_heavy_map(n, d, seed)).to(dev)
    rng = np.random.default_rng(seed + 1)
    prev = torch.zeros(d, device=dev)
    if first_row:
        prev = torch.from_numpy(
            (rng.integers(0, 400, d) / 8).astype(np.float32)).to(dev)
    o_last = None
    if given_lane:
        o_last = torch.tensor(int(rng.integers(0, d)), dtype=torch.int64,
                              device=dev)
    rows = coarse_dp.dp_forward(prev, scores)
    path = coarse_dp.dp_backtrace(o_last, rows)
    torch.cuda.synchronize()
    rows_p = coarse_dp.dp_forward_plain(prev, scores)
    path_p = coarse_dp.dp_backtrace_plain(o_last, rows_p)
    same_rows = torch.equal(rows, rows_p)
    same_path = torch.equal(path, path_p)
    line = (f"[dp] n {n} D {d} first_row {first_row} given_lane "
            f"{given_lane}: rows {'equal' if same_rows else 'DIFFER'}, "
            f"path {'equal' if same_path else 'DIFFER'}")
    if not (same_rows and same_path):
        bad = torch.nonzero(rows != rows_p)
        print(line, "first differing (row, lane):", bad[:5].tolist(),
              "path mismatches:", int((path != path_p).sum()), flush=True)
        return False
    f_ms = cuda_ms(lambda: coarse_dp.dp_forward(prev, scores))
    b_ms = cuda_ms(lambda: coarse_dp.dp_backtrace(o_last, rows))
    f_bytes, b_bytes = coarse_dp.dp_work(n, d)
    line += (f" | dp_forward {f_ms:.3f} ms ({f_ms / n * 1e3:.2f} us/step, "
             f"bytes bound {f_bytes / HBM_BYTES_S * 1e3:.4f} ms), "
             f"dp_backtrace {b_ms:.3f} ms ({b_ms / n * 1e3:.2f} us/step, "
             f"bytes bound {b_bytes / HBM_BYTES_S * 1e3:.4f} ms)")
    if time_plain:
        fp_ms = cuda_ms(lambda: coarse_dp.dp_forward_plain(prev, scores))
        bp_ms = cuda_ms(lambda: coarse_dp.dp_backtrace_plain(o_last, rows))
        line += f" | plain {fp_ms:.1f} ms, {bp_ms:.1f} ms"
    print(f"{line} ({smi})", flush=True)
    return True


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dp_kernel: CUDA is unavailable")
    smi = card_line()
    if args.ptxas:
        for ln in ptxas_report(os.path.join(_build.CSRC, 'coarse_dp.cu')):
            print(f"[ptxas] {ln}", flush=True)
    coarse_dp.load_library()
    shapes = [(1, 11, False, False), (1, 11, True, True),
              (3, 12, False, False), (7, 33, True, True),
              (5, 1000, False, False), (64, 1025, True, True),
              (40, 2047, False, False), (64, 61438, True, True),
              (64, 61438, False, False)]
    if not args.quick:
        shapes.append((1663, 16630, False, False))
    ok = True
    for i, (n, d, first_row, given_lane) in enumerate(shapes):
        ok &= check(n, d, 100 + i, first_row, given_lane, smi,
                    time_plain=n * d > 100000)
    if not ok:
        raise SystemExit("torch_dp_kernel: a kernel disagrees with its "
                         "plain version")
    print("torch_dp_kernel: all shapes equal")


if __name__ == "__main__":
    main()
