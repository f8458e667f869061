#!/usr/bin/env python
"""The coarse-DP CUDA kernels against their plain versions on synthetic
score maps, on one card (sm_90 with cluster launch).

    python scripts/torch_dp_kernel.py [--ptxas] [--quick] [--sweep]

Builds csrc/coarse_dp.cu with the port's nvcc flags (--ptxas prints ptxas's
registers, shared memory and spills for every kernel), then:

- the empty step: dp_forward's cluster doing only a step's halo store,
  three-number exchange and cluster barrier (plus 0 or 2 CTA barriers), for
  cluster sizes 1-16 at the bench and film shapes' thread counts. n times
  this step is the floor of a sequential scan on this card;
- for each shape runs dp_forward and dp_backtrace and their plain torch
  loops on the same map and requires bit-equal rows and equal paths. The
  maps are made to tie: scores quantized to 1/8, a suppressed band of -1e30
  around a diagonal, a block of equal rows. Shapes: the smallest the
  wrappers take (n 1, D 11), widths that are no multiple of a warp, every
  cluster size, forced launch shapes (16 CTAs on D 11, the wide kernel at a
  small width and at its own, D 150,000), the bench pair's (1,663 x 16,630)
  and one 64-row film tile (D 61,438) from a non-zero first row and a given
  last lane; and a map whose rows trip the backtrace's guard (rows of
  -1e30, maxima at 2^22 and above);
- --sweep times dp_forward at the bench and film widths over cluster sizes,
  threads and lanes per thread (each checked against the default's rows).

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
PROBE_STEPS = 20000


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


def empty_steps(smi):
    """The empty step's microseconds by cluster size, threads and CTA
    barriers."""
    for threads in (352, 448, 1024):
        for barriers in (0, 2, -2, -3):
            us = [coarse_dp.empty_step_ms(PROBE_STEPS, c, threads, barriers)
                  / PROBE_STEPS * 1e3 for c in (1, 2, 4, 8, 16)]
            print(f"[empty step] {threads} threads, {barriers} CTA barriers: "
                  + ", ".join(f"cluster {c} {u:.3f} us"
                              for c, u in zip((1, 2, 4, 8, 16), us))
                  + f" ({smi})", flush=True)


def check(n, d, seed, first_row, given_lane, smi, time_plain, config=None):
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
    rows = coarse_dp.dp_forward(prev, scores, config)
    shape = coarse_dp.dp_forward.config
    path = coarse_dp.dp_backtrace(o_last, rows)
    torch.cuda.synchronize()
    rows_p = coarse_dp.dp_forward_plain(prev, scores)
    path_p = coarse_dp.dp_backtrace_plain(o_last, rows_p)
    same_rows = torch.equal(rows, rows_p)
    same_path = torch.equal(path, path_p)
    line = (f"[dp] n {n} D {d} first_row {first_row} given_lane "
            f"{given_lane} (cluster, threads, lanes, passes) {shape}: rows "
            f"{'equal' if same_rows else 'DIFFER'}, "
            f"path {'equal' if same_path else 'DIFFER'}")
    if not (same_rows and same_path):
        bad = torch.nonzero(rows != rows_p)
        print(line, "first differing (row, lane):", bad[:5].tolist(),
              "path mismatches:", int((path != path_p).sum()), flush=True)
        return False
    f_ms = cuda_ms(lambda: coarse_dp.dp_forward(prev, scores, config))
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


def check_guard(n, d, seed, smi):
    """dp_backtrace on rows that trip the guard, with and without a given
    last lane."""
    dev = torch.device('cuda')
    host, tripped = coarse_dp.guard_rows(n, d, seed)
    rows = torch.from_numpy(host).to(dev)
    ok = True
    for o_last in (None, torch.tensor(d // 3, dtype=torch.int64, device=dev)):
        path = coarse_dp.dp_backtrace(o_last, rows)
        ok &= torch.equal(path, coarse_dp.dp_backtrace_plain(o_last, rows))
    ms = cuda_ms(lambda: coarse_dp.dp_backtrace(None, rows))
    print(f"[dp guard] n {n} D {d}, {tripped} rows at or above 2^22: paths "
          f"{'equal' if ok else 'DIFFER'} | dp_backtrace {ms:.3f} ms "
          f"({ms / n * 1e3:.2f} us/step) ({smi})", flush=True)
    return ok


def sweep(smi):
    """dp_forward's time by launch shape at the bench and film widths."""
    dev = torch.device('cuda')
    for n, d in ((1663, 16638), (64, 61438)):
        scores = torch.from_numpy(tie_heavy_map(n, d, 7)).to(dev)
        prev = torch.zeros(d, device=dev)
        want = coarse_dp.dp_forward(prev, scores)
        for cluster in (1, 2, 4, 8, 16):
            for lanes in coarse_dp.LANES:
                try:
                    shape = coarse_dp.forward_config(d, cluster, None, lanes)
                except ValueError:
                    continue
                got = coarse_dp.dp_forward(prev, scores, shape[:3])
                same = torch.equal(got, want)
                ms = cuda_ms(lambda: coarse_dp.dp_forward(prev, scores,
                                                          shape[:3]))
                print(f"[sweep] n {n} D {d} cluster {shape[0]} threads "
                      f"{shape[1]} lanes {shape[2]}: {ms:.3f} ms "
                      f"({ms / n * 1e3:.2f} us/step), rows "
                      f"{'equal' if same else 'DIFFER'} ({smi})", flush=True)
                if not same:
                    raise SystemExit("torch_dp_kernel: a launch shape "
                                     "disagrees with the default's rows")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dp_kernel: CUDA is unavailable")
    smi = card_line()
    if args.ptxas:
        for ln in ptxas_report(os.path.join(_build.CSRC, 'coarse_dp.cu')):
            print(f"[ptxas] {ln}", flush=True)
    coarse_dp.load_library()
    empty_steps(smi)
    # (n, D, first row, given lane, forced (cluster, threads, lanes, passes))
    shapes = [(1, 11, False, False, None), (1, 11, True, True, None),
              (3, 12, False, False, None), (7, 33, True, True, None),
              (5, 1000, False, False, None), (64, 1025, True, True, None),
              (40, 2047, False, False, None), (33, 4097, True, True, None),
              (12, 11, True, True, (16, 32, 1)),
              (9, 300, False, True, (16, 32, 1)),
              (20, 5759, True, True, (4, 32, None, 5)),
              (16, 9000, False, False, (16, 64, None, 1)),
              (6, 150000, True, True, None),
              (64, 61438, True, True, None),
              (64, 61438, False, False, None)]
    if not args.quick:
        shapes.append((1663, 16630, False, False, None))
    ok = True
    for i, (n, d, first_row, given_lane, config) in enumerate(shapes):
        ok &= check(n, d, 100 + i, first_row, given_lane, smi,
                    time_plain=n * d > 100000 and config is None,
                    config=config)
    ok &= check_guard(200, 1500, 300, smi)
    ok &= check_guard(64, 61438, 301, smi)
    if not ok:
        raise SystemExit("torch_dp_kernel: a kernel disagrees with its "
                         "plain version")
    print("torch_dp_kernel: all shapes equal")
    if args.sweep:
        sweep(smi)


if __name__ == "__main__":
    main()
