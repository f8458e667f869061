#!/usr/bin/env python
"""Smoke run of the PyTorch port on an NVIDIA GPU (H100): build its CUDA
kernel from the sources, hold the kernel against its plain version, drive
the single-pair main path on the bench pair, and check the result against
the JAX package's (tests/data/torch_bench_pair_expected.json).

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero without them. Phases:
1. card: nvidia-smi name and power limit, torch / CUDA versions, build times;
2. kernel vs plain: fine_match's CUDA kernel against fine_match_plain on
   the bench pair's coarse state, on every 256-block chunk of both tracks
   (the last chunk carries nonzero audio starts and padded blocks): equal
   candidate sets keyed by (block, frame, video frame), 99th percentile
   relative quality error < 1e-3 and every candidate's absolute quality
   error < 1e-2 (qualities reach 50). Times from CUDA events on the first
   and the last chunk; the first chunk's useful FMA count (from the masks
   and bands) and the kernel's bound: 3xTF32 on the tensor cores, beside
   fp32 FFMA and device memory;
3. main path: describealign_tpu_torch align_from_pcm on the bench pair
   (22-min video, 27-min description), one warm-up and 3 timed runs, a
   per-stage split, kernel launch counts, peak device memory, and the check
   against the JAX result.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
import contextlib
import io
import json
import os
import subprocess
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(REPO, "tests", "data",
                        "torch_bench_pair_expected.json")
TOL_S = 0.010               # node / start-offset agreement with JAX, seconds
P99_REL = 1e-3              # kernel vs plain: 99th percentile relative error
MAX_ABS = 1e-2              # kernel vs plain: worst absolute quality error
# Kernel and plain sum the correlations in other orders, so a candidate
# whose probability sits on QUAL_PROB_CUTOFF may be kept by one side only:
# allowed when its quality is within GATE_REL of the gate's floor, at most
# one per GATE_PER candidates of a chunk; any other difference fails
GATE_REL = 1e-4
GATE_PER = 20000
REPS = 5                    # timed launches per kernel-vs-plain measurement
# NVIDIA H100 SXM peaks (data sheet, dense, at 700 W)
TF32_FLOPS = 495e12         # tensor cores, TF32
FP32_FLOPS = 67e12          # FFMA outside the tensor cores
HBM_BYTES_S = 3.35e12


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn):
    """Mean milliseconds per call of fn over REPS calls after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def build_all(*builders):
    """Run the builders (nvcc of the kernel, g++ of the host library)
    together, one thread each; returns each one's seconds and raises the
    first failure."""
    seconds, errors = [None] * len(builders), []

    def run(i, build):
        t0 = time.perf_counter()
        try:
            build()
        except Exception as e:              # re-raised below
            errors.append(e)
        seconds[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(i, b))
               for i, b in enumerate(builders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return seconds


def keyed(q, v):
    b, l, k = np.nonzero(q > 0)
    return dict(zip(zip(b.tolist(), l.tolist(), v[b, l, k].tolist()),
                    q[b, l, k].tolist()))


def fine_bound(args):
    """(useful FMA, 3xTF32 bound ms, fp32 FFMA bound ms, bytes bound ms)
    of one fine_match call: each useful FMA is three TF32 products (6 FLOP)
    on the tensor cores, or 2 FLOP of fp32 FFMA."""
    from describealign_tpu_torch.ops import fine_kernel
    _, _, a_mask, _, _, v_mask, v_starts, a_starts = args
    fma, nbytes = fine_kernel.fine_match_work(a_mask, v_mask, v_starts,
                                              a_starts)
    return (fma, 6 * fma / TF32_FLOPS * 1e3, 2 * fma / FP32_FLOPS * 1e3,
            nbytes / HBM_BYTES_S * 1e3)


def kernel_vs_plain(state, b0, track, timed):
    """One chunk of one track through the kernel and the plain version on
    the same device tensors. Returns (max_abs_err, p99_rel, kernel_ms,
    plain_ms, n_candidates, bound, gate candidates only one side keeps);
    the times and the bound are None unless `timed`."""
    from describealign_tpu_torch.alignment import matching
    from describealign_tpu_torch.ops import fine_kernel
    ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts, _ = state
    dev = ms_a.device
    v_starts = starts[track, b0:b0 + matching.FINE_CHUNK].contiguous()
    a_starts = ((b0 + torch.arange(matching.FINE_CHUNK, dtype=torch.int32,
                                   device=dev)) * matching.BLOCK)
    args = (ms_a, norms_a, a_mask.float(), ms_v, norms_v, v_mask.float(),
            v_starts, a_starts)
    qk, ok = fine_kernel.fine_match(*args)
    qp, op = fine_kernel.fine_match_plain(*args)
    torch.cuda.synchronize()
    vs = v_starts[:, None, None]
    dk = keyed(qk.cpu().numpy(), (vs + ok).cpu().numpy())
    dp = keyed(qp.cpu().numpy(), (vs + op).cpu().numpy())
    # a candidate only one side keeps must sit on the probability gate:
    # its quality is the floor 1e-4 exp(EXP_COEF LOG_CUT) within GATE_REL
    floor = 1e-4 * float(np.exp(np.float64(fine_kernel.EXP_COEF)
                                * fine_kernel.LOG_CUT))
    only = sorted(set(dk) ^ set(dp))
    gate = [(k, dk.get(k), dp.get(k)) for k in only]
    off_gate = [g for g in gate
                if max(g[1] or 0.0, g[2] or 0.0) > floor * (1 + GATE_REL)]
    if off_gate or len(gate) > len(dp) // GATE_PER:
        raise AssertionError(
            f"chunk b0={b0} track {track}: candidate sets differ in "
            f"{len(gate)} keys, {len(off_gate)} of them off the quality "
            f"gate {floor:.7g} (key, kernel, plain): {(off_gate or gate)[:5]}")
    common = [k for k in dp if k in dk]
    err = np.array([abs(dk[k] - dp[k]) for k in common])
    rel = err / np.array([dp[k] for k in common])
    p99 = float(np.percentile(rel, 99))
    if not p99 < P99_REL:
        raise AssertionError(f"chunk b0={b0} track {track}: p99 relative "
                             f"quality error {p99} >= {P99_REL}")
    if not err.max() < MAX_ABS:
        worst = common[int(err.argmax())]
        raise AssertionError(f"chunk b0={b0} track {track}: absolute "
                             f"quality error {err.max()} >= {MAX_ABS} at "
                             f"{worst} (plain {dp[worst]}, kernel "
                             f"{dk[worst]})")
    if not timed:
        return float(err.max()), p99, None, None, len(dp), None, gate
    k_ms = cuda_ms(lambda: fine_kernel.fine_match(*args))
    p_ms = cuda_ms(lambda: fine_kernel.fine_match_plain(*args))
    return (float(err.max()), p99, k_ms, p_ms, len(dp), fine_bound(args),
            gate)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is unavailable; this check runs "
                         "only on a machine with an NVIDIA GPU")
    from describealign_tpu_torch.alignment import api, matching
    from describealign_tpu_torch.alignment.native import native_lib
    from describealign_tpu_torch.bench_pair import build_scale_pair
    from describealign_tpu_torch.ops import fine_kernel

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # --- phase 1: the card and the builds --------------------------------
    smi = card_line()
    nvcc_s, gxx_s = build_all(fine_kernel.load_library, native_lib)
    print(smi)
    print(f"[1 card] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | nvcc fine_match.cu {nvcc_s:.2f} s | g++ "
          f"host library {gxx_s:.2f} s", flush=True)

    # --- the bench pair (regenerated into the ignored build directory) ---
    with open(EXPECTED) as f:
        expected = json.load(f)
    t0 = time.perf_counter()
    v, a = build_scale_pair(os.path.join(REPO, "build", "bench_pair_i16.npz"))
    if (v.shape[1], a.shape[1]) != (expected["video_samples"],
                                    expected["audio_samples"]):
        raise AssertionError("bench pair differs from the expected fixture")
    gen_s = time.perf_counter() - t0

    # --- phase 2: kernel vs plain on the bench pair's coarse state -------
    sv, sa = v.shape[1], a.shape[1]
    npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
    fv, nv = api.host_features_padded(v, sv, npad)
    fa, na = api.host_features_padded(a, sa, npad)
    state = matching.match_coarse(api._upload(fa, device), na,
                                  api._upload(fv, device), nv)
    nb = matching.nb_for(npad)
    n_chunks = state[6].shape[1] // matching.FINE_CHUNK
    last_b0 = (n_chunks - 1) * matching.FINE_CHUNK
    rows = []
    for b0 in range(0, last_b0 + 1, matching.FINE_CHUNK):
        for track in range(matching.N_TRACKS):
            rows.append((b0, track) + kernel_vs_plain(
                state, b0, track, b0 in (0, last_b0)))
    del state
    for b0, track, err, p99, k_ms, p_ms, n, bound, gate in rows:
        timing = "" if k_ms is None else (
            f", kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms per 256-block "
            f"chunk; useful {bound[0]:.4g} FMA, bound 3xTF32 "
            f"{bound[1]:.4f} ms (fp32 FFMA {bound[2]:.4f} ms, device memory "
            f"{bound[3]:.4f} ms), kernel at {bound[1] / k_ms:.1%} of the "
            f"3xTF32 bound")
        sets = ("equal sets" if not gate else
                f"equal sets apart from {len(gate)} at the quality gate "
                f"(key, kernel, plain) {gate}")
        print(f"[2 kernel vs plain] chunk b0={b0} track {track}: {n} "
              f"candidates, {sets}, max abs err {err:.3g}, p99 rel "
              f"{p99:.3g}{timing} ({smi})", flush=True)

    # --- phase 3: the main path ------------------------------------------
    def run(timings=None):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            r = api.align_from_pcm(v, a, device=device, timings=timings)
        return r, out.getvalue()

    run()                                           # warm-up
    torch.cuda.reset_peak_memory_stats()
    fine_kernel.fine_match.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        result, printed = run()
        times.append(time.perf_counter() - t0)
    launches = fine_kernel.fine_match.launches
    peak = torch.cuda.max_memory_allocated()
    retried = "rechecking alignment" in printed
    want = 3 * n_chunks * matching.N_TRACKS * (2 if retried else 1)
    if launches != want:
        raise AssertionError(f"fine_match launched {launches} times in 3 "
                             f"runs, expected {want}")
    split = {}
    run(split)
    e2e = float(np.median(times))
    print(f"[3 main path] bench pair ({sa / 44100 / 60:.1f}-min "
          f"description, {nb} blocks, {n_chunks} chunks, pair built in "
          f"{gen_s:.1f} s): e2e median {e2e:.3f} s of "
          f"{[round(t, 3) for t in times]} | split "
          + ", ".join(f"{k} {s:.3f} s" for k, s in split.items())
          + f" | fine_match launches {launches} (3 runs) | peak device "
          f"memory {peak / 2**20:.0f} MiB ({smi})", flush=True)

    x, y, sim, _, slope, margin = result
    start_off = float(x[0] - y[0])
    jx = np.asarray(expected["audio_times_s"])
    jy = np.asarray(expected["video_times_s"])
    node_err = float(np.max(np.abs(np.interp(jx, x, y) - jy)))
    checks = {
        "start offset": abs(start_off - expected["start_offset_s"]) <= TOL_S,
        "nodes": node_err <= TOL_S,
        "similarity": abs(sim - expected["similarity_percent"]) <= 0.5,
        "median slope": abs(slope - expected["median_slope"]) <= 1e-4,
        "margin": margin > matching.COARSE_MARGIN_FLOOR,
        "finite": bool(np.isfinite(x).all() and np.isfinite(y).all()),
    }
    print(f"[3 vs JAX] start offset {start_off:.4f} s (JAX "
          f"{expected['start_offset_s']:.4f}), max node error "
          f"{node_err * 1e3:.2f} ms over {len(jx)} JAX nodes, similarity "
          f"{sim:.3f} (JAX {expected['similarity_percent']:.3f}), median "
          f"slope {slope:.7f} (JAX {expected['median_slope']:.7f}), margin "
          f"{margin:.4f} (JAX {expected['margin']:.4f}) - "
          + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                      for k, v in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"main path disagrees with JAX: {checks}")

    chunk0 = [r for r in rows if r[0] == 0]
    k_ms = float(np.mean([r[4] for r in chunk0]))
    bound = [float(np.mean([r[7][i] for r in chunk0])) for i in range(4)]
    print(json.dumps({"kernels": [{
        "name": "fine_match",
        "route": "cuda",
        "source": "describealign_tpu_torch/csrc/fine_match.cu",
        "replaces": "describealign_tpu/ops/fine_kernel.py:61",
        "launches": launches,
        "max_abs_err": max(r[2] for r in rows),
        "ms": k_ms,
        "plain_ms": float(np.mean([r[5] for r in chunk0])),
        "bound_ms": max(bound[1], bound[3]),
        "bound_by": "operations" if bound[1] >= bound[3] else "bytes",
        "bound_share": max(bound[1], bound[3]) / k_ms,
        "bound_fp32_ms": bound[2],
        "useful_fma": bound[0],
        "gate_flips": sum(len(r[8]) for r in rows),
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
