#!/usr/bin/env python
"""The coarse score map's kernel (csrc/coarse_map.cu, ops/coarse_map.py
`block_scores`) on one card, against its plain version, and end to end
against another checkout of the repo.

    python scripts/torch_coarse_map.py [--ptxas] [--baseline TREE]
        [--json OUT.json]

Checks the kernel against block_scores_plain on seeded descriptors
(standard normal / sqrt(K)): edge shapes (Kv below the 9-column halo, Kv
off the 240-lane tile, blocks off the 8-block tile, a partial last 64-block
tile at b0 > 0, suppress paths near lane 0 and near Kv, K 128 and 256) and
the main path's shapes: the bench pair's map (1,663 blocks x 16,638 lanes,
K 128) in one call, the same with K 256 (the 5-stream retry), and film
tiles (64 x 61,438) with and without a suppress path. The map must agree
within rtol 1e-5 / atol 1e-4, and suppressed lanes exactly. Then CUDA-event
times of the kernel, the plain version and the GEMM alone (one
torch.matmul of the 7 phases' product, no skew max) beside the bounds:
3xTF32 (6 FLOP per FMA at 495 TFLOP/s), fp32 FFMA (2 FLOP at 67 TFLOP/s)
and the bytes at 3.35 TB/s. --ptxas prints ptxas's registers, shared
memory and spills.

--baseline TREE (another checkout, `git archive REV | tar -x -C TREE`)
runs the port end to end in subprocesses, TREE and this tree in the order
TREE, this, this, TREE: the bench pair through align_from_pcm (e2e median
and the coarse_map / coarse_dp split), the 95-min film through align()
(e2e, split, and the k-best streamed DP alone on its descriptors) and the
batch of 8 through align_batch_from_pcm (warm wall). The pairs are cached
under build/. --json writes the numbers to a file. Needs a CUDA device and
nvcc.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
BENCH = (1663, 16638)           # the bench pair's blocks and lanes
FILM_KV = 61438                 # the film's lanes
RTOL, ATOL = 1e-5, 1e-4
REPS = 5                        # timed launches per kernel measurement
RUNS = 3                        # timed end-to-end runs per subprocess


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas(path):
    """ptxas -v lines of a source."""
    from describealign_tpu_torch.ops import _build
    cubin = os.path.join(_build.BUILD_DIR, "coarse_map_ptxas.cubin")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc()] + _build.NVCC_FLAGS[:4]
        + ['-cubin', '-Xptxas', '-v', '-o', cubin, path],
        capture_output=True, text=True, check=True)
    return [ln.strip() for ln in proc.stderr.splitlines()
            if 'registers' in ln or 'spill' in ln or 'stack' in ln
            or 'smem' in ln]


def descriptors(nb, kv, k, seed, device):
    """(audio (10 nb padded to whole chunks, K), video (7, Kv, K)) f32."""
    g = torch.Generator(device=device).manual_seed(seed)
    nb_pad = -(-nb // 64) * 64
    a = torch.randn((nb_pad * 10, k), generator=g, device=device) / k ** 0.5
    a[nb * 10:] = 0
    v = torch.randn((7, kv, k), generator=g, device=device) / k ** 0.5
    return a, v


def compare(label, got, want):
    """(max abs err, max rel err); raises outside rtol / atol or where the
    suppressed lanes differ."""
    sup_g, sup_w = got == -1e30, want == -1e30
    err = (got - want).abs()
    ok = bool(torch.equal(sup_g, sup_w)
              and torch.all(err <= ATOL + RTOL * want.abs()))
    live = ~sup_w
    rel = float((err[live] / want[live].abs().clamp_min(1e-6)).max()) \
        if bool(live.any()) else 0.0
    if not ok:
        raise AssertionError(f"{label}: the kernel disagrees with its plain "
                             f"version (max abs err {float(err.max()):.3g})")
    return float(err[live].max()) if bool(live.any()) else 0.0, rel


def edge_checks(device):
    from describealign_tpu_torch.ops import coarse_map as cm
    rng = np.random.default_rng(3)
    cases = [(5, 7, 128, 0, 5), (13, 240, 128, 0, 13), (9, 241, 256, 0, 9),
             (70, 500, 128, 64, 6), (130, 1000, 256, 64, 64),
             (200, 2000, 128, 192, 8)]
    for nb, kv, k, b0, n in cases:
        a, v = descriptors(nb, kv, k, nb + kv, device)
        paths = np.stack([np.r_[rng.integers(0, 26, nb // 2),
                                rng.integers(kv - 26, kv, nb - nb // 2)],
                          rng.integers(-30, kv + 30, nb)]).astype(np.int32)
        for sup in (None, torch.from_numpy(paths[:1]).to(device),
                    torch.from_numpy(paths).to(device)):
            want = cm.block_scores_plain(a, v, b0, n, sup)
            got = cm.block_scores(a, v, b0, n, sup)
            torch.cuda.synchronize()
            err, rel = compare(f"nb {nb} kv {kv} K {k} [{b0}, {b0 + n})",
                               got, want)
        print(f"[edge] nb {nb}, Kv {kv}, K {k}, blocks [{b0}, {b0 + n}), "
              f"0 / 1 / 2 suppress paths: within rtol {RTOL} / atol {ATOL} "
              f"(max abs err {err:.3g}, rel {rel:.3g})", flush=True)


def timed_case(label, nb, kv, k, b0, n, with_sup, device, smi):
    from describealign_tpu_torch.ops import coarse_map as cm
    a, v = descriptors(nb, kv, k, 7, device)
    sup = None
    if with_sup:
        lane = torch.arange(nb, device=device, dtype=torch.int32) * 10 % kv
        sup = lane[None, :].contiguous()
    want = cm.block_scores_plain(a, v, b0, n, sup)
    got = cm.block_scores(a, v, b0, n, sup)
    torch.cuda.synchronize()
    err, rel = compare(label, got, want)
    del got, want
    k_ms = float(np.mean([cuda_ms(lambda: cm.block_scores(a, v, b0, n, sup),
                                  REPS) for _ in range(2)]))
    p_ms = cuda_ms(lambda: cm.block_scores_plain(a, v, b0, n, sup), 1)
    rows = a[b0 * 10:(b0 + n) * 10]
    flat = v.reshape(7 * kv, k)
    gemm_ms = cuda_ms(lambda: torch.matmul(rows, flat.T), 1)
    fma, nbytes = cm.block_scores_work(n, kv, k, 0 if sup is None else 1)
    tf32 = 6 * fma / TF32_FLOPS * 1e3
    ffma = 2 * fma / FP32_FLOPS * 1e3
    mem = nbytes / HBM_BYTES_S * 1e3
    print(f"[{label}] {n} blocks x {kv} lanes, K {k}"
          f"{', 1 suppress path' if sup is not None else ''}: max abs err "
          f"{err:.3g}, rel {rel:.3g} | kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.3f} ms, the GEMM alone (one torch.matmul) "
          f"{gemm_ms:.3f} ms | {fma:.4g} FMA: 3xTF32 bound {tf32:.4f} ms "
          f"(kernel at {tf32 / k_ms:.1%}), FFMA {ffma:.4f} ms "
          f"({ffma / k_ms:.1%}), bytes {nbytes / 1e6:.1f} MB {mem:.4f} ms "
          f"({smi})", flush=True)
    return dict(n=n, kv=kv, k=k, suppress=sup is not None, ms=k_ms,
                plain_ms=p_ms, gemm_ms=gemm_ms, tf32_bound_ms=tf32,
                ffma_bound_ms=ffma, bytes_bound_ms=mem, err=err, rel=rel)


# --- end to end, in a subprocess per tree ----------------------------------

def _batch_pairs(bench_pair):
    path = os.path.join(REPO, "build", "batch8_i16.npz")
    if os.path.exists(path):
        z = np.load(path)
        return ([(z[f"v{i}"], z[f"a{i}"]) for i in range(int(z["n"]))],
                [tuple(int(x) for x in r) for r in z["lens"]])
    pairs, lens, _, _ = bench_pair.build_batch_pairs(workers=4)
    np.savez(path, n=len(pairs), lens=np.asarray(lens),
             **{f"{s}{i}": p[j] for i, p in enumerate(pairs)
                for j, s in enumerate("va")})
    return pairs, lens


def child(tree):
    """End-to-end numbers of the port in `tree` (one JSON line)."""
    sys.path.insert(0, tree)
    from describealign_tpu_torch import bench_pair, film_pair
    from describealign_tpu_torch.alignment import api, matching, preprocess
    out = {"tree": tree}

    def quiet(fn):
        with contextlib.redirect_stdout(io.StringIO()):
            r = fn()
        torch.cuda.synchronize()
        return r

    def median_runs(fn):
        quiet(fn)
        times = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            quiet(fn)
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), times

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    v, a = bench_pair.build_scale_pair(os.path.join(REPO, "build",
                                                    "bench_pair_i16.npz"))
    out["bench_e2e_s"], out["bench_runs"] = median_runs(
        lambda: api.align_from_pcm(v, a, device="cuda"))
    split = {}
    quiet(lambda: api.align_from_pcm(v, a, device="cuda", timings=split))
    out["bench_split"] = split
    del v, a

    video, audio = film_pair.build_film_features()
    out["film_e2e_s"], out["film_runs"] = median_runs(
        lambda: api.align(video, audio, video[0], audio[0], device="cuda"))
    split = {}
    quiet(lambda: api.align(video, audio, video[0], audio[0], device="cuda",
                            timings=split))
    out["film_split"] = split
    nv, na = video.shape[1], audio.shape[1]
    npad = max(api._bucket_pad(na), api._bucket_pad(nv))
    feats = []
    for x, n_true in ((audio, na), (video, nv)):
        f = api._upload(api._stack_padded(x, n_true, npad), "cuda").float()
        ms, norms = preprocess.preprocess_features(f)
        feats.append((ms, norms, f[0], n_true))
    (ms_a, no_a, e_a, _), (ms_v, no_v, e_v, _) = feats
    a_mask = preprocess.valid_audio_mask(e_a, na)
    v_mask = preprocess.valid_video_mask(e_v, nv)
    nf = matching.COARSE_STREAMS
    desc_a = matching._coarse_descriptors(ms_a[:nf], no_a[:nf], a_mask)
    desc_v = [matching._coarse_descriptors(ms_v[:nf], no_v[:nf], v_mask, p)
              for p in matching.SUB_LANE_SHIFTS]
    nb = desc_a.shape[0] // matching.COARSE_PER_BLOCK
    out["film_streamed_dp_s"], out["film_dp_runs"] = median_runs(
        lambda: matching._k_best_tracks(desc_a, desc_v, nb, True))
    del desc_a, desc_v, feats, video, audio
    torch.cuda.empty_cache()

    pairs, lens = _batch_pairs(bench_pair)
    out["batch8_warm_s"], out["batch8_runs"] = median_runs(
        lambda: api.align_batch_from_pcm(pairs, true_samples=lens))
    print("E2E " + json.dumps(out), flush=True)


def end_to_end(baseline, smi):
    rows = []
    for who, tree in (("parent", baseline), ("change", REPO),
                      ("change", REPO), ("parent", baseline)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(tree)],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"{who} ({tree}) failed:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("E2E "))
        row = dict(json.loads(line[4:]), who=who)
        rows.append(row)
        print(f"[e2e {who}] bench e2e {row['bench_e2e_s']:.3f} s "
              f"(coarse_map {row['bench_split'].get('coarse_map', 0):.4f} "
              f"s, coarse_dp {row['bench_split'].get('coarse_dp', 0):.4f} "
              f"s) | film e2e {row['film_e2e_s']:.3f} s (coarse_dp "
              f"{row['film_split'].get('coarse_dp', 0):.3f} s), streamed DP "
              f"alone {row['film_streamed_dp_s']:.3f} s | batch of 8 warm "
              f"{row['batch8_warm_s']:.3f} s ({smi})", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--baseline", help="another checkout of the repo")
    ap.add_argument("--json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_coarse_map: needs a CUDA device")
    if args.child:
        return child(args.child)
    sys.path.insert(0, REPO)
    from describealign_tpu_torch.ops import coarse_map as cm
    device = torch.device("cuda")
    smi = card_line()
    t0 = time.perf_counter()
    cm.load_library()
    report = {"card": smi, "nvcc_s": time.perf_counter() - t0,
              "config": cm.kernel_config()}
    print(f"[card] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | nvcc coarse_map.cu {report['nvcc_s']:.2f}"
          f" s | tile {report['config']}", flush=True)
    if args.ptxas:
        report["ptxas"] = ptxas(os.path.join(
            REPO, "describealign_tpu_torch", "csrc", "coarse_map.cu"))
        for ln in report["ptxas"]:
            print(f"[ptxas] coarse_map.cu: {ln}", flush=True)
    edge_checks(device)
    cases = [("film tile", 64 * 3, FILM_KV, 128, 64, 64, False),
             ("film tile suppressed", 64 * 3, FILM_KV, 128, 64, 64, True),
             ("bench map", BENCH[0], BENCH[1], 128, 0, BENCH[0], False),
             ("bench map K 256", BENCH[0], BENCH[1], 256, 0, BENCH[0], False)]
    report["cases"] = {c[0]: timed_case(*c, device, smi)
                       for c in cases}
    if args.baseline:
        report["e2e"] = end_to_end(args.baseline, smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print("COARSE_MAP_OK", flush=True)


if __name__ == "__main__":
    main()
