#!/usr/bin/env python
"""The coarse score map's kernel (csrc/coarse_map.cu, ops/coarse_map.py
`block_scores`) on one card, against its plain version, and end to end
against another checkout of the repo.

    python scripts/torch_coarse_map.py [--ptxas] [--variants]
        [--baseline TREE] [--no-e2e] [--json OUT.json]

Checks the kernel against block_scores_plain on seeded descriptors
(standard normal / sqrt(K)): edge shapes of its tiles (Kv below the
9-row skew halo, Kv off the 128- and 64-lane tiles, blocks off the
64-block row tile, partial tiles at b0 > 0, suppress paths near lane 0
and near Kv, K 96, 128 and 256) and
the main path's shapes: the bench pair's map (1,663 blocks x 16,638 lanes,
K 128) in one call, the same with K 256 (the 5-stream retry), and film
tiles (64 x 61,438) with and without a suppress path. The map must agree
within rtol 1e-5 / atol 1e-4, and suppressed lanes exactly. Then CUDA-event
times of the kernel, the plain version and the GEMM alone (one
torch.matmul of the 7 phases' product, no skew max) beside the bounds:
3xTF32 (6 FLOP per FMA at 495 TFLOP/s), fp32 FFMA (2 FLOP at 67 TFLOP/s)
and the bytes at 3.35 TB/s. --ptxas prints ptxas's registers, shared
memory, spills and warnings (a serialized wgmma pipeline among them) and
the SASS instruction mix of each kernel in the source (`cuobjdump -sass`:
HGMMA, the wgmma; HMMA, the mma.sync; BAR, the CTA barriers), of TREE's
source too with --baseline.

--variants builds two variants of the kernel from csrc/coarse_map.cu by
text substitution (into build/, loaded with ctypes, never used by the
port) and times them on the same cases beside it: `k16`, two k-steps per
IEEE add (the six products of two k-steps from one zeroed accumulator;
held to the plain version like the kernel), and `tensor_sum`, every
product accumulated in the tensor core with no IEEE add (not the numerics
rule: the rate of the kernel's wgmma stream without its adds, a ceiling;
its map is not checked).

--baseline TREE (another checkout, `git archive REV | tar -x -C TREE`)
runs both trees in subprocesses in the order TREE, this, this, TREE: the
kernel's times on the bench map (K 128 and 256) and the film tile (with
and without a suppress path), then, unless --no-e2e, the port end to end:
the bench pair through align_from_pcm (e2e median and the coarse_map /
coarse_dp split), the 95-min film through align() (e2e, split, and the
k-best streamed DP alone on its descriptors) and the batch of 8 through
align_batch_from_pcm (warm wall). The pairs are cached under build/.
--json writes the numbers to a file. Needs a CUDA device and nvcc.
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


SASS_OPS = ("HGMMA", "HMMA", "BAR")


def ptxas(path, tag):
    """(ptxas -v lines, {kernel: {op: count}}) of a source: its registers,
    shared memory, spills and warnings, and the SASS instruction mix of
    each kernel in it (cuobjdump -sass of the cubin)."""
    from describealign_tpu_torch.ops import _build
    cubin = os.path.join(_build.BUILD_DIR, f"coarse_map_{tag}.cubin")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc()] + _build.NVCC_FLAGS[:4]
        + ['-cubin', '-Xptxas', '-v', '-o', cubin, path],
        capture_output=True, text=True, check=True)
    lines = [ln.strip() for ln in proc.stderr.splitlines() if ln.strip()]
    nvcc_dir = os.path.dirname(_build._nvcc())
    cuobjdump = os.path.join(nvcc_dir, "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    mix, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            mix[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None and "/*" in ln:
            words = ln.split("*/", 1)[-1].replace(";", " ").split()
            ops = [w for w in words if not w.startswith("@")][:1]
            for op in SASS_OPS:
                if ops and ops[0].split(".")[0] == op:
                    mix[name][op] += 1
    return lines, mix


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


# (blocks in desc_a, Kv, K, b0, n): the kernel's tile edges
EDGE_CASES = [(5, 7, 128, 0, 5), (13, 128, 128, 0, 13), (9, 129, 128, 0, 9),
              (13, 65, 256, 0, 13), (70, 500, 128, 64, 6),
              (70, 129, 128, 0, 65), (150, 300, 128, 37, 100),
              (70, 161, 256, 3, 67), (130, 1000, 256, 64, 64),
              (30, 140, 96, 0, 30), (200, 2000, 128, 192, 8)]


def edge_checks(device):
    from describealign_tpu_torch.ops import coarse_map as cm
    rng = np.random.default_rng(3)
    cases = EDGE_CASES
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


CASES = [("film tile", 64 * 3, FILM_KV, 128, 64, 64, False),
         ("film tile suppressed", 64 * 3, FILM_KV, 128, 64, 64, True),
         ("bench map", BENCH[0], BENCH[1], 128, 0, BENCH[0], False),
         ("bench map K 256", BENCH[0], BENCH[1], 256, 0, BENCH[0], False)]


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


# --- variants of the kernel's source, built beside it ----------------------

_PART = "    float part[SPW][NR];\n"
_SPW = "  static constexpr int STEPS_PER_WAIT = N >= 128 ? 1 : 2;"
_PRODUCTS = """      wgmma_fence();
      wgmma_tf32<0>(part[u], al, d_hi);   // lo * hi
      wgmma_tf32<1>(part[u], ah, d_lo);   // + hi * lo
      wgmma_tf32<1>(part[u], ah, d_hi);   // + hi * hi
"""
_ADDS = """#pragma unroll
    for (int u = 0; u < SPW; ++u) {
      fence_regs(part[u]);
#pragma unroll
      for (int i = 0; i < NR; ++i) sum[i] += part[u][i];
    }
"""


def variant_sources(src):
    """{name: source} of the variants (module docstring). Raises if the
    kernel's text no longer has the anchors they replace."""
    for anchor in (_PART, _SPW, _PRODUCTS, _ADDS):
        if anchor not in src:
            raise AssertionError("csrc/coarse_map.cu changed: a variant's "
                                 "anchor is gone")
    # k16: k-step pairs (SPW 2) into one accumulator, one add per pair
    k16 = src.replace(_PRODUCTS, """      wgmma_fence();
      if (u == 0)
        wgmma_tf32<0>(part[0], al, d_hi);
      else
        wgmma_tf32<1>(part[0], al, d_hi);
      wgmma_tf32<1>(part[0], ah, d_lo);
      wgmma_tf32<1>(part[0], ah, d_hi);
""").replace(_ADDS, """    fence_regs(part[0]);
#pragma unroll
    for (int i = 0; i < NR; ++i) sum[i] += part[0][i];
""").replace(_PART, "    float part[1][NR];\n").replace(
        _SPW, "  static constexpr int STEPS_PER_WAIT = 2;")
    # tensor_sum: every product into the sum in the tensor core
    tsum = src.replace(_PRODUCTS, """      wgmma_fence();
      wgmma_tf32<1>(sum, al, d_hi);
      wgmma_tf32<1>(sum, ah, d_lo);
      wgmma_tf32<1>(sum, ah, d_hi);
""").replace(_ADDS, "    fence_regs(sum);\n").replace(_PART, "")
    return {"k16": k16, "tensor_sum": tsum}


def build_variant(name, src):
    """ctypes library of a variant source, built with the port's nvcc
    flags into build/describealign_tpu_torch/."""
    import ctypes
    from describealign_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"coarse_map_{name}.cu")
    so = os.path.join(_build.BUILD_DIR, f"libcoarse_map_{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + ['-o', so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.coarse_map_launch.restype = ctypes.c_int
    lib.coarse_map_launch.argtypes = [ptr] * 4 + [ll] * 7 + [ptr]
    return lib


def variant_cases(device, smi):
    """Each variant's times on CASES beside the kernel's (k16 also held to
    the plain version)."""
    from describealign_tpu_torch.ops import coarse_map as cm
    src = open(os.path.join(REPO, "describealign_tpu_torch", "csrc",
                            "coarse_map.cu")).read()
    out = {}
    for name, vsrc in variant_sources(src).items():
        lib = build_variant(name, vsrc)

        def launch(a, v, b0, n, sup):
            got = torch.empty((n, v.shape[1]), device=device)
            rc = lib.coarse_map_launch(
                a.data_ptr(), v.data_ptr(),
                None if sup is None else sup.data_ptr(), got.data_ptr(),
                a.shape[0], a.shape[1], v.shape[1], b0, n,
                0 if sup is None else sup.shape[0],
                0 if sup is None else sup.shape[1],
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"variant {name}: CUDA error {rc}")
            return got
        for label, nb, kv, k, b0, n, with_sup in CASES:
            a, v = descriptors(nb, kv, k, 7, device)
            sup = None
            if with_sup:
                sup = (torch.arange(nb, device=device, dtype=torch.int32)
                       * 10 % kv)[None, :].contiguous()
            err = None
            if name == "k16":
                err, _ = compare(f"{name} {label}",
                                 launch(a, v, b0, n, sup),
                                 cm.block_scores_plain(a, v, b0, n, sup))
            ms = [cuda_ms(lambda: launch(a, v, b0, n, sup), REPS),
                  cuda_ms(lambda: cm.block_scores(a, v, b0, n, sup), REPS),
                  cuda_ms(lambda: launch(a, v, b0, n, sup), REPS)]
            fma, _ = cm.block_scores_work(n, kv, k)
            tf32 = 6 * fma / TF32_FLOPS * 1e3
            out[f"{name} {label}"] = dict(ms=ms[0::2], kernel_ms=ms[1],
                                          tf32_bound_ms=tf32, err=err)
            print(f"[variant {name}] {label}: {ms[0]:.4f} / {ms[2]:.4f} ms "
                  f"({tf32 / min(ms[0::2]):.1%} of 3xTF32), the kernel "
                  f"{ms[1]:.4f} ms between"
                  + ("" if err is None else f", max abs err {err:.3g}")
                  + f" ({smi})", flush=True)
            del a, v
        torch.cuda.empty_cache()
    return out


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


def child(tree, e2e):
    """The kernel's times on CASES and, with e2e, the end-to-end numbers of
    the port in `tree` (one JSON line)."""
    sys.path.insert(0, tree)
    smi = card_line()
    out = {"tree": tree, "cases": {
        c[0]: timed_case(*c, torch.device("cuda"), smi) for c in CASES}}
    torch.cuda.empty_cache()
    if not e2e:
        print("E2E " + json.dumps(out), flush=True)
        return
    from describealign_tpu_torch import bench_pair, film_pair
    from describealign_tpu_torch.alignment import api, matching, preprocess

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


def end_to_end(baseline, smi, e2e):
    rows = []
    for who, tree in (("parent", baseline), ("change", REPO),
                      ("change", REPO), ("parent", baseline)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(tree)] + ([] if e2e else ["--no-e2e"]),
            cwd=REPO, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"{who} ({tree}) failed:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("E2E "))
        row = dict(json.loads(line[4:]), who=who)
        rows.append(row)
        print(f"[kernel {who}] " + " | ".join(
            f"{label} {r['ms']:.4f} ms ({r['tf32_bound_ms'] / r['ms']:.1%} "
            f"of 3xTF32)" for label, r in row["cases"].items())
            + f" ({smi})", flush=True)
        if not e2e:
            continue
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
    ap.add_argument("--variants", action="store_true",
                    help="time the k16 and tensor_sum variants beside")
    ap.add_argument("--no-e2e", action="store_true",
                    help="with --baseline, the kernel's times only")
    ap.add_argument("--json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_coarse_map: needs a CUDA device")
    if args.child:
        return child(args.child, not args.no_e2e)
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
        trees = [("change", REPO)] + ([("parent", args.baseline)]
                                      if args.baseline else [])
        report["ptxas"] = {}
        for who, tree in trees:
            lines, mix = ptxas(os.path.join(
                tree, "describealign_tpu_torch", "csrc", "coarse_map.cu"), who)
            report["ptxas"][who] = {"lines": lines, "sass": mix}
            for ln in lines:
                print(f"[ptxas {who}] coarse_map.cu: {ln}", flush=True)
            for name, ops in mix.items():
                print(f"[sass {who}] {name}: " + ", ".join(
                    f"{op} {n}" for op, n in ops.items()), flush=True)
    edge_checks(device)
    report["cases"] = {c[0]: timed_case(*c, device, smi) for c in CASES}
    if args.variants:
        report["variants"] = variant_cases(device, smi)
    if args.baseline:
        report["e2e"] = end_to_end(args.baseline, smi, not args.no_e2e)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print("COARSE_MAP_OK", flush=True)


if __name__ == "__main__":
    main()
