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
   against the JAX result;
4. the user's entry point: `python -m describealign_tpu_torch video.wav
   audio.wav --stretch_audio --yes ...` in a subprocess on the bench pair
   written as WAVs (ffmpeg-free): the output WAV's shape, the .txt report's
   numbers and the printed lines against the JAX package's combine()
   (tests/data/torch_combine_expected.json), the wall time of combine()
   and of its stages, kernel launches;
5. a feature film (95-min film, 101.4-min description, built at the
   feature level, describealign_tpu_torch.film_pair) on the streamed
   coarse DP: (a) the streamed and the materialized k-best DP on the film's
   descriptors, equal paths, scores and margin, each one's time and peak
   memory, and the fine kernel against its plain version on the film's
   first and last chunks; (b) one end-to-end run through the feature-level
   entry align() with its split, launches and peak memory, against the JAX
   result (tests/data/torch_film_pair_expected.json) and the planted 202 s.
Each phase prints its wall time. The line before the last is the kernels'
JSON record; the last line is {"ok": true, "device": {...}}.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import wave

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(REPO, "tests", "data",
                        "torch_bench_pair_expected.json")
COMBINE_EXPECTED = os.path.join(REPO, "tests", "data",
                                "torch_combine_expected.json")
FILM_EXPECTED = os.path.join(REPO, "tests", "data",
                             "torch_film_pair_expected.json")
PLANTED_OFFSET_S = 202.0    # the film pair's lead-in
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


def phase_done(n, t0, smi):
    """Print phase n's wall time since t0; returns the time now."""
    now = time.perf_counter()
    print(f"[{n} wall] phase {n}: {now - t0:.1f} s ({smi})", flush=True)
    return now


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
    err = np.array([abs(dk[k] - dp[k]) for k in common] or [0.0])
    rel = err / np.array([dp[k] for k in common] or [1.0])
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


# The CLI run of phase 4: `python -m describealign_tpu_torch ARGS` through
# runpy, with the fine kernel's launch count and the wall time of combine()
# and of its stages (module functions wrapped with a clock, looked up by
# combine() at call time) printed as one JSON line after the CLI's output.
CLI_RUN = """
import json, runpy, sys, time
import describealign_tpu_torch.alignment.api as api
import describealign_tpu_torch.media.decode as decode
import describealign_tpu_torch.media.mux as mux
import describealign_tpu_torch.report.plots as plots
import describealign_tpu_torch.stretch.segments as segments
from describealign_tpu_torch.ops import fine_kernel
stages = {}
def timed(mod, name, stage):
    fn = getattr(mod, name)
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            stages[stage] = stages.get(stage, 0.0) + time.perf_counter() - t0
    setattr(mod, name, run)
timed(decode, "parse_audio_int16", "decode")
timed(api, "align_from_pcm", "align")
timed(segments, "replace_aligned_segments", "stretch")
timed(mux, "write_replaced_media_to_disk", "write")
timed(plots, "plot_alignment", "report")
sys.argv = ["describealign_tpu_torch"] + sys.argv[1:]
fine_kernel.fine_match.launches = 0
t0 = time.perf_counter()
runpy.run_module("describealign_tpu_torch", run_name="__main__",
                 alter_sys=True)
print(json.dumps({"combine_s": time.perf_counter() - t0, "stages": stages,
                  "launches": fine_kernel.fine_match.launches}))
"""


def report_numbers(lines):
    """(similarity %, start offset s, median rate change %) of a report."""
    def number(prefix):
        line = next(ln for ln in lines if ln.startswith(prefix))
        return float(line[len(prefix):].split()[0].rstrip("%"))
    return (number("Input file similarity:"), number("Start Offset:"),
            number("Median Rate Change:"))


def phase_combine(v, a, smi, n_chunks):
    """Phase 4: the CLI on the bench pair's WAVs, against the JAX
    package's combine() on the same WAVs. Returns the fine kernel's
    launches in the run."""
    from describealign_tpu_torch.alignment import matching
    from describealign_tpu_torch.media.decode import write_wav
    with open(COMBINE_EXPECTED) as f:
        expected = json.load(f)
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as run_dir:
        t0 = time.perf_counter()
        video_wav = os.path.join(run_dir, expected["video_wav"])
        audio_wav = os.path.join(run_dir, expected["audio_wav"])
        write_wav(video_wav, v)
        write_wav(audio_wav, a)
        wav_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_RUN, video_wav, audio_wav,
             "--stretch_audio", "--yes",
             "--output_dir", os.path.join(run_dir, "out"),
             "--alignment_dir", os.path.join(run_dir, "plots")],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        out_text, _, last = proc.stdout.rstrip("\n").rpartition("\n")
        stats = json.loads(last)
        with wave.open(os.path.join(run_dir, "out",
                                    "ad_" + expected["video_wav"])) as w:
            shape = (w.getnchannels(), w.getnframes())
        stem = os.path.splitext(expected["video_wav"])[0]
        with open(os.path.join(run_dir, "plots", stem + ".txt")) as f:
            report = [ln.replace(run_dir, "<run>")
                      for ln in f.read().splitlines()
                      if not ln.startswith(("Version:", "Script Hash:"))]
        printed = [ln.replace(run_dir, "<run>")
                   for ln in out_text.splitlines()
                   if not ln.startswith("Processing files with v")]
    # the port writes the .png only where matplotlib imports, and says so
    no_plot = [ln for ln in printed if ln.startswith("  WARNING: matplotlib")]
    printed = [ln for ln in printed if ln not in no_plot]
    got, want = report_numbers(report), report_numbers(expected["report"])
    checks = {
        "output shape": shape == (expected["output_channels"],
                                  expected["output_samples"]),
        "start offset": abs(got[1] - want[1]) <= TOL_S,
        "similarity": abs(got[0] - want[0]) <= 0.5,
        "median rate change": abs(got[2] - want[2]) <= 1e-4 * 100,
        "printed lines": printed == expected["printed"] and len(no_plot) <= 1,
        "launches": stats["launches"] == n_chunks * matching.N_TRACKS,
    }
    print(f"[4 CLI] python -m describealign_tpu_torch on the bench pair's "
          f"WAVs ({expected['video_samples']} video samples, 2 channels): "
          f"CLI process {cli_s:.2f} s, combine() {stats['combine_s']:.2f} s "
          f"= " + ", ".join(f"{k} {t:.2f} s"
                            for k, t in stats["stages"].items())
          + f" (+ the rest); WAVs written in {wav_s:.2f} s | fine_match "
          f"launches {stats['launches']} | output {shape} | report similarity "
          f"{got[0]:.2f}% start offset {got[1]:.2f} s median rate change "
          f"{got[2]:.2f}% (JAX {want[0]:.2f}, {want[1]:.2f}, {want[2]:.2f}); "
          f"report {'identical to' if report == expected['report'] else 'differs from'}"
          f" JAX's apart from Version/Script Hash; "
          f"{'the matplotlib WARNING, ' if no_plot else ''}"
          f"{len(printed)} printed lines ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        if printed != expected["printed"]:
            print(f"[4 CLI] printed {printed}\n[4 CLI] JAX     "
                  f"{expected['printed']}", flush=True)
        raise AssertionError(f"the CLI disagrees with JAX: {checks}")
    return stats["launches"]


def timed_dp(matching, desc_a, desc_v, nb, streamed):
    """(paths, scores, seconds, peak bytes above the inputs) of the k-best
    coarse DP on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    paths, scores = matching._k_best_tracks(desc_a, desc_v, nb, streamed)
    torch.cuda.synchronize()
    return (paths, scores, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def phase_film(device, smi):
    """Phase 5: the feature film on the streamed coarse DP. Returns (the
    fine kernel's launches in the end-to-end run, [(chunk b0, track,
    *kernel_vs_plain row)] on the film's first and last chunks)."""
    from describealign_tpu_torch import film_pair
    from describealign_tpu_torch.alignment import api, matching, preprocess
    from describealign_tpu_torch.ops import fine_kernel
    with open(FILM_EXPECTED) as f:
        expected = json.load(f)
    t0 = time.perf_counter()
    video, audio = film_pair.build_film_features()
    gen_s = time.perf_counter() - t0
    if film_pair.checksum(video, audio) != expected["checksum"]:
        raise AssertionError("the film pair differs from the expected "
                             "fixture's (checksum)")
    nv, na = video.shape[1], audio.shape[1]
    npad = max(api._bucket_pad(na), api._bucket_pad(nv))
    fa = api._stack_padded(audio, na, npad)
    fv = api._stack_padded(video, nv, npad)
    nb = matching.nb_for(npad)
    kv = ((npad - preprocess.WINDOW - max(matching.SUB_LANE_SHIFTS))
          // matching.COARSE_STRIDE + 1)
    streamed = nb * kv > matching.COARSE_STREAM_ELEMS
    print(f"[5 film] {na / 210 / 60:.1f}-min description, "
          f"{nv / 210 / 60:.1f}-min film, features built in {gen_s:.2f} s: "
          f"Npad {npad}, nb {nb}, kv {kv}, nb*kv {nb * kv} "
          f"({nb * kv / 2**20:.1f} Mi) vs COARSE_STREAM_ELEMS "
          f"{matching.COARSE_STREAM_ELEMS} -> "
          f"{'streamed' if streamed else 'materialized'} branch ({smi})",
          flush=True)
    if not streamed or (nb, kv) != (expected["nb"], expected["kv"]):
        raise AssertionError("the film does not take the streamed branch")

    # (a) the streamed and the materialized DP on the film's descriptors
    t_phase = time.perf_counter()
    feats_a = api._upload(fa, device).float()
    feats_v = api._upload(fv, device).float()
    ms_a, norms_a = preprocess.preprocess_features(feats_a)
    ms_v, norms_v = preprocess.preprocess_features(feats_v)
    a_mask = preprocess.valid_audio_mask(feats_a[0], na)
    v_mask = preprocess.valid_video_mask(feats_v[0], nv)
    nf = matching.COARSE_STREAMS
    desc_a = matching._coarse_descriptors(ms_a[:nf], norms_a[:nf], a_mask)
    desc_v = [matching._coarse_descriptors(ms_v[:nf], norms_v[:nf], v_mask,
                                           p) for p in matching.SUB_LANE_SHIFTS]
    runs = {name: timed_dp(matching, desc_a, desc_v, nb, flag)
            for name, flag in (("streamed", True), ("materialized", False))}
    (sp, ss, s_t, s_mem), (mp, ms, m_t, m_mem) = runs.values()
    margins = [float(matching._coarse_margin(sc, a_mask, nb))
               for sc in (ss, ms)]
    same = (all(torch.equal(a, b) for a, b in zip(sp, mp))
            and [float(x) for x in ss] == [float(x) for x in ms]
            and margins[0] == margins[1])
    print(f"[5a film DP] streamed {s_t:.2f} s, peak {s_mem / 2**30:.3f} GiB "
          f"| materialized {m_t:.2f} s, peak {m_mem / 2**30:.3f} GiB "
          f"(above the descriptors) | track scores {[float(x) for x in ss]}, "
          f"margin {margins[0]:.6f} | paths, scores and margin "
          f"{'equal' if same else 'DIFFER'} ({smi})", flush=True)
    if not same:
        raise AssertionError("streamed and materialized DPs disagree")
    # the materialized DP's scores are views of its cost maps: drop them too
    del runs, sp, ss, mp, ms, desc_a, desc_v, ms_a, ms_v, norms_a, norms_v
    del feats_a, feats_v, a_mask, v_mask
    torch.cuda.empty_cache()

    # the fine kernel against its plain version on the film's chunks
    state = matching.match_coarse(api._upload(fa, device), na,
                                  api._upload(fv, device), nv)
    n_chunks = state[6].shape[1] // matching.FINE_CHUNK
    last_b0 = (n_chunks - 1) * matching.FINE_CHUNK
    rows = [(b0, track) + kernel_vs_plain(state, b0, track, True)
            for b0 in (0, last_b0) for track in range(matching.N_TRACKS)]
    del state
    torch.cuda.empty_cache()
    for b0, track, err, p99, k_ms, p_ms, n, bound, gate in rows:
        print(f"[5a film kernel] chunk b0={b0} track {track}: {n} "
              f"candidates, {len(gate)} at the quality gate, max abs err "
              f"{err:.3g}, p99 rel {p99:.3g}, kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, bound 3xTF32 {bound[1]:.4f} ms ({smi})",
              flush=True)
    a_s = time.perf_counter() - t_phase

    # (b) one end-to-end run through the feature-level entry align()
    split = {}
    torch.cuda.reset_peak_memory_stats()
    fine_kernel.fine_match.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ax, vy, sim, _, slope = api.align(video, audio, video[0], audio[0],
                                          device=device, timings=split)
    e2e = time.perf_counter() - t0
    launches = fine_kernel.fine_match.launches
    peak = torch.cuda.max_memory_allocated()
    printed = out.getvalue()
    start_off = float(ax[0] - vy[0])
    jx = np.asarray(expected["audio_times_s"])
    jy = np.asarray(expected["video_times_s"])
    node_err = float(np.max(np.abs(np.interp(jx, ax, vy) - jy)))
    checks = {
        "start offset": abs(start_off - expected["start_offset_s"]) <= TOL_S,
        "planted 202 s": abs(start_off - PLANTED_OFFSET_S) <= TOL_S,
        "nodes": node_err <= TOL_S,
        "similarity": abs(sim - expected["similarity_percent"]) <= 0.5,
        "median slope": abs(slope - expected["median_slope"]) <= 1e-4,
        "margin": (margins[0] > matching.COARSE_MARGIN_FLOOR
                   and abs(margins[0] / expected["margin"] - 1) <= 1e-5),
        "no WARNING": "WARNING" not in printed,
        "no retry": "rechecking alignment" not in printed,
        "launches": launches == n_chunks * matching.N_TRACKS,
    }
    print(f"[5b film e2e] {e2e:.2f} s | split "
          + ", ".join(f"{k} {t:.3f} s" for k, t in split.items())
          + f" | fine_match launches {launches} ({n_chunks} chunks x "
          f"{matching.N_TRACKS} tracks) | peak device memory "
          f"{peak / 2**30:.3f} GiB | start offset {start_off:.4f} s (JAX "
          f"{expected['start_offset_s']:.4f}, planted {PLANTED_OFFSET_S}), "
          f"max node error {node_err * 1e3:.2f} ms over {len(jx)} JAX nodes, "
          f"similarity {sim:.3f} (JAX {expected['similarity_percent']:.3f}), "
          f"median slope {slope:.7f} (JAX {expected['median_slope']:.7f}), "
          f"margin (5a) {margins[0]:.7f} (JAX {expected['margin']:.7f}) | "
          f"phase 5a {a_s:.1f} s ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"the film disagrees with JAX: {checks}")
    return launches, rows


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
    t_phase = time.perf_counter()
    smi = card_line()
    nvcc_s, gxx_s = build_all(fine_kernel.load_library, native_lib)
    print(smi)
    print(f"[1 card] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | nvcc fine_match.cu {nvcc_s:.2f} s | g++ "
          f"host library {gxx_s:.2f} s", flush=True)
    t_phase = phase_done(1, t_phase, smi)

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
    t_phase = phase_done(2, t_phase, smi)

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
    t_phase = phase_done(3, t_phase, smi)

    # --- phase 4: the user's entry point on the bench pair's WAVs ---------
    cli_launches = phase_combine(v, a, smi, n_chunks)
    del v, a
    t_phase = phase_done(4, t_phase, smi)

    # --- phase 5: a feature film through the streamed coarse DP -----------
    film_launches, film_rows = phase_film(device, smi)
    phase_done(5, t_phase, smi)

    chunk0 = [r for r in rows if r[0] == 0]
    film0 = [r for r in film_rows if r[0] == 0]
    k_ms = float(np.mean([r[4] for r in chunk0]))
    bound = [float(np.mean([r[7][i] for r in chunk0])) for i in range(4)]
    print(json.dumps({"kernels": [{
        "name": "fine_match",
        "route": "cuda",
        "source": "describealign_tpu_torch/csrc/fine_match.cu",
        "replaces": "describealign_tpu/ops/fine_kernel.py:61",
        "launches": launches,
        "launches_by_phase": {"3 align_from_pcm, 3 runs": launches,
                              "4 CLI": cli_launches,
                              "5 film": film_launches},
        "max_abs_err": max(r[2] for r in rows + film_rows),
        "ms": k_ms,
        "plain_ms": float(np.mean([r[5] for r in chunk0])),
        "bound_ms": max(bound[1], bound[3]),
        "bound_by": "operations" if bound[1] >= bound[3] else "bytes",
        "bound_share": max(bound[1], bound[3]) / k_ms,
        "bound_fp32_ms": bound[2],
        "useful_fma": bound[0],
        "gate_flips": sum(len(r[8]) for r in rows),
        "film_chunk_ms": float(np.mean([r[4] for r in film0])),
        "film_chunk_plain_ms": float(np.mean([r[5] for r in film0])),
        "film_chunk_bound_ms": float(np.mean([r[7][1] for r in film0])),
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
