#!/usr/bin/env python
"""Smoke run of the PyTorch port on an NVIDIA GPU (H100): build its CUDA
kernels from the sources, hold each kernel against its plain version, drive
the single-pair main path on the bench pair, the CLI, a feature film, a
batch of 8 pairs, the device-feature path, the output side (device fit,
device phase vocoder and resampler), the last device modules (mel
frontend, sequence sharding, data-parallel batch), the GUI's combiner
worker, the JAX package's edge-case structures and the multi-device
dryrun's twin, and check the results against the JAX package's
(tests/data/torch_*_expected.json).

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero without them. Phases:
1. card: nvidia-smi name and power limit, torch / CUDA versions, build times;
2. kernel vs plain: fine_match's CUDA kernel against fine_match_plain on
   the bench pair's coarse state, on every 256-block chunk of both tracks
   (the last chunk carries nonzero audio starts and padded blocks): equal
   candidate sets keyed by (block, frame, video frame), 99th percentile
   relative quality error < 1e-3, every candidate's relative quality
   error < MAX_REL = 2e-3 (an error of the correlation counts in units of
   1 - corr, see MAX_REL) and absolute error < MAX_ABS = 1e-2 (the film's
   chunks in phase 5a too). Times from CUDA events on the first
   and the last chunk; the first chunk's useful FMA count (from the masks
   and bands) and the kernel's bound: 3xTF32 on the tensor cores, beside
   fp32 FFMA and device memory;
2b. the coarse-DP kernels vs plain: dp_forward and dp_backtrace
   (csrc/coarse_dp.cu) against their plain torch loops on the bench pair's
   real score map, for track 1 and for the suppressed track 2: rows
   torch.equal, paths equal (tolerance 0: max-plus is exact). CUDA-event
   times of both beside the bytes bound and beside n empty steps of
   dp_forward's cluster (halo + exchange + barriers, no arithmetic: the
   floor of the sequential scan); the cluster size, which must be more
   than one CTA at these widths. dp_backtrace on rows that trip its guard
   (rows of -1e30, maxima at 2^22 and above). The same as the bench map's
   on one 64-row film tile at D = 61,438 from a non-zero checkpoint (in
   phase 5a);
2c. the coarse score map's kernel vs plain: block_scores
   (csrc/coarse_map.cu) against block_scores_plain on the bench pair's
   whole map (nf 3, K 128, one launch) and on its 5-stream map (K 256),
   and (in phase 5a) on the film's tiles 0 and 1 with and without track
   1 suppressed: the map within MAP_RTOL / MAP_ATOL, suppressed lanes
   equal, both k-best DP tracks from the kernel's map equal to those from
   the plain map (on a film tile: dp_forward + dp_backtrace from a zero
   row). CUDA-event times of the kernel, the plain version and the GEMM
   alone (one torch.matmul of the 7 phases' product, no skew max: no
   PyTorch call computes the whole function) beside the bounds: 3xTF32,
   fp32 FFMA and the bytes;
3. main path: describealign_tpu_torch align_from_pcm on the bench pair
   (22-min video, 27-min description), one warm-up and 3 timed runs, a
   per-stage split, kernel launch counts (coarse_score_map, fine_match
   and the DP's), peak device memory, and the check
   against the JAX result;
4. the user's entry point: `python -m describealign_tpu_torch video.wav
   audio.wav --stretch_audio --yes ...` in a subprocess on the bench pair
   written as WAVs (ffmpeg-free): the output WAV's shape, the .txt report's
   numbers and the printed lines against the JAX package's combine()
   (tests/data/torch_combine_expected.json), the wall time of combine()
   and of its stages, kernel launches;
5. a feature film (95-min film, 101.4-min description, built at the
   feature level, describealign_tpu_torch.film_pair) on the coarse DP's
   branch that matching.coarse_streamed picks on the card: (a) the
   streamed and the materialized k-best DP on the film's descriptors,
   equal paths, scores and margin, each one's time and peak memory (the
   materialized peak within matching.coarse_peak_bytes), and the fine
   kernel against its plain version on the film's first and last chunks;
   (b) two end-to-end runs through the feature-level entry align(), on the
   branch the card allows and with the card reported full (streamed),
   each with its split, launches (those of the branch its coarse pass
   took) and peak memory, against the JAX result
   (tests/data/torch_film_pair_expected.json) and the planted 202 s, the
   second's answer equal to the first's;
6. the batch: describealign_tpu_torch.bench_pair.build_batch_pairs() (8
   distinct ~22-min / ~27-min pairs, one of ~50 % similarity, one slowed
   by 3 %) through align_batch_from_pcm twice (first and warm) and one by
   one through align_from_pcm: every batch tuple equal to the single-pair
   tuple apart from the margin (f16 in the batch: 1e-3 relative), every
   pair against the JAX batch result
   (tests/data/torch_batch8_expected.json: nodes within 10 ms, similarity
   within 0.5, slope within 1e-4) and the 6 plain pairs' planted offsets
   within 10 ms. Batch and one-by-one wall, audio-minutes per second,
   launches by kernel, the dense buffer's bytes and device-to-host time
   per pair, host waits in a pair's dispatch, peak device memory. For the
   ~50 %-similarity pair, how many fine candidates the kernel and its
   plain version keep differently, all of which must sit on the quality
   gate's floor or tie for a row's last kept places, and the worst
   relative quality error (below MAX_REL; no absolute bound there);
7. the device-feature path (int16 PCM to features on the card in two
   kernels, csrc/features_dev.cu, the single-shot matcher): (a) K1
   pcm_frontend and K2 polyphase_blur (every stage of the cascade) against
   their plain versions on the bench pair's two padded streams: FIR
   outputs and crossing counts bit-equal, energy within rtol 1e-6; the
   five streams within rtol 1e-4 / atol 1e-5 of the host C++ extractor
   but for the last EDGE_FRAMES frames, where the two read the end of the
   PCM differently (counted, and held to rtol 1e-2 / atol 1e-3);
   CUDA-event times of both kernels and of their plain versions beside the
   bytes bound, of K2's stages as strided conv1d (conv1d_blur, TF32 off:
   the library reference), and the PCM upload's time; the fine kernel on
   the device path's own state (each stream at its own width, all blocks
   in one call per track) and the DP kernels on its score map against
   their plain versions, by phase 2's and 2b's rules; (b) the bench pair
   through align_from_pcm(features='device'): one warm-up and 3 timed
   runs, the
   split beside the host path's (phase 3), launches, against the JAX
   device-feature fixture (tests/data/torch_device_features_expected.json:
   nodes and start offset within 10 ms, similarity within 0.5); (c) the
   batch of 8 through align_batch_from_pcm(features='device'), each pair
   equal to its align_from_pcm(features='device'), wall, audio-minutes per
   second, host waits in one pair's dispatch;
8. the output side: (a) the bench pair through
   align_from_pcm(fit_backend='device') against the JAX device-fit fixture
   (tests/data/torch_fit_device_expected.json: nodes and start offset
   within 10 ms, similarity within 0.5, slope within 1e-4, no fallback
   WARNING, two ADMM launches); fused_lasso_admm (csrc/fit_admm.cu)
   against its plain version on the fit's four problems (both stages on
   the bench pair's and the film's compressed nodes, n_pad 8,192 and
   16,384): t and z bit-equal, CUDA-event times beside the bytes and fp32
   bounds and the floor (the solve's CTA barriers on an empty CTA plus its
   warp steps on an empty warp), the arrays in shared memory (the
   library's count checked against fit_kernel.shared_slots); the batch of
   8's node sets through solve_l1_fit_device_batched equal to the
   per-problem calls; (b) pv_phase_lock (csrc/pv_lock.cu: prologue, walk,
   epilogue) on the rate pair's first stretched segment (stereo spectra
   on the card): bit-equal to its plain version on the path's first
   8,192-frame block, the whole segment in one call against the host
   library's recurrence on the same magnitudes, phases and increments;
   per block and per segment the CUDA-event time of the call and of each
   pass alone beside the bytes it moves as built, the function's bytes
   bound and an empty walk of the same frames; (c) the rate pair as stereo WAVs through combine() with the
   device PV (counted), the device and host resamplers
   (no_pitch_correction), and - cut to the video's first 240 s, the host
   references being slower - the host PV, the device PV and WSOLA: each
   run's wall and stretch stage; the device and host backends' agreement
   in f16 grid steps and RMS, measured (their sample positions are f32 and
   f64); the card's device resampler within one f16 grid step of the same
   function on the CPU (the plain versions the CPU tests hold to JAX) on
   the whole first stretched segment, the device PV within RMS 0.1 of it
   (PV_CARD_RMS) on the segment's first 2^19 samples; the CLI with
   --fit_backend device
   (and --no_pitch_correction, to keep WSOLA's host time out) on the full
   WAVs: exit 0, no fallback WARNING, ADMM launches;
9. the last device modules, against tests/data/torch_mel_expected.json and
   tests/data/torch_sharded_expected.json (the JAX package's results,
   scripts/torch_expected_parallel.py): (a) the bench pair through
   align_from_pcm(frontend='mel') (the host mel bands), e2e and split, or
   the JAX fixture's raise; (b) features_for(frontend='mel') on both
   tracks on the card (K1 once and K2 twice per track, the torch mel
   bands: each stream within MEL_RTOL / MEL_ATOL of the same function on
   the CPU), then align(); peak memory, mel_band_features' and its rFFT's
   CUDA-event times; (c) sequence_sharded_features over [cuda:0] * 4 and
   [cuda:0] against the unsharded extract_features on the card, each track
   cut to a multiple of 210 x 4: interior frames bit-equal (or within the
   CPU bars), the edge smear, wall times, one K1 and one K2 per shard (one
   card cannot time a multi-GPU exchange); (d) the batch of 8 through
   align_batch_from_pcm with mesh=make_mesh(), mesh=[cuda:0] * 3 and the
   serial path: every pair's nodes within 10 ms of the JAX fixtures, the
   wall and launches of each route, host waits in one group's dispatch;
10. the last modules: (a) the GUI's combiner worker (gui.core) on phase
   4's WAVs, its five settings written through SettingsModel (stretch
   mode): run_combine_to_queue in this process on the bare default
   device, every chunk through TranscriptModel, no line tagged error, the
   report's numbers against tests/data/torch_combine_expected.json and the
   output's shape by phase 4's rules, the kernels' launches as in phase 4;
   then in the child gui.core.start_worker spawns, as CombineFrame does:
   exit code 0, no error line, the output written; (b) the JAX package's
   eight edge-case structures (bench_pair.build_campaign_case: music beds,
   PAL 25/24, a 4.5-min mix, silences, ...) through align_from_pcm on the
   card against tests/data/torch_campaign_expected.json by
   tests/test_torch_campaign.py's rules (input hashes, nodes within 10 ms,
   similarity within 0.5, slope within 1e-4, the retry decision, the
   printed lines and the LIS chain equal; the returned path equal, or
   equal to the same call on this machine's CPU, whose host library sets
   its last bits), and the fine kernel against its plain version on every
   chunk of each case; (c) scripts/torch_dryrun_multichip.py in
   a subprocess on [cuda:0] * 2 and [cuda:0] * 4 (meshes 2 x 1 and 2 x 2):
   exit 0, interior frames bit-equal to the unsharded extractor, the JAX
   dryrun's line, the launches of its five kernels.
Each phase prints its wall time. The line before the last is the kernels'
JSON record; the last line is {"ok": true, "device": {...}}.
"""
import contextlib
import hashlib
import io
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
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
BATCH_EXPECTED = os.path.join(REPO, "tests", "data",
                              "torch_batch8_expected.json")
DEVICE_EXPECTED = os.path.join(REPO, "tests", "data",
                               "torch_device_features_expected.json")
FIT_EXPECTED = os.path.join(REPO, "tests", "data",
                            "torch_fit_device_expected.json")
MEL_EXPECTED = os.path.join(REPO, "tests", "data",
                            "torch_mel_expected.json")
SHARDED_EXPECTED = os.path.join(REPO, "tests", "data",
                                "torch_sharded_expected.json")
CAMPAIGN_EXPECTED = os.path.join(REPO, "tests", "data",
                                 "torch_campaign_expected.json")
DRYRUN = os.path.join(REPO, "scripts", "torch_dryrun_multichip.py")
FIXTURES = (EXPECTED, COMBINE_EXPECTED, FILM_EXPECTED, BATCH_EXPECTED,
            DEVICE_EXPECTED, FIT_EXPECTED, MEL_EXPECTED, SHARDED_EXPECTED,
            CAMPAIGN_EXPECTED, DRYRUN)
MARGIN_REL = 1e-3           # batch margin (an f16 word) vs the f32 margin
PLANTED_OFFSET_S = 202.0    # the film pair's lead-in
TOL_S = 0.010               # node / start-offset agreement with JAX, seconds
P99_REL = 1e-3              # kernel vs plain: 99th percentile relative error
# kernel vs plain: the worst absolute quality error of any candidate
# (qualities reach QUAL_MAX = 50), on the bench, film and device-path
# states. Not on the ~50 %-similarity pair: there a quality of 28.8 took
# 0.0136 (below), so it is held to MAX_REL alone; nor on the edge-case
# structures of phase 10b, where a quality of 49.52 took 0.0199 (4.0e-4
# relative) on the 4.5-min mixed case
MAX_ABS = 1e-2
# kernel vs plain: the worst relative quality error of any candidate. With
# q = (prob / QUAL_SCALE)^(-1/3) and prob = prod(1 - corr_i)^2.9, dq / q =
# 0.967 sum_i dcorr_i / (1 - corr_i): an error of the correlation counts in
# units of 1 - corr, which is ~0.013 at the quality 28.8 of the worst
# candidate measured (0.0136 absolute, 4.7e-4 relative, on the lowsim
# pair). 2e-3 holds that with 4x room; one TF32 pass in place of 3xTF32
# (~1e-4 on a correlation) gives ~1e-2 there and fails
MAX_REL = 2e-3
# Kernel and plain sum the correlations in other orders, so a candidate
# whose probability sits on QUAL_PROB_CUTOFF may be kept by one side only:
# allowed when its quality is within GATE_REL of the gate's floor, at most
# one per GATE_PER candidates of a chunk; any other difference fails
GATE_REL = 1e-4
GATE_PER = 20000
# The top-8 of a row keeps the 8 best: where the 8th and 9th qualities agree
# within the kernel's rounding (3xTF32 products, another summation order),
# either side may keep either. Looked for only where asked (phase 6)
TIE_REL = 1e-4
REPS = 5                    # timed launches per kernel-vs-plain measurement
# coarse score map, kernel vs plain: 3xTF32 products summed in another
# order than cuBLAS's fp32 GEMM; the bar of tests/test_torch_coarse.py's
# score-map parity (XLA vs torch)
MAP_RTOL = 1e-5
MAP_ATOL = 1e-4
# NVIDIA H100 SXM peaks (data sheet, dense, at 700 W)
TF32_FLOPS = 495e12         # tensor cores, TF32
FP32_FLOPS = 67e12          # FFMA outside the tensor cores
HBM_BYTES_S = 3.35e12


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS):
    """Mean milliseconds per call of fn over reps calls after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_counts(reset=False):
    """{kernel: launches so far}; reset sets every count to 0 first."""
    from describealign_tpu_torch.ops import (coarse_dp, coarse_map,
                                             features_kernel, fine_kernel,
                                             fit_kernel, pv_kernel)
    wrappers = {"coarse_score_map": coarse_map.block_scores,
                "fine_match": fine_kernel.fine_match,
                "dp_forward": coarse_dp.dp_forward,
                "dp_backtrace": coarse_dp.dp_backtrace,
                "pcm_frontend": features_kernel.pcm_frontend_cuda,
                "polyphase_blur": features_kernel.polyphase_blur_cuda,
                "fused_lasso_admm": fit_kernel.fused_lasso_admm,
                "pv_phase_lock": pv_kernel.pv_phase_lock}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return {k: w.launches for k, w in wrappers.items()}


EMPTY_STEPS = 20000         # steps of the empty-step measurement
MIN_CLUSTER = 2             # dp_forward's CTAs at the bench and film widths


def dp_vs_plain(label, prev, scores, o_last, smi, tag="2b"):
    """dp_forward and dp_backtrace against their plain versions on one
    score map. Returns {kernel: {ms, plain_ms, bound_ms, n, d, err, ...}}
    and fails on any difference or on a cluster of one CTA."""
    from describealign_tpu_torch.ops import coarse_dp
    n, d = scores.shape
    rows = coarse_dp.dp_forward(prev, scores)
    cluster, threads, lanes, npass = coarse_dp.dp_forward.config
    path = coarse_dp.dp_backtrace(o_last, rows)
    torch.cuda.synchronize()
    rows_p = coarse_dp.dp_forward_plain(prev, scores)
    path_p = coarse_dp.dp_backtrace_plain(o_last, rows_p)
    row_err = float((rows - rows_p).abs().max())
    path_err = int((path != path_p).sum())
    same = torch.equal(rows, rows_p) and path_err == 0
    f_ms = cuda_ms(lambda: coarse_dp.dp_forward(prev, scores))
    b_ms = cuda_ms(lambda: coarse_dp.dp_backtrace(o_last, rows))
    fp_ms = cuda_ms(lambda: coarse_dp.dp_forward_plain(prev, scores), 1)
    bp_ms = cuda_ms(lambda: coarse_dp.dp_backtrace_plain(o_last, rows), 1)
    f_bound, b_bound = (x / HBM_BYTES_S * 1e3 for x in coarse_dp.dp_work(n, d))
    # the same cluster doing only a step's exchange and barriers
    floor_us = coarse_dp.empty_step_ms(EMPTY_STEPS, cluster,
                                       threads) / EMPTY_STEPS * 1e3
    print(f"[{tag} DP kernels vs plain] {label} ({n} x {d}): rows "
          f"{'equal' if torch.equal(rows, rows_p) else 'DIFFER'} (max abs "
          f"err {row_err:.3g}), path {'equal' if path_err == 0 else 'DIFFERS'}"
          f" ({path_err} lanes) | dp_forward on a cluster of {cluster} CTAs "
          f"x {threads} threads x {lanes} lanes {f_ms:.3f} ms "
          f"({f_ms / n * 1e3:.2f} us per step), plain {fp_ms:.1f} ms, bytes "
          f"bound {f_bound:.4f} ms, empty step {floor_us:.3f} us so n empty "
          f"steps {floor_us * n / 1e3:.3f} ms | dp_backtrace {b_ms:.3f} ms "
          f"({b_ms / n * 1e3:.2f} us per step), plain {bp_ms:.1f} ms, bytes "
          f"bound {b_bound:.4f} ms ({smi})", flush=True)
    if not same:
        raise AssertionError(f"{label}: the DP kernels disagree with their "
                             f"plain versions")
    if cluster < MIN_CLUSTER or npass:
        raise AssertionError(f"{label}: dp_forward launched {cluster} CTAs, "
                             f"{npass} passes; expected a cluster at this "
                             f"width")
    return {"dp_forward": dict(ms=f_ms, plain_ms=fp_ms, bound_ms=f_bound,
                               n=n, d=d, err=row_err, cluster=cluster,
                               threads=threads, lanes=lanes,
                               empty_step_us=floor_us),
            "dp_backtrace": dict(ms=b_ms, plain_ms=bp_ms, bound_ms=b_bound,
                                 n=n, d=d, err=float(path_err))}


def backtrace_guard(n, d, device, smi):
    """dp_backtrace on cost rows that trip its guard, against the plain
    loop, from the last row and from a given lane."""
    from describealign_tpu_torch.ops import coarse_dp
    host, tripped = coarse_dp.guard_rows(n, d, 11)
    rows = torch.from_numpy(host).to(device)
    same = True
    for o_last in (None, torch.tensor(d // 3, dtype=torch.int64,
                                      device=device)):
        path = coarse_dp.dp_backtrace(o_last, rows)
        same &= torch.equal(path, coarse_dp.dp_backtrace_plain(o_last, rows))
    ms = cuda_ms(lambda: coarse_dp.dp_backtrace(None, rows))
    print(f"[2b DP guard] {n} x {d} cost rows, {tripped} with |max| >= 2^22 "
          f"(the walk scans those whole): paths "
          f"{'equal' if same else 'DIFFER'} | dp_backtrace {ms:.3f} ms "
          f"({ms / n * 1e3:.2f} us per step) ({smi})", flush=True)
    if not same or not tripped:
        raise AssertionError("dp_backtrace disagrees with its plain version "
                             "on rows that trip the guard")


def coarse_descriptors(fa, na, fv, nv, device, nf=None):
    """(audio descriptors, the 7 video phases' (7, Kv, K) descriptors,
    audio mask) of the coarse pass over nf streams (None: COARSE_STREAMS),
    from padded (5, Npad) f32 feature stacks."""
    from describealign_tpu_torch.alignment import api, matching, preprocess
    feats_a = api._upload(fa, device).float()
    feats_v = api._upload(fv, device).float()
    ms_a, norms_a = preprocess.preprocess_features(feats_a)
    ms_v, norms_v = preprocess.preprocess_features(feats_v)
    a_mask = preprocess.valid_audio_mask(feats_a[0], na)
    v_mask = preprocess.valid_video_mask(feats_v[0], nv)
    nf = nf or matching.COARSE_STREAMS
    desc_a = matching._coarse_descriptors(ms_a[:nf], norms_a[:nf], a_mask)
    desc_v = torch.stack([matching._coarse_descriptors(
        ms_v[:nf], norms_v[:nf], v_mask, p)
        for p in matching.SUB_LANE_SHIFTS])
    return desc_a, desc_v, a_mask


def k_best_of(p_map):
    """Both k-best tracks' paths and scores of the DP over a score map, the
    second with the first suppressed (matching._k_best_tracks on a given
    map)."""
    from describealign_tpu_torch.alignment import matching
    lanes = torch.arange(p_map.shape[1], dtype=torch.int32,
                         device=p_map.device)[None, :]
    paths, scores = [], []
    for _ in range(matching.N_TRACKS):
        path, score = matching._coarse_dp(p_map)
        paths.append(path)
        scores.append(float(score))
        p_map = torch.where(
            torch.abs(lanes - path[:, None]) <= matching.SUPPRESS_LANES,
            torch.tensor(-1e30, dtype=torch.float32, device=p_map.device),
            p_map)
    return paths, scores


def map_vs_plain(label, desc_a, desc_v, b0, n, suppress, smi, timed=True):
    """coarse_score_map (block_scores, csrc/coarse_map.cu) against
    block_scores_plain on blocks [b0, b0 + n): the map within MAP_RTOL /
    MAP_ATOL and the suppressed lanes equal, else it fails. With timed,
    CUDA-event times of the kernel, the plain version and the GEMM alone
    (one torch.matmul of the 7 phases' product) beside the bounds. Returns
    (kernel map, plain map, record)."""
    from describealign_tpu_torch.ops import coarse_map
    kv, k = desc_v.shape[1], desc_v.shape[2]
    got = coarse_map.block_scores(desc_a, desc_v, b0, n, suppress)
    torch.cuda.synchronize()
    want = coarse_map.block_scores_plain(desc_a, desc_v, b0, n, suppress)
    live = want != -1e30
    err = (got - want).abs()
    ok = (torch.equal(got == -1e30, ~live)
          and bool(torch.all(err <= MAP_ATOL + MAP_RTOL * want.abs())))
    max_err = float(err[live].max())
    max_rel = float((err[live] / want[live].abs().clamp_min(1e-6)).max())
    fma, nbytes = coarse_map.block_scores_work(
        n, kv, k, 0 if suppress is None else suppress.shape[0])
    rec = dict(n=n, kv=kv, k=k, err=max_err, rel=max_rel, fma=fma,
               suppressed=suppress is not None,
               tf32_ms=6 * fma / TF32_FLOPS * 1e3,
               ffma_ms=2 * fma / FP32_FLOPS * 1e3,
               bytes_ms=nbytes / HBM_BYTES_S * 1e3)
    timing = ""
    if timed:
        rows = desc_a[b0 * 10:(b0 + n) * 10]
        flat = desc_v.reshape(-1, k)
        rec["ms"] = cuda_ms(lambda: coarse_map.block_scores(
            desc_a, desc_v, b0, n, suppress))
        rec["plain_ms"] = cuda_ms(lambda: coarse_map.block_scores_plain(
            desc_a, desc_v, b0, n, suppress), 1)
        rec["gemm_ms"] = cuda_ms(lambda: torch.matmul(rows, flat.T), 1)
        timing = (f" | kernel {rec['ms']:.4f} ms, plain "
                  f"{rec['plain_ms']:.3f} ms, the GEMM alone (one "
                  f"torch.matmul) {rec['gemm_ms']:.3f} ms | "
                  f"{fma:.4g} FMA: 3xTF32 bound {rec['tf32_ms']:.4f} ms "
                  f"({rec['tf32_ms'] / rec['ms']:.1%}), FFMA "
                  f"{rec['ffma_ms']:.4f} ms ({rec['ffma_ms'] / rec['ms']:.1%})"
                  f", bytes {nbytes / 1e6:.1f} MB {rec['bytes_ms']:.4f} ms")
    print(f"[2c coarse map kernel vs plain] {label} ({n} blocks x {kv} "
          f"lanes, K {k}{', suppressed' if suppress is not None else ''}): "
          f"map {'within' if ok else 'OUTSIDE'} rtol {MAP_RTOL} / atol "
          f"{MAP_ATOL} (max abs err {max_err:.3g}, rel {max_rel:.3g})"
          f"{timing} ({smi})", flush=True)
    if not ok:
        raise AssertionError(f"{label}: coarse_score_map disagrees with its "
                             f"plain version")
    return got, want, rec


def phase_coarse_map(fa, na, fv, nv, device, smi):
    """Phase 2c on the bench pair: its whole map at nf 3 (K 128) and nf 5
    (K 256), each in one launch, against the plain version, and both
    k-best tracks from each map. Returns {nf: map_vs_plain's record}."""
    out = {}
    for nf in (3, 5):
        desc_a, desc_v, _ = coarse_descriptors(fa, na, fv, nv, device, nf)
        nb = desc_a.shape[0] // 10
        got, want, rec = map_vs_plain(f"bench pair map, nf {nf}", desc_a,
                                      desc_v, 0, nb, None, smi)
        (kp, ks), (pp, ps) = k_best_of(got), k_best_of(want)
        same = all(torch.equal(a, b) for a, b in zip(kp, pp))
        rec["tracks_equal"] = same
        print(f"[2c coarse map tracks] bench pair, nf {nf}: both k-best "
              f"tracks from the kernel's map {'equal' if same else 'DIFFER'}"
              f" to the plain map's; scores {ks} vs {ps} ({smi})",
              flush=True)
        if not same or not np.allclose(ks, ps, rtol=1e-5, atol=0):
            raise AssertionError(f"bench pair nf {nf}: the DP tracks of the "
                                 f"kernel's map differ from the plain map's")
        out[nf] = rec
        del desc_a, desc_v, got, want
    torch.cuda.empty_cache()
    return out


def dp_tracks_vs_plain(desc_a, desc_v, label, smi, tag="2b"):
    """dp_vs_plain on the score map of these descriptors: track 1, then
    track 2 on the map with track 1 suppressed. Returns dp_vs_plain's rows
    per track and the map's width."""
    from describealign_tpu_torch.alignment import matching
    device = desc_a.device
    p_map = matching._block_scores_local(desc_a, desc_v)
    zero = torch.zeros(p_map.shape[1], dtype=torch.float32, device=device)
    out = [dp_vs_plain(f"{label}, track 1", zero, p_map, None, smi, tag)]
    v_path, _ = matching._coarse_dp(p_map)
    lanes = torch.arange(p_map.shape[1], dtype=torch.int32,
                         device=device)[None, :]
    suppressed = torch.where(
        torch.abs(lanes - v_path[:, None]) <= matching.SUPPRESS_LANES,
        torch.tensor(-1e30, dtype=torch.float32, device=device), p_map)
    out.append(dp_vs_plain(f"{label}, track 2 (track 1 suppressed)", zero,
                           suppressed, None, smi, tag))
    return out, p_map.shape[1]


def phase_dp_kernels(fa, na, fv, nv, device, smi):
    """Phase 2b on the bench pair's score map (dp_tracks_vs_plain), and
    dp_backtrace on guard rows. Returns dp_vs_plain's rows per track."""
    desc_a, desc_v, _ = coarse_descriptors(fa, na, fv, nv, device)
    out, d = dp_tracks_vs_plain(desc_a, desc_v, "bench pair", smi)
    del desc_a, desc_v
    backtrace_guard(256, d, device, smi)
    return out


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


def rank_ties(only, dk, dp):
    """Of the keys only one side keeps, those that are ties for a row's
    last kept places: in one (block, frame) row both sides keep as many,
    the displaced qualities pair up within TIE_REL, and none exceeds the
    row's smallest common quality by more than TIE_REL. Returns the keys."""
    by_row = {}
    for k in only:
        by_row.setdefault(k[:2], []).append(k)
    ties = []
    for row, keys in by_row.items():
        kq = sorted(dk[k] for k in keys if k in dk)
        pq = sorted(dp[k] for k in keys if k in dp)
        common = [dp[k] for k in dp if k[:2] == row and k in dk]
        cap = min(common) * (1 + TIE_REL) if common else float("inf")
        if (len(kq) == len(pq)
                and all(abs(a - b) <= TIE_REL * b for a, b in zip(kq, pq))
                and max(kq + pq) <= cap):
            ties += keys
    return ties


def kernel_vs_plain(state, b0, track, timed, gate_per=GATE_PER, ties=None,
                    count=None, max_abs=MAX_ABS):
    """`count` blocks from block b0 (None: one FINE_CHUNK; the device path
    passes all its blocks) of one track through the kernel and the plain
    version on the same device tensors. Returns (max_abs_err, p99_rel,
    kernel_ms, plain_ms, n_candidates, bound, gate candidates only one side
    keeps, max_rel); the times and the bound are None unless `timed`.
    gate_per=None lifts the limit on how many candidates may differ at the
    quality gate (off the gate none may). ties: a list that takes (key,
    kernel, plain) of candidates that tie for a row's last kept places
    (rank_ties), which are then allowed; None allows none. Every common
    candidate's relative quality error must stay below MAX_REL, and its
    absolute error below max_abs (None: no absolute bound)."""
    from describealign_tpu_torch.alignment import matching
    from describealign_tpu_torch.ops import fine_kernel
    ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts, _ = state
    dev = ms_a.device
    count = count or matching.FINE_CHUNK
    v_starts = starts[track, b0:b0 + count].contiguous()
    a_starts = ((b0 + torch.arange(count, dtype=torch.int32, device=dev))
                * matching.BLOCK)
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
    if ties is not None:
        tied = set(rank_ties(only, dk, dp))
        ties += [(k, dk.get(k), dp.get(k)) for k in only if k in tied]
        only = [k for k in only if k not in tied]
    gate = [(k, dk.get(k), dp.get(k)) for k in only]
    off_gate = [g for g in gate
                if max(g[1] or 0.0, g[2] or 0.0) > floor * (1 + GATE_REL)]
    if off_gate or (gate_per and len(gate) > len(dp) // gate_per):
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
    if not rel.max() < MAX_REL:
        worst = common[int(rel.argmax())]
        raise AssertionError(f"chunk b0={b0} track {track}: relative "
                             f"quality error {rel.max()} >= {MAX_REL} at "
                             f"{worst} (plain {dp[worst]}, kernel "
                             f"{dk[worst]})")
    if max_abs is not None and not err.max() < max_abs:
        worst = common[int(err.argmax())]
        raise AssertionError(f"chunk b0={b0} track {track}: quality error "
                             f"{err.max()} >= {max_abs} at {worst} (plain "
                             f"{dp[worst]}, kernel {dk[worst]})")
    if not timed:
        return (float(err.max()), p99, None, None, len(dp), None, gate,
                float(rel.max()))
    k_ms = cuda_ms(lambda: fine_kernel.fine_match(*args))
    p_ms = cuda_ms(lambda: fine_kernel.fine_match_plain(*args))
    return (float(err.max()), p99, k_ms, p_ms, len(dp), fine_bound(args),
            gate, float(rel.max()))


# The CLI run of phase 4: `python -m describealign_tpu_torch ARGS` through
# runpy, with the kernels' launch counts and the wall time of combine()
# and of its stages (module functions wrapped with a clock, looked up by
# combine() at call time) printed as one JSON line after the CLI's output.
CLI_RUN = """
import json, runpy, sys, time
import describealign_tpu_torch.alignment.api as api
import describealign_tpu_torch.media.decode as decode
import describealign_tpu_torch.media.mux as mux
import describealign_tpu_torch.report.plots as plots
import describealign_tpu_torch.stretch.segments as segments
from describealign_tpu_torch.ops import (coarse_dp, coarse_map,
                                         features_kernel, fine_kernel,
                                         fit_kernel, pv_kernel)
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
wrappers = {"coarse_score_map": coarse_map.block_scores,
            "fine_match": fine_kernel.fine_match,
            "dp_forward": coarse_dp.dp_forward,
            "dp_backtrace": coarse_dp.dp_backtrace,
            "pcm_frontend": features_kernel.pcm_frontend_cuda,
            "polyphase_blur": features_kernel.polyphase_blur_cuda,
            "fused_lasso_admm": fit_kernel.fused_lasso_admm,
            "pv_phase_lock": pv_kernel.pv_phase_lock}
for w in wrappers.values():
    w.launches = 0
t0 = time.perf_counter()
runpy.run_module("describealign_tpu_torch", run_name="__main__",
                 alter_sys=True)
print(json.dumps({"combine_s": time.perf_counter() - t0, "stages": stages,
                  "launches": {k: w.launches for k, w in wrappers.items()}}))
"""


def report_numbers(lines):
    """(similarity %, start offset s, median rate change %) of a report."""
    def number(prefix):
        line = next(ln for ln in lines if ln.startswith(prefix))
        return float(line[len(prefix):].split()[0].rstrip("%"))
    return (number("Input file similarity:"), number("Start Offset:"),
            number("Median Rate Change:"))


def phase_combine(v, a, smi, n_chunks, wav_dir):
    """Phase 4: the CLI on the bench pair's WAVs, against the JAX
    package's combine() on the same WAVs. The WAVs are written to wav_dir
    and stay there for phase 10. Returns the kernels' launches in the run
    and the two WAVs' paths."""
    from describealign_tpu_torch.alignment import matching
    from describealign_tpu_torch.media.decode import write_wav
    with open(COMBINE_EXPECTED) as f:
        expected = json.load(f)
    t0 = time.perf_counter()
    video_wav = os.path.join(wav_dir, expected["video_wav"])
    audio_wav = os.path.join(wav_dir, expected["audio_wav"])
    write_wav(video_wav, v)
    write_wav(audio_wav, a)
    wav_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=wav_dir) as run_dir:
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
        "launches": stats["launches"] == {
            "coarse_score_map": 1,
            "fine_match": n_chunks * matching.N_TRACKS,
            "dp_forward": matching.N_TRACKS,
            "dp_backtrace": matching.N_TRACKS,
            "pcm_frontend": 0, "polyphase_blur": 0,
            "fused_lasso_admm": 0, "pv_phase_lock": 0},
    }
    print(f"[4 CLI] python -m describealign_tpu_torch on the bench pair's "
          f"WAVs ({expected['video_samples']} video samples, 2 channels): "
          f"CLI process {cli_s:.2f} s, combine() {stats['combine_s']:.2f} s "
          f"= " + ", ".join(f"{k} {t:.2f} s"
                            for k, t in stats["stages"].items())
          + f" (+ the rest); WAVs written in {wav_s:.2f} s | launches "
          f"{stats['launches']} | output {shape} | report similarity "
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
    return stats["launches"], video_wav, audio_wav


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
    """Phase 5: the feature film on the coarse DP's branch the card's
    memory allows (matching.coarse_streamed). Returns (the
    kernels' launches in the end-to-end run, [(chunk b0, track,
    *kernel_vs_plain row)] on the film's first and last chunks, the DP
    kernels' dp_vs_plain row on one film tile, map_vs_plain's records of
    the film's tiles 0 and 1)."""
    from describealign_tpu_torch import film_pair
    from describealign_tpu_torch.alignment import api, matching, preprocess
    from describealign_tpu_torch.ops import coarse_dp, coarse_map
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
    # the branch the card's memory allows now; 5b reads the one its runs take
    streamed = matching.coarse_streamed(nb, kv, device)
    free, _ = torch.cuda.mem_get_info(device)
    print(f"[5 film] {na / 210 / 60:.1f}-min description, "
          f"{nv / 210 / 60:.1f}-min film, features built in {gen_s:.2f} s: "
          f"Npad {npad}, nb {nb}, kv {kv}, nb*kv {nb * kv} "
          f"({nb * kv / 2**20:.1f} Mi) vs COARSE_STREAM_ELEMS "
          f"{matching.COARSE_STREAM_ELEMS}; {matching.COARSE_PASSES} x "
          f"materialized peak "
          f"{matching.coarse_peak_bytes(nb, kv) / 2**30:.3f} GiB + headroom "
          f"{matching.COARSE_HEADROOM_BYTES / 2**30:.3f} GiB vs "
          f"{free / 2**30:.2f} GiB free -> "
          f"{'streamed' if streamed else 'materialized'} branch ({smi})",
          flush=True)
    if (nb, kv) != (expected["nb"], expected["kv"]):
        raise AssertionError("the film's map differs from the expected "
                             "fixture's")

    # (a) the streamed and the materialized DP on the film's descriptors
    t_phase = time.perf_counter()
    desc_a, desc_v, a_mask = coarse_descriptors(fa, na, fv, nv, device)
    runs = {name: timed_dp(matching, desc_a, desc_v, nb, flag)
            for name, flag in (("streamed", True), ("materialized", False))}
    (sp, ss, s_t, s_mem), (mp, ms, m_t, m_mem) = runs.values()
    margins = [float(matching._coarse_margin(sc, a_mask, nb))
               for sc in (ss, ms)]
    same = (all(torch.equal(a, b) for a, b in zip(sp, mp))
            and [float(x) for x in ss] == [float(x) for x in ms]
            and margins[0] == margins[1])
    counted = matching.coarse_peak_bytes(nb, kv)
    print(f"[5a film DP] streamed {s_t:.2f} s, peak {s_mem / 2**30:.3f} GiB "
          f"| materialized {m_t:.2f} s, peak {m_mem / 2**30:.3f} GiB "
          f"(above the descriptors; counted {counted / 2**30:.3f} GiB) | "
          f"track scores {[float(x) for x in ss]}, "
          f"margin {margins[0]:.6f} | paths, scores and margin "
          f"{'equal' if same else 'DIFFER'} ({smi})", flush=True)
    if not same:
        raise AssertionError("streamed and materialized DPs disagree")
    if m_mem > counted:
        raise AssertionError("the materialized DP's peak exceeds "
                             "matching.coarse_peak_bytes")
    # 2c: the score map's kernel on the film's tiles 0 and 1, alone and with
    # track 1 suppressed (the streamed DP's second pass), and the DP over
    # each tile from a zero row on the kernel's and on the plain tile
    map_rows = []
    zero = torch.zeros(kv, device=device)
    for c in (0, 1):
        for sup in (None, sp[0][None].contiguous()):
            got, want, rec = map_vs_plain(
                f"film tile {c}", desc_a, desc_v, c * matching.COARSE_CHUNK,
                matching.COARSE_CHUNK, sup, smi, timed=c == 1)
            paths = [coarse_dp.dp_backtrace(None, coarse_dp.dp_forward(
                zero, tile)) for tile in (got, want)]
            rec["tracks_equal"] = torch.equal(*paths)
            print(f"[2c coarse map tracks] film tile {c}"
                  f"{', suppressed' if sup is not None else ''}: the DP "
                  f"path over the kernel's tile "
                  f"{'equal' if rec['tracks_equal'] else 'DIFFERS'} to the "
                  f"plain tile's ({smi})", flush=True)
            if not rec["tracks_equal"]:
                raise AssertionError(f"film tile {c}: the DP path over the "
                                     f"kernel's tile differs")
            map_rows.append(rec)
            del got, want
    # the DP kernels on the film's second 64-block tile, from the cost row
    # the first tile leaves (a non-zero checkpoint) and a given last lane
    chunk = matching.COARSE_CHUNK
    tile0 = coarse_map.block_scores(desc_a, desc_v, 0, chunk)
    tile1 = coarse_map.block_scores(desc_a, desc_v, chunk, chunk)
    ckpt = coarse_dp.dp_forward(torch.zeros(kv, device=device), tile0)[-1]
    dp_row = dp_vs_plain("film tile 1 from tile 0's last row", ckpt, tile1,
                         sp[0][2 * matching.COARSE_CHUNK].long(), smi)
    # the materialized DP's scores are views of its cost maps: drop them too
    del runs, sp, ss, mp, ms, desc_a, desc_v, a_mask, tile0, tile1, ckpt
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
    for b0, track, err, p99, k_ms, p_ms, n, bound, gate, rel in rows:
        print(f"[5a film kernel] chunk b0={b0} track {track}: {n} "
              f"candidates, {len(gate)} at the quality gate, max abs err "
              f"{err:.3g}, p99 rel {p99:.3g}, max rel {rel:.3g}, kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, bound 3xTF32 {bound[1]:.4f} ms ({smi})",
              flush=True)
    a_s = time.perf_counter() - t_phase

    # (b) two end-to-end runs through the feature-level entry align(): on
    # the branch the card's memory allows, then with the card reported
    # full, which takes the streamed branch; each run's launches are held
    # to the branch its own coarse pass took
    tiles = -(-nb // matching.COARSE_CHUNK)
    first = film_e2e(api, matching, video, audio, device)
    check_film_e2e("5b film e2e", first, expected, n_chunks, tiles, nb, kv,
                   a_s, smi)
    total = torch.cuda.mem_get_info(device)[1]
    patched = {"mem_get_info": lambda device=None: (0, total),
               "memory_reserved": torch.cuda.memory_allocated}
    saved = {k: getattr(torch.cuda, k) for k in patched}
    try:
        for k, fn in patched.items():
            setattr(torch.cuda, k, fn)
        full = film_e2e(api, matching, video, audio, device)
    finally:
        for k, fn in saved.items():
            setattr(torch.cuda, k, fn)
    check_film_e2e("5b film e2e, card reported full", full, expected,
                   n_chunks, tiles, nb, kv, a_s, smi, want_streamed=True,
                   same_as=first)
    return ({"": first["launches"], "full": full["launches"]}, rows, dp_row,
            map_rows)


def film_e2e(api, matching, video, audio, device):
    """One align() of the film on the card: {answer, printed, seconds,
    launches, peak bytes, streamed: the flag each coarse pass gave
    _k_best_tracks, margins: each pass's _coarse_margin}."""
    k_best, coarse_margin = matching._k_best_tracks, matching._coarse_margin
    run = {"streamed": [], "margins": []}

    def recorded_k_best(desc_a, desc_v, nb, streamed, mark=None):
        run["streamed"].append(streamed)
        return k_best(desc_a, desc_v, nb, streamed, mark)

    def recorded_margin(scores, a_mask, nb):
        margin = coarse_margin(scores, a_mask, nb)
        run["margins"].append(float(margin))
        return margin

    split = {}
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    matching._k_best_tracks = recorded_k_best
    matching._coarse_margin = recorded_margin
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            run["answer"] = api.align(video, audio, video[0], audio[0],
                                      device=device, timings=split)
        run["seconds"] = time.perf_counter() - t0
    finally:
        matching._k_best_tracks = k_best
        matching._coarse_margin = coarse_margin
    run.update(split=split, launches=kernel_counts(),
               peak=torch.cuda.max_memory_allocated(),
               printed=out.getvalue())
    return run


def check_film_e2e(tag, run, expected, n_chunks, tiles, nb, kv, a_s, smi,
                   want_streamed=None, same_as=None):
    """Print one film_e2e run and fail unless it agrees with the JAX
    result, ran one coarse pass (streamed if want_streamed says so) and
    launched the kernels that pass's branch launches."""
    from describealign_tpu_torch.alignment import matching
    ax, vy, sim, _, slope = run["answer"]
    printed = run["printed"]
    start_off = float(ax[0] - vy[0])
    jx = np.asarray(expected["audio_times_s"])
    jy = np.asarray(expected["video_times_s"])
    node_err = float(np.max(np.abs(np.interp(jx, ax, vy) - jy)))
    passes = run["streamed"]
    streamed = passes[0] if len(passes) == 1 else None
    margin = run["margins"][0] if len(run["margins"]) == 1 else float("nan")
    tracks = matching.N_TRACKS
    checks = {
        "one coarse pass": streamed is not None and len(run["margins"]) == 1,
        "start offset": abs(start_off - expected["start_offset_s"]) <= TOL_S,
        "planted 202 s": abs(start_off - PLANTED_OFFSET_S) <= TOL_S,
        "nodes": node_err <= TOL_S,
        "similarity": abs(sim - expected["similarity_percent"]) <= 0.5,
        "median slope": abs(slope - expected["median_slope"]) <= 1e-4,
        "margin": (margin > matching.COARSE_MARGIN_FLOOR
                   and abs(margin / expected["margin"] - 1) <= 1e-5),
        "no WARNING": "WARNING" not in printed,
        "no retry": "rechecking alignment" not in printed,
        # the streamed DP scores every tile twice (forward and back) and
        # runs it forward twice and back once; the materialized one scores
        # the map once and runs one forward and one backtrace a track
        "launches": run["launches"] == {
            "coarse_score_map": 2 * tiles * tracks if streamed else 1,
            "fine_match": n_chunks * tracks,
            "dp_forward": 2 * tiles * tracks if streamed else tracks,
            "dp_backtrace": tiles * tracks if streamed else tracks,
            "pcm_frontend": 0, "polyphase_blur": 0,
            "fused_lasso_admm": 0, "pv_phase_lock": 0},
    }
    if want_streamed is not None:
        checks["branch"] = streamed is want_streamed
    if same_as is not None:
        checks["answer as the first run's"] = (
            all(np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(run["answer"], same_as["answer"]))
            and run["margins"] == same_as["margins"])
    branch = {True: "streamed", False: "materialized"}.get(
        streamed, f"passes {passes}")
    print(f"[{tag}] {run['seconds']:.2f} s | split "
          + ", ".join(f"{k} {t:.3f} s" for k, t in run["split"].items())
          + f" | {branch} coarse DP (nb*kv {nb * kv}), launches "
          f"{run['launches']} ({n_chunks} chunks and {tiles} tiles x "
          f"{matching.N_TRACKS} tracks) | peak device memory "
          f"{run['peak'] / 2**30:.3f} GiB | start offset {start_off:.4f} s "
          f"(JAX {expected['start_offset_s']:.4f}, planted "
          f"{PLANTED_OFFSET_S}), max node error {node_err * 1e3:.2f} ms over "
          f"{len(jx)} JAX nodes, similarity {sim:.3f} (JAX "
          f"{expected['similarity_percent']:.3f}), median slope "
          f"{slope:.7f} (JAX {expected['median_slope']:.7f}), margin "
          f"{margin:.7f} (JAX {expected['margin']:.7f}) | phase 5a "
          f"{a_s:.1f} s ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{tag}: the film disagrees with JAX or its "
                             f"branch: {checks}")


def host_waits(fn):
    """Where fn makes the host wait for the device: torch's
    synchronization warnings, as a list of file:line."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def phase_batch(device, smi):
    """Phase 6: the 8 bench-batch pairs through align_batch_from_pcm (on
    the card by default) and one by one. Returns (the kernels' launches in
    the warm batch call, (pairs, true lengths, planted offsets, kinds))."""
    from describealign_tpu_torch import bench_pair
    from describealign_tpu_torch.alignment import api, matching
    with open(BATCH_EXPECTED) as f:
        expected = json.load(f)["pairs"]
    t0 = time.perf_counter()
    pairs, lens, planted, kinds = bench_pair.build_batch_pairs(workers=4)
    gen_s = time.perf_counter() - t0
    sums = [bench_pair.checksum(v, a) for v, a in pairs]
    same = [c == e["checksum"] for c, e in zip(sums, expected)]
    if ([tuple(ln) for ln in lens]
            != [(e["video_samples"], e["audio_samples"]) for e in expected]
            or kinds != [e["kind"] for e in expected]
            # the slowed pair goes through scipy's resampler, whose last
            # bits may differ between versions; the others are numpy's
            or not all(ok for ok, k in zip(same, kinds) if k != "rate")):
        raise AssertionError(f"the batch pairs differ from the expected "
                             f"fixture's: lens {lens}, checksums {sums}")
    minutes = sum(sa for _, sa in lens) / 44100 / 60
    print(f"[6 batch] 8 pairs, {minutes:.1f} audio-minutes, built in "
          f"{gen_s:.1f} s on 4 threads; PCM checksums "
          f"{'all equal to' if all(same) else 'equal but the slowed pair to'}"
          f" the fixture's ({smi})", flush=True)

    def batch():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            results = api.align_batch_from_pcm(pairs, true_samples=lens)
        return results, time.perf_counter() - t0, out.getvalue()

    _, first_s, _ = batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    results, warm_s, printed = batch()
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()

    singles = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        for v, a in pairs:
            singles.append(api.align_from_pcm(v, a, device=device))
    seq_s = time.perf_counter() - t0
    retries = out.getvalue().count("rechecking alignment")

    # one pair's dispatch: host waits, the dense buffer and its copy
    sv, sa = lens[0]
    npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
    fv, nv = api.host_features_padded(pairs[0][0], sv, npad)
    fa, na = api.host_features_padded(pairs[0][1], sa, npad)
    dev_av = torch.from_numpy(np.stack([fa, fv]).astype(np.float16)).to(device)
    made = []

    def dispatch():
        chunks, starts, _, margin = matching.match_stream_pair(dev_av, na, nv)
        made.append(matching.concat_chunks_with_starts(chunks, starts,
                                                       margin))
    waits = host_waits(dispatch)
    combo = made[0]
    host_buf = torch.empty(combo.shape, dtype=combo.dtype, pin_memory=True)
    d2h_ms = cuda_ms(lambda: host_buf.copy_(combo, non_blocking=True))
    d2h_bytes = combo.numel() * combo.element_size()
    del dev_av, made, combo

    # the ~50 %-similarity pair, whose nodes differ most from JAX's: which
    # fine candidates the kernel and its plain version keep differently
    low = kinds.index("lowsim")
    sv, sa = lens[low]
    npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
    fv, nv = api.host_features_padded(pairs[low][0], sv, npad)
    fa, na = api.host_features_padded(pairs[low][1], sa, npad)
    state = matching.match_coarse(api._upload(fa, device), na,
                                  api._upload(fv, device), nv)
    low_ties = []
    low_rows = [kernel_vs_plain(state, b0, track, False, gate_per=None,
                                ties=low_ties, max_abs=None)
                for b0 in range(0, state[6].shape[1], matching.FINE_CHUNK)
                for track in range(matching.N_TRACKS)]
    del state
    low_gate = [g for r in low_rows for g in r[6]]
    print(f"[6 batch lowsim] pair {low}: {sum(r[4] for r in low_rows)} fine "
          f"candidates in {len(low_rows)} chunk x track calls; kept by only "
          f"one of kernel and plain: {len(low_gate)} within {GATE_REL} of "
          f"the quality gate's floor {low_gate[:4]}, {len(low_ties)} tied "
          f"within {TIE_REL} for a row's last kept places {low_ties[:4]} "
          f"(key, kernel, plain; anything else fails); of the common ones "
          f"max abs quality error {max(r[0] for r in low_rows):.3g}, worst "
          f"p99 relative error {max(r[1] for r in low_rows):.3g}, max "
          f"relative error {max(r[7] for r in low_rows):.3g} (bound "
          f"{MAX_REL}) ({smi})",
          flush=True)

    # chunks per pair follow its shape bucket
    n_chunks = sum(-(-matching.nb_for(max(api._bucket_pad(sv // 210),
                                          api._bucket_pad(sa // 210)))
                     // matching.FINE_CHUNK) for sv, sa in lens)
    want = {"coarse_score_map": 8,
            "fine_match": n_chunks * matching.N_TRACKS,
            "dp_forward": 8 * matching.N_TRACKS,
            "dp_backtrace": 8 * matching.N_TRACKS,
            "pcm_frontend": 0, "polyphase_blur": 0,
            "fused_lasso_admm": 0, "pv_phase_lock": 0}
    rows, checks = [], {}
    for k, (got, one, e) in enumerate(zip(results, singles, expected)):
        x, y, sim, path, slope, margin = got
        start_off = float(x[0] - y[0])
        jx = np.asarray(e["audio_times_s"])
        jy = np.asarray(e["video_times_s"])
        node_err = float(np.max(np.abs(np.interp(jx, x, y) - jy)))
        checks[k] = {
            "batch == single": (all(np.array_equal(got[i], one[i])
                                    for i in (0, 1, 3))
                                and sim == one[2] and slope == one[4]
                                and abs(margin / one[5] - 1) <= MARGIN_REL),
            "nodes": node_err <= TOL_S,
            "similarity": abs(sim - e["similarity_percent"]) <= 0.5,
            "median slope": abs(slope - e["median_slope"]) <= 1e-4,
            "margin": abs(margin / e["margin"] - 1) <= MARGIN_REL,
            "planted": (kinds[k] != "plain"
                        or abs(start_off - planted[k]) <= TOL_S),
            "finite": bool(np.isfinite(x).all() and np.isfinite(y).all()),
        }
        rows.append(f"pair {k} ({kinds[k]}): start offset {start_off:.4f} s "
                    f"(JAX {e['start_offset_s']:.4f}, planted {planted[k]}),"
                    f" node error {node_err * 1e3:.2f} ms over {len(jx)} JAX "
                    f"nodes, similarity {sim:.3f} (JAX "
                    f"{e['similarity_percent']:.3f}), slope {slope:.7f} (JAX "
                    f"{e['median_slope']:.7f}), margin {margin:.4f} (single "
                    f"{one[5]:.4f}, JAX {e['margin']:.4f})")
    checks["run"] = {
        "launches": launches == want,
        "quiet": printed == "",
        "no retry": retries == 0,
    }
    for row in rows:
        print(f"[6 batch vs JAX] {row}", flush=True)
    print(f"[6 batch] align_batch_from_pcm on the card: first call "
          f"{first_s:.3f} s, warm {warm_s:.3f} s = "
          f"{minutes / warm_s:.1f} audio-minutes per second | the same 8 "
          f"pairs one by one through align_from_pcm {seq_s:.3f} s | launches "
          f"in the warm call {launches} | dense buffer {d2h_bytes} bytes per "
          f"pair, device-to-host copy into pinned memory {d2h_ms:.3f} ms "
          f"({d2h_bytes / d2h_ms / 1e6:.1f} GB/s) | host waits in one "
          f"pair's matcher dispatch: {len(waits)} {waits} | peak device memory "
          f"{peak / 2**20:.0f} MiB ({smi}) - "
          + ", ".join(f"{name} {'ok' if all(c[name] for c in checks.values() if name in c) else 'FAIL'}"
                      for name in list(checks[0]) + list(checks["run"])),
          flush=True)
    if not all(all(c.values()) for c in checks.values()):
        raise AssertionError(f"the batch disagrees: {checks}")
    return launches, (pairs, lens, planted, kinds)


# the five streams of the device extractor against the host C++ extractor
# (tests/test_features.py:52 and tests/test_host_features.py:24 hold both
# to the oracle at 5e-5 / 5e-6; two such errors add up)
STREAM_RTOL, STREAM_ATOL = 1e-4, 1e-5
# Where the true length is a multiple of 210 the host extractor stops at
# it, while the device extractor (the JAX package's too) reads the
# bucket's zero padding: a sign change into the padding counts in frame n
# and the cascade's blurs reach past the end, so the last frames differ
# within the streams' smoothing reach (7 frames: 15 taps at 210 fps,
# band 1's 630 taps at 42 kHz). Those frames are held to a looser bound:
# on the bench pair 5 crossing-rate frames and 1 band-3 frame miss the
# streams' tolerance, the worst by 0.27 at a rate of 95 (2.9e-3 relative)
EDGE_FRAMES = 8
EDGE_RTOL, EDGE_ATOL = 1e-2, 1e-3
ENERGY_RTOL = 1e-6          # K1's energy vs plain: a sum of 105 C squares
# conv1d_blur vs K2, relative to the stage's largest output: rounding of
# another summation order (~1e-7 on the CPU); TF32 would give ~1e-3
LIBRARY_REL = 1e-4


def feature_stages(pcm):
    """[(label, fn(impl), args)] of one stream: K1, then the six K2 calls
    of the cascade on K1's outputs (ops/features._streams)."""
    from describealign_tpu_torch.ops import features as tf
    energy, crossings, bottom1, band1 = tf.pcm_frontend(pcm)
    bottom2 = tf.polyphase_blur(bottom1, 7, 3)
    return [("energy smoothing", (energy, 1, 13), dict(epilogue="energy")),
            ("crossings smoothing", (crossings, 1, 13), {}),
            ("band 1", (band1, 42, 15), dict(epilogue="band")),
            ("bottom 2", (bottom1, 7, 3), {}),
            ("band 2", (bottom1, 6, 15), dict(r=7, bottom=bottom2,
                                                epilogue="band")),
            ("band 3", (bottom2, 1, 15), dict(r=6, epilogue="band"))]


def conv1d_blur(ds, blur, device):
    """The library reference for polyphase_blur's time, which the port
    never calls: _downsample_blur(y, ds, blur) as one strided conv1d.
    Phase i's tap taps[i + ds m], centred on the phase's own tap count t_i
    (c_i = (t_i - 1) // 2), weighs the sample i + ds (c_i - m) past output
    j's first (ds j), so the phases fold into one weight vector. The
    prologue and the epilogues are elementwise torch ops. Returns
    fn(x, r=0, bottom=None, epilogue=None), polyphase_blur's arguments
    after ds and blur; cuDNN sums in its own order, so it agrees with the
    kernel to rounding (LIBRARY_REL), not bit for bit. Run it with TF32
    off."""
    from describealign_tpu_torch.ops.windows import hann_taps
    taps = hann_taps(ds * blur + 2)
    offs, vals = [], []
    for i in range(ds):
        c = (len(taps[i::ds]) - 1) // 2
        for m, tap in enumerate(taps[i::ds]):
            offs.append(i + ds * (c - m))
            vals.append(tap)
    pad = -min(offs)
    w = np.zeros(max(offs) + pad + 1, np.float32)
    w[np.asarray(offs) + pad] = vals
    weight = torch.from_numpy(w).to(device)[None, None]
    conv1d, fpad = torch.nn.functional.conv1d, torch.nn.functional.pad

    def run(x, r=0, bottom=None, epilogue=None):
        if r:
            y = x[:x.shape[0] - x.shape[0] % r].reshape(-1, r)
            if bottom is not None:
                y = y - bottom[:, None]
            x = (y * y).sum(1)
        n = x.shape[0] - x.shape[0] % ds
        out = conv1d(fpad(x[None, None, :n], (pad, w.shape[0])), weight,
                     stride=ds)[0, 0, :n // ds]
        if epilogue == "energy":
            return (torch.log10(1 + out) / 2)[::2]
        if epilogue == "band":
            return torch.log10(1 + out / 210) / 2
        return out
    return run


def device_ms(fn, name, reps=REPS):
    """Mean device milliseconds per call of fn in kernels whose name holds
    `name` (torch.profiler), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0) or 0
               for e in prof.key_averages() if name in e.key) / reps / 1e3


def phase_feature_kernels(streams, smi):
    """Phase 7a: K1 and K2 against their plain versions on the bench pair's
    two padded int16 streams (K2 per stage and as the cascade, one launch
    per stream), the five streams against the host C++ extractor, and the
    times. Returns {kernel: record} with times, bounds and errors summed or
    maxed over the pair's two streams: `ms` the kernel's device time
    (torch.profiler), `wrapper_ms` the wrapper's calls between CUDA events
    (host issue included); K2's time is the cascade's."""
    from describealign_tpu_torch.ops import features as tf
    from describealign_tpu_torch.ops import features_kernel as fk
    from describealign_tpu_torch.ops.host_features import (
        extract_features_host)
    rec = {k: dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   err=0.0, bytes=0)
           for k in ("pcm_frontend", "polyphase_blur")}
    rec["polyphase_blur"].update(library_ms=0.0, library_rel=0.0,
                                 stages_ms=0.0)
    up_ms, up_bytes, lines = 0.0, 0, []
    for label, pcm_np, true_samples in streams:
        pinned = torch.from_numpy(pcm_np).pin_memory()
        up_ms += cuda_ms(lambda: pinned.to("cuda", non_blocking=True))
        up_bytes += pcm_np.nbytes
        pcm = pinned.to("cuda")
        c, s = pcm.shape
        got = tf.pcm_frontend(pcm)
        want = tf.pcm_frontend_plain(pcm.half().float())
        e_rel = float(((got[0] - want[0]).abs()
                       / want[0].abs().clamp(min=1e-30)).max())
        exact = [torch.equal(g, w) for g, w in zip(got, want)]
        if not (e_rel <= ENERGY_RTOL and all(exact[1:])):
            raise AssertionError(f"{label}: pcm_frontend disagrees with its "
                                 f"plain version (energy rel {e_rel}, "
                                 f"exact {exact})")
        work = fk.feature_work(c, s)
        k1 = rec["pcm_frontend"]
        k1["wrapper_ms"] += cuda_ms(lambda: tf.pcm_frontend(pcm))
        k1["ms"] += device_ms(lambda: tf.pcm_frontend(pcm), "pcm_frontend")
        k1["plain_ms"] += cuda_ms(
            lambda: tf.pcm_frontend_plain(pcm.half().float()), 1)
        k1["bound_ms"] += work["pcm_frontend"] / HBM_BYTES_S * 1e3
        k1["bytes"] += work["pcm_frontend"]
        k1["err"] = max(k1["err"], float((got[0] - want[0]).abs().max()))
        k2 = rec["polyphase_blur"]
        k2["bound_ms"] += work["polyphase_blur"] / HBM_BYTES_S * 1e3
        k2["bytes"] += work["polyphase_blur"]
        # the cascade, bit-equal in one launch
        plain = tf.polyphase_cascade_plain(*got)
        before = fk.polyphase_blur_cuda.launches
        out = tf.polyphase_cascade(*got)
        if not (all(torch.equal(g, w) for g, w in zip(out, plain))
                and fk.polyphase_blur_cuda.launches == before + 1):
            raise AssertionError(f"{label}: the cascade differs from its "
                                 f"plain version or took other than one "
                                 f"launch")
        k2["wrapper_ms"] += cuda_ms(lambda: tf.polyphase_cascade(*got))
        k2["ms"] += device_ms(lambda: tf.polyphase_cascade(*got),
                              "polyphase_group")
        k2["plain_ms"] += cuda_ms(lambda: tf.polyphase_cascade_plain(*got), 1)
        stage_ms = []
        for name, args, kw in feature_stages(pcm):
            out = tf.polyphase_blur(*args, **kw)
            plain = tf.polyphase_blur_plain(*args, **kw)
            if not torch.equal(out, plain):
                raise AssertionError(f"{label}: polyphase_blur ({name}) "
                                     f"differs from its plain version")
            ms = cuda_ms(lambda: tf.polyphase_blur(*args, **kw))
            k2["stages_ms"] += ms
            # the library reference: one strided conv1d, in f32
            lib = conv1d_blur(args[1], args[2], pcm.device)
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                lib_rel = float((lib(args[0], **kw) - out).abs().max()
                                / out.abs().max())
                lib_ms = cuda_ms(lambda: lib(args[0], **kw))
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            if not lib_rel <= LIBRARY_REL:
                raise AssertionError(f"{label}: conv1d_blur ({name}) is "
                                     f"{lib_rel} off polyphase_blur")
            k2["library_ms"] += lib_ms
            k2["library_rel"] = max(k2["library_rel"], lib_rel)
            stage_ms.append(f"{name} {ms:.4f} (conv1d {lib_ms:.4f})")
        # the streams against the host extractor, over the true frames
        n = true_samples // 210
        dev = tf.feature_stack(pcm, s // 210).cpu().numpy()[:, :n]
        host = extract_features_host(pcm_np, true_samples)
        worst, edge = [], []
        for j, h in enumerate(host):
            h = h[:n]
            bad = np.abs(dev[j] - h) > STREAM_ATOL + STREAM_RTOL * np.abs(h)
            body = slice(0, n - EDGE_FRAMES)
            worst.append(float(np.max(np.abs(dev[j][body] - h[body])
                                      / (np.abs(h[body])
                                         + STREAM_ATOL / STREAM_RTOL))))
            edge.append(int(bad[body.stop:].sum()))
            far = (np.abs(dev[j][body.stop:] - h[body.stop:])
                   > EDGE_ATOL + EDGE_RTOL * np.abs(h[body.stop:]))
            if bad[body].any() or far.any():
                raise AssertionError(f"{label}: stream {j} of the device "
                                     f"extractor differs from the host "
                                     f"extractor at {int(bad[body].sum())} "
                                     f"frames, and at {int(far.sum())} of "
                                     f"the last {EDGE_FRAMES} beyond rtol "
                                     f"{EDGE_RTOL} / atol {EDGE_ATOL}")
        lines.append(f"{label} ({c} x {s} int16): K1 {exact[1:].count(True)}/3 "
                     f"outputs bit-equal, energy {'bit-equal' if exact[0] else f'max rel {e_rel:.3g}'}; "
                     f"K2 6/6 stages bit-equal one launch each "
                     f"({', '.join(stage_ms)} ms), the cascade bit-equal in "
                     f"one launch; "
                     f"vs host C++ extractor, worst |d| / (|h| + "
                     f"{STREAM_ATOL / STREAM_RTOL:g}) per stream "
                     f"{[f'{w:.2g}' for w in worst]} over all but the last "
                     f"{EDGE_FRAMES} of {n} frames; of those, outside the "
                     f"tolerance per stream {edge}, all within rtol "
                     f"{EDGE_RTOL} / atol {EDGE_ATOL}")
        del pcm, pinned, got, want
    for ln in lines:
        print(f"[7a feature kernels vs plain] {ln} ({smi})", flush=True)
    k1, k2 = rec["pcm_frontend"], rec["polyphase_blur"]
    if not (k1["ms"] > 0 and k2["ms"] > 0):
        raise AssertionError(f"7a: the profiler saw no device time of the "
                             f"feature kernels ({k1['ms']}, {k2['ms']})")
    slots, per_sm = fk.frontend_config(1)
    print(f"[7a feature kernels] per pair (both streams), device time: "
          f"pcm_frontend {k1['ms']:.4f} ms "
          f"({k1['bytes'] / k1['ms'] / 1e6:.0f} GB/s; {slots} ring slots, "
          f"{per_sm} CTAs per SM; the wrapper between events "
          f"{k1['wrapper_ms']:.4f} ms; plain {k1['plain_ms']:.2f} ms, bytes "
          f"bound {k1['bound_ms']:.4f} ms, {k1['bound_ms'] / k1['ms']:.1%}) "
          f"| polyphase_blur as the cascade, one launch per stream, "
          f"{k2['ms']:.4f} ms ({k2['bytes'] / k2['ms'] / 1e6:.0f} GB/s of "
          f"the function's {k2['bytes']} bytes; the wrapper between events "
          f"{k2['wrapper_ms']:.4f} ms; plain {k2['plain_ms']:.2f} ms, bytes "
          f"bound {k2['bound_ms']:.4f} ms, {k2['bound_ms'] / k2['ms']:.1%}); "
          f"the six stages one launch each, between events, "
          f"{k2['stages_ms']:.4f} ms, as strided conv1d, TF32 off, "
          f"{k2['library_ms']:.4f} ms, worst {k2['library_rel']:.2g} of a "
          f"stage's largest output off the kernel | upload of the "
          f"{up_bytes} bytes of int16 PCM from pinned memory {up_ms:.3f} ms "
          f"({up_bytes / up_ms / 1e6:.1f} GB/s) ({smi})", flush=True)
    rec["upload_ms"] = up_ms
    return rec


def phase_device_kernels(v, a, device, smi):
    """Phase 7a, second part: the fine and the DP kernels against their
    plain versions on the device path's own state for the bench pair. The
    audio and the video stream pad to their own buckets, so the fine
    kernel runs at two widths, over all blocks in one call per track (as
    _match_core calls it), and the DP on a narrower score map than the
    host path's. Same rules as phases 2 and 2b. Returns ([(track,
    *kernel_vs_plain row)], dp_tracks_vs_plain's rows)."""
    from describealign_tpu_torch.alignment import api, matching, preprocess
    from describealign_tpu_torch.ops import fine_kernel
    na, nv = a.shape[1] // 210, v.shape[1] // 210
    quals, _, _, feats_a, feats_v, _ = matching.extract_and_match(
        api._pcm_to_device(a, device), na, api._pcm_to_device(v, device), nv)
    ms_a, norms_a = preprocess.preprocess_features(feats_a)
    ms_v, norms_v = preprocess.preprocess_features(feats_v)
    a_mask, v_mask, starts, _, _ = matching._coarse_tracks(
        ms_a, norms_a, feats_a[0], na, ms_v, norms_v, feats_v[0], nv)
    nb = starts.shape[1]
    # this state is the path's: track 1's call gives its first 8 slots
    q1, _ = fine_kernel.fine_match(
        ms_a, norms_a, a_mask.float(), ms_v, norms_v, v_mask.float(),
        starts[0].contiguous(),
        torch.arange(nb, dtype=torch.int32, device=device) * matching.BLOCK)
    if ms_a.shape[1] == ms_v.shape[1] or not torch.equal(
            q1, quals[:, :, :matching.TOP_K]):
        raise AssertionError(f"the device path's state: widths "
                             f"{ms_a.shape[1]}, {ms_v.shape[1]}; track 1 "
                             f"differs from extract_and_match's")
    state = (ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts, None)
    ties = []
    rows = [(track,) + kernel_vs_plain(state, 0, track, True, ties=ties,
                                       count=nb)
            for track in range(matching.N_TRACKS)]
    for track, err, p99, k_ms, p_ms, n, bound, gate, rel in rows:
        print(f"[7a device-path kernel vs plain] fine_match, track {track}, "
              f"all {nb} blocks in one call, audio width {ms_a.shape[1]}, "
              f"video width {ms_v.shape[1]}: {n} candidates, {len(gate)} "
              f"kept by one side at the quality gate, max abs err {err:.3g},"
              f" p99 rel {p99:.3g}, max rel {rel:.3g} | kernel {k_ms:.3f} "
              f"ms, plain {p_ms:.3f} ms, bound 3xTF32 {bound[1]:.4f} ms, "
              f"bytes {bound[3]:.4f} ms ({smi})", flush=True)
    print(f"[7a device-path kernel vs plain] fine_match: {len(ties)} "
          f"candidates tied within {TIE_REL} for a row's last kept places "
          f"{ties[:4]} ({smi})", flush=True)
    nf = matching.COARSE_STREAMS
    desc_a = matching._coarse_descriptors(ms_a[:nf], norms_a[:nf], a_mask)
    desc_v = [matching._coarse_descriptors(ms_v[:nf], norms_v[:nf], v_mask,
                                           p) for p in matching.SUB_LANE_SHIFTS]
    dp_rows, _ = dp_tracks_vs_plain(desc_a, desc_v, "device path, bench pair",
                                    smi, tag="7a device-path")
    return rows, dp_rows


def phase_device_features(v, a, host_split, batch, smi):
    """Phase 7b-c: the device-feature path. (b) the bench pair through
    align_from_pcm(features='device'), 3 timed runs after a warm-up,
    against tests/data/torch_device_features_expected.json; (c) the batch
    of 8 through align_batch_from_pcm(features='device') (first and warm
    call) against the pairs one by one. Returns (the kernels' launches in
    7b's 3 runs, in 7c's warm call)."""
    from describealign_tpu_torch.alignment import api, matching
    with open(DEVICE_EXPECTED) as f:
        expected = json.load(f)

    def run(timings=None):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            r = api.align_from_pcm(v, a, device="cuda", timings=timings,
                                   features="device")
        return r, out.getvalue()

    run()                                           # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        result, printed = run()
        times.append(time.perf_counter() - t0)
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    # per run: K1 once and the cascade once per stream, the fine
    # pass once per track (over all blocks), the DP once per track
    want = {"coarse_score_map": 3,
            "fine_match": 3 * matching.N_TRACKS,
            "dp_forward": 3 * matching.N_TRACKS,
            "dp_backtrace": 3 * matching.N_TRACKS,
            "pcm_frontend": 3 * 2,
            "polyphase_blur": 3 * 2,
            "fused_lasso_admm": 0, "pv_phase_lock": 0}
    split = {}
    run(split)
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
        "margin": (margin > matching.COARSE_MARGIN_FLOOR
                   and abs(margin / expected["margin"] - 1) <= MARGIN_REL),
        "finite": bool(np.isfinite(x).all() and np.isfinite(y).all()),
        "no retry": "rechecking alignment" not in printed,
        "launches": launches == want,
    }
    print(f"[7b device features] bench pair through align_from_pcm("
          f"features='device'): e2e median {np.median(times):.3f} s of "
          f"{[round(t, 3) for t in times]} | split "
          + ", ".join(f"{k} {t:.3f} s" for k, t in split.items())
          + " | host path's split (phase 3) "
          + ", ".join(f"{k} {t:.3f} s" for k, t in host_split.items())
          + f" | launches {launches} (3 runs) | peak device memory "
          f"{peak / 2**20:.0f} MiB | start offset {start_off:.4f} s (JAX "
          f"{expected['start_offset_s']:.4f}), max node error "
          f"{node_err * 1e3:.2f} ms over {len(jx)} JAX nodes, similarity "
          f"{sim:.3f} (JAX {expected['similarity_percent']:.3f}), slope "
          f"{slope:.7f} (JAX {expected['median_slope']:.7f}), margin "
          f"{margin:.5f} (JAX {expected['margin']:.5f}) ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"the device-feature path disagrees with JAX: "
                             f"{checks}, launches {launches} vs {want}")

    pairs, lens, planted, kinds = batch
    minutes = sum(sa for _, sa in lens) / 44100 / 60

    def batch_call():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            res = api.align_batch_from_pcm(pairs, true_samples=lens,
                                           features="device")
        return res, time.perf_counter() - t0, out.getvalue()

    _, first_s, _ = batch_call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    results, warm_s, quiet = batch_call()
    batch_launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    singles = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        for pv, pa in pairs:
            singles.append(api.align_from_pcm(pv, pa, features="device"))
    seq_s = time.perf_counter() - t0
    retries = out.getvalue().count("rechecking alignment")

    # one pair's dispatch: uploads, extract_and_match, the copies out
    def dispatch():
        out = matching.extract_and_match(
            api._pcm_to_device(pairs[0][1], torch.device("cuda")),
            lens[0][1] // 210,
            api._pcm_to_device(pairs[0][0], torch.device("cuda")),
            lens[0][0] // 210)
        api._to_host(api._single_shot_parts(out), torch.device("cuda"))
    waits = host_waits(dispatch)
    torch.cuda.synchronize()

    same = [all(np.array_equal(g[i], o[i]) for i in (0, 1, 3))
            and g[2] == o[2] and g[4] == o[4] and g[5] == o[5]
            for g, o in zip(results, singles)]
    offsets = [float(r[0][0] - r[1][0]) for r in results]
    planted_ok = all(k != "plain" or abs(o - p) <= TOL_S
                     for k, o, p in zip(kinds, offsets, planted))
    checks = {"batch == single": all(same),
              "planted": planted_ok,
              "launches": batch_launches == {
                  "coarse_score_map": 8,
                  "fine_match": 8 * matching.N_TRACKS,
                  "dp_forward": 8 * matching.N_TRACKS,
                  "dp_backtrace": 8 * matching.N_TRACKS,
                  "pcm_frontend": 8 * 2,
                  "polyphase_blur": 8 * 2,
                  "fused_lasso_admm": 0, "pv_phase_lock": 0},
              "quiet": quiet == "",
              "no retry": retries == 0}
    print(f"[7c device features batch] align_batch_from_pcm(features="
          f"'device') on the 8 pairs: first call {first_s:.3f} s, warm "
          f"{warm_s:.3f} s = {minutes / warm_s:.1f} audio-minutes per "
          f"second | one by one through align_from_pcm(features='device') "
          f"{seq_s:.3f} s | launches in the warm call {batch_launches} | "
          f"host waits in one pair's dispatch: {len(waits)} {waits} | peak "
          f"device memory {peak / 2**20:.0f} MiB | start offsets "
          f"{[round(o, 3) for o in offsets]} ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"the device-feature batch disagrees: {checks}")
    return launches, batch_launches, len(waits)


# ---------------------------------------------------------------------------
# Phase 8: the output side (the device fit, the device PV and resampler)
# ---------------------------------------------------------------------------

FIT_TOL_S = TOL_S           # device fit vs the JAX device fit, seconds


class FitNodes:
    """Records the compressed nodes every piecewise-linear fit of the port
    is given (fit.solve_l1_fit is looked up at call time by the host tail),
    under the label of the phase that runs it; pool threads append too."""

    def __init__(self):
        from describealign_tpu_torch.alignment import fit
        self.label, self.sets, self._fit = None, [], fit
        self._real = fit.solve_l1_fit

        def record(x, y, *args, **kwargs):
            self.sets.append((self.label, np.asarray(x), np.asarray(y)))
            return self._real(x, y, *args, **kwargs)
        fit.solve_l1_fit = record

    def of(self, label):
        return [(x, y) for lab, x, y in self.sets if lab == label]


def fit_stage_problems(x, y):
    """The two (b, data_cost, kappa) fused-lasso problems of the device fit
    on nodes (x, y) (stage 2 follows stage 1's result), and the fit."""
    from describealign_tpu_torch.alignment import fit_device
    problems, real = [], fit_device.fused_lasso_l1_device

    def record(b, data_cost, kappa, **kw):
        problems.append((np.asarray(b), np.asarray(data_cost),
                         np.asarray(kappa)))
        return real(b, data_cost, kappa, **kw)
    fit_device.fused_lasso_l1_device = record
    try:
        result = fit_device.solve_l1_fit_device(x, y, device="cuda")
    finally:
        fit_device.fused_lasso_l1_device = real
    return problems, result


def admm_vs_plain(label, problem, smi):
    """fused_lasso_admm against its plain version on one padded problem on
    the card: t and z bit-equal (signed zeros too), times, bounds."""
    from describealign_tpu_torch.alignment import fit_device
    from describealign_tpu_torch.ops import fit_kernel as fk
    n = len(problem[0])
    n_pad = fit_device.bucket(n)
    prep = fit_device._prep_problem(*problem, n_pad)
    args = [torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float64)[None] if np.ndim(a) else [a],
        np.float32)).cuda() for a in prep]
    t, z = fk.fused_lasso_admm(*args)
    t0 = time.perf_counter()
    tp, zp = fk.fused_lasso_admm_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    equal = (torch.equal(t, tp) and torch.equal(z, zp)
             and torch.equal(torch.signbit(z), torch.signbit(zp)))
    err = float(torch.max(torch.abs(t - tp)))
    flips = int(torch.sum((z != 0) != (zp != 0)))
    ms = cuda_ms(lambda: fk.fused_lasso_admm(*args))
    nbytes, flops = fk.fit_admm_work(n_pad)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    # the floor: the solve's CTA barriers on an empty CTA of the kernel's
    # threads plus its warp steps on an empty warp
    barriers, warp_steps = fk.steps_per_solve(n_pad)
    cta_ms = fk.empty_steps_ms(barriers, n_pad)
    warp_ms = fk.empty_warp_steps_ms(warp_steps)
    floor_ms = cta_ms + warp_ms
    shared = sorted(set(fk.shared_slots(n_pad)), key=fk.SLOTS.index)
    print(f"[8a fit kernel vs plain] {label}: n {n}, n_pad {n_pad} (in "
          f"shared memory {', '.join(shared) or 'nothing'}, the rest in "
          f"the global scratch), {int((z != 0).sum())} breaks: t and z "
          f"{'bit-equal' if equal else 'DIFFER'} (max |t - plain| {err:.3g},"
          f" {flips} break flips) | kernel {ms:.3f} ms, plain {plain_ms:.1f}"
          f" ms | bounds: bytes {bytes_ms:.5f} ms at 3.35 TB/s, fp32 "
          f"{ops_ms:.4f} ms at 67 TFLOP/s; floor: {barriers} CTA barriers "
          f"of an empty CTA {cta_ms:.3f} ms + {warp_steps} steps of an "
          f"empty warp {warp_ms:.3f} ms = {floor_ms:.3f} ms "
          f"({floor_ms / ms:.1%} of the kernel) ({smi})", flush=True)
    if not equal:
        raise AssertionError(f"fused_lasso_admm differs from its plain "
                             f"version on {label}")
    return {"n": n, "n_pad": n_pad, "ms": ms, "plain_ms": plain_ms,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "floor_ms": floor_ms,
            "barriers": barriers, "warp_steps": warp_steps, "err": err}


def phase_fit_device(v, a, nodes, smi):
    """Phase 8a: the device fit. The bench pair through align_from_pcm(...,
    fit_backend='device') against the JAX fixture, with the ADMM counted;
    the fit's four problems (both stages on the bench pair's and the
    film's compressed nodes) through the kernel and its plain version;
    the batch of 8's node sets through solve_l1_fit_device_batched against
    the per-problem calls. Returns (launches in the fixture run, rows)."""
    from describealign_tpu_torch.alignment import api, fit_device
    with open(FIT_EXPECTED) as f:
        expected = json.load(f)
    nodes.label = "8a"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        api.align_from_pcm(v, a, device="cuda", fit_backend="device")
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        x, y, sim, _, slope, _ = api.align_from_pcm(
            v, a, device="cuda", fit_backend="device")
    e2e = time.perf_counter() - t0
    launches = kernel_counts()
    printed = out.getvalue()
    bench_nodes = nodes.of("8a")[-1]
    jx = np.asarray(expected["audio_times_s"])
    jy = np.asarray(expected["video_times_s"])
    node_err = float(np.max(np.abs(np.interp(jx, x, y) - jy)))
    checks = {
        "nodes": node_err <= FIT_TOL_S,
        "start offset": abs(float(x[0] - y[0]) - expected["start_offset_s"])
        <= FIT_TOL_S,
        "similarity": abs(sim - expected["similarity_percent"]) <= 0.5,
        "median slope": abs(slope - expected["median_slope"]) <= 1e-4,
        "compressed nodes": len(bench_nodes[0]) == len(expected["nodes_x"]),
        "no fallback": "WARNING: device fit" not in printed,
        "launches": launches["fused_lasso_admm"] == 2,
    }
    print(f"[8a device fit] align_from_pcm(fit_backend='device') on the "
          f"bench pair: {e2e:.3f} s, {len(bench_nodes[0])} compressed nodes "
          f"(JAX {len(expected['nodes_x'])}), max node error "
          f"{node_err * 1e3:.2f} ms over {len(jx)} JAX nodes, similarity "
          f"{sim:.3f} (JAX {expected['similarity_percent']:.3f}), median "
          f"slope {slope:.9f} (JAX {expected['median_slope']:.9f}) | "
          f"launches {launches} ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"the device fit disagrees with JAX: {checks}")

    from describealign_tpu_torch.ops import fit_kernel as fk
    lib = fk.load_library()
    for n_pad in (16, 4096, 8192, 16384, 32768):
        if lib.fit_admm_shared_slots(n_pad) != len(fk.shared_slots(n_pad)):
            raise AssertionError(f"csrc/fit_admm.cu keeps "
                                 f"{lib.fit_admm_shared_slots(n_pad)} slots "
                                 f"in shared memory at n_pad {n_pad}, "
                                 f"fit_kernel.shared_slots says "
                                 f"{len(fk.shared_slots(n_pad))}")
    rows = {}
    for label, (nx, ny) in (("bench pair", bench_nodes),
                            ("film", nodes.of("5")[-1])):
        problems, _ = fit_stage_problems(nx, ny)
        for stage, problem in enumerate(problems, 1):
            rows[f"{label} stage {stage}"] = admm_vs_plain(
                f"{label} stage {stage}", problem, smi)

    sets = nodes.of("6")[:8]
    t0 = time.perf_counter()
    batched = fit_device.solve_l1_fit_device_batched(sets, device="cuda")
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [fit_device.solve_l1_fit_device(sx, sy, device="cuda")
               for sx, sy in sets]
    single_s = time.perf_counter() - t0
    same = all(np.array_equal(b[k], s[k]) for b, s in zip(batched, singles)
               for k in ("fit_err", "slopes", "smooth_y"))
    print(f"[8a fit batch] solve_l1_fit_device_batched on the batch of 8's "
          f"node sets ({[len(sx) for sx, _ in sets]} nodes): {batch_s:.3f} s"
          f" (2 launches) against {single_s:.3f} s one by one (16): "
          f"{'equal' if same else 'DIFFERENT'} results ({smi})", flush=True)
    if len(sets) != 8 or not same:
        raise AssertionError("the batched device fit differs from the "
                             "per-problem calls")
    return launches, rows


def pv_spectrum(seg, num_out, device):
    """The analysis spectrum (C, F, 513) of the device PV stretching seg to
    num_out samples, as stretch.phase_vocoder._pv_device computes it, its
    omega and its f32 rate."""
    from describealign_tpu_torch.stretch import phase_vocoder as pv
    c, n_in = seg.shape
    rate32 = np.float32(n_in / num_out)
    f = -(-num_out // pv.HOP_SYN)
    pos = torch.round(torch.arange(f, dtype=torch.float32, device=device)
                      * float(np.float32(pv.HOP_SYN) * rate32)).long()
    pad = torch.zeros((c, max(n_in, int(pos[-1]) + pv.N_FFT)),
                      device=device)
    pad[:, :n_in] = torch.from_numpy(seg).to(device)
    frames = (pad.unfold(1, pv.N_FFT, 1).index_select(1, pos)
              * torch.from_numpy(pv._WINDOW).to(device))
    omega = torch.from_numpy((2 * np.pi * np.arange(pv._BINS) * pv.HOP_SYN
                              / pv.N_FFT).astype(np.float32)).to(device)
    return torch.fft.rfft(frames, dim=2), omega, rate32


def phase_pv_kernel(seg, num_out, smi):
    """Phase 8b: pv_phase_lock on the rate pair's first stretched segment:
    kernel vs plain on its first block (the path's 8,192 frames), the
    kernel over the whole segment vs the host library's recurrence on the
    same magnitudes, phases and increments, times and bounds."""
    from describealign_tpu_torch.ops import pv_kernel as pk
    from describealign_tpu_torch.stretch import phase_vocoder as pv
    spec, omega, rate32 = pv_spectrum(seg, num_out, "cuda")
    c, f, bins = spec.shape
    blk = spec[:, :pv.DEVICE_BLK_FRAMES].contiguous()
    out_k, carry_k = pk.pv_phase_lock(blk, omega, rate32)
    t0 = time.perf_counter()
    out_p, carry_p = pk.pv_phase_lock_plain(blk, omega, float(rate32))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    equal = torch.equal(out_k, out_p) and torch.equal(carry_k, carry_p)
    err = float(torch.max(torch.abs(out_k - out_p)))
    ms = cuda_ms(lambda: pk.pv_phase_lock(blk, omega, rate32))
    passes = pk.pass_ms(blk, omega, rate32, reps=REPS)
    nbytes, flops = pk.pv_lock_work(c, blk.shape[1])
    bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOPS * 1e3
    pass_bytes_ms = {k: v / HBM_BYTES_S * 1e3
                     for k, v in pk.pv_pass_bytes(c, blk.shape[1]).items()}
    floor_blk = pk.empty_steps_ms(blk.shape[1], c)

    # the whole segment in one call, against the host recurrence
    seg_ms = cuda_ms(lambda: pk.pv_phase_lock(spec, omega, rate32), reps=2)
    seg_passes = pk.pass_ms(spec, omega, rate32, reps=2)
    out_seg, _ = pk.pv_phase_lock(spec, omega, rate32)
    rate_t = torch.tensor(float(rate32), device="cuda")
    two_pi = torch.tensor(pk.TWO_PI, device="cuda")
    mag = torch.hypot(spec.real, spec.imag)
    pa = torch.atan2(spec.imag, spec.real)
    om = omega * rate_t
    dphi = pa[:, 1:] - pa[:, :-1] - om
    dphi = dphi - two_pi * torch.round(dphi / two_pi)
    iors = (om + dphi) / rate_t
    pa_h, mag_h, iors_h = (np.ascontiguousarray(t.cpu().numpy())
                           for t in (pa, mag, iors))
    del dphi, iors
    t0 = time.perf_counter()
    phases = pv._phase_lock(pa_h, mag_h, iors_h)   # the host library's
    host_s = time.perf_counter() - t0
    ph = torch.from_numpy(phases).cuda()
    out_h = torch.complex(mag * torch.cos(ph), mag * torch.sin(ph))
    seg_equal = torch.equal(out_seg, out_h)
    seg_err = float(torch.max(torch.abs(out_seg - out_h)) / torch.max(mag))
    seg_bytes, seg_flops = pk.pv_lock_work(c, f)
    seg_bound = max(seg_bytes / HBM_BYTES_S, seg_flops / FP32_FLOPS) * 1e3
    seg_pass_ms = {k: v / HBM_BYTES_S * 1e3
                   for k, v in pk.pv_pass_bytes(c, f).items()}
    seg_floor = pk.empty_steps_ms(f, c)

    def shares(dev, built):
        return ", ".join(f"{k} {dev[k]:.4f} ms (its bytes {built[k]:.4f} ms, "
                         f"{built[k] / dev[k]:.1%})" for k in pk.PASSES)
    print(f"[8b PV kernel vs plain] rate pair's first stretched segment "
          f"({c} channels, {seg.shape[1]} -> {num_out} samples, {f} frames,"
          f" rate {float(rate32):.6f}): first {blk.shape[1]} frames "
          f"{'bit-equal' if equal else 'DIFFER'} (max |out - plain| "
          f"{err:.3g}); kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms (the function's bytes; "
          f"{max(bytes_ms, ops_ms) / ms:.1%}) | per pass: "
          f"{shares(passes, pass_bytes_ms)}; the walk's floor, an empty walk of "
          f"{blk.shape[1]} frames, {floor_blk:.3f} ms "
          f"({floor_blk / passes['walk']:.1%} of the walk) ({smi})",
          flush=True)
    print(f"[8b PV segment] the whole segment in one call {seg_ms:.2f} ms "
          f"({seg_ms / f * 1e3:.4f} us per frame), bound {seg_bound:.3f} ms "
          f"(the function's bytes; {seg_bound / seg_ms:.1%}), the passes' "
          f"bytes as built {sum(seg_pass_ms.values()):.3f} ms | per pass: "
          f"{shares(seg_passes, seg_pass_ms)}; an empty walk of "
          f"{f} frames {seg_floor:.2f} ms ({seg_floor / seg_passes['walk']:.1%}"
          f" of the walk) | vs the host library's recurrence ({host_s:.2f} "
          f"s): {'bit-equal' if seg_equal else 'differs'}, max |diff| "
          f"{seg_err:.3g} of the peak magnitude ({smi})", flush=True)
    if not equal or seg_err > PV_HOST_REL:
        raise AssertionError("pv_phase_lock differs from its plain version "
                             "or from the host recurrence")
    return {"ms": ms, "plain_ms": plain_ms, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "floor_ms": floor_blk, "err": err,
            "frames": blk.shape[1], "passes_ms": passes,
            "passes_bytes_ms": pass_bytes_ms, "segment_frames": f,
            "segment_ms": seg_ms, "segment_bound_ms": seg_bound,
            "segment_passes_ms": seg_passes,
            "segment_floor_ms": seg_floor, "segment_vs_host": seg_err}


# the whole segment's kernel output against the host library's recurrence
# on the same magnitudes, phases and increments (computed on the card):
# the recurrence has sums and selects only, nothing g++ could contract into
# an FMA, so they are expected bit-equal; 1e-6 of the peak magnitude holds
# the check against a stray rounding
PV_HOST_REL = 1e-6
CUT_VIDEO_S = 240.0         # the host references' cut of the rate pair
DEVICE_CHECK = 2 ** 19      # input samples of the PV's card-vs-CPU check
# the device PV on the card (cuFFT) against the same function on the CPU:
# the kernel is bit-equal to its plain version (8b), but the two FFTs
# round differently, and a wrap or a locking choice between near-equal
# neighbours decided differently offsets that bin's carried phase for
# good, so the outputs part slowly: RMS of the difference 0.022 of the
# signal's over the first 2^19 samples of the rate pair's segment (PR 8's
# chip runs; the port's CPU path against the JAX program: 6.8e-4 there).
# 0.1 still fails a broken block carry or overlap-add (~1) or an unrelated
# signal (~1.4)
PV_CARD_RMS = 0.1


def stereo(pcm):
    """(2, n) int16: the mono PCM and a 3/4-scaled copy."""
    return np.concatenate([pcm, (pcm.astype(np.int32) * 3 // 4)
                           .astype(np.int16)])


def first_stretched_segment(audio_times, video_times):
    """(x0, x1, y0, y1) in samples of the first segment the pitch-preserving
    stretcher takes (stretch/segments.py's rules)."""
    from describealign_tpu_torch.constants import (
        JUST_NOTICEABLE_DIFF_IN_FREQ_RATIO, MAX_RATE_RATIO_DIFF_ALIGN,
        MIN_DURATION_TO_REPLACE_SECONDS, MIN_STRETCH_OFFSET)
    xs = (np.asarray(audio_times) * 44100).astype(int)
    ys = (np.asarray(video_times) * 44100).astype(int)
    for i in range(len(xs) - 1):
        dx, dy = xs[i + 1] - xs[i], ys[i + 1] - ys[i]
        slope = dx / dy
        if (dy >= MIN_DURATION_TO_REPLACE_SECONDS * 44100
                and abs(1 - slope) <= MAX_RATE_RATIO_DIFF_ALIGN
                and abs(1 - slope) > JUST_NOTICEABLE_DIFF_IN_FREQ_RATIO
                and abs(dy - dx) >= MIN_STRETCH_OFFSET):
            return xs[i], xs[i + 1], ys[i], ys[i + 1]
    raise AssertionError("the rate pair has no stretched segment")


def run_combine(video_wav, audio_wav, root, tag, **kw):
    """combine() in stretch mode on one WAV pair into root/tag (alignments
    cached in root/plots): (seconds, stretch stage seconds, the stretched
    array, launches)."""
    from describealign_tpu_torch import pipeline
    from describealign_tpu_torch.stretch import segments
    real, seen = segments.replace_aligned_segments, {}

    def stretch(video_arr, *args, **kwargs):
        t0 = time.perf_counter()
        real(video_arr, *args, **kwargs)
        seen["s"] = time.perf_counter() - t0
        seen["out"] = video_arr.copy()
    segments.replace_aligned_segments = stretch
    try:
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            pipeline.combine([video_wav], [audio_wav], stretch_audio=True,
                             yes=True, output_dir=os.path.join(root, tag),
                             alignment_dir=os.path.join(root, "plots"),
                             **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
    finally:
        segments.replace_aligned_segments = real
    return wall, seen["s"], seen["out"], launches


def f16_steps(got, want):
    """Max |got - want| in f16 grid steps of the larger value (floored at
    the step of 1.0) and the RMS of the difference against want's."""
    step = np.spacing(np.maximum(np.maximum(np.abs(got), np.abs(want)),
                                 1.0).astype(np.float16)).astype(np.float32)
    d = got - want
    return (float(np.max(np.abs(d) / step)),
            float(np.sqrt(np.mean(d.astype(np.float64) ** 2))
                  / np.sqrt(np.mean(want.astype(np.float64) ** 2))))


def phase_stretch(rate_pair, smi):
    """Phase 8b-c: the rate pair (22-min video, its description slowed by 3
    %) as stereo WAVs through combine() with the device PV, the host PV,
    WSOLA and both resamplers, and the CLI with --fit_backend device; the
    PV kernel on its first stretched segment (8b). Returns (pv_phase_lock's
    launches in the device-PV run, the 8b record, the CLI's launches)."""
    from describealign_tpu_torch.alignment import api
    from describealign_tpu_torch.media.decode import write_wav
    from describealign_tpu_torch.stretch import phase_vocoder, resample
    v, a = rate_pair
    with contextlib.redirect_stdout(io.StringIO()):
        ax, vy, *_ = api.align_from_pcm(v, a, device="cuda")
    x0, x1, y0, y1 = first_stretched_segment(ax, vy)
    pv_rec = phase_pv_kernel(stereo(a)[:, x0:x1].astype(np.float32),
                             y1 - y0, smi)

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        t0 = time.perf_counter()
        full = (os.path.join(root, "film.wav"), os.path.join(root, "desc.wav"))
        write_wav(full[0], stereo(v))
        write_wav(full[1], stereo(a))
        cut_a = int((180.0 + CUT_VIDEO_S * 1.03 + 10.0) * 44100)
        cut = (os.path.join(root, "cut_film.wav"),
               os.path.join(root, "cut_desc.wav"))
        write_wav(cut[0], stereo(v[:, :int(CUT_VIDEO_S * 44100)]))
        write_wav(cut[1], stereo(a[:, :cut_a]))
        wav_s = time.perf_counter() - t0

        runs = {}
        for tag, media, kw in (
                ("pv device", full, dict(stretcher="pv", pv_backend="device")),
                ("resample device", full, dict(no_pitch_correction=True,
                                               resample_backend="device")),
                ("resample host", full, dict(no_pitch_correction=True)),
                ("cut pv device", cut, dict(stretcher="pv",
                                            pv_backend="device")),
                ("cut pv host", cut, dict(stretcher="pv")),
                ("cut wsola", cut, {})):
            runs[tag] = run_combine(*media, root, tag.replace(" ", "_"),
                                    **kw)
        pv_launches = runs["pv device"][3]
        # the device backends against the host ones: measured, not bounded
        # (their positions are f32 in the JAX design, the host's f64: a
        # position that rounds to another sample moves a PV frame, and
        # the PV's phases then drift apart for good; it moves the
        # resampler's 3-point window on this near-white content)
        pv_steps, pv_rms = f16_steps(runs["cut pv device"][2],
                                     runs["cut pv host"][2])
        rs_steps, rs_rms = f16_steps(runs["resample device"][2],
                                     runs["resample host"][2])

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_RUN, *full, "--stretch_audio",
             "--yes", "--no_pitch_correction", "--fit_backend", "device",
             "--output_dir", os.path.join(root, "cli"),
             "--alignment_dir", os.path.join(root, "cli_plots")],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    cli_out, _, last = proc.stdout.rstrip("\n").rpartition("\n")
    cli = json.loads(last)
    n_out = runs["pv device"][2].shape[1]
    for tag, (wall, st, _, launches) in runs.items():
        scope = (f"the first {CUT_VIDEO_S:.0f} s of the video: the host "
                 f"references cut" if tag.startswith("cut")
                 else f"{n_out / 44100 / 60:.1f}-min")
        print(f"[8c stretch] combine() {tag} ({scope} stereo): {wall:.2f} s,"
              f" stretch stage {st:.2f} s, launches "
              f"fused_lasso_admm {launches['fused_lasso_admm']}, "
              f"pv_phase_lock {launches['pv_phase_lock']} ({smi})",
              flush=True)
    # the card's device backends against the same functions on the CPU
    # (their plain versions, which tests/test_torch_stretch.py holds to
    # the JAX package's): the resampler on the whole first stretched
    # segment, the PV on its first DEVICE_CHECK input samples
    seg = stereo(a)[:, x0:x1].astype(np.float32)
    rs = [resample.resample_segment(seg, 0, seg.shape[1], y1 - y0,
                                    backend="device", device=d)
          for d in ("cuda", "cpu")]
    rs_card_steps, _ = f16_steps(*rs)
    short = seg[:, :DEVICE_CHECK]
    pv_out = [phase_vocoder.pv_stretch(
        short, int(round(DEVICE_CHECK * (y1 - y0) / (x1 - x0))),
        backend="device", device=d) for d in ("cuda", "cpu")]
    pv_card_steps, pv_card_rms = f16_steps(*pv_out)
    checks = {
        "pv launched": pv_launches["pv_phase_lock"] > 0,
        "host runs launch no PV": all(
            r[3]["pv_phase_lock"] == 0 for t, r in runs.items()
            if "pv device" not in t),
        "device PV card vs CPU": pv_card_rms < PV_CARD_RMS,
        "device resampler card vs CPU": rs_card_steps <= 1.0,
        "CLI fit launched": cli["launches"]["fused_lasso_admm"] > 0,
        "CLI no fallback": "WARNING: device fit" not in cli_out,
    }
    print(f"[8c stretch agreement] device vs host (measured): cut pair's "
          f"PV max {pv_steps:.0f} f16 grid steps, RMS of the difference "
          f"{pv_rms:.3g} of the signal's; full pair's resampler max "
          f"{rs_steps:.0f} steps, RMS {rs_rms:.3g} | the card vs the CPU's "
          f"plain versions: resampler on the first stretched segment "
          f"({seg.shape[1]} -> {y1 - y0} samples) max {rs_card_steps:.1f} "
          f"f16 grid steps, PV on its first {DEVICE_CHECK} samples max "
          f"{pv_card_steps:.1f} steps, RMS {pv_card_rms:.3g} | WAVs written "
          f"in {wav_s:.1f} s | CLI "
          f"--fit_backend device --no_pitch_correction on the full WAVs: "
          f"{cli_s:.2f} s, combine() {cli['combine_s']:.2f} s, launches "
          f"{cli['launches']} ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"the output side disagrees: {checks}")
    return pv_launches, pv_rec, cli["launches"]


# ---------------------------------------------------------------------------
# Phase 9: the last device modules (mel frontend, sequence sharding, the
# data-parallel batch)
# ---------------------------------------------------------------------------

# the mel bands on the card (cuFFT) against the same function on the CPU
# (pocketfft): two FFTs of 512 points round differently, ~1e-6 of a band's
# power; the CPU tests hold the CPU version to XLA's at rtol 1e-5 / atol
# 1e-6. K1 and K2, which make streams 0-1, are bit-equal to their plain
# versions (phase 7a)
MEL_RTOL = 1e-4
MEL_ATOL = 1e-5
# sharded vs unsharded interior frames: bit-equal expected (the halo keeps
# every interior output's inputs and order); else held to the CPU tests'
# bars against the JAX sharded call (tests/test_torch_seqshard.py)
SHARD_RTOL = 2e-5
SHARD_ATOL = 2e-5


def against_jax(label, result, expected, margin=True):
    """{check: ok} of an alignment's 5- or 6-tuple against a JAX fixture's
    entry (nodes, start offset, similarity, slope; the margin when both
    have one), and the line that says so."""
    x, y, sim, _, slope = result[:5]
    start_off = float(x[0] - y[0])
    jx = np.asarray(expected["audio_times_s"])
    jy = np.asarray(expected["video_times_s"])
    node_err = float(np.max(np.abs(np.interp(jx, x, y) - jy)))
    checks = {
        "start offset": abs(start_off - expected["start_offset_s"]) <= TOL_S,
        "nodes": node_err <= TOL_S,
        "similarity": abs(sim - expected["similarity_percent"]) <= 0.5,
        "median slope": abs(slope - expected["median_slope"]) <= 1e-4,
        "finite": bool(np.isfinite(x).all() and np.isfinite(y).all()),
    }
    line = (f"{label}: start offset {start_off:.4f} s (JAX "
            f"{expected['start_offset_s']:.4f}), max node error "
            f"{node_err * 1e3:.2f} ms over {len(jx)} JAX nodes, similarity "
            f"{sim:.3f} (JAX {expected['similarity_percent']:.3f}), slope "
            f"{slope:.7f} (JAX {expected['median_slope']:.7f})")
    if margin and len(result) > 5 and "margin" in expected:
        checks["margin"] = (abs(result[5] / expected["margin"] - 1)
                            <= MARGIN_REL)
        line += (f", margin {result[5]:.5f} (JAX "
                 f"{expected['margin']:.5f})")
    return checks, node_err, line


def run_or_raise(fn):
    """(fn()'s result, None) or (None, the exception's type name)."""
    try:
        return fn(), None
    except Exception as e:          # compared with the fixture's raise
        return None, type(e).__name__


def phase_mel(v, a, n_chunks, smi):
    """Phase 9a-b: the mel frontend. (a) the bench pair through
    align_from_pcm(frontend='mel') (host mel bands, the streamed matcher)
    against tests/data/torch_mel_expected.json's host entry; (b) the mel
    streams on the card (features_for(frontend='mel'): K1 + two K2
    launches per track, the torch mel bands) against the same function on
    the CPU, then align() against the fixture's device entry. Returns the
    kernels' launches in 9a's timed run and in 9b's two features_for
    calls and align()."""
    from describealign_tpu_torch.alignment import api, matching
    from describealign_tpu_torch.ops import mel
    from describealign_tpu_torch.pipeline import features_for
    with open(MEL_EXPECTED) as f:
        expected = json.load(f)

    # (a) the host path
    def host(timings=None):
        with contextlib.redirect_stdout(io.StringIO()):
            return api.align_from_pcm(v, a, device="cuda", timings=timings,
                                      frontend="mel")

    split = {}
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    result, raised = run_or_raise(host)
    first_s = time.perf_counter() - t0
    host_launches = kernel_counts()
    want_raise = expected["host"].get("raises")
    if raised or want_raise:
        print(f"[9a mel host] align_from_pcm(frontend='mel') raised "
              f"{raised}, JAX raised {want_raise} ({smi})", flush=True)
        if raised != want_raise:
            raise AssertionError(f"9a: the port raised {raised}, JAX "
                                 f"{want_raise}")
    else:
        t0 = time.perf_counter()
        host(split)
        split_s = time.perf_counter() - t0
        checks, _, line = against_jax("bench pair", result,
                                      expected["host"])
        want = {"coarse_score_map": 1,
                "fine_match": n_chunks * matching.N_TRACKS,
                "dp_forward": matching.N_TRACKS,
                "dp_backtrace": matching.N_TRACKS,
                "pcm_frontend": 0, "polyphase_blur": 0,
                "fused_lasso_admm": 0, "pv_phase_lock": 0}
        checks["launches"] = host_launches == want
        print(f"[9a mel host] align_from_pcm(frontend='mel'): e2e "
              f"{first_s:.3f} s, again with the split {split_s:.3f} s: "
              + ", ".join(f"{k} {s:.3f} s" for k, s in split.items())
              + f" | launches {host_launches} | {line} ({smi}) - "
              + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                          for k, ok in checks.items()), flush=True)
        if not all(checks.values()):
            raise AssertionError(f"9a disagrees with JAX: {checks}")

    # (b) the device mel streams, then align()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    feats = [features_for(pcm, frontend="mel") for pcm in (v, a)]
    feat_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    (vf, nv), (af, na) = feats
    with contextlib.redirect_stdout(io.StringIO()):
        result, raised = run_or_raise(lambda: api.align(
            vf, af, vf[0], af[0], video_frames=nv, audio_frames=na,
            device="cuda"))
    dev_launches = kernel_counts()
    worst = []
    for label, pcm, got in (("video", v, vf), ("audio", a, af)):
        cpu, _ = features_for(pcm, device="cpu", frontend="mel")
        errs = []
        for j, (g, c) in enumerate(zip(got, cpu)):
            d = np.abs(g.astype(np.float64) - c)
            errs.append((float(d.max()),
                         float(np.max(d / np.maximum(np.abs(c), 1e-30))),
                         bool(np.all(d <= MEL_ATOL + MEL_RTOL * np.abs(c)))))
        worst.append((label, errs))
    # mel_band_features and its rFFT alone, on the audio track
    pcm = torch.from_numpy(a.astype(np.float32)).cuda()
    mel_ms = cuda_ms(lambda: mel.mel_band_features(pcm))
    n_frames = pcm.shape[1] // mel.HOP
    frames = torch.nn.functional.pad(pcm[0, :n_frames * mel.HOP],
                                     (0, mel.N_FFT)).unfold(
        0, mel.N_FFT, mel.HOP)[:n_frames].contiguous()
    rfft_ms = cuda_ms(lambda: torch.fft.rfft(frames, dim=1))
    del frames, pcm
    want_raise = expected["device"].get("raises")
    checks = {"streams on the card vs CPU": all(ok for _, errs in worst
                                                for _, _, ok in errs),
              # K1 once and K2 twice per track; the matcher's kernels
              "launches": dev_launches["pcm_frontend"] == 2
              and dev_launches["polyphase_blur"] == 4
              and (raised is not None or min(
                  dev_launches[k] for k in ("coarse_score_map", "fine_match",
                                            "dp_forward", "dp_backtrace"))
                  > 0),
              "raise": raised == want_raise}
    line = f"align() raised {raised}, JAX raised {want_raise}"
    if result is not None and not want_raise:
        more, _, line = against_jax("bench pair", result, expected["device"])
        checks.update(more)
    print(f"[9b mel device] features_for(frontend='mel') on both tracks "
          f"{feat_s:.3f} s (peak device memory {peak / 2**20:.0f} MiB over "
          f"what was allocated before; on the audio track mel_band_features "
          f"{mel_ms:.3f} ms, its {n_frames} frames' rFFT alone "
          f"{rfft_ms:.3f} ms); streams vs the CPU "
          f"version (max abs, max rel, within rtol {MEL_RTOL} / atol "
          f"{MEL_ATOL}) "
          + "; ".join(f"{label} " + ", ".join(
              f"{j}: {e:.3g} {r:.3g}" for j, (e, r, _) in enumerate(errs))
              for label, errs in worst)
          + f" | launches {dev_launches} | {line} ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"9b disagrees: {checks}")
    return host_launches, dev_launches


def phase_seqshard(v, a, smi):
    """Phase 9c: sequence_sharded_features over [cuda:0] * 4 and [cuda:0]
    against the unsharded extract_features on the card, each bench track
    cut to a multiple of 210 x 4: interior frames (8 .. n - 8) bit-equal
    or within the CPU bars, edge frames' error stated, wall times, K1 / K2
    launches per shard. Returns the launches of the four- and one-shard
    calls on both tracks."""
    from describealign_tpu_torch.ops.features import extract_features
    from describealign_tpu_torch.parallel.seqshard import \
        sequence_sharded_features
    card = torch.device("cuda", 0)
    launches = {}
    rows, checks = [], {}
    for label, pcm in (("video", v), ("audio", a)):
        s = pcm.shape[1] - pcm.shape[1] % (210 * 4)
        x = torch.from_numpy(np.ascontiguousarray(pcm[:, :s])).float()
        x = x.to(card)
        n = s // 210

        def whole():
            return torch.stack([f[:n] for f in extract_features(
                x, device=card)])

        def wall(fn):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        ref, ref_ms = wall(whole)
        for shards in (4, 1):
            mesh = [card] * shards
            kernel_counts(reset=True)
            got = sequence_sharded_features(x, mesh)
            torch.cuda.synchronize()
            count = kernel_counts()
            for k, c in count.items():
                launches[k] = launches.get(k, 0) + c
            _, ms = wall(lambda: sequence_sharded_features(x, mesh))
            inner_g, inner_r = got[:, 8:n - 8], ref[:, 8:n - 8]
            d = (inner_g - inner_r).abs()
            rel = float((d / inner_r.abs().clamp_min(1e-30)).max())
            bit = bool(torch.equal(inner_g, inner_r))
            edge = float((got - ref).abs().max())
            ok = bit or bool(torch.all(d <= SHARD_ATOL
                                       + SHARD_RTOL * inner_r.abs()))
            checks[f"{label} {shards}"] = (
                ok and got.shape == (5, n)
                and count["pcm_frontend"] == shards
                and count["polyphase_blur"] == shards)
            rows.append(f"{label} {s} samples over {shards} shard(s): "
                        f"{ms:.3f} ms (unsharded {ref_ms:.3f} ms), interior "
                        f"frames {'bit-equal' if bit else 'worst rel err'}"
                        f"{'' if bit else f' {rel:.3g}'}, all frames max "
                        f"abs err {edge:.3g} (the edge smear), K1 "
                        f"{count['pcm_frontend']} and K2 "
                        f"{count['polyphase_blur']} launches")
        del x, ref
    print(f"[9c seqshard] sequence_sharded_features on one card (the "
          f"halo copies stay on it: one card cannot time a multi-GPU "
          f"exchange): " + " | ".join(rows) + f" ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"9c disagrees: {checks}")
    return launches


def phase_sharded_batch(batch, smi):
    """Phase 9d: the batch of 8 through align_batch_from_pcm three ways in
    this call: mesh=make_mesh() (one card: groups of 1), mesh=[cuda:0] * 3
    (groups of 3, 3 and 2) and the serial path; each pair against the JAX
    fixtures (tests/data/torch_sharded_expected.json for the meshes,
    torch_batch8_expected.json for the serial path), wall and launches of
    each route, host waits in one group's dispatch. Returns {route:
    launches}."""
    from describealign_tpu_torch.alignment import api, matching
    from describealign_tpu_torch.parallel.batch import (device_align_step,
                                                        make_mesh)
    with open(SHARDED_EXPECTED) as f:
        expected = json.load(f)
    with open(BATCH_EXPECTED) as f:
        serial_expected = json.load(f)["pairs"]
    pairs, lens, _, kinds = batch
    n_pairs = len(expected["pairs"])
    if [(e["video_samples"], e["audio_samples"], e["kind"])
            for e in expected["pairs"]] != [
            (sv, sa, k) for (sv, sa), k in zip(lens[:n_pairs],
                                               kinds[:n_pairs])]:
        raise AssertionError("the batch pairs differ from the sharded "
                             "fixture's")
    pairs, lens = pairs[:n_pairs], lens[:n_pairs]
    minutes = sum(sa for _, sa in lens) / 44100 / 60
    card = torch.device("cuda", 0)
    routes = {"mesh=make_mesh()": (make_mesh(), "mesh1"),
              "mesh=[cuda:0]*3": ([card] * 3, "mesh3"),
              "serial": (None, None)}
    launches, rows, checks = {}, [], {}
    for route, (mesh, key) in routes.items():
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            results = api.align_batch_from_pcm(pairs, true_samples=lens,
                                               mesh=mesh)
        wall_s = time.perf_counter() - t0
        launches[route] = kernel_counts()
        want = expected[key] if key else serial_expected[:n_pairs]
        errs = []
        for k, (got, e) in enumerate(zip(results, want)):
            c, err, _ = against_jax(f"pair {k}", got, e, margin=key is None)
            checks[f"{route} pair {k}"] = all(c.values())
            errs.append(err * 1e3)
        n_groups = -(-n_pairs // len(mesh)) if mesh else None
        checks[f"{route} quiet"] = out.getvalue() == ""
        # the meshes run the single-shot matcher: one score map per pair,
        # one fine pass and one DP per track and pair; the serial path,
        # phase 6's streamed matcher
        per = (2 * n_pairs if mesh else None)
        checks[f"{route} launches"] = (
            launches[route]["pcm_frontend"] == 0
            and all(launches[route][k] == per if per else
                    launches[route][k] > 0
                    for k in ("fine_match", "dp_forward", "dp_backtrace"))
            and launches[route]["coarse_score_map"] == n_pairs)
        rows.append(f"{route}"
                    f"{f' ({n_groups} groups)' if n_groups else ''}: "
                    f"{wall_s:.3f} s = {minutes / wall_s:.1f} "
                    f"audio-minutes per second, node error vs JAX max "
                    f"{max(errs):.2f} ms (per pair "
                    f"{[round(e, 2) for e in errs]}), launches "
                    f"{launches[route]}")

    # one group's dispatch on three slots, as the mesh route dispatches
    # each pair: host waits
    npad = max(max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
               for sv, sa in lens[:3])

    class Extracted:
        """A stream's host features made ahead of the dispatch, handed
        over as the batch's feature pool hands a finished task."""

        def __init__(self, pcm, samples):
            self.out = api.host_features_padded(pcm, samples, npad)

        def done(self):
            return True

        def result(self):
            return self.out

    ahead = [(Extracted(v, sv), Extracted(a, sa))
             for (v, a), (sv, sa) in zip(pairs[:3], lens[:3])]

    def dispatch():
        for video, audio in ahead:
            dev_av, _, _, na, nv = api._upload_pair_features(video, audio,
                                                             npad, card)
            api._to_host(device_align_step(dev_av[0], na, dev_av[1], nv),
                         card)
    waits = host_waits(dispatch)
    torch.cuda.synchronize()
    checks["no host wait"] = not waits
    print(f"[9d sharded batch] the batch of {n_pairs} ({minutes:.1f} "
          f"audio-minutes) on one card: " + " | ".join(rows)
          + f" | host waits in one 3-pair group's dispatch: {len(waits)} "
          f"{waits} ({smi}) - "
          + ("nodes, quiet, launches, no host wait: all ok"
             if all(checks.values()) else "FAIL "
             + ", ".join(k for k, ok in checks.items() if not ok)),
          flush=True)
    if not all(checks.values()):
        raise AssertionError(f"9d disagrees: {checks}")
    return launches


# --- phase 10: the GUI's worker, the edge-case campaign, the dryrun twin ----

WORKER_TIMEOUT_S = 600      # the spawned GUI worker's run, seconds


def gui_settings(root, tag):
    """The five settings written to a config.ini under root through the
    GUI's SettingsModel (stretch mode, output and report folders under
    root/tag) and read back, as MainFrame hands them to its worker."""
    from describealign_tpu_torch.gui import core
    path = os.path.join(root, tag + ".ini")
    model = core.SettingsModel(path)
    model.set("stretch_audio", True)
    model.set("output_dir", os.path.join(root, tag, "out"))
    model.set("alignment_dir", os.path.join(root, tag, "plots"))
    model.save()
    return core.SettingsModel(path).values


def transcript_of(chunks):
    """(TranscriptModel fed every chunk, the lines tagged 'error')."""
    from describealign_tpu_torch.gui import core
    model = core.TranscriptModel()
    for chunk in chunks:
        model.feed(chunk)
    return model, [ln for ln in model.lines
                   if core.classify_line(ln) == "error"]


def gui_outputs(settings, expected):
    """(output WAV shape, report lines) of a worker's run."""
    with wave.open(os.path.join(settings["output_dir"],
                                "ad_" + expected["video_wav"])) as w:
        shape = (w.getnchannels(), w.getnframes())
    stem = os.path.splitext(expected["video_wav"])[0]
    with open(os.path.join(settings["alignment_dir"], stem + ".txt")) as f:
        return shape, f.read().splitlines()


def phase_gui(video_wav, audio_wav, wav_dir, smi, n_chunks):
    """Phase 10a: the GUI's combiner worker (gui.core) on phase 4's WAVs,
    with the settings written through SettingsModel: in this process on
    the bare default device, every chunk through TranscriptModel, no
    error line, the report's numbers against the JAX combine() fixture by
    phase 4's rules, the output's shape and the kernels' launches as in
    phase 4; then once more in the child gui.core.start_worker spawns (as
    CombineFrame does): exit code 0, no error line, the output written.
    Returns the in-process run's launches."""
    from describealign_tpu_torch.alignment import matching
    from describealign_tpu_torch.gui import core
    with open(COMBINE_EXPECTED) as f:
        expected = json.load(f)
    want_shape = (expected["output_channels"], expected["output_samples"])
    want = report_numbers(expected["report"])
    with tempfile.TemporaryDirectory(dir=wav_dir) as root:
        settings = gui_settings(root, "in_process")
        q = queue.Queue()
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        core.run_combine_to_queue(q, [video_wav], [audio_wav], settings)
        torch.cuda.synchronize()
        in_s = time.perf_counter() - t0
        launches = kernel_counts()
        chunks = []
        while not q.empty():
            chunks.append(q.get())
        model, errors = transcript_of(chunks)
        shape, report = gui_outputs(settings, expected)
        got = report_numbers(report)
        checks = {
            "in-process error lines": not errors,
            "in-process output shape": shape == want_shape,
            "in-process start offset": abs(got[1] - want[1]) <= TOL_S,
            "in-process similarity": abs(got[0] - want[0]) <= 0.5,
            "in-process median rate change":
                abs(got[2] - want[2]) <= 1e-4 * 100,
            "in-process launches": launches == {
                "coarse_score_map": 1,
                "fine_match": n_chunks * matching.N_TRACKS,
                "dp_forward": matching.N_TRACKS,
                "dp_backtrace": matching.N_TRACKS,
                "pcm_frontend": 0, "polyphase_blur": 0,
                "fused_lasso_admm": 0, "pv_phase_lock": 0},
        }
        # the bench pair's output WAV is 233 MB
        shutil.rmtree(os.path.join(root, "in_process"))

        child_settings = gui_settings(root, "child")
        t0 = time.perf_counter()
        q, worker = core.start_worker([video_wav], [audio_wav],
                                      child_settings)
        chunks, deadline = [], time.monotonic() + WORKER_TIMEOUT_S
        # the GUI's own drain: read while the queue has data
        while worker.is_alive() or not q.empty():
            if not q.empty():
                chunks.append(q.get())
            elif time.monotonic() > deadline:
                worker.terminate()
                raise AssertionError("10a: the spawned GUI worker did not "
                                     f"finish in {WORKER_TIMEOUT_S} s")
            else:
                time.sleep(0.05)
        worker.join()
        child_s = time.perf_counter() - t0
        child_model, child_errors = transcript_of(chunks)
        if worker.exitcode != 0 or child_errors:
            raise AssertionError(
                f"10a: the spawned GUI worker exited {worker.exitcode} "
                f"with the error lines {child_errors}:\n"
                f"{child_model.text()[-3000:]}")
        child_shape, child_report = gui_outputs(child_settings, expected)
        checks.update({
            "child spawned": type(worker).__name__ == "SpawnProcess",
            "child output shape": child_shape == want_shape,
            "child report": report_numbers(child_report) == got,
        })
    print(f"[10a GUI worker] gui.core.run_combine_to_queue on phase 4's "
          f"WAVs, settings through SettingsModel (stretch mode): in this "
          f"process on the default device {in_s:.2f} s, {len(model.lines)} "
          f"transcript lines, launches {launches}, output {shape}, report "
          f"similarity {got[0]:.2f}% start offset {got[1]:.2f} s median "
          f"rate change {got[2]:.2f}% (JAX {want[0]:.2f}, {want[1]:.2f}, "
          f"{want[2]:.2f}); in the spawned child ({type(worker).__name__}, "
          f"exit code {worker.exitcode}) {child_s:.2f} s with its start, "
          f"{len(child_model.lines)} transcript lines, output {child_shape} "
          f"({smi}) - " + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                                    for k, ok in checks.items()),
          flush=True)
    if not all(checks.values()):
        if errors:
            print(f"[10a GUI worker] in-process error lines {errors}:\n"
                  f"{model.text()[-3000:]}", flush=True)
        raise AssertionError(f"10a disagrees: {checks}")
    return launches


def sha16(x, dtype):
    """sha256 (first 16 hex digits) of an array's bytes as dtype."""
    return hashlib.sha256(np.ascontiguousarray(x, dtype).tobytes()
                          ).hexdigest()[:16]


def campaign_features(v, a, device):
    """One campaign pair's padded host features on device, as
    align_from_pcm uploads them: (fa, na, fv, nv)."""
    from describealign_tpu_torch.alignment import api
    sv, sa = v.shape[1], a.shape[1]
    npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
    fv, nv = api.host_features_padded(v, sv, npad)
    fa, na = api.host_features_padded(a, sa, npad)
    return api._upload(fa, device), na, api._upload(fv, device), nv


def align_quiet(v, a, device):
    """align_from_pcm on device: (its 6-tuple, what it printed)."""
    from describealign_tpu_torch.alignment import api
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = api.align_from_pcm(v, a, device=device)
    return result, out.getvalue()


def phase_campaign(device, smi):
    """Phase 10b: the JAX package's eight edge-case structures
    (bench_pair.build_campaign_case) through align_from_pcm on the card
    against tests/data/torch_campaign_expected.json, by
    tests/test_torch_campaign.py's rules: the int16 inputs' hashes, nodes
    within 10 ms, similarity within 0.5, slope within 1e-4, the same retry
    decision and printed lines, the streamed matcher's LIS chain on the
    card bit-equal; the returned path (the host tail's floats) bit-equal,
    or where not, bit-equal to the same call on this machine's CPU: the
    host library is built with -march=native, so its last bits follow the
    host's CPU, not the card (ROADMAP C6). Every chunk of both tracks of
    every case also goes through the fine kernel and its plain version by
    phase 2's rules (any number of gate candidates, ties allowed, MAX_REL
    alone). Returns the launches over the eight align_from_pcm runs."""
    from describealign_tpu_torch.alignment import api, matching
    from describealign_tpu_torch.bench_pair import (CAMPAIGN_CASES,
                                                    build_campaign_case)
    with open(CAMPAIGN_EXPECTED) as f:
        expected = json.load(f)["cases"]
    launches, rows, checks, build_s = {}, [], {}, 0.0
    for name in CAMPAIGN_CASES:
        want = expected[name]
        t0 = time.perf_counter()
        v, a = build_campaign_case(name)
        build_s += time.perf_counter() - t0
        inputs = ((v.shape[1], a.shape[1], sha16(v, np.int16),
                   sha16(a, np.int16))
                  == (want["video_samples"], want["audio_samples"],
                      want["video_sha256_16"], want["audio_sha256_16"]))
        kernel_counts(reset=True)
        t0 = time.perf_counter()
        (x, y, sim, path, slope, margin), printed = align_quiet(v, a, device)
        align_s = time.perf_counter() - t0
        counts = kernel_counts()
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        jx = np.asarray(want["audio_times_s"])
        jy = np.asarray(want["video_times_s"])
        node_err = float(np.abs(np.interp(jx, x, y) - jy).max())
        retry = "rechecking alignment" in printed
        path_equal = (len(path) == want["path_rows"]
                      and sha16(path, np.float64) == want["path_sha256_16"])
        # the LIS chain, then the fine kernel against its plain version
        # on this case's coarse state
        feats = campaign_features(v, a, device)
        y_lis, x_lis, _ = api._streamed_lis(*feats)
        chain = np.stack([y_lis, x_lis]).astype(np.int64)
        lis_equal = (chain.shape[1] == want["lis_rows"]
                     and sha16(chain, np.int64) == want["lis_sha256_16"])
        state = matching.match_coarse(*feats)
        del feats
        ties = []
        fine = [kernel_vs_plain(state, b0, track, False, gate_per=None,
                                ties=ties, max_abs=None)
                for b0 in range(0, state[6].shape[1], matching.FINE_CHUNK)
                for track in range(matching.N_TRACKS)]
        del state
        gate = [g for r in fine for g in r[6]]
        note = (f"LIS chain {'bit-equal' if lis_equal else 'DIFFERS'} "
                f"({chain.shape[1]} pairs); fine kernel vs plain: "
                f"{sum(r[4] for r in fine)} candidates, {len(gate)} kept by "
                f"one side at the gate, {len(ties)} in ties, max abs err "
                f"{max(r[0] for r in fine):.3g}, max rel "
                f"{max(r[7] for r in fine):.3g}")
        path_ok = path_equal
        if not path_equal:
            host = align_quiet(v, a, "cpu")[0][3]
            path_ok = host.shape == path.shape and bool(np.all(host == path))
            note += (f"; the path on this machine's CPU "
                     f"{'is bit-equal to' if path_ok else 'DIFFERS from'} "
                     f"the card's")
        case = {"inputs": inputs, "nodes": node_err <= TOL_S,
                "similarity": abs(sim - want["similarity_percent"]) <= 0.5,
                "slope": abs(slope - want["median_slope"]) <= 1e-4,
                "retry": retry == want["retry"], "lis": lis_equal,
                "path": path_ok,
                # one score map per coarse pass, two with the retry
                "coarse map launched": counts["coarse_score_map"]
                == (2 if retry else 1),
                "printed": printed == want["printed"]}
        checks[name] = all(case.values())
        rows.append(
            f"{name} ({a.shape[1] / 44100:.1f}-s description) "
            f"{align_s:.3f} s: node error {node_err * 1e3:.2f} ms over "
            f"{len(jx)} JAX nodes, similarity {sim:.3f} (JAX "
            f"{want['similarity_percent']:.3f}), slope {slope:.7f} (JAX "
            f"{want['median_slope']:.7f}), margin {margin:.4f} (JAX "
            f"{want['margin']:.4f}), retry {retry}, path "
            f"{'bit-equal' if path_equal else 'DIFFERS'} ({len(path)} "
            f"rows); {note}"
            + ("" if checks[name] else " FAIL: " + ", ".join(
                k for k, ok in case.items() if not ok)))
        if ties or gate:
            rows[-1] += f" (key, kernel, plain) {(gate + ties)[:4]}"
    print(f"[10b campaign] the eight edge-case structures through "
          f"align_from_pcm on the card (inputs built in {build_s:.1f} s, "
          f"hashes equal to the fixture's): " + " | ".join(rows)
          + f" | launches {launches} ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"10b disagrees: {checks}")
    return launches


# The dryrun twin of phase 10c: scripts/torch_dryrun_multichip.py through
# runpy, with the kernels' launch counts printed as one JSON line after it.
DRYRUN_RUN = """
import json, runpy, sys
from describealign_tpu_torch.ops import (coarse_dp, coarse_map,
                                         features_kernel, fine_kernel)
wrappers = {"coarse_score_map": coarse_map.block_scores,
            "fine_match": fine_kernel.fine_match,
            "dp_forward": coarse_dp.dp_forward,
            "dp_backtrace": coarse_dp.dp_backtrace,
            "pcm_frontend": features_kernel.pcm_frontend_cuda,
            "polyphase_blur": features_kernel.polyphase_blur_cuda}
for w in wrappers.values():
    w.launches = 0
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name="__main__")
print(json.dumps({k: w.launches for k, w in wrappers.items()}))
"""


def phase_dryrun(smi):
    """Phase 10c: scripts/torch_dryrun_multichip.py in a subprocess on
    [cuda:0] * 2 (mesh data 2 x seq 1) and [cuda:0] * 4 (2 x 2): exit 0
    (its interior frames bit-equal to the unsharded extractor), the JAX
    dryrun's line, and per pair K1 and K2 once per shard and once for the
    unsharded reference, coarse_score_map once, fine_match, dp_forward and
    dp_backtrace once per track. Returns {mesh label: launches}."""
    out = {}
    rows, checks = [], {}
    for n in (2, 4):
        seq = 2 if (n % 2 == 0 and n >= 4) else 1
        data = n // seq
        label = f"[cuda:0]*{n}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", DRYRUN_RUN, DRYRUN] + ["cuda:0"] * n,
            cwd=REPO, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"10c: the dryrun on {label} failed "
                                 f"({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        launches = json.loads(lines[-1])
        want = {"coarse_score_map": data,
                "fine_match": 2 * data, "dp_forward": 2 * data,
                "dp_backtrace": 2 * data,
                "pcm_frontend": 2 * data * (seq + 1),
                "polyphase_blur": 2 * data * (seq + 1)}
        checks[label] = (lines[-2].startswith(
            f"dryrun_multichip OK: mesh(data={data}, seq={seq}), quals ")
            and launches == want)
        out[label] = dict(launches, fused_lasso_admm=0, pv_phase_lock=0)
        rows.append(f"{label}: {lines[-2]!r}, process {wall:.2f} s, "
                    f"launches {launches}")
    print(f"[10c dryrun twin] scripts/torch_dryrun_multichip.py, interior "
          f"frames bit-equal to the unsharded extractor: "
          + " | ".join(rows) + f" ({smi}) - "
          + ", ".join(f"{k} {'ok' if ok else 'FAIL'}"
                      for k, ok in checks.items()), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"10c disagrees: {checks}")
    return out


def main():
    missing = [p for p in (os.path.join(REPO, "describealign_tpu_torch",
                                        "__init__.py"),) + FIXTURES
               if not os.path.exists(p)]
    if missing:
        raise SystemExit(f"chip_smoke: {', '.join(missing)} not found: run "
                         f"this script from the root of a checkout of the "
                         f"repository (it drives the port and holds it to "
                         f"these fixtures)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is unavailable; this check runs "
                         "only on a machine with an NVIDIA GPU")
    from describealign_tpu_torch.alignment import api, matching
    from describealign_tpu_torch.alignment.native import native_lib
    from describealign_tpu_torch.bench_pair import build_scale_pair
    from describealign_tpu_torch.ops import (coarse_dp, coarse_map,
                                             features_kernel, fine_kernel,
                                             fit_kernel, pv_kernel)

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # --- phase 1: the card and the builds --------------------------------
    t_phase = time.perf_counter()
    smi = card_line()
    nvcc_s, dp_s, map_s, feat_s, fit_s, pv_s, gxx_s = build_all(
        fine_kernel.load_library, coarse_dp.load_library,
        coarse_map.load_library, features_kernel.load_library,
        fit_kernel.load_library, pv_kernel.load_library, native_lib)
    print(smi)
    print(f"[1 card] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | nvcc fine_match.cu {nvcc_s:.2f} s, "
          f"coarse_dp.cu {dp_s:.2f} s, coarse_map.cu {map_s:.2f} s (tile "
          f"{coarse_map.kernel_config()}), features_dev.cu {feat_s:.2f} s, "
          f"fit_admm.cu {fit_s:.2f} s, pv_lock.cu {pv_s:.2f} s | g++ "
          f"host library {gxx_s:.2f} s (built side by side)", flush=True)
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
    for b0, track, err, p99, k_ms, p_ms, n, bound, gate, rel in rows:
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
              f"{p99:.3g}, max rel {rel:.3g}{timing} ({smi})", flush=True)
    dp_rows = phase_dp_kernels(fa, na, fv, nv, device, smi)
    map_rows = phase_coarse_map(fa, na, fv, nv, device, smi)
    t_phase = phase_done(2, t_phase, smi)

    # --- phase 3: the main path ------------------------------------------
    nodes = FitNodes()                  # the fits' nodes, for phase 8a
    nodes.label = "3"

    def run(timings=None):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            r = api.align_from_pcm(v, a, device=device, timings=timings)
        return r, out.getvalue()

    run()                                           # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        result, printed = run()
        times.append(time.perf_counter() - t0)
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    runs = 3 * (2 if "rechecking alignment" in printed else 1)
    want = {"coarse_score_map": runs,
            "fine_match": runs * n_chunks * matching.N_TRACKS,
            "dp_forward": runs * matching.N_TRACKS,
            "dp_backtrace": runs * matching.N_TRACKS,
            "pcm_frontend": 0, "polyphase_blur": 0,
            "fused_lasso_admm": 0, "pv_phase_lock": 0}
    if launches != want:
        raise AssertionError(f"the kernels launched {launches} in 3 runs, "
                             f"expected {want}")
    split = {}
    run(split)
    e2e = float(np.median(times))
    print(f"[3 main path] bench pair ({sa / 44100 / 60:.1f}-min "
          f"description, {nb} blocks, {n_chunks} chunks, pair built in "
          f"{gen_s:.1f} s): e2e median {e2e:.3f} s of "
          f"{[round(t, 3) for t in times]} | split "
          + ", ".join(f"{k} {s:.3f} s" for k, s in split.items())
          + f" | launches {launches} (3 runs) | peak device "
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
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    wav_dir = tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build"))
    cli_launches, video_wav, audio_wav = phase_combine(v, a, smi, n_chunks,
                                                       wav_dir.name)
    t_phase = phase_done(4, t_phase, smi)

    # --- phase 5: a feature film through the coarse DP the card allows ----
    nodes.label = "5"
    film_launches, film_rows, film_dp, film_map = phase_film(device, smi)
    t_phase = phase_done(5, t_phase, smi)

    # --- phase 6: the batch of 8 -------------------------------------------
    nodes.label = "6"
    batch_launches, batch = phase_batch(device, smi)
    t_phase = phase_done(6, t_phase, smi)

    # --- phase 7: the device-feature path -----------------------------------
    nodes.label = "7"
    feat = phase_feature_kernels(
        [(label, api._pad_pcm_i16(pcm), pcm.shape[1])
         for label, pcm in (("audio", a), ("video", v))], smi)
    dev_rows, dev_dp = phase_device_kernels(v, a, device, smi)
    dev_launches, dev_batch_launches, _ = phase_device_features(
        v, a, split, batch, smi)
    t_phase = phase_done(7, t_phase, smi)

    # --- phase 8: the output side: device fit, device PV and resampler ----
    fit_launches, fit_rows = phase_fit_device(v, a, nodes, smi)
    rate_pair = batch[0][batch[3].index("rate")]
    pv_launches, pv_rec, cli8_launches = phase_stretch(rate_pair, smi)
    del rate_pair
    t_phase = phase_done(8, t_phase, smi)

    # --- phase 9: the mel frontend, sequence sharding, the sharded batch --
    mel_launches, mel_dev_launches = phase_mel(v, a, n_chunks, smi)
    shard_launches = phase_seqshard(v, a, smi)
    del v, a
    dp_launches = phase_sharded_batch(batch, smi)
    del batch
    t_phase = phase_done(9, t_phase, smi)

    # --- phase 10: the GUI's worker, the edge-case campaign, the dryrun ----
    gui_launches = phase_gui(video_wav, audio_wav, wav_dir.name, smi,
                             n_chunks)
    wav_dir.cleanup()
    campaign_launches = phase_campaign(device, smi)
    dryrun_launches = phase_dryrun(smi)
    phase_done(10, t_phase, smi)

    def by_phase(kernel):
        return {"3 align_from_pcm, 3 runs": launches[kernel],
                "4 CLI": cli_launches[kernel],
                "5 film": film_launches[""][kernel],
                "5 film, card reported full": film_launches["full"][kernel],
                "6 batch of 8, warm call": batch_launches[kernel],
                "7b align_from_pcm(features='device'), 3 runs":
                    dev_launches[kernel],
                "7c batch of 8 (features='device'), warm call":
                    dev_batch_launches[kernel],
                "8a align_from_pcm(fit_backend='device')":
                    fit_launches[kernel],
                "8c combine(stretcher='pv', pv_backend='device')":
                    pv_launches[kernel],
                "8c CLI --fit_backend device": cli8_launches[kernel],
                "9a align_from_pcm(frontend='mel')": mel_launches[kernel],
                "9b features_for(frontend='mel') x 2 + align()":
                    mel_dev_launches[kernel],
                "9c sequence_sharded_features, 4 + 1 shards, 2 tracks":
                    shard_launches[kernel],
                **{f"9d batch of 8, {route}": n[kernel]
                   for route, n in dp_launches.items()},
                "10a GUI worker in process": gui_launches[kernel],
                "10b campaign, 8 cases": campaign_launches[kernel],
                **{f"10c dryrun twin, {mesh}": n[kernel]
                   for mesh, n in dryrun_launches.items()}}

    def feature_record(kernel, line):
        # times and bounds per pair: the sum over its two streams
        rec = feat[kernel]
        return {"name": kernel,
                "route": "cuda",
                "source": "describealign_tpu_torch/csrc/features_dev.cu",
                "replaces": f"describealign_tpu/ops/features.py:{line}",
                "launches": dev_launches[kernel],
                "launches_by_phase": by_phase(kernel),
                "max_abs_err": rec["err"],
                "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": "bytes",
                "bound_share": rec["bound_ms"] / rec["ms"],
                "gb_per_s": rec["bytes"] / rec["ms"] / 1e6,
                "wrapper_ms": rec["wrapper_ms"],
                **{k: rec[k] for k in ("stages_ms",) if k in rec},
                "pcm_upload_ms": feat["upload_ms"],
                "library_ms": rec.get("library_ms")}

    def dp_record(kernel, line):
        # times on the bench pair's score map, mean of the two tracks; the
        # steps are sequential, so n empty steps of the cluster stand
        # beside the bytes bound
        bench = {k: float(np.mean([r[kernel][k] for r in dp_rows]))
                 for k in ("ms", "plain_ms", "bound_ms", "n")}
        film = film_dp[kernel]
        record = {
            "name": kernel,
            "route": "cuda",
            "source": "describealign_tpu_torch/csrc/coarse_dp.cu",
            "replaces": f"describealign_tpu/alignment/matching.py:{line}",
            "launches": launches[kernel],
            "launches_by_phase": by_phase(kernel),
            "max_abs_err": max([r[kernel]["err"] for r in dp_rows + dev_dp]
                               + [film["err"]]),
            "ms": bench["ms"],
            "plain_ms": bench["plain_ms"],
            "bound_ms": bench["bound_ms"],
            "bound_by": "bytes",
            "bound_share": bench["bound_ms"] / bench["ms"],
            "step_us": bench["ms"] / bench["n"] * 1e3,
            "film_tile_ms": film["ms"],
            "film_tile_plain_ms": film["plain_ms"],
            "film_tile_bound_ms": film["bound_ms"],
            "film_tile_step_us": film["ms"] / film["n"] * 1e3,
            # on the device path's narrower score map, mean of the tracks
            **{f"device_path_{k}": float(np.mean([r[kernel][k]
                                                  for r in dev_dp]))
               for k in ("ms", "plain_ms", "bound_ms", "d")},
            "library_ms": None,
        }
        if kernel == "dp_forward":
            first = dp_rows[0][kernel]
            record.update(
                cluster=first["cluster"], threads=first["threads"],
                lanes=first["lanes"],
                empty_step_us=float(np.mean([r[kernel]["empty_step_us"]
                                             for r in dp_rows])),
                film_tile_cluster=film["cluster"],
                film_tile_threads=film["threads"],
                film_tile_lanes=film["lanes"],
                film_tile_empty_step_us=film["empty_step_us"])
            record["empty_steps_ms"] = (record["empty_step_us"] * bench["n"]
                                        / 1e3)
        return record

    def fit_record():
        # per call on the bench pair's two stage problems (their mean); the
        # film's beside; both bounds: bytes / fp32 operations, and the
        # solve's barrier steps on an empty CTA of the same shape
        bench = {k: float(np.mean([fit_rows[f"bench pair stage {s}"][k]
                                   for s in (1, 2)]))
                 for k in ("ms", "plain_ms", "bytes_ms", "ops_ms",
                           "floor_ms")}
        film = {k: float(np.mean([fit_rows[f"film stage {s}"][k]
                                  for s in (1, 2)]))
                for k in ("ms", "plain_ms", "floor_ms")}
        bound = max(bench["bytes_ms"], bench["ops_ms"])
        return {"name": "fused_lasso_admm",
                "route": "cuda",
                "source": "describealign_tpu_torch/csrc/fit_admm.cu",
                "replaces": "describealign_tpu/alignment/fit_device.py:86",
                "launches": fit_launches["fused_lasso_admm"],
                "launches_by_phase": by_phase("fused_lasso_admm"),
                "max_abs_err": max(r["err"] for r in fit_rows.values()),
                "ms": bench["ms"],
                "plain_ms": bench["plain_ms"],
                "bound_ms": bound,
                "bound_by": ("operations" if bench["ops_ms"]
                             >= bench["bytes_ms"] else "bytes"),
                "bound_share": bound / bench["ms"],
                "barrier_floor_ms": bench["floor_ms"],
                "barrier_floor_share": bench["floor_ms"] / bench["ms"],
                "barriers": fit_rows["bench pair stage 1"]["barriers"],
                "warp_steps": fit_rows["bench pair stage 1"]["warp_steps"],
                "n_pad": fit_rows["bench pair stage 1"]["n_pad"],
                "film_n_pad": fit_rows["film stage 1"]["n_pad"],
                "film_ms": film["ms"],
                "film_plain_ms": film["plain_ms"],
                "film_barrier_floor_ms": film["floor_ms"],
                "library_ms": None}

    def pv_record():
        # per call on the path's block (8,192 frames, stereo); the whole
        # segment in one launch beside
        bound = max(pv_rec["bytes_ms"], pv_rec["ops_ms"])
        return {"name": "pv_phase_lock",
                "route": "cuda",
                "source": "describealign_tpu_torch/csrc/pv_lock.cu",
                "replaces": "describealign_tpu/stretch/phase_vocoder.py:60",
                "launches": pv_launches["pv_phase_lock"],
                "launches_by_phase": by_phase("pv_phase_lock"),
                "max_abs_err": pv_rec["err"],
                "ms": pv_rec["ms"],
                "plain_ms": pv_rec["plain_ms"],
                "bound_ms": bound,
                "bound_by": ("operations" if pv_rec["ops_ms"]
                             >= pv_rec["bytes_ms"] else "bytes"),
                "bound_share": bound / pv_rec["ms"],
                "frames": pv_rec["frames"],
                "passes_ms": pv_rec["passes_ms"],
                "passes_bytes_ms": pv_rec["passes_bytes_ms"],
                "empty_steps_ms": pv_rec["floor_ms"],
                "segment_frames": pv_rec["segment_frames"],
                "segment_ms": pv_rec["segment_ms"],
                "segment_bound_ms": pv_rec["segment_bound_ms"],
                "segment_passes_ms": pv_rec["segment_passes_ms"],
                "segment_empty_steps_ms": pv_rec["segment_floor_ms"],
                "segment_vs_host_rel": pv_rec["segment_vs_host"],
                "library_ms": None}

    def map_record():
        # the bench pair's whole map in one launch (nf 3, K 128); the
        # 5-stream map (K 256) and the film's tile 1 beside
        bench, retry = map_rows[3], map_rows[5]
        tiles = {r["suppressed"]: r for r in film_map if "ms" in r}
        bound = max(bench["tf32_ms"], bench["bytes_ms"])
        return {"name": "coarse_score_map",
                "route": "cuda",
                "source": "describealign_tpu_torch/csrc/coarse_map.cu",
                "replaces": "describealign_tpu/alignment/matching.py:171",
                "launches": launches["coarse_score_map"],
                "launches_by_phase": by_phase("coarse_score_map"),
                "max_abs_err": max(r["err"] for r in
                                   list(map_rows.values()) + film_map),
                "max_rel": max(r["rel"] for r in
                               list(map_rows.values()) + film_map),
                "ms": bench["ms"],
                "plain_ms": bench["plain_ms"],
                "bound_ms": bound,
                "bound_by": ("operations" if bench["tf32_ms"]
                             >= bench["bytes_ms"] else "bytes"),
                "bound_share": bound / bench["ms"],
                "bound_fp32_ms": bench["ffma_ms"],
                "bound_bytes_ms": bench["bytes_ms"],
                "useful_fma": bench["fma"],
                # no PyTorch call computes the whole function; the GEMM
                # alone is one torch.matmul of the 7 phases' product
                "gemm_alone_ms": bench["gemm_ms"],
                "retry_map_ms": retry["ms"],
                "retry_map_plain_ms": retry["plain_ms"],
                "retry_map_gemm_alone_ms": retry["gemm_ms"],
                "retry_map_bound_ms": max(retry["tf32_ms"],
                                          retry["bytes_ms"]),
                **{f"film_tile{'_suppressed' if sup else ''}_{k}": r[key]
                   for sup, r in tiles.items()
                   for k, key in (("ms", "ms"), ("plain_ms", "plain_ms"),
                                  ("gemm_alone_ms", "gemm_ms"))},
                "film_tile_bound_ms": max(tiles[False]["tf32_ms"],
                                          tiles[False]["bytes_ms"]),
                "tile": coarse_map.kernel_config(),
                "library_ms": None}

    chunk0 = [r for r in rows if r[0] == 0]
    film0 = [r for r in film_rows if r[0] == 0]
    k_ms = float(np.mean([r[4] for r in chunk0]))
    bound = [float(np.mean([r[7][i] for r in chunk0])) for i in range(4)]
    print(json.dumps({"kernels": [{
        "name": "fine_match",
        "route": "cuda",
        "source": "describealign_tpu_torch/csrc/fine_match.cu",
        "replaces": "describealign_tpu/ops/fine_kernel.py:61",
        "launches": launches["fine_match"],
        "launches_by_phase": by_phase("fine_match"),
        "max_abs_err": max([r[2] for r in rows + film_rows]
                           + [r[1] for r in dev_rows]),
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
        # the device path: all blocks in one call per track, at two widths
        "device_path_ms": float(np.mean([r[3] for r in dev_rows])),
        "device_path_plain_ms": float(np.mean([r[4] for r in dev_rows])),
        "device_path_bound_ms": float(np.mean([max(r[6][1], r[6][3])
                                               for r in dev_rows])),
        "device_path_max_rel": max(r[8] for r in dev_rows),
        "max_rel": max([r[9] for r in rows + film_rows]
                       + [r[8] for r in dev_rows]),
        "library_ms": None,
    }, dp_record("dp_forward", 225), dp_record("dp_backtrace", 241),
        feature_record("pcm_frontend", 51),
        feature_record("polyphase_blur", 85), fit_record(),
        pv_record(), map_record()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
