#!/usr/bin/env python
"""The PyTorch port's multi-card paths on every CUDA device of the host:
sequence-sharded features (parallel/seqshard.py: one shard per card, halos
copied between cards) and the data-parallel batch
(align_batch_from_pcm(mesh=...): one pair per card), each beside the same
code with every shard or pair on one card and the unsharded / serial path.

    python scripts/torch_multicard.py

Needs at least two CUDA devices (exits non-zero otherwise). Prints the
cards (nvidia-smi name and power limit) and their peer access, then:
- SHARDS: each bench track (bench_pair.build_scale_pair) cut to a
  multiple of 210 x the card count, through sequence_sharded_features over
  make_mesh() and over [cuda:0] * n, against extract_features on cuda:0:
  interior frames (8 .. n - 8) bit-equal, wall times (every card
  synchronized), K1 / K2 launches;
- BATCH: the batch of 8 (bench_pair.build_batch_pairs) through
  align_batch_from_pcm with mesh=make_mesh() (all cards), make_mesh(3),
  [cuda:0] * 3 and serially on cuda:0, the routes in turn, four calls
  each (the first pays each card's set-up): every pair's fit nodes within
  10 ms of the JAX fixture for the same mesh size
  (tests/data/torch_sharded_expected.json's n-device results for the
  meshes, tests/data/torch_batch8_expected.json for the serial path),
  wall and audio-minutes per second, launches, host waits in one group's
  dispatch over all cards; pipeline._auto_mesh() returning every card for
  the bare 'cuda' and None for 'cuda:1'.
The last line is {"ok": true, ...}.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SHARDED_EXPECTED = os.path.join(REPO, "tests", "data",
                                "torch_sharded_expected.json")
BATCH_EXPECTED = os.path.join(REPO, "tests", "data",
                              "torch_batch8_expected.json")
TOL_S = 0.010               # node agreement with the JAX fixtures, seconds
REPS = 4                    # calls of each batch route, taken in turn


def counts(reset=False):
    """{kernel: launches} of the matcher's and the extractor's kernels."""
    from describealign_tpu_torch.ops import (coarse_dp, features_kernel,
                                             fine_kernel)
    wrappers = {"fine_match": fine_kernel.fine_match,
                "dp_forward": coarse_dp.dp_forward,
                "dp_backtrace": coarse_dp.dp_backtrace,
                "pcm_frontend": features_kernel.pcm_frontend_cuda,
                "polyphase_blur": features_kernel.polyphase_blur_cuda}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return {k: w.launches for k, w in wrappers.items()}


def sync_all():
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def node_err(result, expected):
    x, y = result[0], result[1]
    jx = np.asarray(expected["audio_times_s"])
    jy = np.asarray(expected["video_times_s"])
    return float(np.max(np.abs(np.interp(jx, x, y) - jy)))


def shards(cards, smi):
    from describealign_tpu_torch.bench_pair import build_scale_pair
    from describealign_tpu_torch.ops.features import extract_features
    from describealign_tpu_torch.parallel.seqshard import \
        sequence_sharded_features
    n_cards = len(cards)
    v, a = build_scale_pair(os.path.join(REPO, "build", "bench_pair_i16.npz"))
    ok = True
    for label, pcm in (("video", v), ("audio", a)):
        s = pcm.shape[1] - pcm.shape[1] % (210 * n_cards)
        x = torch.from_numpy(np.ascontiguousarray(pcm[:, :s])).float()
        x = x.to(cards[0])
        n = s // 210
        rows = []
        for name, fn in (
                ("unsharded", lambda: torch.stack(
                    [f[:n] for f in extract_features(x, device=cards[0])])),
                (f"{n_cards} cards", lambda: sequence_sharded_features(
                    x, cards)),
                (f"{n_cards} shards on cuda:0", lambda: sequence_sharded_features(
                    x, [cards[0]] * n_cards))):
            fn()
            sync_all()
            counts(reset=True)
            t0 = time.perf_counter()
            got = fn()
            sync_all()
            ms = (time.perf_counter() - t0) * 1e3
            rows.append((name, got, ms, counts()))
        ref = rows[0][1]
        parts = []
        for name, got, ms, c in rows:
            same = bool(torch.equal(got[:, 8:n - 8], ref[:, 8:n - 8]))
            ok = ok and same
            parts.append(f"{name} {ms:.3f} ms (interior "
                         f"{'bit-equal' if same else 'DIFFERS'}, K1 "
                         f"{c['pcm_frontend']}, K2 {c['polyphase_blur']})")
        print(f"SHARDS {label} {s} samples: " + " | ".join(parts)
              + f" ({smi})", flush=True)
    return ok


def host_waits(fn):
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def batch(cards, smi):
    from describealign_tpu_torch import bench_pair
    from describealign_tpu_torch.alignment import api
    from describealign_tpu_torch.parallel.batch import (device_align_step,
                                                        make_mesh)
    from describealign_tpu_torch.pipeline import _auto_mesh
    with open(SHARDED_EXPECTED) as f:
        sharded = json.load(f)
    with open(BATCH_EXPECTED) as f:
        serial = json.load(f)["pairs"]
    t0 = time.perf_counter()
    pairs, lens, _, kinds = bench_pair.build_batch_pairs(workers=4)
    gen_s = time.perf_counter() - t0
    if [(e["video_samples"], e["audio_samples"]) for e in sharded["pairs"]
            ] != [tuple(ln) for ln in lens]:
        raise SystemExit("the batch pairs differ from the fixture's")
    minutes = sum(sa for _, sa in lens) / 44100 / 60
    # what the dispatching thread of every batch route does before each
    # pair's device work: the host features, one pair after another
    t0 = time.perf_counter()
    for (v, a), (sv, sa) in zip(pairs, lens):
        npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
        api.host_features_padded(v, sv, npad)
        api.host_features_padded(a, sa, npad)
    feat_s = time.perf_counter() - t0
    own = f"mesh{len(cards)}"
    if own not in sharded:
        raise SystemExit(f"{SHARDED_EXPECTED} has no {own}: rerun "
                         f"scripts/torch_expected_parallel.py with a "
                         f"{len(cards)}-device mesh")
    routes = [(f"mesh=make_mesh() ({len(cards)} cards)", cards,
               sharded[own])]
    if len(cards) > 3:
        routes.append(("mesh=make_mesh(3)", make_mesh(3), sharded["mesh3"]))
    routes += [("mesh=[cuda:0]*3", [cards[0]] * 3, sharded["mesh3"]),
               ("serial on cuda:0", None, serial)]
    ok = True
    walls = {name: [] for name, _, _ in routes}
    errs, launches = {}, {}
    # the routes in turn, REPS times: drift of the shared host falls on
    # every route alike; the first round pays each card's set-up
    for _ in range(REPS):
        for name, mesh, want in routes:
            counts(reset=True)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                results = api.align_batch_from_pcm(
                    pairs, true_samples=lens, mesh=mesh, device=cards[0])
            walls[name].append(time.perf_counter() - t0)
            launches[name] = counts()
            errs[name] = [node_err(r, e) * 1e3
                          for r, e in zip(results, want)]
    for name, _, _ in routes:
        warm = walls[name][1:]
        ok = ok and max(errs[name]) <= TOL_S * 1e3
        print(f"BATCH {name}: first call {walls[name][0]:.3f} s, warm "
              f"{[round(w, 3) for w in warm]} s, median "
              f"{np.median(warm):.3f} s = "
              f"{minutes / np.median(warm):.1f} audio-minutes per second | "
              f"max node error vs JAX {max(errs[name]):.2f} ms (per pair "
              f"{[round(e, 2) for e in errs[name]]}) | launches "
              f"{launches[name]} ({smi})", flush=True)

    # one group's dispatch over every card, as the mesh route dispatches
    # each pair: host waits
    npad = max(max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
               for sv, sa in lens[:len(cards)])

    def dispatch():
        with ThreadPoolExecutor(max_workers=2) as feats:
            for j, ((v, a), (sv, sa)) in enumerate(zip(pairs[:len(cards)],
                                                       lens[:len(cards)])):
                with torch.cuda.device(cards[j]):
                    dev_av, _, _, na, nv = api._upload_pair_features(
                        feats.submit(api.host_features_padded, v, sv, npad),
                        feats.submit(api.host_features_padded, a, sa, npad),
                        npad, cards[j])
                    api._to_host(device_align_step(dev_av[0], na,
                                                   dev_av[1], nv), cards[j])
    waits = host_waits(dispatch)
    sync_all()
    auto = _auto_mesh()
    ok = ok and not waits and auto == cards and _auto_mesh("cuda:1") is None
    print(f"BATCH {len(pairs)} pairs, {minutes:.1f} audio-minutes, built in "
          f"{gen_s:.1f} s, their host features on one thread "
          f"{feat_s:.3f} s | host waits in one {len(cards)}-pair group's "
          f"dispatch over the cards: {len(waits)} {waits} | "
          f"pipeline._auto_mesh() {[str(d) for d in auto or []]}, "
          f"_auto_mesh('cuda:1') {_auto_mesh('cuda:1')} ({smi})",
          flush=True)
    return ok


def main():
    if torch.cuda.device_count() < 2:
        raise SystemExit("needs at least two CUDA devices")
    from describealign_tpu_torch.alignment.native import native_lib
    from describealign_tpu_torch.ops import (coarse_dp, features_kernel,
                                             fine_kernel)
    from describealign_tpu_torch.parallel.batch import make_mesh
    cards = make_mesh()
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    smi = f"{len(lines)} x {lines[0]}"
    peer = [[torch.cuda.can_device_access_peer(i, j) if i != j else None
             for j in range(len(cards))] for i in range(len(cards))]
    threads = [threading.Thread(target=f) for f in (
        fine_kernel.load_library, coarse_dp.load_library,
        features_kernel.load_library, native_lib)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"CARDS {lines} | torch {torch.__version__} | peer access "
          f"{peer} | builds {time.perf_counter() - t0:.1f} s", flush=True)
    ok = shards(cards, smi)
    ok = batch(cards, smi) and ok
    print(json.dumps({"ok": ok, "cards": len(cards), "card": lines[0]}))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
