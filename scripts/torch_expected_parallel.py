#!/usr/bin/env python
"""Write the JAX package's results on the port's last device modules, the
fixtures that chip_smoke.py's phase 9 holds the PyTorch port against:

- tests/data/torch_mel_expected.json: the bench pair
  (`describealign_tpu_torch.bench_pair.build_scale_pair()`, the 22-min
  video / 27-min description with a 202 s lead-in) with the mel frontend
  (DESCRIBEALIGN_FRONTEND=mel in this process): (host) through
  `align_from_pcm`, whose host features then take the numpy mel bands;
  (device) through `pipeline.features_for` on each track (the mel bands
  of `ops/mel.mel_band_features` under XLA) and then `align()`. A call
  that raises is recorded as the raise.
- tests/data/torch_sharded_expected.json: the 8 bench-batch pairs
  (`bench_pair.build_batch_pairs()`) through `align_batch_from_pcm(...,
  mesh=...)` on a 1-, a 3- and a 4-device virtual CPU mesh
  (XLA_FLAGS=--xla_force_host_platform_device_count=4, set here before
  JAX is imported): groups of 1; of 3, 3 and 2; and of 4 and 4.

The card machine has no JAX, so these files are how the port's mel
frontend and data-parallel batch are compared with the reference. Run
from the repo root (CPU only; the JSON records its seconds and peak RSS):

    python scripts/torch_expected_parallel.py [--pairs N] [--only mel|sharded]

--pairs cuts the batch to its first N pairs (default all 8).
"""
import argparse
import json
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4"
                           ).strip()
os.environ.pop("DESCRIBEALIGN_FRONTEND", None)
os.environ.pop("DESCRIBEALIGN_FEATURES", None)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
MEL_OUT = os.path.join(REPO, "tests", "data", "torch_mel_expected.json")
SHARDED_OUT = os.path.join(REPO, "tests", "data",
                           "torch_sharded_expected.json")
MESHES = (1, 3, 4)                # devices of the sharded batch's meshes


def _peak_gib():
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                 / 2**20, 2)


def _nodes(r):
    x, y, sim, path, slope = r[:5]
    out = {"audio_times_s": [float(t) for t in x],
           "video_times_s": [float(t) for t in y],
           "similarity_percent": float(sim),
           "median_slope": float(slope),
           "start_offset_s": float(x[0] - y[0]),
           "path_rows": int(len(path))}
    if len(r) > 5:
        out["margin"] = float(r[5])
    return out


def _run(fn):
    """fn()'s result as _nodes gives it and the seconds it took, or the
    raise it made."""
    t0 = time.time()
    try:
        r = fn()
    except Exception as e:              # the fixture records the raise
        return {"raises": type(e).__name__, "message": str(e),
                "seconds_cpu": round(time.time() - t0, 1)}
    return dict(_nodes(r), seconds_cpu=round(time.time() - t0, 1))


def write(path, out):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def mel_fixture():
    from describealign_tpu.alignment.api import align, align_from_pcm
    from describealign_tpu.pipeline import features_for
    from describealign_tpu_torch import bench_pair

    t0 = time.time()
    video, audio = bench_pair.build_scale_pair(
        os.path.join(REPO, "build", "bench_pair_i16.npz"))
    gen_s = time.time() - t0
    os.environ["DESCRIBEALIGN_FRONTEND"] = "mel"
    try:
        host = _run(lambda: align_from_pcm(video, audio))

        def device():
            vf, nv = features_for(video)
            af, na = features_for(audio)
            return align(vf, af, vf[0], af[0], video_frames=nv,
                         audio_frames=na)
        dev = _run(device)
    finally:
        del os.environ["DESCRIBEALIGN_FRONTEND"]
    out = {
        "source": "describealign_tpu (JAX, CPU backend, "
                  "DESCRIBEALIGN_FRONTEND=mel) on "
                  "describealign_tpu_torch.bench_pair.build_scale_pair(): "
                  "host = alignment.api.align_from_pcm; device = "
                  "pipeline.features_for on each track, then "
                  "alignment.api.align",
        "video_samples": int(video.shape[1]),
        "audio_samples": int(audio.shape[1]),
        "pair_seconds_to_build": round(gen_s, 1),
        "host": host,
        "device": dev,
        "peak_rss_gib": _peak_gib(),
    }
    write(MEL_OUT, out)
    print(json.dumps({k: {kk: out[k].get(kk) for kk in (
        "start_offset_s", "similarity_percent", "raises", "seconds_cpu")}
        for k in ("host", "device")}))


def sharded_fixture(n_pairs):
    import jax
    from describealign_tpu.alignment.api import align_batch_from_pcm
    from describealign_tpu.parallel.batch import make_mesh
    from describealign_tpu_torch import bench_pair

    if jax.device_count() < max(MESHES):
        raise SystemExit("the 4-device virtual mesh is missing: XLA_FLAGS "
                         "must be set before JAX is imported")
    t0 = time.time()
    pairs, lens, planted, kinds = bench_pair.build_batch_pairs(workers=2)
    gen_s = time.time() - t0
    pairs, lens = pairs[:n_pairs], lens[:n_pairs]
    out = {
        "source": "describealign_tpu.alignment.api.align_batch_from_pcm "
                  "(JAX, CPU backend, mesh=parallel.batch.make_mesh(n), "
                  "n = 1, 3, 4, on a 4-device virtual CPU mesh) on "
                  "describealign_tpu_torch.bench_pair.build_batch_pairs()"
                  + (f", cut to its first {n_pairs} pairs"
                     if n_pairs < len(planted) else ""),
        "pairs_seconds_to_build": round(gen_s, 1),
        "pairs": [{"kind": str(k), "planted_offset_s": float(p),
                   "video_samples": int(ln[0]), "audio_samples": int(ln[1]),
                   "checksum": bench_pair.checksum(v, a)}
                  for (v, a), ln, p, k in zip(pairs, lens, planted, kinds)],
    }
    for n_dev in MESHES:
        t0 = time.time()
        results = align_batch_from_pcm(pairs, true_samples=lens,
                                       mesh=make_mesh(n_dev))
        out[f"mesh{n_dev}_seconds_cpu"] = round(time.time() - t0, 1)
        out[f"mesh{n_dev}"] = [_nodes(r) for r in results]
        print(f"mesh {n_dev}: {out[f'mesh{n_dev}_seconds_cpu']} s",
              flush=True)
    out["peak_rss_gib"] = _peak_gib()
    write(SHARDED_OUT, out)
    for k, *rs in zip(kinds, *(out[f"mesh{n}"] for n in MESHES)):
        print(k, [r["start_offset_s"] for r in rs],
              [r["similarity_percent"] for r in rs], len(rs[0]["audio_times_s"]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--only", choices=("mel", "sharded"))
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.only in (None, "mel"):
        mel_fixture()
    if args.only in (None, "sharded"):
        sharded_fixture(args.pairs)


if __name__ == "__main__":
    main()
