#!/usr/bin/env python
"""The PyTorch port's twin of __graft_entry__.py::dryrun_multichip: the
device side of the alignment on a (data x seq) mesh of devices, with
sequence-sharded features (parallel/seqshard.py) feeding data-parallel
matching (parallel/batch.py).

    python scripts/torch_dryrun_multichip.py cuda:0 cuda:0 cuda:0 cuda:0
    python scripts/torch_dryrun_multichip.py cpu cpu
    python scripts/torch_dryrun_multichip.py          # every CUDA device

For n devices the mesh is the JAX dryrun's: seq = 2 when n is even and at
least 4, else 1; data = n // seq; row r holds devices[r * seq:(r + 1) *
seq]. One 16-s pair per row (the port's build_pair, seed = row), both
tracks cut to a multiple of 210 x seq samples. Each track's PCM is
sequence-sharded over its row's devices, and its interior frames (all but
EDGE_FRAMES at either end, where the zero-padded edges smear) must be
bit-equal to the unsharded extract_features on the row's first device.
Then parallel/batch.sharded_match runs device_align_step for pair r on
row r's first device, every pair dispatched before any result is read.
On CUDA devices this launches pcm_frontend and polyphase_blur (one each
per shard and per unsharded extraction), fine_match, dp_forward and
dp_backtrace.

Prints the JAX dryrun's line, `dryrun_multichip OK: mesh(data=..,
seq=..), quals (..), N candidates`; exits non-zero on a mismatch. Imports
only the port, torch and numpy.
"""
import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SECONDS = 16.0
EDGE_FRAMES = 8


def mesh_shape(n_devices):
    """(data, seq) of the JAX dryrun's mesh for n devices."""
    seq = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    return n_devices // seq, seq


def _cut(pcm, s):
    """pcm (C, S') zero-padded or cut to s samples, as float32."""
    out = np.zeros((pcm.shape[0], s), np.float32)
    k = min(s, pcm.shape[1])
    out[:, :k] = pcm[:, :k]
    return out


def dryrun(devices, seconds=SECONDS):
    """Run the dryrun on a list of devices; returns a dict with the mesh
    shape, the stacked quals (on the CPU), the candidate count and, per
    row and track, whether the interior frames were bit-equal."""
    from describealign_tpu_torch.ops.features import extract_features
    from describealign_tpu_torch.parallel.batch import sharded_match
    from describealign_tpu_torch.parallel.seqshard import \
        sequence_sharded_features
    from describealign_tpu_torch.utils.synthmedia import build_pair

    devices = [torch.device(d) for d in devices]
    data, seq = mesh_shape(len(devices))
    rows = [devices[r * seq:(r + 1) * seq] for r in range(data)]
    s = int(seconds * 44100) // (210 * seq) * (210 * seq)
    n = s // 210
    inner = slice(EDGE_FRAMES, n - EDGE_FRAMES)
    feats = {"video": [], "audio": []}
    interior = {}
    for r, row in enumerate(rows):
        video, audio, _ = build_pair(content_seconds=seconds - 3.0,
                                     narration=(), lead_in=2.0, seed=r)
        for label, pcm in (("video", video), ("audio", audio)):
            pcm = _cut(pcm, s)
            sharded = sequence_sharded_features(pcm, row)
            whole = torch.stack([f[:n] for f in extract_features(
                pcm, device=row[0])])
            interior[(r, label)] = bool(torch.equal(sharded[:, inner],
                                                    whole[:, inner]))
            feats[label].append(sharded)
    outs = sharded_match([row[0] for row in rows], feats["audio"],
                         [n] * data, feats["video"], [n] * data)
    quals = torch.stack([o[0].cpu() for o in outs])
    return {"data": data, "seq": seq, "quals": quals,
            "candidates": int((quals > 0).sum()), "interior": interior}


def summary(result):
    """The JAX dryrun's line for a result of dryrun()."""
    return (f"dryrun_multichip OK: mesh(data={result['data']}, "
            f"seq={result['seq']}), quals {tuple(result['quals'].shape)}, "
            f"{result['candidates']} candidates")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("devices", nargs="*",
                        help="torch devices of the mesh, in order (default: "
                             "every CUDA device)")
    args = parser.parse_args()
    devices = args.devices or [f"cuda:{i}"
                               for i in range(torch.cuda.device_count())]
    if not devices:
        raise SystemExit("torch_dryrun_multichip: no CUDA device; name the "
                         "devices, e.g. `cpu cpu`")
    result = dryrun(devices)
    bad = [k for k, ok in result["interior"].items() if not ok]
    if bad:
        raise SystemExit(f"torch_dryrun_multichip: sharded interior frames "
                         f"differ from the unsharded extractor (row, track) "
                         f"{bad}")
    print(summary(result))


if __name__ == "__main__":
    main()
