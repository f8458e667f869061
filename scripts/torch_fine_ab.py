#!/usr/bin/env python
"""A/B of the fine-match CUDA kernel against another version of its source,
on the bench pair's first full 256-block chunk, both tracks, on one card.

    python scripts/torch_fine_ab.py --baseline OTHER/fine_match.cu \
        [--baseline ANOTHER.cu ...] [--ptxas]

Each baseline is any source with the same C entry point
(fine_match_launch), e.g. an earlier commit's, written out with
`git show REV:describealign_tpu_torch/csrc/fine_match.cu`, or a variant of
the kernel. All are built with the port's nvcc flags. For each baseline
the script checks that it and the kernel give the same candidate sets
(keyed by block, frame and video frame) and both against the plain
version, then times them with CUDA events in the order baseline, kernel,
kernel, baseline, and prints each time beside the kernel's bound
(fine_kernel.fine_match_work; 3xTF32 at 495 TFLOP/s, fp32 FFMA at 67
TFLOP/s, device memory at 3.35 TB/s). --ptxas prints ptxas's registers,
shared memory and spills for every source. Needs a CUDA device and nvcc.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from describealign_tpu_torch.alignment import api, matching  # noqa: E402
from describealign_tpu_torch.bench_pair import build_scale_pair  # noqa: E402
from describealign_tpu_torch.ops import _build, fine_kernel  # noqa: E402

TF32_FLOPS, FP32_FLOPS, HBM_BYTES_S = 495e12, 67e12, 3.35e12


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
            if 'registers' in ln or 'spill' in ln or 'smem' in ln]


def baseline_launcher(path, i):
    lib = _build.load_library(f'fine_match_baseline{i}',
                              [os.path.abspath(path)])
    lib.fine_match_launch.restype = ctypes.c_int
    lib.fine_match_launch.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
           ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p])

    def launch(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, v_starts,
               a_starts):
        c = v_starts.shape[0]
        dev = ms_a.device
        quals = torch.empty((c, 210, 8), dtype=torch.float32, device=dev)
        offs = torch.empty((c, 210, 8), dtype=torch.int32, device=dev)
        rc = lib.fine_match_launch(
            ms_a.data_ptr(), norms_a.data_ptr(), a_mask.data_ptr(),
            ms_v.data_ptr(), norms_v.data_ptr(), v_mask.data_ptr(),
            v_starts.data_ptr(), a_starts.data_ptr(), ms_a.shape[1], c,
            fine_kernel.LOG_CUT, fine_kernel.EXP_COEF, quals.data_ptr(),
            offs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {rc}")
        return quals, offs
    return launch


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


def candidates(q, o, v_starts):
    q = q.cpu().numpy()
    v = (v_starts[:, None, None] + o).cpu().numpy()
    b, l, k = np.nonzero(q > 0)
    return dict(zip(zip(b.tolist(), l.tolist(), v[b, l, k].tolist()),
                    q[b, l, k].tolist()))


def compare(got, want):
    """(equal key sets, number of differing keys, max abs quality error)."""
    same = set(got) == set(want)
    common = set(got) & set(want)
    err = max((abs(got[k] - want[k]) for k in common), default=0.0)
    return same, len(set(got) ^ set(want)), err


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--baseline', required=True, action='append')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--ptxas', action='store_true')
    ap.add_argument('--all-chunks', action='store_true',
                    help='also hold the kernel and every baseline against '
                         'the plain version on every chunk of both tracks')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fine_ab: needs a CUDA device")
    smi = card_line()
    print(smi, flush=True)
    if args.ptxas:
        for label, path in ([('kernel', os.path.join(_build.CSRC,
                                                     'fine_match.cu'))]
                            + [(b, b) for b in args.baseline]):
            for line in ptxas_report(path):
                print(f"[ptxas {label}] {line}", flush=True)

    device = torch.device('cuda')
    baselines = [baseline_launcher(b, i) for i, b in enumerate(args.baseline)]
    v, a = build_scale_pair(os.path.join(REPO, 'build', 'bench_pair_i16.npz'))
    npad = max(api._bucket_pad(v.shape[1] // 210),
               api._bucket_pad(a.shape[1] // 210))
    fv, nv = api.host_features_padded(v, v.shape[1], npad)
    fa, na = api.host_features_padded(a, a.shape[1], npad)
    ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts, _ = \
        matching.match_coarse(api._upload(fa, device), na,
                              api._upload(fv, device), nv)
    a_starts = (torch.arange(matching.FINE_CHUNK, dtype=torch.int32,
                             device=device) * matching.BLOCK)
    result = {"card": smi, "tracks": []}
    for track in range(starts.shape[0]):
        v_starts = starts[track, :matching.FINE_CHUNK].contiguous()
        call = (ms_a, norms_a, a_mask.float(), ms_v, norms_v,
                v_mask.float(), v_starts, a_starts)
        kernel = candidates(*fine_kernel.fine_match(*call), v_starts)
        plain = candidates(*fine_kernel.fine_match_plain(*call), v_starts)
        fma, nbytes = fine_kernel.fine_match_work(call[2], call[5],
                                                  v_starts, a_starts)
        bound = {'3xtf32_ms': 6 * fma / TF32_FLOPS * 1e3,
                 'fp32_ms': 2 * fma / FP32_FLOPS * 1e3,
                 'bytes_ms': nbytes / HBM_BYTES_S * 1e3}
        row = {'track': track, 'candidates': len(kernel),
               'useful_fma': fma, 'bytes': nbytes, 'bound': bound,
               'kernel vs plain': compare(kernel, plain), 'baselines': []}
        print(f"[ab] track {track}: {len(kernel)} candidates, useful {fma} "
              f"FMA, bound 3xTF32 {bound['3xtf32_ms']:.4f} ms, fp32 "
              f"{bound['fp32_ms']:.4f} ms, bytes {bound['bytes_ms']:.4f} ms;"
              f" kernel vs plain {row['kernel vs plain']}", flush=True)
        for path, baseline in zip(args.baseline, baselines):
            base = candidates(*baseline(*call), v_starts)
            times = {'baseline': [], 'kernel': []}
            for who in ('baseline', 'kernel', 'kernel', 'baseline'):
                fn = baseline if who == 'baseline' else fine_kernel.fine_match
                times[who].append(cuda_ms(lambda: fn(*call), args.reps))
            k_ms, b_ms = np.mean(times['kernel']), np.mean(times['baseline'])
            differ = sorted(set(kernel) ^ set(base))[:3]
            entry = {'baseline': path,
                     'kernel vs baseline': compare(kernel, base),
                     'baseline vs plain': compare(base, plain),
                     'differing': [(k, kernel.get(k), base.get(k),
                                    plain.get(k)) for k in differ],
                     'kernel_ms': times['kernel'],
                     'baseline_ms': times['baseline'],
                     'speedup': b_ms / k_ms,
                     'kernel_share_of_3xtf32_bound':
                         bound['3xtf32_ms'] / k_ms}
            row['baselines'].append(entry)
            print(f"[ab] track {track} vs {path}: kernel vs baseline "
                  f"{entry['kernel vs baseline']}, baseline vs plain "
                  f"{entry['baseline vs plain']} (equal sets, keys differing,"
                  f" max abs err); first differing (key, kernel, baseline, "
                  f"plain) {entry['differing']} | baseline "
                  f"{times['baseline']} ms, kernel {times['kernel']} ms, "
                  f"speedup {b_ms / k_ms:.2f}x; kernel at "
                  f"{bound['3xtf32_ms'] / k_ms:.1%} of the 3xTF32 bound "
                  f"({smi})", flush=True)
        result['tracks'].append(row)
    if args.all_chunks:
        result['all_chunks'] = check_all_chunks(
            (ms_a, norms_a, a_mask.float(), ms_v, norms_v, v_mask.float()),
            starts, dict(zip(args.baseline, baselines)))
    print(json.dumps(result))


def check_all_chunks(tensors, starts, baselines):
    """Every chunk of every track: the kernel and each baseline against
    the plain version; prints the keys only one side keeps, with their
    qualities."""
    device = starts.device
    out = []
    for b0 in range(0, starts.shape[1], matching.FINE_CHUNK):
        a_starts = ((b0 + torch.arange(matching.FINE_CHUNK, dtype=torch.int32,
                                       device=device)) * matching.BLOCK)
        for track in range(starts.shape[0]):
            v_starts = starts[track, b0:b0 + matching.FINE_CHUNK].contiguous()
            call = tensors + (v_starts, a_starts)
            plain = candidates(*fine_kernel.fine_match_plain(*call), v_starts)
            for name, fn in [('kernel', fine_kernel.fine_match)] + list(
                    baselines.items()):
                got = candidates(*fn(*call), v_starts)
                same, n, err = compare(got, plain)
                only = sorted(set(got) ^ set(plain))
                flips = [(k, got.get(k), plain.get(k)) for k in only]
                out.append({'b0': b0, 'track': track, 'source': name,
                            'equal_sets': same, 'keys_differing': n,
                            'max_abs_err': err, 'flips': flips})
                print(f"[chunks] b0={b0} track {track} {name} vs plain: "
                      f"{len(plain)} candidates, equal {same}, max abs err "
                      f"{err:.3g}, differing (key, {name}, plain) {flips}",
                      flush=True)
    return out


if __name__ == '__main__':
    main()
