#!/usr/bin/env python
"""The device-feature kernels (csrc/features_dev.cu: K1 pcm_frontend, K2
the grouped polyphase_blur) on one card at the bench pair's padded
lengths (73,382,400 and 59,270,400 mono int16 samples), against their
plain versions and, with --variant, against other versions of the source
with the same C interface, or with --baseline against another checkout
of the repo.

    python scripts/torch_feature_kernels.py [--baseline TREE]
        [--variant OTHER.cu ...] [--ptxas] [--quick] [--reps N]
        [--json OUT.json]

The PCM is made on the card from a seed (int16 noise with silent gaps);
K1's outputs feed K2. The script checks that every output of the kernel
(and of each variant) is bit-equal to the plain version (the energy
within rtol 1e-6), then times per stream K1, the cascade (one launch)
and the six one-stage launches with CUDA events (the wrappers' calls,
host issue included), and K1 and the cascade's device time with
torch.profiler, for the kernel and every variant (in the order kernel,
variants, kernel). A baseline is a directory holding another checkout
(`git archive REV | tar -x -C TREE`): its `ops` package is imported as
`baseline_ops`, builds its kernels into TREE/build, and its
`features._streams` (the five streams off one PCM stream, whatever its
kernels' interface) is checked bit-equal to this tree's and timed in the
order baseline, kernel, kernel, baseline, by CUDA events and by device
time per kernel name. Each time is printed beside the bytes bound
(features_kernel.feature_work at 3.35 TB/s) with the achieved GB/s.
--ptxas prints ptxas's registers, shared memory and spills and, from
cuobjdump -sass, each kernel's count of global loads (LDG), asynchronous
copies (LDGSTS), shared loads and stores, and barriers. --quick: one
2-minute stream instead of the bench lengths. --json writes the numbers
to a file. Needs a CUDA device and nvcc.
"""
import argparse
import collections
import ctypes
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from describealign_tpu_torch.ops import _build  # noqa: E402
from describealign_tpu_torch.ops import features as tf  # noqa: E402
from describealign_tpu_torch.ops import features_kernel as fk  # noqa: E402

HBM_BYTES_S = 3.35e12
BENCH = (("audio", 73382400), ("video", 59270400))
SASS_OPS = ("LDG", "LDGSTS", "LDS", "STS", "BAR", "FADD", "FMUL", "STG")


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


def ptxas_and_sass(path, tag):
    """ptxas -v lines and per-kernel SASS instruction counts of a source."""
    cubin = os.path.join(_build.BUILD_DIR, f"{tag}.cubin")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
         '-std=c++17', '-O3', '-cubin', '-Xptxas', '-v', '-o', cubin, path],
        capture_output=True, text=True, check=True)
    lines = [ln.strip() for ln in proc.stderr.splitlines()
             if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', cubin], capture_output=True,
                          text=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r'Function : (\S+)', ln)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.search(r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)',
                      ln)
        if fn and m:
            counts[fn][m.group(1)] += 1
    return lines, {f: {op: c[op] for op in SASS_OPS} for f, c in counts.items()}


def stages(energy, crossings, bottom1, band1, bottom2):
    return [("energy smoothing", (energy, 1, 13), dict(epilogue="energy")),
            ("crossings smoothing", (crossings, 1, 13), {}),
            ("band 1", (band1, 42, 15), dict(epilogue="band")),
            ("bottom 2", (bottom1, 7, 3), {}),
            ("band 2", (bottom1, 6, 15), dict(r=7, bottom=bottom2,
                                                epilogue="band")),
            ("band 3", (bottom2, 1, 15), dict(r=6, epilogue="band"))]


def device_ms(fn, reps):
    """{kernel name: mean device ms per call of fn} from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        tags = [k for k in ("pcm_frontend", "polyphase_group",
                            "polyphase_blur") if k in e.key]
        if t > 0 and tags:
            out[tags[0]] += t / reps / 1e3
    return dict(out)


def baseline_features(tree):
    """ops/features of another checkout, imported as baseline_ops.features
    (ops' modules import each other relatively and nothing above ops)."""
    path = os.path.join(os.path.abspath(tree), "describealign_tpu_torch",
                        "ops")
    spec = importlib.util.spec_from_file_location(
        "baseline_ops", os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_ops"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("baseline_ops.features")


def make_pcm(s, seed):
    """(1, s) int16 on the card: noise at three levels with silent gaps."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(s, generator=g, device="cuda") * 3000
    gate = (torch.arange(s, device="cuda") // 44100 % 5 != 4).float()
    return (x * gate).clamp(-32768, 32767).to(torch.int16)[None]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="another checkout of the repo")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json")
    ap.add_argument("--variant", action="append", default=[],
                    help="another source with this one's C interface, "
                    "checked and timed beside it (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_feature_kernels: needs a CUDA device")
    smi = card_line()
    print(f"[card] {smi} | torch {torch.__version__} CUDA {torch.version.cuda}"
          f" | ncu {'at ' + shutil.which('ncu') if shutil.which('ncu') else 'not installed'}",
          flush=True)
    report = {"card": smi}
    src = os.path.join(_build.CSRC, "features_dev.cu")
    if args.ptxas:
        base_src = [("baseline", os.path.join(
            args.baseline, "describealign_tpu_torch", "csrc",
            "features_dev.cu"))] if args.baseline else []
        for tag, path in [("kernel", src)] + base_src + [
                (f"variant{i}", v) for i, v in enumerate(args.variant)]:
            lines, sass = ptxas_and_sass(path, f"features_{tag}")
            for ln in lines:
                print(f"[ptxas {tag}] {ln}", flush=True)
            for f, c in sass.items():
                print(f"[sass {tag}] {f}: {c}", flush=True)
            report[f"sass_{tag}"] = sass
    base = baseline_features(args.baseline) if args.baseline else None
    main_lib = fk.load_library()
    variants = [(path, fk.bind(ctypes.CDLL(_build._build(
        f'features_dev_variant{i}', [os.path.abspath(path)],
        [_build._nvcc()] + _build.NVCC_FLAGS))))
        for i, path in enumerate(args.variant)]
    slots, per_sm = fk.frontend_config(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[K1 config] mono int16: {slots} ring slots of {3376 * 2} B, "
          f"{per_sm} CTAs of 224 threads per SM, grid {sms * per_sm} on "
          f"{sms} SMs", flush=True)
    report["k1_config"] = dict(slots=slots, per_sm=per_sm, sms=sms)
    streams = [("quick", 44100 * 120)] if args.quick else BENCH
    rows = []
    for k, (label, s) in enumerate(streams):
        pcm = make_pcm(s, k)
        got = tf.pcm_frontend(pcm)
        want = tf.pcm_frontend_plain(pcm.half().float())
        e_rel = float(((got[0] - want[0]).abs()
                       / want[0].abs().clamp(min=1e-30)).max())
        assert e_rel <= 1e-6 and all(torch.equal(g, w) for g, w in
                                     zip(got[1:], want[1:])), label
        plain = tf.polyphase_cascade_plain(*got)
        assert all(torch.equal(g, w) for g, w in
                   zip(tf.polyphase_cascade(*got), plain)), label
        st = stages(*got, tf.polyphase_blur_plain(got[2], 7, 3))
        for name, a, kw in st:
            assert torch.equal(tf.polyphase_blur(*a, **kw),
                               tf.polyphase_blur_plain(*a, **kw)), name

        def device_times():
            return {"k1": sum(device_ms(lambda: tf.pcm_frontend(pcm),
                                        args.reps).values()),
                    "k2": sum(device_ms(lambda: tf.polyphase_cascade(*got),
                                        args.reps).values())}
        t = {"k1": cuda_ms(lambda: tf.pcm_frontend(pcm), args.reps),
             "k2": cuda_ms(lambda: tf.polyphase_cascade(*got), args.reps),
             "device": device_times(),
             "stages": [cuda_ms(lambda: tf.polyphase_blur(*a, **kw),
                                args.reps) for _, a, kw in st]}
        if base:
            old = base._streams(pcm)
            assert all(torch.equal(g, o) for g, o in
                       zip(tf._streams(pcm), old)), (label, "baseline")
            for who in ("baseline", "kernel", "kernel", "baseline"):
                fn = base._streams if who == "baseline" else tf._streams
                t.setdefault(f"{who}_streams", []).append(
                    cuda_ms(lambda: fn(pcm), args.reps))
                t.setdefault(f"{who}_device", []).append(
                    device_ms(lambda: fn(pcm), args.reps))
            print(f"[{label} baseline] K1 + K2 per stream between events: "
                  f"baseline {t['baseline_streams']} ms, kernel "
                  f"{t['kernel_streams']} ms | device: baseline "
                  f"{t['baseline_device']}, kernel {t['kernel_device']} "
                  f"({smi})", flush=True)
        if variants:
            t["variants"] = []
            for path, lib in [("kernel", main_lib)] + variants + [
                    ("kernel", main_lib)]:
                fk._lib = lib
                k1 = tf.pcm_frontend(pcm)
                assert all(torch.equal(g, w) for g, w in zip(k1, got)), path
                assert all(torch.equal(g, w) for g, w in zip(
                    tf.polyphase_cascade(*got), plain)), path
                t["variants"].append((path, device_times()))
                print(f"[{label} variant] {path}: device ms "
                      f"{t['variants'][-1][1]} ({smi})", flush=True)
            fk._lib = main_lib
        work = fk.feature_work(1, s)
        rows.append(dict(label=label, samples=s, work=work, **t))
        k1b = work["pcm_frontend"] / HBM_BYTES_S * 1e3
        k2b = work["polyphase_blur"] / HBM_BYTES_S * 1e3
        d1, d2 = t["device"]["k1"], t["device"]["k2"]
        print(f"[{label} {s} int16] K1 device {d1:.4f} ms "
              f"({work['pcm_frontend'] / d1 / 1e6:.0f} GB/s, bound "
              f"{k1b:.4f} ms, {k1b / d1:.1%}; the wrapper between events "
              f"{t['k1']:.4f} ms) | K2 cascade, one launch, device "
              f"{d2:.4f} ms ({work['polyphase_blur'] / d2 / 1e6:.0f} GB/s "
              f"of the function's bytes, bound {k2b:.4f} ms, {k2b / d2:.1%};"
              f" the wrapper between events {t['k2']:.4f} ms) | one-stage "
              f"launches " + ", ".join(f"{n} {m:.4f}" for (n, _, _), m in
                                       zip(st, t["stages"]))
              + f" ms ({smi})", flush=True)
        del pcm, got, want, plain
    report["rows"] = rows
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print("[done] bit-equal throughout", flush=True)


if __name__ == "__main__":
    main()
