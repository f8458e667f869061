#!/usr/bin/env python
"""The output side's kernels (csrc/pv_lock.cu `pv_phase_lock`, csrc/fit_admm.cu
`fused_lasso_admm`) on one card at the main path's shapes, against their
plain versions and, with --baseline, against another checkout of the repo.

    python scripts/torch_output_kernels.py [--baseline TREE] [--ptxas]
        [--feed] [--quick] [--json OUT.json]

pv_phase_lock runs on a stereo spectrum made on the card from a seed
(complex Gaussian bins, 513 per frame, rate 1/0.97 as the rate pair's) at
the device PV's block of 8,192 frames and at the rate pair's whole
227,390-frame segment in one call; fused_lasso_admm on fit problems of
5,761 and 13,653 nodes (the bench pair's and the film's fits: n_pad 8,192
and 16,384) made from a seed through alignment/fit_device._prep_problem.
The script checks each kernel bit-equal to its plain version (the PV's
output and carry on the block, and the block in two launches with the
carry equal to one; the ADMM's t, z and z's sign bits), then times the
wrapper calls and each PV pass alone (pv_kernel.pass_ms) with CUDA
events, beside the bounds: the bytes at 3.35 TB/s (the function's
least and, for the PV, the three passes as built) and the sequential
floors (an empty walk of the same shape; the ADMM's CTA barriers and warp
steps, each on an empty CTA or warp). A baseline is a directory holding
another checkout (`git archive REV | tar -x -C TREE`): its `ops` package
is imported as `baseline_ops`, builds its kernels into TREE/build, is
checked equal to this tree's on the same inputs and timed in the order
baseline, kernel, kernel, baseline. --ptxas prints ptxas's registers,
shared memory and spills of both sources (and the baseline's). --feed
builds and runs scripts/torch_smem_feed.cu: how fast one SM streams
device memory into shared memory by bulk copies and by warps' cp.async
(the walk's ring feed). --quick skips the plain versions at full size.
--json writes the numbers to a file. Needs a CUDA device and nvcc.
"""
import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from describealign_tpu_torch.alignment import fit_device  # noqa: E402
from describealign_tpu_torch.ops import _build  # noqa: E402
from describealign_tpu_torch.ops import fit_kernel as fk  # noqa: E402
from describealign_tpu_torch.ops import pv_kernel as pk  # noqa: E402

HBM_BYTES_S = 3.35e12
BLOCK, SEGMENT = 8192, 227390          # frames: the device PV's block, the
                                       # rate pair's stretched segment
FIT_NODES = (5761, 13653)              # the bench pair's and the film's fits


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


def ptxas(path, tag):
    """ptxas -v lines of a source."""
    cubin = os.path.join(_build.BUILD_DIR, f"{tag}.cubin")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
         '-std=c++17', '-O3', '-cubin', '-Xptxas', '-v', '-o', cubin, path],
        capture_output=True, text=True, check=True)
    return [ln.strip() for ln in proc.stderr.splitlines()
            if 'registers' in ln or 'spill' in ln or 'Compiling' in ln
            or 'stack' in ln]


def baseline_ops(tree):
    """ops/pv_kernel and ops/fit_kernel of another checkout, imported as
    baseline_ops.* (ops' modules import each other relatively)."""
    path = os.path.join(os.path.abspath(tree), "describealign_tpu_torch",
                        "ops")
    spec = importlib.util.spec_from_file_location(
        "baseline_ops", os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_ops"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("baseline_ops.pv_kernel"),
            importlib.import_module("baseline_ops.fit_kernel"))


def same(got, want, what):
    """Raise, with the size of the difference, unless got is want bit for
    bit (and sign for sign)."""
    if torch.equal(got, want) and torch.equal(torch.signbit(torch.view_as_real(
            got) if got.is_complex() else got), torch.signbit(
            torch.view_as_real(want) if want.is_complex() else want)):
        return
    diff = (got != want)
    raise AssertionError(f"{what}: {int(diff.sum())} of {diff.numel()} "
                         f"differ, max |diff| "
                         f"{float((got - want).abs().max())}")


def pv_inputs(f, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (2, f, pk.BINS)
    spec = torch.complex(torch.randn(shape, generator=g, device="cuda"),
                         torch.randn(shape, generator=g, device="cuda"))
    omega = torch.from_numpy((2 * np.pi * np.arange(pk.BINS) * 256 / 1024)
                             .astype(np.float32)).cuda()
    return spec, omega, float(np.float32(1 / 0.97))


def pv_section(args, base_pk, smi, report):
    rows = {}
    for label, f in (("block", BLOCK), ("segment", SEGMENT)):
        spec, omega, rate = pv_inputs(f, 1)
        row = {"frames": f}
        ref, ref_carry = pk.pv_phase_lock(spec, omega, rate)
        if label == "block":
            if not args.quick:
                want, carry_w = pk.pv_phase_lock_plain(spec, omega, rate)
                same(ref, want, "kernel vs plain")
                same(ref_carry, carry_w, "kernel vs plain, carry")
            h = f // 2
            a, ca = pk.pv_phase_lock(spec[:, :h].contiguous(), omega, rate)
            b, cb = pk.pv_phase_lock(spec[:, h:].contiguous(), omega, rate,
                                     ca)
            same(torch.cat([a, b], 1), ref, "two blocks with the carry")
            same(cb, ref_carry, "two blocks with the carry, carry")
        if base_pk is not None:
            got, carry = base_pk.pv_phase_lock(spec, omega, rate)
            same(got, ref, "parent")
            same(carry, ref_carry, "parent, carry")
        reps = 10 if label == "block" else 2
        order = (["baseline"] if base_pk else []) + ["kernel"]
        for who in order + order[::-1]:
            mod = base_pk if who == "baseline" else pk
            fn = (lambda m=mod: m.pv_phase_lock(spec, omega, rate))
            row.setdefault(f"{who}_ms", []).append(cuda_ms(fn, reps))
            if who == "kernel":
                row.setdefault("passes_ms", []).append(
                    pk.pass_ms(spec, omega, rate, reps=reps))
        row["floor_ms"] = pk.empty_steps_ms(f, 2)
        row["pass_bytes"] = pk.pv_pass_bytes(2, f)
        nbytes, flops = pk.pv_lock_work(2, f)
        row["bound_ms"] = max(nbytes / HBM_BYTES_S, flops / 67e12) * 1e3
        rows[label] = row
        built = sum(row["pass_bytes"].values()) / HBM_BYTES_S * 1e3
        print(f"[pv {label}] {f} stereo frames, walk on {pk.WALK_WARPS} "
              f"warps: {row['kernel_ms']} ms; each pass alone "
              + ", ".join(f"{k} {[round(d[k], 4) for d in row['passes_ms']]}"
                          for k in pk.PASSES)
              + f" ms | bounds: the function's bytes {row['bound_ms']:.4f}"
              f" ms, the passes as built {built:.4f} ms ("
              + ", ".join(f"{k} {v / HBM_BYTES_S * 1e3:.4f}"
                          for k, v in row["pass_bytes"].items())
              + f"), an empty walk {row['floor_ms']:.4f} ms "
              f"({row['floor_ms'] / f * 1e6:.1f} ns per frame) ({smi})",
              flush=True)
        if base_pk:
            print(f"[pv {label} baseline] parent {row['baseline_ms']} ms; "
                  f"equal outputs and carries ({smi})", flush=True)
        del spec, ref
        torch.cuda.empty_cache()
    report["pv"] = rows


def fit_problem(nodes, seed):
    """A fit problem of `nodes` compressed nodes: slopes near 1 with a few
    steps, costs and kappa as the stage-1 fit makes them."""
    rng = np.random.default_rng(seed)
    b = 1.0 + 0.002 * rng.standard_normal(nodes)
    b[nodes // 3:] += 0.03
    b[2 * nodes // 3:] -= 0.05
    data_cost = rng.uniform(0.5, 2.0, nodes)
    kappa = np.full(nodes - 1, 4e4)
    n_pad = fit_device.bucket(nodes)
    prep = fit_device._prep_problem(b, data_cost, kappa, n_pad)
    return n_pad, [torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float64)[None] if np.ndim(a) else [a],
        np.float32)).cuda() for a in prep]


def fit_section(args, base_fk, smi, report):
    rows = {}
    warp_us = fk.empty_warp_steps_ms(100000) / 100000 * 1e3
    for nodes in FIT_NODES:
        n_pad, prob = fit_problem(nodes, nodes)
        t, z = fk.fused_lasso_admm(*prob)
        if not args.quick:
            tp, zp = fk.fused_lasso_admm_plain(*prob)
            same(t, tp, f"ADMM t vs plain, n_pad {n_pad}")
            same(z, zp, f"ADMM z vs plain, n_pad {n_pad}")
        if base_fk is not None:
            tb, zb = base_fk.fused_lasso_admm(*prob)
            same(t, tb, f"ADMM t vs parent, n_pad {n_pad}")
            same(z, zb, f"ADMM z vs parent, n_pad {n_pad}")
        row = {"nodes": nodes, "n_pad": n_pad,
               "shared": sorted(set(fk.shared_slots(n_pad)))}
        order = (["baseline"] if base_fk else []) + ["kernel"]
        for who in order + order[::-1]:
            mod = base_fk if who == "baseline" else fk
            fn = (lambda m=mod: m.fused_lasso_admm(*prob))
            row.setdefault(f"{who}_ms", []).append(cuda_ms(fn, 5))
        barriers, warp_steps = fk.steps_per_solve(n_pad)
        cta_ms = fk.empty_steps_ms(barriers, n_pad)
        row.update(barriers=barriers, warp_steps=warp_steps,
                   cta_floor_ms=cta_ms, warp_step_us=warp_us,
                   floor_ms=cta_ms + warp_steps * warp_us / 1e3,
                   parent_floor_ms=fk.empty_steps_ms(
                       800 * (2 * fk.levels_of(n_pad) + 3), n_pad))
        nbytes, flops = fk.fit_admm_work(n_pad)
        row.update(bytes_ms=nbytes / HBM_BYTES_S * 1e3,
                   ops_ms=flops / 67e12 * 1e3)
        rows[str(n_pad)] = row
        print(f"[fit n_pad {n_pad}] {nodes} nodes, in shared memory "
              f"{row['shared']}: kernel {row['kernel_ms']} ms"
              + (f" | parent {row['baseline_ms']} ms; equal t, z and signs"
                 if base_fk else "")
              + f" | floor: {barriers} CTA barriers {cta_ms:.3f} ms + "
              f"{warp_steps} warp steps x {warp_us:.4f} us = "
              f"{row['floor_ms']:.3f} ms (the parent's "
              f"{800 * (2 * fk.levels_of(n_pad) + 3)} barriers "
              f"{row['parent_floor_ms']:.3f} ms) | bounds bytes "
              f"{row['bytes_ms']:.5f} ms, fp32 {row['ops_ms']:.4f} ms "
              f"({smi})", flush=True)
    report["fit"] = rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="another checkout of the repo")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--feed", action="store_true",
                    help="run scripts/torch_smem_feed.cu first")
    ap.add_argument("--json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_output_kernels: needs a CUDA device")
    smi = card_line()
    print(f"[card] {smi} | torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    report = {"card": smi}
    if args.ptxas:
        trees = [("kernel", REPO)] + ([("baseline", args.baseline)]
                                      if args.baseline else [])
        for tag, tree in trees:
            for src in ("pv_lock.cu", "fit_admm.cu"):
                path = os.path.join(tree, "describealign_tpu_torch", "csrc",
                                    src)
                for ln in ptxas(path, f"{tag}_{src[:-3]}"):
                    print(f"[ptxas {tag} {src}] {ln}", flush=True)
    if args.feed:
        exe = os.path.join(_build.BUILD_DIR, "torch_smem_feed")
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build._nvcc(), '-gencode',
                        'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                        '-o', exe, os.path.join(REPO, "scripts",
                                                "torch_smem_feed.cu")],
                       check=True)
        feed = subprocess.run([exe], capture_output=True, text=True,
                              check=True).stdout
        print(feed.rstrip().replace("\n", f" ({smi})\n") + f" ({smi})",
              flush=True)
        report["feed"] = feed
    base_pk, base_fk = (baseline_ops(args.baseline) if args.baseline
                        else (None, None))
    lib = fk.load_library()
    for n in (16, 1024, 4096, 8192, 16384, 32768, 65536):
        assert lib.fit_admm_shared_slots(n) == len(fk.shared_slots(n)), n
    pv_section(args, base_pk, smi, report)
    fit_section(args, base_fk, smi, report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print("[done] bit-equal throughout", flush=True)


if __name__ == "__main__":
    main()
