#!/usr/bin/env python3
"""The readings the limits of the comparison that decides `correct` are
set from: the program's sound runs and the control, on a cell's own
inputs at its own size.

For each seed, the first request of that seed's window (one pair, or the
batch of 8) goes through the program's timed entry once, and every pair
of it is judged as a run judges its sample: missed_pct, the share of
probes whose map lies beyond the tolerance from the true map; map_gap
and margin_gap, the gaps of the program's score-map rows and coarse
margin from the plain fp32 reference's; and at the PCM level
feature_gap, the gap of the program's feature streams from the plain
fp32 cascade's. For the first --control-seeds seeds the controls are read
too, each put in the program's place: the reference's score map in TF32
and its cascade in bfloat16, the precisions below the configuration's
fp32 (map_gap, margin_gap, feature_gap), and the true map with the
description CONTROL_LATE_FRAMES
frames (14.3 ms) late, just past the configuration's 10-ms guarantee
(missed_pct). Each limit lies between the sound runs' largest reading
and the controls' smallest (PERF.md).

    python3 benchmark/control.py --workload episode-single \\
        --seeds 11 12 13 --control-seeds 3

prints one JSON line per seed and a summary line. On a card it uses the
cell's cards, as the run does; the benchmark's own runs never run it.
"""
import argparse
import contextlib
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "triton_cache"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, ROOT)

CONTROL_LATE_FRAMES = 3
FPS = 210


def readings(cell, seed, devices, call, control):
    """The program's and (control=True) the controls' readings of one
    seed's first request."""
    from harness import core, gen
    requests = gen.Requests(cell.config, cell.traffic, seed, devices[0])
    req = requests.next()
    with open(os.devnull, "w") as quiet, \
            contextlib.redirect_stdout(quiet), core.Probes() as probes:
        answers = list(call(req))
    state = probes.take(req)
    tol = cell.config["guarantees"]["tolerance_ms"]
    maps = [cell.reference.judge(a[0], a[1], p.segments, tol)
            for p, a in zip(req, answers)]
    samples = [(p, None if m is None else float(m), rows, f)
               for p, (m, rows, f) in zip(req, state)]
    out = {"seed": seed, "pairs": len(req),
           "missed_pct": max(m[0] for m in maps),
           "widest_gap_ms": max(m[1] for m in maps),
           "margins": [s[1] for s in samples],
           "gaps": cell.margin_reference.compare(samples, cell.config,
                                                 devices[0], margins=True)}
    if control:
        out["control_gaps"] = cell.margin_reference.compare(
            samples, cell.config, devices[0], control=True, margins=True)
        late = [cell.reference.control_nodes(p.segments,
                                              CONTROL_LATE_FRAMES / FPS)
                for p in req]
        out["control_missed_pct"] = min(
            cell.reference.judge(nx, ny, p.segments, tol)[0]
            for p, (nx, ny) in zip(req, late))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="read the control on the first this many seeds")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose BENCHMARK.json names the cell")
    args = ap.parse_args(argv)
    import torch
    from harness import core, gen
    cell = core.Cell(args.root, args.workload)
    if torch.cuda.is_available():
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    else:
        devices = [torch.device("cpu")] * cell.chips
    call = core.program_call(cell, devices)
    warm = gen.Requests(cell.config, cell.traffic, args.seeds[0], devices[0])
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        call(warm.warm_up())
    del warm
    g = cell.config["guarantees"]
    names = ("map_gap", "margin_gap", "feature_gap")
    sound = {k: [] for k in names}
    ctrl = {k: [] for k in names}
    missed, ctrl_missed = [], []
    for i, seed in enumerate(args.seeds):
        r = readings(cell, seed, devices, call, i < args.control_seeds)
        r.update(workload=args.workload, device=str(devices[0]))
        for k in names:
            sound[k] += r["gaps"].get(k, [])
            ctrl[k] += r.get("control_gaps", {}).get(k, [])
        missed.append(r["missed_pct"])
        if "control_missed_pct" in r:
            ctrl_missed.append(r["control_missed_pct"])
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "summary": True,
               "seeds": len(args.seeds),
               "control_seeds": min(args.control_seeds, len(args.seeds)),
               "missed_pct_max": max(missed),
               "control_missed_pct_min": min(ctrl_missed, default=None),
               "missed_pct_limit": g["missed_pct_limit"]}
    for k in names:
        if sound[k]:
            summary.update({k + "_max": max(sound[k]),
                            "control_" + k + "_min": min(ctrl[k],
                                                         default=None),
                            k + "_limit": g.get(k + "_limit")})
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
