"""One run of one cell: find its pieces by name, make the inputs, warm up,
measure a closed loop for the window, read the metrics, judge the answers.

Everything a cell is made of is found by the names in BENCHMARK.json:
  configs:   the entry's "file" (benchmark/configs/<name>.json)
  traffic:   benchmark/traffic/<name>.json
  metrics:   benchmark/metrics/<name>.py, a read(run) -> number or None
  references: benchmark/references/<config "reference">.py (the true
             map) and <config "margin_reference">.py (the coarse stage)
so a later change adds a configuration, a mix, a metric or a reference by
adding files and entries, and edits none.
"""
import contextlib
import functools
import importlib
import importlib.util
import inspect
import json
import os
import sys
import threading
import time

import numpy as np

from . import gen

FORBIDDEN = ("jax", "jaxlib", "flax", "describealign_tpu")


class CellError(Exception):
    """A cell that BENCHMARK.json and the files do not define."""


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic mix,
    metric entries (end_to_end and per_layer that apply to it) and
    reference, found by name under root/benchmark."""

    def __init__(self, root, name):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        entry = cells[name]
        self.name = name
        self.chips = int(entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        with open(os.path.join(root, configs[entry["config"]]["file"])) as f:
            self.config = json.load(f)
        bdir = os.path.join(root, "benchmark")
        with open(os.path.join(bdir, "traffic",
                               entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)

        def applies(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]
        self.metric_dir = os.path.join(bdir, "metrics")
        self.reference, self.margin_reference = (
            load_module(os.path.join(bdir, "references", ref + ".py"),
                        "bench_reference_" + ref)
            for ref in (self.config["reference"],
                        self.config["margin_reference"]))

    def reader(self, metric):
        path = os.path.join(self.metric_dir, metric["name"] + ".py")
        return load_module(path, "bench_metric_" +
                           metric["name"].replace(".", "_").replace("-", "_"))


class Run:
    """What the readers see: the window's requests and times, the traced
    window's trace and stage splits, and the device's readings."""

    def __init__(self, cell, seed, devices, device_name):
        self.cell = cell
        self.seed = seed
        self.devices = devices
        self.device_name = device_name
        self.setup_s = None
        self.window_s = None
        self.durations = []      # wall seconds of each request completed
        self.pairs_done = []     # the Pairs of each request answered
        self.timings = []        # the program's stage splits, per alignment
        self.trace = None
        self.peak_bytes = 0
        self.answers = []        # (Pair, (audio_times, video_times))
        self.widest_gap_ms = None
        self.sample = Sample(int(cell.traffic.get("check_sample", 3)), seed)
        self.gaps = None         # the sample's gaps (references' compare)
        self.failures = []       # (Pair, error text)


def program_call(cell, devices):
    """call(request, timings) -> one answer per pair of the request, each
    the program's return tuple. The program's entry is chosen by the
    configuration's level and the mix's mode, with the mix's entry_kwargs
    (such as {"features": "device"}); the mesh of the program's
    own make_mesh over the cell's cards is used where the mix asks for a
    mesh."""
    import describealign_tpu_torch as program
    kwargs = dict(cell.traffic.get("entry_kwargs", {}))
    level, mode = cell.config["level"], cell.traffic["mode"]
    dev = devices[0]
    if (level, mode) == ("pcm", "single"):
        def call(req, timings=None):
            p = req[0]
            return [program.align_from_pcm(p.video, p.audio, device=dev,
                                           timings=timings, **kwargs)]
    elif (level, mode) == ("features", "single"):
        def call(req, timings=None):
            p = req[0]
            return [program.align(p.video, p.audio, p.video[0], p.audio[0],
                                  device=dev, timings=timings, **kwargs)]
    elif (level, mode) == ("pcm", "batch"):
        if cell.traffic.get("mesh"):
            from describealign_tpu_torch.parallel.batch import make_mesh
            kwargs["mesh"] = (make_mesh(cell.chips) if dev.type == "cuda"
                              else devices)
        else:
            kwargs["device"] = dev

        def call(req, timings=None):
            return program.align_batch_from_pcm(
                [(p.video, p.audio) for p in req], **kwargs)
    else:
        raise CellError(f"no entry for level {level!r} in mode {mode!r}")
    return call


def _sync(devices):
    import torch
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def _peak_bytes(devices):
    import torch
    return max((torch.cuda.max_memory_allocated(d) for d in devices
                if torch.device(d).type == "cuda"), default=0)


def _reset_peak(devices):
    import torch
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def _free(devices):
    import torch
    if any(torch.device(d).type == "cuda" for d in devices):
        torch.cuda.empty_cache()


def execute(cell, seed, seconds, trace, devices, device_name, t_proc):
    """Run the cell once and return (Run, result dict). devices: torch
    devices (the chips the cell asks for, or CPU devices in the tests);
    t_proc: the process's start on the wall clock (time.time())."""
    run = Run(cell, seed, devices, device_name)
    requests = gen.Requests(cell.config, cell.traffic, seed, devices[0])
    _sync(devices)
    _free(devices)
    call = program_call(cell, devices)
    # the program's progress lines stay off the result's stdout
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        call(requests.warm_up())                # the cell's shapes
        _sync(devices)
        _reset_peak(devices)
        run.setup_s = time.time() - t_proc
        with Probes() as probes:
            if trace:
                _traced_window(run, call, requests, probes)
            else:
                _window(run, call, requests, seconds, probes)
    run.peak_bytes = _peak_bytes(devices)
    del call
    _free(devices)
    return run, _result(run, trace)


class Probes:
    """What the benchmark reads of the program's state, without a wait on
    the device: each call of the coarse stage
    (alignment.matching._coarse_tracks, whose last output is the coarse
    margin, an f32 device scalar) as (len_a, len_v, nf, margin, map rows),
    where map rows are (first block, a copy of up to MAP_ROWS middle rows)
    of the first unsuppressed score map or tile that the call made
    (ops.coarse_map.block_scores); and each host feature stack
    (alignment.api.host_features_padded) as (the PCM array it was given,
    the (5, Npad) f32 stack)."""

    TARGETS = (("alignment.matching", "_coarse_tracks", "margins"),
               ("ops.coarse_map", "block_scores", "map"),
               ("alignment.api", "host_features_padded", "features"))
    MAP_ROWS = 64

    def __init__(self):
        self.margins, self.features = [], []
        self._undo = []
        self._local = threading.local()

    def __enter__(self):
        for mod_name, fn_name, kind in self.TARGETS:
            mod = importlib.import_module("describealign_tpu_torch."
                                          + mod_name)
            real = getattr(mod, fn_name)
            setattr(mod, fn_name, self._wrap(real, kind))
            self._undo.append((mod, fn_name, real))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, real in reversed(self._undo):
            # what the program kept on its function (launch counters)
            # went to the wrapper meanwhile
            probed = getattr(mod, fn_name)
            for k, v in vars(probed).items():
                if k != "__wrapped__":
                    setattr(real, k, v)
            setattr(mod, fn_name, real)
        self._undo = []

    def _wrap(self, real, kind):
        sig = inspect.signature(real)
        local = self._local

        def probed(*args, **kwargs):
            if kind == "margins":
                frame, outer = {}, getattr(local, "frame", None)
                local.frame = frame
                try:
                    out = real(*args, **kwargs)
                finally:
                    local.frame = outer
                a = sig.bind(*args, **kwargs).arguments
                self.margins.append((int(a["len_a"]), int(a["len_v"]),
                                     a.get("nf"), out[-1], frame.get("map")))
                return out
            out = real(*args, **kwargs)
            if kind == "features":
                a = sig.bind(*args, **kwargs).arguments
                self.features.append((a["pcm_i16"], out[0]))
                return out
            # the score map: only the first of a coarse-stage call
            frame = getattr(local, "frame", None)
            if frame is None or "map" in frame:
                return out
            a = sig.bind(*args, **kwargs).arguments
            if a.get("suppress") is None:
                n = out.shape[0]
                m = min(n, self.MAP_ROWS)
                off = (n - m) // 2
                frame["map"] = (int(a["b0"]) + off, out[off:off + m].clone())
            return out
        # the program may keep counters on its function (fn.launches)
        return functools.wraps(real)(probed)

    def take(self, req):
        """Each pair's (margin, map rows, (video stack, description stack)
        or None) among the records made since the last take, which it
        clears: the margin and map rows of the first three-stream call (not
        the five-stream retry) with the pair's true lengths, or None; the
        stacks made from the pair's own arrays."""
        margins = [r for r in self.margins if r[2] in (None, 3)]
        feats = self.features
        out = []
        for pair in req:
            nv, na = pair.frames()
            hit = next((r for r in margins if r[0] == na and r[1] == nv),
                       None)
            if hit is not None:
                margins.remove(hit)
            fv = next((f for x, f in feats if x is pair.video), None)
            fa = next((f for x, f in feats if x is pair.audio), None)
            out.append((None if hit is None else hit[3],
                        None if hit is None else hit[4],
                        None if fv is None or fa is None else (fv, fa)))
        self.margins, self.features = [], []
        return out


class Sample:
    """A reservoir of k answers drawn from the seed as they come: the
    answers whose coarse stage is compared after the window."""

    def __init__(self, k, seed):
        self.k = k
        self.kept = []
        self.seen = 0
        self._rng = np.random.default_rng(gen.derive(seed, 0x5A))

    def offer(self, item):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
            return
        j = int(self._rng.integers(0, self.seen))
        if j < self.k:
            self.kept[j] = item


def _record(run, req, answers, t0, t1, probes):
    """Keep an answered request. A request answered by another number of
    answers than it had pairs has failed: which answer is whose cannot be
    told, and none of its pairs counts as done."""
    state = probes.take(req)
    try:
        answers = list(answers)
    except TypeError:
        answers = []
    if len(answers) != len(req):
        run.failures.extend(
            (p, f"{len(answers)} answers to {len(req)} pairs") for p in req)
        return
    run.durations.append(t1 - t0)
    run.pairs_done.append(req)
    for pair, ans, (margin, rows, feats) in zip(req, answers, state):
        run.answers.append((pair, (ans[0], ans[1])))
        run.sample.offer((pair, margin, rows, feats))


def _window(run, call, requests, seconds, probes):
    """The closed loop: each request starts when the last has returned;
    the window runs from the first start to the end of the last request
    started before `seconds` had passed."""
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        req = requests.next()
        t0 = time.perf_counter()
        try:
            answers = call(req)
        except Exception as exc:            # judged below, not fatal
            run.failures.extend((p, repr(exc)) for p in req)
            probes.take(req)
            continue
        _record(run, req, answers, t0, time.perf_counter(), probes)
    run.window_s = time.perf_counter() - t_start


def _traced_window(run, call, requests, probes):
    """trace_requests requests under the profiler, with the program's
    stage splits and the benchmark's spans."""
    from . import tracing
    single = run.cell.traffic["mode"] == "single"
    out = {}
    t_start = time.perf_counter()
    with tracing.program_spans(), tracing.profiled(out):
        for _ in range(run.cell.traffic["trace_requests"]):
            req = requests.next()
            timings = {} if single else None
            t0 = time.perf_counter()
            try:
                with tracing.request_span():
                    answers = call(req, timings)
            except Exception as exc:        # judged below, not fatal
                run.failures.extend((p, repr(exc)) for p in req)
                probes.take(req)
                continue
            _record(run, req, answers, t0, time.perf_counter(), probes)
            if timings is not None:
                run.timings.append(timings)
    run.window_s = time.perf_counter() - t_start
    run.trace = out.get("trace")


def judge(run):
    """The comparison with the references, after the window:

    - every answer of the window against the true map of its own pair:
      the worst answer's share of content mapped beyond the
      configuration's tolerance (missed_pct);
    - the sample's coarse stage against the plain fp32 reference, the
      configuration's precision: the widest gap of the program's score
      map rows (map_gap) and, at the PCM level, of its feature streams
      from the plain cascade's (feature_gap); and of its coarse margin
      (margin_gap) where the configuration gives that a limit.
    """
    ref = run.cell.reference
    g = run.cell.config["guarantees"]
    readings = [ref.judge(nx, ny, pair.segments, g["tolerance_ms"])
                for pair, (nx, ny) in run.answers]
    missed = max((r[0] for r in readings), default=100.0)
    run.widest_gap_ms = max((r[1] for r in readings), default=float("inf"))
    run.gaps = run.cell.margin_reference.compare(
        run.sample.kept, run.cell.config, run.devices[0])
    checks = {"missed_pct": {"value": missed,
                             "limit": g["missed_pct_limit"]}}
    for name, gaps in run.gaps.items():
        if name + "_limit" in g:
            checks[name] = {"value": max(gaps, default=float("inf")),
                            "limit": g[name + "_limit"]}
    correct = (not run.failures and len(run.answers) >= 1
               and all(c["value"] <= c["limit"] for c in checks.values()))
    checks["failed"] = {"value": len(run.failures), "limit": 0}
    checks["answers"] = {"value": len(run.answers), "limit": 1}
    return correct, checks


def read_metrics(run, entries):
    out = {}
    for m in entries:
        value = run.cell.reader(m).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _result(run, trace):
    correct, checks = judge(run)
    device = {"platform": "gpu", "kind": run.device_name,
              "count": len(set(str(d) for d in run.devices)),
              "memory_peak_bytes": int(run.peak_bytes)}
    res = {"correct": bool(correct),
           "attempted": len(run.answers) + len(run.failures),
           "failed": len(run.failures)}
    if trace:
        res["metrics"] = read_metrics(run, run.cell.per_layer)
        tr = run.trace
        n = device["count"]
        device["busy_s"] = tr.mean_busy_s(n) if tr else 0.0
        device["window_s"] = tr.window_s if tr else 0.0
        res["device"] = device
        bd = tr.breakdown() if tr else None
        if bd:
            res["breakdown"] = bd
    else:
        res["metrics"] = read_metrics(run, run.cell.end_to_end)
        res["device"] = device
    res["checks"] = checks
    return res


def forbidden_modules():
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
