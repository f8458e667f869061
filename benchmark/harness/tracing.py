"""The traced run: the benchmark's own spans around the calls into the
program's layers, torch.profiler's device timeline, and what the per-layer
readers take from them.

Spans are opened from here, never from the program: each entry of SPANS
names a function of the program's modules; where it exists, it is wrapped
for the traced window only by a torch.profiler.record_function of the
span's name, so spans and device operations share one clock. A function a
later version of the program renames is simply not wrapped, and a metric
that reads its span then finds nothing.
"""
import contextlib
import importlib
import json
import os
import tempfile
from collections import defaultdict

import torch

from . import stats

PROGRAM = "describealign_tpu_torch"

# (module under the program, function, span): what the host does, by layer
SPANS = (
    ("alignment.api", "host_features_padded", "host_features"),
    ("alignment.api", "_upload_pair_features", "upload_features"),
    ("alignment.matching", "match_stream", "matcher"),
    ("alignment.matching", "match_stream_pair", "matcher"),
    ("parallel.batch", "device_align_step", "matcher"),
    ("alignment.api", "_consume_stream", "lis"),
    ("alignment.lis", "lis_from_match", "lis"),
    ("alignment.api", "_host_stages_from_path", "host_tail"),
)
REQUEST_SPAN = "request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _wrap(fn, name):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function("bench:" + name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def program_spans():
    """Wrap the program functions of SPANS for the duration."""
    undo = []
    try:
        for mod_name, fn_name, span in SPANS:
            try:
                mod = importlib.import_module(f"{PROGRAM}.{mod_name}")
            except ImportError:
                continue
            fn = getattr(mod, fn_name, None)
            if fn is None:
                continue
            setattr(mod, fn_name, _wrap(fn, span))
            undo.append((mod, fn_name, fn))
        yield
    finally:
        for mod, fn_name, fn in reversed(undo):
            setattr(mod, fn_name, fn)


def request_span():
    return torch.profiler.record_function("bench:" + REQUEST_SPAN)


class Trace:
    """The parsed timeline, in seconds on the profiler's clock.

    ops: (name, device, start, end) of every kernel, copy and set;
    spans: (name, thread, start, end) of the benchmark's spans;
    window: (start, end) from the first request span's start to the last
    one's end; main: the thread that opened the request spans."""

    def __init__(self, events):
        self.ops, self.spans = [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            t0 = float(ev["ts"]) * 1e-6
            t1 = t0 + float(ev["dur"]) * 1e-6
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                dev = (ev.get("args") or {}).get("device", 0)
                self.ops.append((ev.get("name", ""), int(dev), t0, t1))
            elif (cat == "user_annotation"
                  and ev.get("name", "").startswith("bench:")):
                self.spans.append((ev["name"][6:], ev.get("tid"), t0, t1))
        req = [s for s in self.spans if s[0] == REQUEST_SPAN]
        self.main = req[0][1] if req else None
        self.window = ((min(s[2] for s in req), max(s[3] for s in req))
                       if req else None)

    @property
    def window_s(self):
        return self.window[1] - self.window[0] if self.window else 0.0

    def devices(self):
        return sorted({op[1] for op in self.ops})

    def busy_s(self, device):
        lo, hi = self.window
        return stats.busy([(op[2], op[3]) for op in self.ops
                           if op[1] == device], lo, hi)

    def mean_busy_s(self, n_devices):
        """Busy seconds averaged over the n_devices used (a device that ran
        nothing counts as idle throughout)."""
        if not self.window:
            return 0.0
        return sum(self.busy_s(d) for d in self.devices()) / n_devices

    def kernel_s(self, substring):
        """(total seconds, launches) of the kernels whose name holds
        substring, inside the window."""
        lo, hi = self.window
        hits = [op for op in self.ops if substring in op[0]
                and op[2] >= lo and op[3] <= hi]
        return sum(op[3] - op[2] for op in hits), len(hits)

    def span_s(self, name, main_only=True):
        return sum(s[3] - s[2] for s in self.spans if s[0] == name
                   and (not main_only or s[1] == self.main))

    def _label(self, t):
        """The innermost benchmark span open at t on the main thread, or
        'other host work'."""
        open_ = [s for s in self.spans if s[1] == self.main
                 and s[2] <= t < s[3]]
        if not open_:
            return "other host work"
        return min(open_, key=lambda s: s[3] - s[2])[0]

    def breakdown(self, top=10):
        """The device operations that took most time, and the longest idle
        gaps labelled by what the host's main thread was doing."""
        if not self.window:
            return None
        lo, hi = self.window
        by_name = defaultdict(float)
        for name, _, t0, t1 in self.ops:
            by_name[name[:120]] += t1 - t0
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        devs = self.devices()
        idle = []
        for d in devs:
            for g0, g1 in stats.gaps([(op[2], op[3]) for op in self.ops
                                      if op[1] == d], lo, hi):
                label = self._label((g0 + g1) / 2)
                if len(devs) > 1:
                    label = f"cuda:{d} {label}"
                idle.append((label, g1 - g0))
        idle.sort(key=lambda x: -x[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle[:top]]}


@contextlib.contextmanager
def profiled(result):
    """Profile the body (CPU and CUDA activities); on exit result['trace']
    holds the parsed Trace. The chrome trace goes through a file in TMPDIR
    that is deleted at once."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    result["trace"] = Trace(events)
