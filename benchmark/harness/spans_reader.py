"""The program's own spans and counters (describealign_tpu_torch/utils/
spans.py), read for the traced window and put on the trace's clock.

The program records a call only while a torch.profiler records it, so its
records are those of the traced requests. Each entry of the program (a
root span `align` or `batch`) runs inside the benchmark's `request` span.
The trace keeps times relative to a base it does not say, and the
program's are time.time_ns(): the offset between the two clocks is the
least difference, over the traced requests, between the entry's start and
its request span's start. If those differences spread by more than
ANCHOR_SPREAD_S, the anchor does not hold and nothing is read.

A program without the module, or one that recorded nothing, reads None,
as does a run without a trace: every metric that reads spans is then left
out of the result.
"""
import collections
import importlib

from . import stats
from .tracing import REQUEST_SPAN

MODULE = "describealign_tpu_torch.utils.spans"
ENTRIES = ("align", "batch")
ANCHOR_SPREAD_S = 0.005

# a span on the trace's clock, in seconds
Rec = collections.namedtuple("Rec", "id name request parent thread t0 t1")


def overlap_s(a, b):
    """Seconds that two unions of intervals, each sorted and disjoint
    (stats.merge), have in common."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def minus(a, b):
    """The union a without the union b (both sorted and disjoint)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


class Spans:
    """The traced entries' records on the trace's clock.

    entries: the entries' root spans, in time order; offset_s: program
    clock minus trace clock; spread_s: how far the anchor's differences
    spread; requests: {id: (name, parent id)} of the entries and their
    pairs; counters: {request id: {name: n}}."""

    def __init__(self, records, requests, counters, offset_s, spread_s,
                 window):
        self.records = records
        self.requests = requests
        self.counters = counters
        self.offset_s = offset_s
        self.spread_s = spread_s
        self.window = window
        self.entries = sorted((r for r in records if r.parent is None
                               and r.name in ENTRIES
                               and r.request in requests
                               and requests[r.request][1] is None),
                              key=lambda r: r.t0)
        self._children = collections.defaultdict(list)
        for r in records:
            if r.parent is not None:
                self._children[r.parent].append(r)

    def named(self, name):
        return [r for r in self.records if r.name == name]

    def self_s(self, rec):
        """The span's duration less the part its child spans cover."""
        kids = [(c.t0, c.t1) for c in self._children[rec.id]]
        return (rec.t1 - rec.t0) - stats.busy(kids, rec.t0, rec.t1)

    def total_self_s(self, name):
        return sum(self.self_s(r) for r in self.named(name))

    def pairs(self):
        """Request ids of the traced batches' pairs."""
        batches = {e.request for e in self.entries if e.name == "batch"}
        return [i for i, (_, parent) in self.requests.items()
                if parent in batches]

    def retried(self, request_ids):
        """How many of the requests counted a retry."""
        return sum(1 for i in request_ids
                   if any(k.startswith("retry.")
                          for k in self.counters.get(i, {})))

    def union(self, names=(), prefix=None):
        """The union of the named spans (or of those whose name starts
        with prefix) on every thread, clipped to the window."""
        iv = [(r.t0, r.t1) for r in self.records
              if r.name in names or (prefix and r.name.startswith(prefix))]
        return stats.clip(stats.merge(iv), *self.window)


def anchor(entry_starts, request_starts):
    """(offset, spread) from the entries' starts on the program's clock and
    their requests' starts on the trace's, paired in time order; None if
    the counts differ or there are none."""
    if not entry_starts or len(entry_starts) != len(request_starts):
        return None
    diffs = [e - r for e, r in zip(sorted(entry_starts),
                                   sorted(request_starts))]
    return min(diffs), max(diffs) - min(diffs)


def from_snapshot(snap, trace):
    """Spans from a program snapshot and the parsed Trace, or None."""
    if not snap or not snap.get("spans") or trace is None \
            or not trace.window:
        return None
    requests = {i: (r.name, r.parent) for i, r in snap["requests"].items()}
    roots = [s for s in snap["spans"] if s.parent is None
             and s.name in ENTRIES and s.request in requests
             and requests[s.request][1] is None]
    # nanoseconds since the first entry, so that no float holds the epoch
    ref_ns = min((s.t0_ns for s in roots), default=0)

    def clock(t_ns):
        return (t_ns - ref_ns) * 1e-9

    got = anchor([clock(s.t0_ns) for s in roots],
                 [s[2] for s in trace.spans if s[0] == REQUEST_SPAN])
    if got is None or got[1] > ANCHOR_SPREAD_S:
        return None
    offset, spread = got
    lo, hi = trace.window
    inside = {s.request for s in roots
              if lo - ANCHOR_SPREAD_S <= clock(s.t0_ns) - offset <= hi}
    inside |= {i for i, (_, parent) in requests.items() if parent in inside}
    records = [Rec(s.id, s.name, s.request, s.parent, s.thread,
                   clock(s.t0_ns) - offset, clock(s.t1_ns) - offset)
               for s in snap["spans"] if s.request in inside]
    return Spans(records, {i: requests[i] for i in inside},
                 {i: c for i, c in snap.get("counters", {}).items()
                  if i in inside},
                 ref_ns * 1e-9 + offset, spread, trace.window)


def load(run):
    """The traced window's Spans, or None (no trace, a program without
    spans, nothing recorded, or no anchor)."""
    if run.trace is None or not run.trace.window:
        return None
    try:
        module = importlib.import_module(MODULE)
    except ImportError:
        return None
    return from_snapshot(module.snapshot(), run.trace)


def idle_share(run, busy_host):
    """The window's share, in %, in which a card is idle while the host
    intervals busy_host (sorted, disjoint) hold, averaged over the cell's
    cards (a card that ran nothing is idle throughout)."""
    tr = run.trace
    lo, hi = tr.window
    devices = tr.devices()
    total = sum(overlap_s(stats.gaps([(op[2], op[3]) for op in tr.ops
                                      if op[1] == d], lo, hi), busy_host)
                for d in devices)
    total += (max(len(run.devices) - len(devices), 0)
              * overlap_s([(lo, hi)], busy_host))
    return 100.0 * total / (len(run.devices) * (hi - lo))
