"""The readers of the program's own spans (harness/spans_reader.py and the
metrics that use it): self time, the anchor between the program's clock
and the trace's and its rejection, the disjoint idle attribution, None
for a program without spans; and a traced run on the CPU at a cut size
that reads them from the program."""
import collections
import os
import sys
import time
import types

import pytest
import torch

from conftest import BENCH_DIR
from harness import core, spans_reader
from harness.tracing import Trace

# the program's record types, by field
Span = collections.namedtuple(
    "Span", "id name request parent thread t0_ns t1_ns")
Request = collections.namedtuple("Request", "id name parent")

BASE_NS = 1_700_000_000_000_000_000     # the program's clock at trace 0


def _ev(cat, name, ts, dur, tid=1, device=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if device is not None:
        ev["args"] = {"device": device}
    return ev


def _ms(i, name, req, parent, t0, t1, thread=1):
    return Span(i, name, req, parent, thread, BASE_NS + int(t0 * 1e6),
                BASE_NS + int(t1 * 1e6))


def _trace(second_start_ms=20.3):
    """Two 10-ms requests at 0 and 20 ms on the trace's clock; the card
    busy 1-2 and 6-7 ms."""
    tr = Trace([_ev("user_annotation", "bench:request", 0, 10000),
                _ev("user_annotation", "bench:request", 20000, 10000),
                _ev("kernel", "k", 1000, 1000, device=0),
                _ev("kernel", "k", 6000, 1000, device=0)])
    snap = {"spans": [
        _ms(1, "align", 1, None, 0.1, 9.9),
        _ms(2, "features.host", 1, 1, 0.1, 3.0),
        _ms(3, "match", 1, 1, 3.0, 4.0),
        _ms(4, "tail.lis", 1, 1, 4.0, 7.0),
        _ms(5, "tail.fetch", 1, 4, 4.0, 5.0),
        _ms(6, "tail.pass1", 1, 1, 7.0, 8.0),
        _ms(7, "tail.pass2", 1, 1, 8.0, 9.5),
        _ms(8, "align", 9, None, second_start_ms, 29.0),
        _ms(10, "align", 11, None, 500.0, 501.0),   # another clock's call
    ], "requests": {1: Request(1, "align", None),
                    9: Request(9, "align", None)},
        "counters": {9: {"retry.low_margin": 1, "retry.kept": 1}},
        "dropped": 0}
    return tr, snap


def test_self_time_and_the_anchor():
    tr, snap = _trace()
    sp = spans_reader.from_snapshot(snap, tr)
    assert sp.offset_s == pytest.approx(BASE_NS * 1e-9 + 1e-4, abs=1e-6)
    assert sp.spread_s == pytest.approx(2e-4, abs=1e-6)
    assert [e.request for e in sp.entries] == [1, 9]
    assert sp.entries[0].t0 == pytest.approx(0.0, abs=1e-6)
    (lis,) = sp.named("tail.lis")
    assert sp.self_s(lis) == pytest.approx(0.002, abs=1e-6)
    (align,) = [e for e in sp.entries if e.request == 1]
    # 9.8 ms less its children's union (0.1-9.5 ms)
    assert sp.self_s(align) == pytest.approx(0.0004, abs=1e-6)
    assert sp.retried([1, 9]) == 1


def test_the_anchor_spreads_too_far():
    tr, snap = _trace(second_start_ms=25.2)        # 5.1 ms late
    assert spans_reader.from_snapshot(snap, tr) is None
    tr, snap = _trace(second_start_ms=25.0)
    assert spans_reader.from_snapshot(snap, tr) is not None
    assert spans_reader.anchor([1.0], [0.0, 2.0]) is None
    assert spans_reader.anchor([], []) is None


def test_interval_arithmetic():
    a = [(0.0, 2.0), (3.0, 6.0)]
    b = [(1.0, 4.0), (5.0, 5.5), (7.0, 8.0)]
    assert spans_reader.overlap_s(a, b) == pytest.approx(2.5)
    assert spans_reader.minus(a, b) == [(0.0, 1.0), (4.0, 5.0), (5.5, 6.0)]
    assert spans_reader.minus(a, []) == a
    assert spans_reader.overlap_s([], b) == 0.0


def _reader(name):
    return core.load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                            "test_" + name.replace(".", "_"))


@pytest.fixture
def program_spans(monkeypatch):
    """Put a snapshot where the readers look for the program's module."""
    def use(snap):
        mod = types.ModuleType(spans_reader.MODULE)
        mod.snapshot = lambda: snap
        monkeypatch.setitem(sys.modules, spans_reader.MODULE, mod)
    return use


def test_single_readers(program_spans):
    tr, snap = _trace()
    program_spans(snap)
    run = types.SimpleNamespace(trace=tr, devices=["cuda:0"])
    got = {n: _reader(n).read(run) for n in (
        "tail.lis_s", "tail.pass1_s", "tail.pass2_s",
        "tail.retry_pct.single")}
    assert got == {"tail.lis_s": pytest.approx(0.001, abs=1e-6),
                   "tail.pass1_s": pytest.approx(0.0005, abs=1e-6),
                   "tail.pass2_s": pytest.approx(0.00075, abs=1e-6),
                   "tail.retry_pct.single": pytest.approx(50.0)}
    # no batch in the window
    assert _reader("batch.slot_wait_share").read(run) is None
    assert _reader("tail.retry_pct.batch").read(run) is None


def test_idle_attribution_is_disjoint(program_spans):
    tr, snap = _trace()
    program_spans(snap)
    run = types.SimpleNamespace(trace=tr, devices=["cuda:0"])
    feats = _reader("device_idle.features_share").read(run)
    tail = _reader("device_idle.tail_share").read(run)
    # idle and in features: 0.1-1 and 2-3 ms; in the tail: 4-9.5 ms less
    # the kernel at 6-7 ms; over the 30-ms window
    assert feats == pytest.approx(100 * 1.9 / 30, abs=1e-3)
    assert tail == pytest.approx(100 * 4.5 / 30, abs=1e-3)
    # a tail span that overlaps the features counts for the features only
    snap["spans"].append(_ms(20, "tail.pass2", 1, None, 2.0, 3.0,
                             thread=2))
    assert _reader("device_idle.tail_share").read(run) == \
        pytest.approx(tail, abs=1e-3)
    # a second card that ran nothing is idle throughout
    run.devices = ["cuda:0", "cuda:1"]
    assert _reader("device_idle.features_share").read(run) == \
        pytest.approx(100 * (1.9 + 2.9) / 60, abs=1e-3)


def test_batch_readers(program_spans):
    tr = Trace([_ev("user_annotation", "bench:request", 0, 10000)])
    snap = {"spans": [
        _ms(1, "batch", 10, None, 0.05, 9.05),
        _ms(2, "batch.slot_wait", 11, 1, 1.0, 2.0),
        _ms(3, "batch.slot_wait", 12, 1, 4.0, 4.5),
        _ms(4, "batch.slot_wait", 12, None, 5.0, 9.0, thread=2),
        _ms(5, "batch.token_wait", 11, None, 2.0, 2.5, thread=2),
        _ms(6, "batch.token_wait", 12, 1, 6.0, 6.25),
    ], "requests": {10: Request(10, "batch", None),
                    11: Request(11, "pair", 10),
                    12: Request(12, "pair", 10)},
        "counters": {12: {"retry.short_path": 1}}, "dropped": 0}
    program_spans(snap)
    run = types.SimpleNamespace(trace=tr, devices=["cuda:0"])
    assert _reader("batch.slot_wait_share").read(run) == \
        pytest.approx(100 * 1.5 / 9.0, abs=1e-3)   # the calling thread's
    assert _reader("batch.token_wait_s").read(run) == \
        pytest.approx(0.00075, abs=1e-6)          # every thread's
    assert _reader("tail.retry_pct.batch").read(run) == pytest.approx(50.0)
    assert _reader("tail.retry_pct.single").read(run) == pytest.approx(0.0)
    # nothing ran on the card: no idle share
    assert _reader("device_idle.features_share").read(run) is None


NEW = ("tail.lis_s", "tail.pass1_s", "tail.pass2_s",
       "tail.retry_pct.single", "tail.retry_pct.batch",
       "batch.slot_wait_share", "batch.token_wait_s",
       "device_idle.features_share", "device_idle.tail_share")


def test_none_without_the_module(monkeypatch, program_spans):
    tr, snap = _trace()
    run = types.SimpleNamespace(trace=tr, devices=["cuda:0"])
    monkeypatch.setattr(spans_reader, "MODULE",
                        "describealign_tpu_torch.utils.no_such_module")
    assert spans_reader.load(run) is None
    assert all(_reader(n).read(run) is None for n in NEW)
    monkeypatch.undo()
    program_spans({"spans": [], "requests": {}, "counters": {},
                   "dropped": 0})
    assert all(_reader(n).read(run) is None for n in NEW)
    run.trace = None
    assert spans_reader.load(run) is None


@pytest.mark.parametrize("name,present", [
    ("tiny-episode-single", ("tail.lis_s", "tail.pass1_s", "tail.pass2_s",
                             "tail.retry_pct.single")),
    ("tiny-episode-batch", ("tail.retry_pct.batch", "batch.slot_wait_share",
                            "batch.token_wait_s")),
])
def test_a_traced_run_reads_the_programs_spans(tiny_root, cpu_threads,
                                               name, present):
    from describealign_tpu_torch.utils import spans
    spans.clear()
    cell = core.Cell(tiny_root, name)
    devices = [torch.device("cpu")] * cell.chips
    run, res = core.execute(cell, 2 ** 31 + 5, 1.0, 1, devices, "cpu",
                            time.time())
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert set(present) <= set(metrics), metrics
    # no device operations on the CPU: no idle shares
    assert "device_idle.features_share" not in metrics
    sp = spans_reader.load(run)
    assert len(sp.entries) == cell.traffic["trace_requests"]
    assert sp.spread_s < spans_reader.ANCHOR_SPREAD_S
    spans.clear()
