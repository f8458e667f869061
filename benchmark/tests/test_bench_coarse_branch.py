"""coarse.streamed_pct, the share of the traced alignments' coarse passes
that ran the streamed DP: read from the program's counters of a recorded
snapshot and of traced CPU runs (the materialized branch, and the streamed
one with the program's threshold cut to 0), and None without them."""
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

Span = collections.namedtuple(
    "Span", "id name request parent thread t0_ns t1_ns")
Request = collections.namedtuple("Request", "id name parent")

BASE_NS = 1_700_000_000_000_000_000
NAME = "coarse.streamed_pct"


def _reader():
    return core.load_module(os.path.join(BENCH_DIR, "metrics",
                                         NAME + ".py"),
                            "test_coarse_streamed_pct")


def _use(monkeypatch, snap):
    mod = types.ModuleType(spans_reader.MODULE)
    mod.snapshot = lambda: snap
    monkeypatch.setitem(sys.modules, spans_reader.MODULE, mod)


def _single(counters):
    """Two traced alignments (requests 1 and 2) with counters."""
    tr = Trace([{"ph": "X", "cat": "user_annotation",
                 "name": "bench:request", "ts": t, "dur": 10000,
                 "tid": 1, "pid": 1} for t in (0, 20000)])
    snap = {"spans": [Span(i, "align", i, None, 1,
                           BASE_NS + t0 * 1_000_000 + 50_000,
                           BASE_NS + t0 * 1_000_000 + 9_050_000)
                      for i, t0 in ((1, 0), (2, 20))],
            "requests": {i: Request(i, "align", None) for i in (1, 2)},
            "counters": counters, "dropped": 0}
    return types.SimpleNamespace(trace=tr, devices=["cuda:0"]), snap


def test_the_share_from_the_counters(monkeypatch):
    # the second alignment retried: its 5-stream pass streamed; request 3
    # is none of the traced window's
    run, snap = _single({1: {"coarse.materialized": 1},
                         2: {"coarse.materialized": 1,
                             "coarse.streamed": 1, "retry.low_margin": 1},
                         3: {"coarse.streamed": 4}})
    _use(monkeypatch, snap)
    assert _reader().read(run) == pytest.approx(100.0 / 3)


def test_a_batch_counts_its_pairs(monkeypatch):
    tr = Trace([{"ph": "X", "cat": "user_annotation",
                 "name": "bench:request", "ts": 0, "dur": 10000,
                 "tid": 1, "pid": 1}])
    snap = {"spans": [Span(1, "batch", 10, None, 1,
                           BASE_NS + 50_000, BASE_NS + 9_050_000)],
            "requests": {10: Request(10, "batch", None),
                         **{i: Request(i, "pair", 10)
                            for i in range(11, 15)}},
            "counters": {i: {"coarse.streamed" if i == 11
                             else "coarse.materialized": 1}
                         for i in range(11, 15)},
            "dropped": 0}
    _use(monkeypatch, snap)
    run = types.SimpleNamespace(trace=tr, devices=["cuda:0"])
    assert _reader().read(run) == pytest.approx(25.0)


@pytest.mark.parametrize("case", ["no counters", "no module", "no trace"])
def test_none_without_records(monkeypatch, case):
    run, snap = _single({2: {"retry.kept": 1}})
    _use(monkeypatch, snap)
    if case == "no module":
        monkeypatch.setattr(spans_reader, "MODULE",
                            "describealign_tpu_torch.utils.no_such_module")
    if case == "no trace":
        run.trace = None
    assert _reader().read(run) is None


@pytest.mark.parametrize("limit,want", [(None, 0.0), (0, 100.0)])
def test_a_traced_cpu_run_reads_the_programs_counters(tiny_root,
                                                      cpu_threads,
                                                      monkeypatch, limit,
                                                      want):
    from describealign_tpu_torch.alignment import matching
    from describealign_tpu_torch.utils import spans
    if limit is not None:
        monkeypatch.setattr(matching, "COARSE_STREAM_ELEMS", limit)
    # the profiler's one-time set-up runs inside the first record_function
    # of a process, which would move the first request's start past the
    # anchor's bound: do it here
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm"):
            pass
    spans.clear()
    cell = core.Cell(tiny_root, "tiny-episode-single")
    devices = [torch.device("cpu")] * cell.chips
    run, res = core.execute(cell, 2 ** 31 + 11, 1.0, 1, devices, "cpu",
                            time.time())
    assert res["correct"], res["checks"]
    sp = spans_reader.load(run)
    assert len(sp.entries) == cell.traffic["trace_requests"]
    assert res["metrics"][NAME] == {"value": pytest.approx(want),
                                    "unit": "%"}
    spans.clear()
