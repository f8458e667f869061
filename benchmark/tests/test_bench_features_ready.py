"""features.ready_pct.batch, the share of a batch's pairs whose host
features were done when the dispatching thread asked: read from the
program's counters of a recorded snapshot and of a traced CPU batch, and
None without them."""
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
NAME = "features.ready_pct.batch"


def _reader():
    return core.load_module(os.path.join(BENCH_DIR, "metrics",
                                         NAME + ".py"),
                            "test_features_ready_pct_batch")


def _use(monkeypatch, snap):
    mod = types.ModuleType(spans_reader.MODULE)
    mod.snapshot = lambda: snap
    monkeypatch.setitem(sys.modules, spans_reader.MODULE, mod)


def _batch(counters):
    """One traced batch of four pairs (requests 11-14) with counters."""
    tr = Trace([{"ph": "X", "cat": "user_annotation",
                 "name": "bench:request", "ts": 0, "dur": 10000,
                 "tid": 1, "pid": 1}])
    snap = {"spans": [Span(1, "batch", 10, None, 1,
                           BASE_NS + 50_000, BASE_NS + 9_050_000)],
            "requests": {10: Request(10, "batch", None),
                         **{i: Request(i, "pair", 10)
                            for i in range(11, 15)}},
            "counters": counters, "dropped": 0}
    return types.SimpleNamespace(trace=tr, devices=["cuda:0"]), snap


def test_the_share_from_the_counters(monkeypatch):
    run, snap = _batch({11: {"features.waited": 1},
                        12: {"features.ready": 1},
                        13: {"features.ready": 1, "retry.low_margin": 1},
                        14: {"features.ready": 1}})
    _use(monkeypatch, snap)
    assert _reader().read(run) == pytest.approx(75.0)


@pytest.mark.parametrize("case", ["no counters", "no module", "no trace"])
def test_none_without_records(monkeypatch, case):
    run, snap = _batch({12: {"retry.kept": 1}})
    _use(monkeypatch, snap)
    if case == "no module":
        monkeypatch.setattr(spans_reader, "MODULE",
                            "describealign_tpu_torch.utils.no_such_module")
    if case == "no trace":
        run.trace = None
    assert _reader().read(run) is None


def test_a_traced_cpu_batch_reads_the_programs_counters(tiny_root,
                                                        cpu_threads):
    from describealign_tpu_torch.utils import spans
    # the profiler's one-time set-up runs inside the first record_function
    # of a process (up to ~20 ms on a busy CPU), which would move the first
    # request's start past the anchor's bound: do it here
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm"):
            pass
    spans.clear()
    cell = core.Cell(tiny_root, "tiny-episode-batch")
    devices = [torch.device("cpu")] * cell.chips
    run, res = core.execute(cell, 2 ** 31 + 7, 1.0, 1, devices, "cpu",
                            time.time())
    assert res["correct"], res["checks"]
    sp = spans_reader.load(run)
    pairs = sp.pairs()
    counted = [k for i in pairs for k in sp.counters.get(i, {})
               if k.startswith("features.")]
    # each pair of the traced batches counted once
    assert len(counted) == len(pairs) > 0
    want = 100.0 * counted.count("features.ready") / len(pairs)
    assert res["metrics"][NAME] == {"value": pytest.approx(want),
                                    "unit": "%"}
    spans.clear()
