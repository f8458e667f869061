"""The metric arithmetic: rates, the percentile, the union of device
intervals, the idle share and the breakdown read from a trace, and the
coarse score map's work counted from its shapes."""
import types

import pytest

from harness import roofline, stats
from harness.tracing import Trace


def test_rate_and_percentile():
    assert stats.rate(90, 45.0) == 2.0
    assert stats.percentile(range(1, 11), 90) == pytest.approx(9.1)
    assert stats.percentile([0.5] * 7 + [2.0], 90) == pytest.approx(0.95)


def test_union_counts_overlap_once():
    iv = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0), (3.2, 3.4)]
    assert stats.merge(iv) == [(0.0, 1.5), (3.0, 4.0)]
    assert stats.busy(iv, 0.0, 5.0) == pytest.approx(2.5)
    assert stats.busy(iv, 1.0, 3.5) == pytest.approx(1.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(1.5, 3.0), (4.0, 5.0)]


def _ev(cat, name, ts, dur, tid=1, device=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if device is not None:
        ev["args"] = {"device": device}
    return ev


def test_trace_idle_share_and_breakdown():
    # a 10-ms request; two overlapping kernels and a copy on device 0;
    # the host in the matcher span for the first half, in the tail later
    events = [
        _ev("user_annotation", "bench:request", 0, 10000),
        _ev("user_annotation", "bench:matcher", 0, 5000),
        _ev("user_annotation", "bench:host_tail", 6000, 4000),
        _ev("user_annotation", "bench:upload_features", 0, 500, tid=2),
        _ev("kernel", "coarse_map_kernel<128>", 1000, 2000, device=0),
        _ev("kernel", "fine_match_kernel", 2000, 2000, device=0),
        _ev("gpu_memcpy", "Memcpy DtoH", 5000, 500, device=0),
    ]
    tr = Trace(events)
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s(0) == pytest.approx(0.0035)
    assert tr.mean_busy_s(1) == pytest.approx(0.0035)
    assert tr.mean_busy_s(2) == pytest.approx(0.00175)
    assert tr.kernel_s("coarse_map_kernel") == (pytest.approx(0.002), 1)
    assert tr.span_s("upload_features") == 0.0          # not main thread
    assert tr.span_s("upload_features", main_only=False) == \
        pytest.approx(0.0005)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["coarse_map_kernel<128>",
                                   pytest.approx(0.002)]
    assert bd["idle_gaps"][0] == ["host_tail", pytest.approx(0.0045)]
    assert [g[0] for g in bd["idle_gaps"]] == [
        "host_tail", "matcher", "matcher"]


def test_idle_metric_reader_reads_the_trace():
    from harness.core import load_module
    import os
    from conftest import BENCH_DIR
    reader = load_module(os.path.join(BENCH_DIR, "metrics",
                                      "device_idle.single.py"), "idle")
    tr = Trace([_ev("user_annotation", "bench:request", 0, 10000),
                _ev("kernel", "k", 1000, 1000, device=0)])
    run = types.SimpleNamespace(trace=tr, devices=["cuda:0"])
    assert reader.read(run) == pytest.approx(90.0)
    run.trace = Trace([_ev("user_annotation", "bench:request", 0, 10)])
    assert reader.read(run) is None          # nothing ran: no reading


def test_coarse_map_work_of_the_bench_map():
    # the 22-min episode: 1,320 s of video, 1,618 s of description
    nb, kv = roofline.coarse_map_shape(277200, 339780)
    assert (nb, kv) == (1663, 16638)
    fma, nbytes = roofline.coarse_map_work(nb, kv)
    # 7 phases x 10 rows x (3 streams x 41 taps) per element; with the
    # program's descriptors padded to K 128 the same map would count
    # 2.479e11
    assert fma == 7 * 10 * 1663 * 16638 * 123 == 238230038340
    assert fma * 128 / 123 == pytest.approx(2.479e11, rel=1e-3)
    assert nbytes == 4 * (10 * 1663 * 123 + 7 * 16638 * 123 + 1663 * 16638)
    t = roofline.least_time_s(fma, nbytes, "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(2 * fma / 495e12)          # compute-bound
    assert roofline.least_time_s(fma, nbytes, "some other card") is None


def test_coarse_map_shape_of_the_film():
    nb, kv = roofline.coarse_map_shape(1197000, 1197000 + 42420 + 37800)
    assert (nb, kv) == (6143, 61438)
