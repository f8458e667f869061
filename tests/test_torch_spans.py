"""The port's spans and counters (describealign_tpu_torch/utils/spans.py)
on the CPU: recorded only under torch.profiler, one request id per call,
nested per thread, on the profiler's clock, handed to the batch's pool
threads, counting the retry, the pairs whose features the device
computes (staged and uploaded apart) and each coarse pass's branch; the
ring's bound.

The pair is tests/test_torch_batch.py's retry pair (40 s of content, 3 s
of narration); a confidence floor above any margin forces the retry.
"""
import json
import sys
import threading

import numpy as np
import pytest
import torch

from describealign_tpu_torch.alignment import api
from describealign_tpu_torch.alignment import matching
from describealign_tpu_torch.utils import spans
from describealign_tpu_torch.utils.synthmedia import build_pair

SINGLE_SPANS = {'align', 'features.host', 'features.upload', 'match',
                'tail.fetch', 'tail.lis', 'tail.pass1', 'tail.pass2'}


@pytest.fixture(scope="module")
def pair():
    video, audio, _ = build_pair(content_seconds=40.0,
                                 narration=((8.0, 3.0),), lead_in=2.0,
                                 seed=78)
    return tuple(np.clip(x, -32768, 32767).astype(np.int16)
                 for x in (video, audio))


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _check_nesting(records):
    by_id = {s.id: s for s in records}
    for s in records:
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns


def test_nothing_recorded_without_the_profiler(pair):
    api.align_from_pcm(*pair, device='cpu')
    api.align_batch_from_pcm([pair], device='cpu', host_workers=1)
    snap = spans.snapshot()
    assert snap['spans'] == [] and snap['requests'] == {}
    assert spans.span('match') is spans.span('tail.lis')     # the no-op


def test_one_alignment_under_the_profiler(pair, tmp_path):
    with _profile() as prof:
        api.align_from_pcm(*pair, device='cpu')
    snap = spans.snapshot()
    records = snap['spans']
    assert {s.name for s in records} == SINGLE_SPANS
    assert len({s.request for s in records}) == 1
    (req,) = snap['requests'].values()
    assert (req.name, req.parent) == ('align', None)
    _check_nesting(records)
    root = next(s for s in records if s.name == 'align')
    assert root.parent is None
    # the video's features on the helper thread, in the same request
    (helper,) = [s for s in records if s.thread != root.thread]
    assert (helper.name, helper.parent) == ('features.host', None)
    records = [s for s in records if s is not helper]
    assert all(s.parent is not None for s in records if s is not root)
    # the layers in their order: features, matcher, LIS, pass 1, pass 2
    first = {}
    for s in sorted(records, key=lambda s: s.t0_ns):
        first.setdefault(s.name, s)
    order = ['features.host', 'match', 'tail.lis', 'tail.pass1',
             'tail.pass2']
    for a, b in zip(order, order[1:]):
        assert first[a].t1_ns <= first[b].t0_ns
    # the fetches of the LIS's chunks are its children
    lis = first['tail.lis']
    assert any(s.name == 'tail.fetch' and s.parent == lis.id
               for s in records)

    # the exported trace shows each span at its recorded time
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    base_us = trace['baseTimeNanoseconds'] / 1000
    events = sorted((ev for ev in trace['traceEvents']
                     if ev.get('name', '').startswith(spans.PREFIX)),
                    key=lambda ev: float(ev['ts']))
    assert len(events) == len(records)
    for ev, s in zip(events, sorted(records, key=lambda s: s.t0_ns)):
        assert ev['name'] == spans.PREFIX + s.name
        assert abs(float(ev['ts']) - (s.t0_ns / 1000 - base_us)) < 1000
        end = float(ev['ts']) + float(ev['dur'])
        assert abs(end - (s.t1_ns / 1000 - base_us)) < 1000


def test_batch_pairs_on_the_pool_threads(pair):
    main = threading.get_native_id()
    with _profile():
        out = api.align_batch_from_pcm([pair] * 3, device='cpu',
                                       host_workers=2)
    assert len(out) == 3
    snap = spans.snapshot()
    records = snap['spans']
    _check_nesting(records)
    (batch,) = [r for r in snap['requests'].values() if r.name == 'batch']
    pairs = [r for r in snap['requests'].values() if r.name == 'pair']
    assert len(pairs) == 3 and all(r.parent == batch.id for r in pairs)
    root = next(s for s in records if s.name == 'batch')
    assert (root.request, root.thread, root.parent) == (batch.id, main,
                                                        None)
    featuring = {s.thread for s in records if s.name == 'features.host'}
    assert main not in featuring and len(featuring) <= 2
    for r in pairs:
        mine = [s for s in records if s.request == r.id]
        on_main = {s.name for s in mine if s.thread == main}
        assert {'batch.slot_wait', 'batch.dispatch', 'features.upload',
                'match'} <= on_main
        # the feature pool: the two streams, each under a host token
        extracted = [s for s in mine if s.thread in featuring]
        assert sorted(s.name for s in extracted) == [
            'batch.token_wait', 'batch.token_wait', 'features.host',
            'features.host']
        assert all(s.parent is None for s in extracted)
        assert sum(snap['counters'][r.id].get(k, 0) for k in (
            'features.ready', 'features.waited')) == 1
        pooled = [s for s in mine if s.thread not in featuring | {main}]
        names = {s.name for s in pooled}
        assert {'batch.result_wait', 'batch.token_wait', 'batch.refine',
                'tail.lis', 'tail.pass1', 'tail.pass2'} <= names
        assert not names & {'features.host', 'match'}
        assert len({s.thread for s in pooled}) == 1
        refine = next(s for s in pooled if s.name == 'batch.refine')
        assert all(s.parent == refine.id for s in pooled
                   if s.name.startswith('tail.'))
    for name in ('batch.slot_wait', 'batch.dispatch', 'batch.drain'):
        assert all(s.parent == root.id for s in records if s.name == name)
    assert len([s for s in records if s.name == 'batch.drain']) == 1


def test_a_forced_retry_is_spanned_and_counted(pair, monkeypatch):
    monkeypatch.setattr(matching, 'COARSE_MARGIN_FLOOR', 1e9)
    with _profile():
        api.align_from_pcm(*pair, device='cpu')
    snap = spans.snapshot()
    (req,) = snap['requests']
    # the first coarse pass and the retry's
    assert snap['counters'] == {req: {'retry.low_margin': 1,
                                      'coarse.materialized': 2}}
    (retry,) = [s for s in snap['spans'] if s.name == 'tail.retry']
    inside = {s.name for s in snap['spans'] if s.parent == retry.id}
    assert {'features.upload', 'match', 'tail.lis', 'tail.fetch'} <= inside


def test_device_features_are_staged_uploaded_and_counted(pair):
    with _profile():
        api.align_from_pcm(*pair, device='cpu', features='device')
    snap = spans.snapshot()
    records = snap['spans']
    _check_nesting(records)
    (req,) = snap['requests']
    assert snap['counters'] == {req: {'features.device': 1,
                                      'coarse.materialized': 1}}
    root = next(s for s in records if s.name == 'align')
    names = [s.name for s in sorted(records, key=lambda s: s.t0_ns)
             if s.parent == root.id]
    # each track (description, then video): staged, then uploaded
    assert names[:4] == ['features.stage', 'features.upload'] * 2
    assert 'features.host' not in {s.name for s in records}
    assert all(s.request == req for s in records)


def test_device_features_counted_once_per_pair_of_a_batch(pair):
    main = threading.get_native_id()
    with _profile():
        out = api.align_batch_from_pcm([pair] * 3, device='cpu',
                                       host_workers=2, features='device')
    assert len(out) == 3
    snap = spans.snapshot()
    pairs = [r.id for r in snap['requests'].values() if r.name == 'pair']
    assert len(pairs) == 3
    assert {i: snap['counters'].get(i) for i in pairs} == {
        i: {'features.device': 1, 'coarse.materialized': 1} for i in pairs}
    (batch,) = [r.id for r in snap['requests'].values()
                if r.name == 'batch']
    assert batch not in snap['counters']
    for i in pairs:
        on_main = [s.name for s in snap['spans']
                   if s.request == i and s.thread == main]
        assert on_main.count('features.stage') == 2
        assert on_main.count('features.upload') == 2


def test_the_host_route_neither_stages_nor_counts_device_features(pair):
    with _profile():
        api.align_from_pcm(*pair, device='cpu')
        api.align_batch_from_pcm([pair] * 2, device='cpu', host_workers=1)
    snap = spans.snapshot()
    assert 'features.stage' not in {s.name for s in snap['spans']}
    assert not any('features.device' in c
                   for c in snap['counters'].values())


@pytest.mark.parametrize('limit,branch', [(None, 'coarse.materialized'),
                                          (0, 'coarse.streamed')])
def test_each_coarse_pass_counts_its_branch(pair, monkeypatch, limit,
                                            branch):
    """One count of coarse.streamed or coarse.materialized a coarse pass,
    on the request it serves: an alignment's, each pair's of a batch (the
    threshold cut to 0 puts every pass on the streamed branch)."""
    if limit is not None:
        monkeypatch.setattr(matching, 'COARSE_STREAM_ELEMS', limit)
    with _profile():
        api.align_from_pcm(*pair, device='cpu')
        api.align_batch_from_pcm([pair] * 2, device='cpu', host_workers=1)
    snap = spans.snapshot()
    requests = snap['requests'].values()
    served = [r.id for r in requests if r.name in ('align', 'pair')]
    assert len(served) == 3
    for i in served:
        counts = snap['counters'][i]
        assert counts[branch] == 1
        assert not {'coarse.streamed', 'coarse.materialized'} - {branch} \
            & set(counts)
    (batch,) = [r.id for r in requests if r.name == 'batch']
    assert batch not in snap['counters']


def test_the_ring_drops_the_oldest_and_counts_them():
    ring = spans.Ring(4)
    req = spans.Request(1, 'align', None)
    ring.add_request(req)
    for i in range(6):
        ring.add_span(spans.Span(i, 'x', 1, None, 0, i, i + 1))
    ring.count(1, 'retry.kept')
    ring.count(1, 'retry.kept')
    snap = ring.snapshot()
    assert [s.id for s in snap['spans']] == [2, 3, 4, 5]
    assert snap['dropped'] == 2
    assert snap['counters'] == {1: {'retry.kept': 2}}
    ring.clear()
    assert ring.snapshot() == {'spans': [], 'requests': {}, 'counters': {},
                               'dropped': 0}
    assert spans.RING_SPANS == 65536


def test_the_ring_keeps_every_count_under_contention():
    ring = spans.Ring(1000)
    n_threads, per_thread = 16, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per_thread):
                ring.add_span(spans.Span(k * per_thread + i, 'x', 1, None,
                                         k, 0, 1))
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = ring.snapshot()
    assert len(snap['spans']) == 1000
    assert snap['dropped'] == n_threads * per_thread - 1000
