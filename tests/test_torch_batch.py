"""Port parity: align_batch_from_pcm, the JAX package's against the port's
on the CPU.

Three 40-s pairs: the two of tests/test_alignment.py's batch test and the
retry pair of tests/test_torch_slice.py, with the confidence floor placed
(in both packages) between that pair's 3-stream margin and its accepted
5-stream margin. The floor then lies above all three pairs' margins, so
the 5-stream retry runs inside the batch for each: rejected for the first
pair (its original result stands), accepted for the other two.

The port's batch path ships the margin as one f16 word in the pair's
buffer, as the JAX package's dense batch transport does
(DESCRIBEALIGN_COMPACT=0). Against that transport everything is held
equal: times, nodes and paths bit for bit, similarity and slope equal, and
the margin too: both sides round to f16 margins that agree to ~3e-6
relative before the rounding, so the words are equal unless a margin lies
that close to an f16 rounding boundary. A pair whose retry is accepted
ships the retry's own f32 margin (no transport): rtol 1e-5, as in
tests/test_torch_slice.py. Against the JAX default (the compact transport, a u8 margin code in 1/500 steps)
everything but the margin is equal and the margin is within 1/500.
Against the port's own align_from_pcm the margin is the f32 one: within
one f16 rounding, 1e-3 relative.
"""
import inspect
import threading
import time

import numpy as np
import pytest
import torch

from describealign_tpu.alignment import api as japi
from describealign_tpu.alignment import matching as jm
from describealign_tpu.utils.synthmedia import build_pair
from describealign_tpu_torch.alignment import api as tapi
from describealign_tpu_torch.alignment import matching as tm

SPECS = (dict(content_seconds=40.0, narration=(), lead_in=6.0, seed=3),
         dict(content_seconds=40.0, narration=(), lead_in=6.0, seed=11),
         dict(content_seconds=40.0, narration=((8.0, 3.0),), lead_in=2.0,
              seed=78))


def _i16(x):
    return np.clip(x, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def pairs():
    out = []
    for spec in SPECS:
        video, audio, _ = build_pair(**spec)
        out.append((_i16(video), _i16(audio)))
    return out


@pytest.fixture(scope="module")
def floor(pairs):
    """A confidence floor above every pair's margin and clear of their f16
    rounding, placed as tests/test_torch_slice.py places it for the third
    pair."""
    margins = []
    for v, a in pairs:
        sv, sa = v.shape[1], a.shape[1]
        npad = max(tapi._bucket_pad(sv // 210), tapi._bucket_pad(sa // 210))
        fv, nv = tapi.host_features_padded(v, sv, npad)
        fa, na = tapi.host_features_padded(a, sa, npad)
        margins.append(float(tm.match_coarse(
            tapi._upload(fa, 'cpu'), na, tapi._upload(fv, 'cpu'), nv)[7]))
    m5n = (float(tm.match_coarse(tapi._upload(fa, 'cpu'), na,
                                 tapi._upload(fv, 'cpu'), nv, nf=5)[7])
           * tm.COARSE_STREAMS / tm.COARSE_RETRY_STREAMS)
    m3 = margins[2]
    if m5n > m3 + 0.01:      # acceptance branch
        value = m3 + (min(m5n, 2.0 * m3) - m3) / 2
    else:                    # rejection branch
        value = max(m3, m5n) * 1.5
    assert all(float(np.float16(m)) < value - 2e-3 for m in margins)
    return value


def _recording(real, calls):
    """host_features_padded that records, as the benchmark's probes do,
    (the PCM array it was given, the stack it made, the thread)."""
    sig = inspect.signature(real)

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        pcm = sig.bind(*args, **kwargs).arguments['pcm_i16']
        calls.append((pcm, out[0], threading.get_ident()))
        return out
    return recorded


@pytest.fixture(scope="module")
def results(pairs, floor):
    """{'dense': JAX batch with the dense transport, 'compact': JAX batch
    as shipped, 'port': the port's batch, 'single': the port's
    align_from_pcm per pair, 'retries': how often the port's retry ran -
    all with the floor placed; 'plain': the port's batch with the shipped
    floor, no retry; 'stacks': what the port's batch extracted, as
    _recording records it}."""
    retries, stacks = [], []
    real_retry = tapi._coarse_retry

    def counting_retry(*args, **kwargs):
        retries.append(1)
        return real_retry(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, 'COARSE_MARGIN_FLOOR', floor)
        mp.setattr(tm, 'COARSE_MARGIN_FLOOR', floor)
        mp.setattr(tapi, '_coarse_retry', counting_retry)
        mp.setattr(tapi, 'host_features_padded',
                   _recording(tapi.host_features_padded, stacks))
        out = {'port': tapi.align_batch_from_pcm(pairs, device='cpu'),
               'retries': len(retries), 'stacks': list(stacks)}
        out['single'] = [tapi.align_from_pcm(v, a, device='cpu')
                         for v, a in pairs]
        mp.setenv('DESCRIBEALIGN_COMPACT', '0')
        out['dense'] = japi.align_batch_from_pcm(pairs)
        mp.delenv('DESCRIBEALIGN_COMPACT')
        out['compact'] = japi.align_batch_from_pcm(pairs)
    out['plain'] = tapi.align_batch_from_pcm(pairs, device='cpu')
    return out


def _assert_same_but_margin(got, want):
    assert len(got) == len(want) == 6
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    assert got[2] == want[2]
    assert got[4] == want[4]


def test_batch_matches_jax_dense_transport(results):
    assert results['retries'] == 3           # every pair, inside the batch
    kinds = set()
    for got, want in zip(results['port'], results['dense']):
        _assert_same_but_margin(got, want)
        if want[5] == float(np.float16(want[5])):
            kinds.add('rejected')
            assert got[5] == want[5]         # the same f16 word
        else:
            kinds.add('accepted')            # the retry's own f32 margin
            np.testing.assert_allclose(got[5], want[5], rtol=1e-5)
    assert kinds == {'rejected', 'accepted'}


def test_batch_matches_jax_default_transport(results):
    for got, want in zip(results['port'], results['compact']):
        _assert_same_but_margin(got, want)
        assert abs(got[5] - want[5]) <= 1 / 500


def test_batch_matches_port_single_pair(results):
    for got, want in zip(results['port'], results['single']):
        _assert_same_but_margin(got, want)
        np.testing.assert_allclose(got[5], want[5], rtol=1e-3)


def _assert_own_arrays(pairs, stacks, npads, caller):
    """Each pair's two streams extracted once, off the calling thread,
    from the pair's own PCM arrays (identity, as the benchmark's probes
    match them), into the stacks a direct call makes."""
    assert len(stacks) == 2 * len(pairs)
    for (v, a), npad in zip(pairs, npads):
        for pcm in (v, a):
            (stack, thread), = [(f, t) for x, f, t in stacks if x is pcm]
            assert thread != caller
            np.testing.assert_array_equal(
                stack, tapi.host_features_padded(pcm, pcm.shape[1],
                                                 npad)[0])


def test_batch_stacks_are_made_from_the_pairs_own_arrays(pairs, results):
    npads = [max(tapi._bucket_pad(v.shape[1] // 210),
                 tapi._bucket_pad(a.shape[1] // 210)) for v, a in pairs]
    _assert_own_arrays(pairs, results['stacks'], npads,
                       threading.get_ident())


def test_sharded_stacks_are_made_from_the_pairs_own_arrays(pairs,
                                                           monkeypatch):
    """The mesh route: each group's common bucket, the same feature pool."""
    stacks = []
    monkeypatch.setattr(tapi, 'host_features_padded',
                        _recording(tapi.host_features_padded, stacks))
    got = tapi.align_batch_from_pcm(pairs[:2], device='cpu',
                                    mesh=['cpu'] * 2)
    monkeypatch.undo()
    assert len(got) == 2
    npad = max(max(tapi._bucket_pad(v.shape[1] // 210),
                   tapi._bucket_pad(a.shape[1] // 210))
               for v, a in pairs[:2])
    _assert_own_arrays(pairs[:2], stacks, [npad] * 2,
                       threading.get_ident())


@pytest.mark.parametrize("device_depth", [0, 1, 4])
def test_features_start_ahead_of_the_dispatch(device_depth, monkeypatch):
    """With extraction that sleeps: pair i+1's extraction starts before
    pair i's dispatch returns, no extraction starts more than
    max(2, device_depth + 1) pairs beyond the last dispatch returned, and
    each dispatch gets its own pair's stacks, in input order."""
    n, depth = 9, max(2, device_depth + 1)
    pairs = [(np.full((1, 210 * 50), j, np.int16),
              np.full((2, 210 * 60), j, np.int16)) for j in range(n)]
    which = {id(x): j for j, pair in enumerate(pairs) for x in pair}
    events, lock = [], threading.Lock()

    def log(kind, j):
        with lock:
            events.append((kind, j))

    def sleeping(pcm_i16, true_samples=None, npad=None, frontend='cascade'):
        log('start', which[id(pcm_i16)])
        time.sleep(0.02)
        return (np.full((5, npad), pcm_i16[0, 0], np.float32),
                true_samples // 210)

    def dispatch(video, audio, sv, sa, npad, device):
        dev_av, fa, fv, na, nv = tapi._upload_pair_features(video, audio,
                                                            npad, device)
        time.sleep(0.03)
        log('dispatched', int(fv[0, 0]))
        assert fa[0, 0] == fv[0, 0] and (nv, na) == (50, 60)
        return int(fv[0, 0]), None

    monkeypatch.setattr(tapi, 'host_features_padded', sleeping)
    got = tapi._pipelined(
        pairs, [(v.shape[1], a.shape[1]) for v, a in pairs], dispatch,
        lambda parts, sv, sa, device: parts, 2, device_depth,
        [torch.device('cpu')], 'cascade')
    assert got == list(range(n))
    order = {e: k for k, e in enumerate(events)}
    assert sorted(j for kind, j in events if kind == 'start') == sorted(
        list(range(n)) * 2)
    for i in range(n - 1):
        assert order[('start', i + 1)] < order[('dispatched', i)]
    returned = 0
    for kind, j in events:
        if kind == 'dispatched':
            returned += 1
        else:
            assert j - returned <= depth


def test_batch_prints_nothing(pairs, capsys):
    capsys.readouterr()
    tapi.align_batch_from_pcm(pairs[:1], device='cpu')
    assert capsys.readouterr().out == ""


def test_batch_padded_pcm_with_true_samples(pairs, results):
    """combine()'s directory mode passes decoded PCM and its true lengths;
    padded arrays with true_samples give the unpadded results."""
    padded = [(tapi._pad_pcm_i16(v), tapi._pad_pcm_i16(a))
              for v, a in pairs[:2]]
    lens = [(v.shape[1], a.shape[1]) for v, a in pairs[:2]]
    assert padded[0][0].shape[1] > lens[0][0]
    got = tapi.align_batch_from_pcm(padded, true_samples=lens, device='cpu')
    for g, want in zip(got, results['plain']):
        _assert_same_but_margin(g, want)
        assert g[5] == want[5]


@pytest.mark.parametrize("kw", [dict(device_depth=1), dict(host_workers=1),
                                dict(device_depth=1, host_workers=1)])
def test_batch_depth_and_workers_do_not_change_results(pairs, results, kw):
    got = tapi.align_batch_from_pcm(pairs[:2], device='cpu', **kw)
    for g, want in zip(got, results['plain']):
        _assert_same_but_margin(g, want)
        assert g[5] == want[5]


def test_dense_buffer_byte_equal_to_jax():
    """concat_chunks_with_starts on the same chunks, starts and margin:
    the same bytes, and the host split gives them back."""
    rng = np.random.default_rng(4)
    w = 2415
    chunks = [rng.integers(-32768, 32768, (rows, w), dtype=np.int16)
              for rows in (256, 256, 41)]
    starts = rng.integers(0, 2**20, (2, 768), dtype=np.int32)
    margin = np.float32(0.41234)
    want = np.asarray(jm.concat_chunks_with_starts(
        [np.asarray(c) for c in chunks], starts, margin))
    got = tm.concat_chunks_with_starts(
        [torch.from_numpy(c) for c in chunks], torch.from_numpy(starts),
        torch.tensor(margin))
    assert got.dtype == torch.int16 and tuple(got.shape) == (553, w + 6)
    assert got.numpy().tobytes() == want.tobytes()
    packed, starts_tracks, m = tapi._pull_dense_parts(got.numpy(), 2)
    np.testing.assert_array_equal(packed, np.concatenate(chunks))
    np.testing.assert_array_equal(starts_tracks, starts[:, :553])
    assert m == float(np.float16(margin)) == jm.margin_from_i16(want[0, w])
    assert tm.margin_from_i16(want[5, w]) == m


def test_match_stream_pair_is_match_stream(pairs):
    v, a = pairs[0]
    sv, sa = v.shape[1], a.shape[1]
    npad = max(tapi._bucket_pad(sv // 210), tapi._bucket_pad(sa // 210))
    fv, nv = tapi.host_features_padded(v, sv, npad)
    fa, na = tapi.host_features_padded(a, sa, npad)
    fav = torch.from_numpy(np.stack([fa, fv]).astype(np.float16))
    pair = tm.match_stream_pair(fav, na, nv)
    single = tm.match_stream(fav[0], na, fav[1], nv)
    assert pair[2] == single[2] == len(pair[0])
    for x, y in zip(pair[0], single[0]):
        assert torch.equal(x, y)
    assert torch.equal(pair[1], single[1]) and pair[3] == single[3]
    # the last chunk is trimmed to the true block count
    assert sum(c.shape[0] for c in pair[0]) == tm.nb_for(npad)


def test_matcher_error_aborts_the_batch_and_leaves_no_thread(pairs,
                                                            monkeypatch):
    """A matcher error in pair 2 of 3 reaches the caller; the call returns
    with no pool thread left, whether the dispatching thread, a pool
    thread (the retry's matcher) or a feature thread raised."""
    real = tm.match_stream_pair
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("match_stream_pair: forced failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(tm, 'match_stream_pair', failing)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="forced failure"):
        tapi.align_batch_from_pcm(pairs, device='cpu', device_depth=1)
    assert len(calls) == 2                   # pair 3 was never dispatched
    assert threading.active_count() == before
    monkeypatch.setattr(tm, 'match_stream_pair', real)

    # the same from a pool thread: the retry's matcher fails
    def failing_retry(*args, **kwargs):
        raise RuntimeError("fine_match: forced launch failure")

    monkeypatch.setattr(tapi, '_coarse_retry', failing_retry)
    monkeypatch.setattr(tm, 'COARSE_MARGIN_FLOOR', 1e9)
    with pytest.raises(RuntimeError, match="forced launch failure"):
        tapi.align_batch_from_pcm(pairs[:2], device='cpu')
    assert threading.active_count() == before
    monkeypatch.undo()

    # the same from the feature pool: pair 2's description fails, on one
    # card and on a mesh
    real_features = tapi.host_features_padded

    def failing_features(pcm_i16, *args, **kwargs):
        if pcm_i16 is pairs[1][1]:
            raise RuntimeError("extract_features_i16: forced failure")
        return real_features(pcm_i16, *args, **kwargs)

    monkeypatch.setattr(tapi, 'host_features_padded', failing_features)
    for kw in (dict(device='cpu'), dict(mesh=['cpu'] * 2)):
        with pytest.raises(RuntimeError, match="extract_features_i16"):
            tapi.align_batch_from_pcm(pairs, device_depth=1, **kw)
        assert threading.active_count() == before


def test_batch_defaults_to_cuda_and_names_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the batch would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.align_batch_from_pcm([])
