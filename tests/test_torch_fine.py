"""Port parity: the fine pass, JAX vs torch on the CPU.

`fine_match_plain` (the CPU path of the port's fine_match, and the plain
version the CUDA kernel is held against on the card) is compared with the
JAX package's XLA path and with its Pallas kernel in interpret mode as
candidate sets keyed by (block, frame, video frame), with the 99th
percentile relative quality error below 1e-3 - the bar of
tests/test_parallel.py::test_fine_kernel_matches_xla (the contraction order
differs, so near-equal qualities may reorder within a row's top-K).
"""
import numpy as np
import pytest
import torch

from describealign_tpu.alignment import api as japi
from describealign_tpu.alignment import matching as jm
from describealign_tpu.alignment import preprocess as jpre
from describealign_tpu.ops.features import extract_features
from describealign_tpu.ops.fine_kernel import fine_match_fused
from describealign_tpu.utils.synthmedia import build_pair
from describealign_tpu_torch.alignment import matching as tm
from describealign_tpu_torch.ops import fine_kernel as tfk
from describealign_tpu_torch.state import state_from_numpy


def _key_qual(q, v):
    nzb, nzl, nzk = np.nonzero(q > 0)
    return dict(zip(zip(nzb.tolist(), nzl.tolist(),
                        v[nzb, nzl, nzk].tolist()),
                    q[nzb, nzl, nzk].tolist()))


def _assert_same_candidates(q_ref, v_ref, q_got, v_got):
    ref = _key_qual(q_ref, v_ref)
    got = _key_qual(q_got, v_got)
    assert len(ref) > 100
    assert set(got) == set(ref)
    err = np.array([abs(got[k] - ref[k]) for k in ref])
    rel = err / np.array([ref[k] for k in ref])
    assert np.percentile(rel, 99) < 1e-3
    # the worst candidate too: qualities reach QUAL_MAX=50
    assert err.max() < 1e-2, err.max()


@pytest.fixture(scope='module')
def small_pair():
    """tests/test_parallel.py::test_fine_kernel_matches_xla's inputs."""
    video, audio, _ = build_pair(content_seconds=14.0, narration=(),
                                 lead_in=2.0, seed=0)
    fs_a = [np.asarray(f) for f in extract_features(audio)]
    fs_v = [np.asarray(f) for f in extract_features(video)]
    na = min(len(f) for f in fs_a)
    nv = min(len(f) for f in fs_v)
    npad = 210 * 20
    fa = japi._stack_padded(fs_a, na, npad)
    fv = japi._stack_padded(fs_v, nv, npad)
    ms_a, norms_a = (np.asarray(x) for x in jpre.preprocess_features(fa))
    ms_v, norms_v = (np.asarray(x) for x in jpre.preprocess_features(fv))
    quals, vids, centers, _ = jm.match_pair(ms_a, norms_a, fa[0], na,
                                            ms_v, norms_v, fv[0], nv)
    nb = centers.shape[0]
    a_mask = np.asarray(jpre.valid_audio_mask(fa[0], na), np.float32)
    v_mask = np.asarray(jpre.valid_video_mask(fv[0], nv), np.float32)
    starts = np.clip(np.arange(nb, dtype=np.int32) * jm.BLOCK
                     + np.asarray(centers) - jm.FINE_HALF_BAND, 0,
                     npad - (jm.FINE_W + jpre.WINDOW - 1)).astype(np.int32)
    a_starts = np.arange(nb, dtype=np.int32) * jm.BLOCK
    return dict(ms_a=ms_a, norms_a=norms_a, a_mask=a_mask, ms_v=ms_v,
                norms_v=norms_v, v_mask=v_mask, starts=starts,
                a_starts=a_starts,
                xla_quals=np.asarray(quals)[:, :, :jm.TOP_K],
                xla_vids=np.asarray(vids)[:, :, :jm.TOP_K])


def _plain(p, starts, a_starts):
    t = {k: torch.from_numpy(np.ascontiguousarray(p[k]))
         for k in ('ms_a', 'norms_a', 'a_mask', 'ms_v', 'norms_v', 'v_mask')}
    q, o = tfk.fine_match(t['ms_a'], t['norms_a'], t['a_mask'], t['ms_v'],
                          t['norms_v'], t['v_mask'], torch.from_numpy(starts),
                          torch.from_numpy(a_starts))
    return q.numpy(), o.numpy()


def test_fine_plain_matches_xla(small_pair):
    p = small_pair
    q, o = _plain(p, p['starts'], p['a_starts'])
    assert q.shape == (len(p['starts']), jm.BLOCK, jm.TOP_K)
    assert o.dtype == np.int32
    _assert_same_candidates(p['xla_quals'], p['xla_vids'], q,
                            p['starts'][:, None, None] + o)


def test_fine_plain_matches_pallas_interpret(small_pair):
    p = small_pair
    q, o = _plain(p, p['starts'], p['a_starts'])
    qp, op = fine_match_fused(p['ms_a'], p['norms_a'], p['a_mask'],
                              p['ms_v'], p['norms_v'], p['v_mask'],
                              p['starts'], p['a_starts'], interpret=True)
    vp = p['starts'][:, None, None] + np.asarray(op)
    _assert_same_candidates(np.asarray(qp), vp, q,
                            p['starts'][:, None, None] + o)
    # chunk configuration: blocks 2.. with a nonzero first audio start
    q2, o2 = _plain(p, p['starts'][2:], p['a_starts'][2:])
    np.testing.assert_array_equal(q2, q[2:])
    np.testing.assert_array_equal(o2, o[2:])
    qp2, op2 = fine_match_fused(p['ms_a'], p['norms_a'], p['a_mask'],
                                p['ms_v'], p['norms_v'], p['v_mask'],
                                p['starts'][2:], p['a_starts'][2:],
                                interpret=True)
    _assert_same_candidates(np.asarray(qp2),
                            p['starts'][2:, None, None] + np.asarray(op2),
                            q2, p['starts'][2:, None, None] + o2)


def test_topk_ties_take_first_columns():
    """More than TOP_K columns tied at QUAL_MAX: the lowest columns win, in
    ascending order (QUAL_MAX clamps many candidates to equal quality, so
    the tie order is load-bearing). A video band that repeats one period-P
    pattern matches every audio frame exactly at columns l, l+P, ..."""
    period, npad = 20, 1024
    rng = np.random.default_rng(4)
    pattern = rng.standard_normal((5, period)).astype(np.float32)
    ms = np.ascontiguousarray(np.tile(pattern, (1, npad // period + 1))
                              [:, :npad])
    sq = np.pad(ms.astype(np.float64) ** 2, ((0, 0), (0, jpre.WINDOW)))
    csum = np.concatenate([np.zeros((5, 1)), np.cumsum(sq, axis=1)], axis=1)
    norms = np.sqrt(csum[:, jpre.WINDOW:jpre.WINDOW + npad]
                    - csum[:, :npad]).astype(np.float32)
    mask = np.ones(npad, np.float32)
    starts = np.zeros(1, np.int32)
    t = torch.from_numpy
    q, o = tfk.fine_match(t(ms), t(norms), t(mask), t(ms), t(norms), t(mask),
                          t(starts), t(starts))
    want = np.arange(jm.BLOCK)[:, None] + period * np.arange(jm.TOP_K)
    np.testing.assert_array_equal(q[0].numpy(), jm.QUAL_MAX)
    np.testing.assert_array_equal(o[0].numpy(), want)
    # the JAX package's XLA path (lax.top_k) picks the same columns
    jq, jo = jm._fine_block(ms, norms, ms, norms, mask > 0, mask > 0, 0, 0)
    np.testing.assert_array_equal(np.asarray(jq), jm.QUAL_MAX)
    np.testing.assert_array_equal(np.asarray(jo), want)


def test_u8_codes_and_packing_bit_equal():
    """The u8 quality grid, its decode and the packed transport words are
    bit-equal on equal inputs (boundary values of the f16 grid included)."""
    rng = np.random.default_rng(2)
    q = rng.uniform(0.0, 50.0, (3, 210, 8)).astype(np.float32)
    q[0, 0, :8] = [0.0, 1e-8, 0.033, 0.0464, 49.99, 50.0, -1.0, 12.5]
    q[q < 5] = 0.0                      # empty slots, as in real rows
    edges = (np.arange(0x4000 // 64) * 64 + 0x20).astype(np.uint16)
    q[1].reshape(-1)[:len(edges)] = edges.view(np.float16).astype(np.float32)
    o = rng.integers(0, 768, (3, 210, 8)).astype(np.int32)
    codes_j = np.asarray(jm._qual_quantize_u8(q))
    codes_t = tm._qual_quantize_u8(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(codes_t, codes_j)
    np.testing.assert_array_equal(
        tm._qual_dequantize_f16(torch.from_numpy(codes_j)).numpy().view(
            np.uint16),
        np.asarray(jm._qual_dequantize_f16(codes_j)).view(np.uint16))
    for k in (8, 4):
        packed_j = np.asarray(jm._pack_slots(q[:, :, :k],
                                             o[:, :, :k].astype(np.int16)))
        packed_t = tm._pack_slots(torch.from_numpy(q[:, :, :k]),
                                  torch.from_numpy(o[:, :, :k])).numpy()
        assert packed_t.dtype == np.int16
        np.testing.assert_array_equal(packed_t, packed_j)


def _live(packed, starts_grouped, b0):
    """Live candidates of one packed chunk, decoded by the JAX package's
    api._unpack_chunk: {(block, frame, video frame): u8 code}."""
    q1, o1, q2, o2 = japi._unpack_chunk(packed, jm.TOP_K, jm.TOP_K // 2)
    out = {}
    for q, o, frame_step, group in ((q1, o1, 1, 0), (q2, o2, 2, 2)):
        b, l, k = np.nonzero(q)
        vid = starts_grouped[b0 + b, group] + o[b, l, k]
        out.update(zip(zip((b0 + b).tolist(), (l * frame_step).tolist(),
                           vid.tolist()), q[b, l, k].tolist()))
    return out


def test_match_fine_chunk_from_jax_state(monkeypatch):
    """The fine half on the JAX coarse state, over several chunks (the last
    one carries padded blocks): the packed chunks decode to the same live
    candidates as the JAX package's chunks."""
    video, audio, _ = build_pair(content_seconds=45.0,
                                 narration=((15.0, 3.0), (30.0, 4.0)),
                                 seed=7)
    v = np.clip(video, -32768, 32767).astype(np.int16)
    a = np.clip(audio, -32768, 32767).astype(np.int16)
    npad = max(japi._bucket_pad(v.shape[1] // 210),
               japi._bucket_pad(a.shape[1] // 210))
    fv, nv = japi.host_features_padded(v, v.shape[1], npad)
    fa, na = japi.host_features_padded(a, a.shape[1], npad)
    fa, fv = fa.astype(np.float16), fv.astype(np.float16)
    monkeypatch.setattr(jm, 'FINE_CHUNK', 32)
    monkeypatch.setattr(tm, 'FINE_CHUNK', 32)
    jm.match_coarse.clear_cache()
    jm.match_fine_chunk.clear_cache()
    try:
        j_state = [np.asarray(s) for s in jm.match_coarse(fa, na, fv, nv)]
        nb = jm.nb_for(npad)
        t_state = state_from_numpy(j_state, 'cpu')
        starts = j_state[6]
        grouped = np.stack([starts[0], starts[0], starts[1]], axis=1)
        n_chunks = starts.shape[1] // 32
        assert n_chunks >= 2 and nb % 32
        n_live = 0
        for c in range(n_chunks):
            jc = np.asarray(jm.match_fine_chunk(*j_state[:7], c * 32, nb))
            tc = tm.match_fine_chunk(*t_state[:7], c * 32, nb).numpy()
            assert tc.shape == jc.shape and tc.dtype == np.int16
            live_j = _live(jc, grouped, c * 32)
            live_t = _live(tc, grouped, c * 32)
            assert set(live_t) == set(live_j)
            flips = sum(live_t[k] != live_j[k] for k in live_j)
            # codes agree except where an f32 ulp of difference straddles
            # a u8 grid boundary (~3e-5 per candidate)
            assert flips <= max(2, len(live_j) // 5000), flips
            n_live += len(live_j)
        assert n_live > 1000
    finally:
        jm.match_coarse.clear_cache()
        jm.match_fine_chunk.clear_cache()
