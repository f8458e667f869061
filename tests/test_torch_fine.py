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


def test_top8_membership_turns_on_rounding_sized_changes():
    """Where more than TOP_K candidates of a row have equal quality, which
    8 are kept is decided by differences of the size of a rounding error:
    a video band that repeats one pattern gives every audio frame 28 equal
    candidates (columns l, l+P, ...), and scaling the band's later part by
    1 +/- 4e-7 (norms unchanged, so those correlations move by 4e-7, and
    the qualities by under 1e-4 relative) moves the whole top-8 there or
    leaves it on the first columns. The CUDA kernel's qualities differ
    from the plain version's by more than that on the card (3xTF32
    products, another summation order), so on inputs with near-equal
    candidates the two may keep different ones of equal quality; the card
    check counts such ties apart from other differences."""
    period, npad, cut = 20, 1024, 300
    rng = np.random.default_rng(6)
    pattern = rng.standard_normal((5, period)).astype(np.float32)
    ms_v = np.ascontiguousarray(np.tile(pattern, (1, npad // period + 1))
                                [:, :npad])
    ms_a = (ms_v + 0.33 * rng.standard_normal(ms_v.shape)).astype(np.float32)

    def norms_of(ms):
        sq = np.pad(ms.astype(np.float64) ** 2, ((0, 0), (0, jpre.WINDOW)))
        csum = np.concatenate([np.zeros((5, 1)), np.cumsum(sq, axis=1)], 1)
        return np.sqrt(csum[:, jpre.WINDOW:jpre.WINDOW + npad]
                       - csum[:, :npad]).astype(np.float32)

    mask = np.ones(npad, np.float32)
    starts = np.zeros(1, np.int32)
    t = torch.from_numpy
    runs = []
    for delta in (-4e-7, 4e-7):
        moved = ms_v.copy()
        moved[:, cut:] *= np.float32(1 + delta)
        q, o = tfk.fine_match(t(ms_a), t(norms_of(ms_a)), t(mask), t(moved),
                              t(norms_of(ms_v)), t(mask), t(starts),
                              t(starts))
        runs.append((q[0].numpy(), o[0].numpy()))
    (q_lo, o_lo), (q_hi, o_hi) = runs
    assert (q_lo > 0).all() and (q_lo < jm.QUAL_MAX).all()
    # scaled down, the later copies lose: the first 8 columns stay
    first = np.arange(jm.BLOCK)[:, None] + period * np.arange(jm.TOP_K)
    np.testing.assert_array_equal(o_lo, first)
    # scaled up, they win: every kept column lies past the cut
    assert (o_hi + jpre.WINDOW > cut).all()
    assert (o_hi != o_lo).mean() > 0.9
    # and the qualities hardly moved
    assert np.abs(q_hi / q_lo - 1).max() < 1e-4


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


# --- the CUDA kernel's arithmetic, emulated in torch ------------------------
# csrc/fine_match.cu computes the correlations on the tensor cores in
# 3xTF32 and keeps a top-8 per (thread, row) that a quad of lanes merges.
# The emulation below follows it step by step on the CPU: values split into
# tf32 hi/lo by bit rounding, K = 41 taps padded to 48 with zero B rows, six
# k-steps of lo*hi + hi*lo + hi*hi in fp32, each added to the sum, the
# log-space epilogue, then the per-thread top-8 over the C fragment's
# columns and the quad merge.

MT_ROWS = 224                   # 14 row tiles of 16
K_PAD = 48                      # 6 k-steps of 8


def tf32_rna(x):
    """cvt.rna.tf32.f32: round an f32 tensor to 10 mantissa bits, ties
    away from zero (add half an ulp to the magnitude bits, truncate)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _emulated_block(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, a0, v0):
    """One CTA of the kernel: (quals (210, 8), offs (210, 8))."""
    rows = torch.arange(MT_ROWS)
    taps = torch.arange(K_PAD)
    a_win = ms_a[:, a0 + rows[:, None] + taps[None, :]]        # (5, 224, 48)
    cols = torch.nonzero(v_mask[v0:v0 + tfk.FINE_W] > 0)[:, 0]
    ncol = len(cols)
    n_pos = -(-max(ncol, 1) // 8) * 8
    cols = torch.nn.functional.pad(cols, (0, n_pos - ncol))    # pad: col 0
    pos = torch.arange(n_pos)
    v_win = ms_v[:, v0 + cols[None, :] + torch.clamp(taps, max=40)[:, None]]
    v_win[:, jpre.WINDOW:, :] = 0.0                            # taps 41-47
    a_hi, a_lo = split_tf32(a_win)
    v_hi, v_lo = split_tf32(v_win)
    acc = torch.zeros((5, MT_ROWS, n_pos), dtype=torch.float32)
    for ks in range(K_PAD // 8):
        # a k-step's three products from zero, then one fp32 add
        k = slice(8 * ks, 8 * ks + 8)
        part = a_lo[:, :, k] @ v_hi[:, k, :]
        part = part + a_hi[:, :, k] @ v_lo[:, k, :]
        part = part + a_hi[:, :, k] @ v_hi[:, k, :]
        acc = acc + part
    ra = 1.0 / norms_a[:, a0 + rows]
    rv = torch.where(pos < ncol, 1.0 / norms_v[:, v0 + cols],
                     torch.zeros(()))
    corr = acc * (ra[:, :, None] * rv[:, None, :])
    p3 = torch.clamp(1.0 - corr[0], min=1e-8)
    p3 = p3 * torch.clamp(1.0 - corr[1], min=1e-8)
    p3 = p3 * torch.clamp(1.0 - corr[2], min=1e-8)
    bmax = torch.maximum(corr[3], corr[4])
    lp = torch.log(p3)
    am = torch.where(rows < jm.BLOCK, a_mask[a0 + rows], torch.zeros(()))
    valid = ((am > 0)[:, None] & (pos < ncol)[None, :]
             & (cols[None, :] >= rows[:, None])
             & (cols[None, :] <= rows[:, None] + 2 * jm.FINE_HALF_BAND)
             & (bmax >= 0.2) & (lp <= tfk.LOG_CUT))
    q = torch.where(valid, torch.clamp(
        1e-4 * torch.exp(tfk.EXP_COEF * lp), max=jm.QUAL_MAX),
        torch.zeros(()))

    # thread t of a quad holds columns 2t, 2t+1 of every n8 tile, walked in
    # ascending order; it inserts on a strictly greater quality, so its list
    # is the stable descending sort of its qualities, zeros left empty
    heads = []
    for t in range(4):
        mine = pos[(pos % 8) // 2 == t]
        tq, idx = torch.sort(q[:, mine], dim=1, descending=True, stable=True)
        te = cols[mine][idx]
        tq = torch.nn.functional.pad(tq[:, :jm.TOP_K],
                                     (0, max(0, jm.TOP_K - tq.shape[1])))
        te = torch.nn.functional.pad(te[:, :jm.TOP_K],
                                     (0, max(0, jm.TOP_K - te.shape[1])))
        heads.append([tq, torch.where(tq > 0, te,
                                      torch.zeros((), dtype=te.dtype))])
    # quad merge: 8 arg-max rounds by (quality desc, column asc); the owner
    # of a live winner pops it
    out_q = torch.zeros((MT_ROWS, jm.TOP_K))
    out_e = torch.zeros((MT_ROWS, jm.TOP_K), dtype=torch.int64)
    r = torch.arange(MT_ROWS)
    ptr = [torch.zeros(MT_ROWS, dtype=torch.int64) for _ in range(4)]

    def head(t):
        tq, te = heads[t]
        live = ptr[t] < jm.TOP_K
        i = torch.clamp(ptr[t], max=jm.TOP_K - 1)
        return (torch.where(live, tq[r, i], torch.zeros(())),
                torch.where(live, te[r, i], torch.zeros((), dtype=te.dtype)))

    for k in range(jm.TOP_K):
        cand = [head(t) for t in range(4)]
        bq, be = cand[0]
        owner = torch.zeros(MT_ROWS, dtype=torch.int64)
        for t in range(1, 4):
            cq, ce = cand[t]
            win = (cq > bq) | ((cq == bq) & (ce < be))
            bq, be = torch.where(win, cq, bq), torch.where(win, ce, be)
            owner = torch.where(win, t, owner)
        out_q[:, k], out_e[:, k] = bq, be
        for t in range(4):
            ptr[t] = ptr[t] + ((owner == t) & (bq > 0)).long()
    return out_q[:jm.BLOCK], out_e[:jm.BLOCK].to(torch.int32)


def emulate_fine_kernel(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask,
                        v_starts, a_starts):
    """fine_match's outputs as the CUDA kernel computes them (numpy in,
    numpy out)."""
    t = [torch.tensor(np.asarray(x, np.float32))
         for x in (ms_a, norms_a, a_mask, ms_v, norms_v, v_mask)]
    npad = t[0].shape[1]
    a_starts = np.clip(a_starts, 0, npad - tfk.SEG_A)
    v_starts = np.clip(v_starts, 0, npad - tfk.SEG_V)
    quals, offs = zip(*(_emulated_block(*t, int(a0), int(v0))
                        for a0, v0 in zip(a_starts, v_starts)))
    return torch.stack(quals).numpy(), torch.stack(offs).numpy()


def test_tf32_split_rounds_half_away():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                      1 + 3 * 2 ** -11, 0.0, 3.1415927, -1e-30],
                     dtype=torch.float32)
    hi = tf32_rna(x)
    assert hi[0] == 1 + 2 ** -10 and hi[1] == -(1 + 2 ** -10)
    assert hi[2] == 1.0 and hi[3] == 1 + 2 ** -9 and hi[4] == 0.0
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(100000)
                          * 10.0 ** rng.integers(-6, 6, 100000))
                         .astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not torch.any(part.view(torch.int32) & 0x1FFF)
    # hi + lo carries 22 of the 24 bits: |x - hi - lo| <= 2^-22 |x|
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(resid <= 2.0 ** -22 * x.double().abs())
    # hi * hi + hi * lo + lo * hi: each product is exact in f32
    y = torch.flip(x, [0])
    yh, yl = split_tf32(y)
    for a, b in ((hi, yh), (hi, yl), (lo, yh)):
        assert torch.equal((a.double() * b.double()).float().double(),
                           a.double() * b.double())


def test_emulated_kernel_matches_xla(small_pair):
    p = small_pair
    q, o = emulate_fine_kernel(p['ms_a'], p['norms_a'], p['a_mask'],
                               p['ms_v'], p['norms_v'], p['v_mask'],
                               p['starts'], p['a_starts'])
    assert q.shape == (len(p['starts']), jm.BLOCK, jm.TOP_K)
    _assert_same_candidates(p['xla_quals'], p['xla_vids'], q,
                            p['starts'][:, None, None] + o)


def test_emulated_kernel_matches_xla_on_jax_state():
    """Both tracks of the 45-s pair's JAX coarse state: the emulated kernel
    against the JAX package's XLA fine path (matching._fine_block)."""
    import jax

    video, audio, _ = build_pair(content_seconds=45.0,
                                 narration=((15.0, 3.0), (30.0, 4.0)),
                                 seed=7)
    v = np.clip(video, -32768, 32767).astype(np.int16)
    a = np.clip(audio, -32768, 32767).astype(np.int16)
    npad = max(japi._bucket_pad(v.shape[1] // 210),
               japi._bucket_pad(a.shape[1] // 210))
    fv, nv = japi.host_features_padded(v, v.shape[1], npad)
    fa, na = japi.host_features_padded(a, a.shape[1], npad)
    ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts, _ = [
        np.asarray(s) for s in jm.match_coarse(fa.astype(np.float16), na,
                                               fv.astype(np.float16), nv)]
    nb = jm.nb_for(npad)
    blocks = np.arange(nb, dtype=np.int32)

    @jax.jit
    def xla(track_starts):
        return jax.lax.map(lambda x: jm._fine_block(
            ms_a, norms_a, ms_v, norms_v, a_mask, v_mask, x[0], x[1]),
            (blocks, track_starts))

    for t in range(starts.shape[0]):
        jq, jo = (np.asarray(x) for x in xla(starts[t, :nb]))
        q, o = emulate_fine_kernel(ms_a, norms_a, a_mask, ms_v, norms_v,
                                   v_mask, starts[t, :nb], blocks * jm.BLOCK)
        vs = starts[t, :nb, None, None]
        _assert_same_candidates(jq, vs + jo.astype(np.int32), q, vs + o)


def test_emulated_kernel_ties_take_first_columns():
    """test_topk_ties_take_first_columns's band through the emulated
    kernel: more than TOP_K columns tied at QUAL_MAX, the lowest win."""
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
    q, o = emulate_fine_kernel(ms, norms, mask, ms, norms, mask, starts,
                               starts)
    want = np.arange(jm.BLOCK)[:, None] + period * np.arange(jm.TOP_K)
    np.testing.assert_array_equal(q[0], jm.QUAL_MAX)
    np.testing.assert_array_equal(o[0], want)
