"""Card-only checks of the CUDA kernels against their plain versions, and
of the batch path against the single-pair path.

Marked `cuda`: they skip where CUDA is unavailable. On an H100 (which has
no jax, and tests/conftest.py imports jax) run them without the conftest:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
chip_smoke.py makes the same comparison at the bench pair's full size.
"""
import numpy as np
import pytest
import torch

from describealign_tpu_torch.utils.synthmedia import build_pair

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(device):
    from describealign_tpu_torch.alignment import api, matching
    video, audio, _ = build_pair(content_seconds=45.0,
                                 narration=((15.0, 3.0), (30.0, 4.0)),
                                 lead_in=3.0, seed=7)
    v = np.clip(video, -32768, 32767).astype(np.int16)
    a = np.clip(audio, -32768, 32767).astype(np.int16)
    npad = max(api._bucket_pad(v.shape[1] // 210),
               api._bucket_pad(a.shape[1] // 210))
    fv, nv = api.host_features_padded(v, v.shape[1], npad)
    fa, na = api.host_features_padded(a, a.shape[1], npad)
    return matching.match_coarse(api._upload(fa, device), na,
                                 api._upload(fv, device), nv)


def test_fine_kernel_matches_plain_on_card(cuda_device):
    from describealign_tpu_torch.alignment import matching
    from describealign_tpu_torch.ops import fine_kernel as fk
    state = _state(cuda_device)
    ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts, _ = state
    nb = matching.nb_for(ms_a.shape[1])
    # one chunk past the true block count: padded blocks clamp their start
    a_starts = (torch.arange(nb + 5, dtype=torch.int32,
                             device=cuda_device) * matching.BLOCK)
    for t in range(starts.shape[0]):
        v_starts = starts[t, :nb + 5].contiguous()
        args = (ms_a, norms_a, a_mask.float(), ms_v, norms_v, v_mask.float(),
                v_starts, a_starts)
        before = fk.fine_match.launches
        qk, ok = fk.fine_match(*args)
        torch.cuda.synchronize()
        assert fk.fine_match.launches == before + 1
        qp, op = fk.fine_match_plain(*args)
        vk = (v_starts[:, None, None] + ok).cpu().numpy()
        vp = (v_starts[:, None, None] + op).cpu().numpy()
        qk, qp = qk.cpu().numpy(), qp.cpu().numpy()

        def keyed(q, v):
            b, l, k = np.nonzero(q[:nb] > 0)
            return dict(zip(zip(b.tolist(), l.tolist(), v[b, l, k].tolist()),
                            q[b, l, k].tolist()))
        dk, dp = keyed(qk, vk), keyed(qp, vp)
        assert len(dp) > 1000 and set(dk) == set(dp)
        err = np.array([abs(dk[k] - dp[k]) for k in dp])
        rel = err / np.array([dp[k] for k in dp])
        assert np.percentile(rel, 99) < 1e-3
        # the worst candidate too: qualities reach QUAL_MAX=50
        assert err.max() < 1e-2
        # and relative: an error of the correlation counts in units of
        # 1 - corr (chip_smoke.py's MAX_REL)
        assert rel.max() < 2e-3


def test_streamed_dp_matches_materialized_on_card(cuda_device):
    """The streamed coarse DP (long media) against the materialized one on
    CUDA tensors, k-best with suppression: bit-equal paths and scores (the
    same tiles, relaxations and backsteps in the same order)."""
    from describealign_tpu_torch.alignment import matching as tm
    rng = np.random.default_rng(5)
    nb, kv = 150, 1200
    desc_a = torch.from_numpy(rng.standard_normal(
        (nb * tm.COARSE_PER_BLOCK + 3, 128)).astype(np.float32)).to(cuda_device)
    desc_v = [torch.from_numpy(rng.standard_normal((kv, 128)).astype(
        np.float32)).to(cuda_device) for _ in tm.SUB_LANE_SHIFTS]
    s_paths, s_scores = tm._k_best_tracks(desc_a, desc_v, nb, streamed=True)
    m_paths, m_scores = tm._k_best_tracks(desc_a, desc_v, nb, streamed=False)
    for sp, mp in zip(s_paths, m_paths):
        assert torch.equal(sp, mp)
    assert [float(x) for x in s_scores] == [float(x) for x in m_scores]


def test_the_film_materializes_on_card(cuda_device, monkeypatch):
    """The 95-min film's feature pair through align(): its map (377.4 M
    elements, above COARSE_STREAM_ELEMS) fits an 80-GB card, so the coarse
    pass runs materialized; with the card reported full it runs streamed,
    and both give the same answer, with bit-equal coarse paths, track
    scores and margin."""
    import contextlib
    import io
    from describealign_tpu_torch import film_pair
    from describealign_tpu_torch.alignment import api
    from describealign_tpu_torch.alignment import matching as tm
    video, audio = film_pair.build_film_features()
    k_best, coarse_margin = tm._k_best_tracks, tm._coarse_margin
    runs = []

    def recorded_k_best(desc_a, desc_v, nb, streamed, mark=None):
        paths, scores = k_best(desc_a, desc_v, nb, streamed, mark)
        runs.append({'streamed': streamed,
                     'paths': [p.cpu() for p in paths],
                     'scores': [float(x) for x in scores]})
        return paths, scores

    def recorded_margin(scores, a_mask, nb):
        margin = coarse_margin(scores, a_mask, nb)
        runs[-1]['margin'] = float(margin)
        return margin

    monkeypatch.setattr(tm, '_k_best_tracks', recorded_k_best)
    monkeypatch.setattr(tm, '_coarse_margin', recorded_margin)

    def align():
        with contextlib.redirect_stdout(io.StringIO()):
            return api.align(video, audio, video[0], audio[0],
                             device=cuda_device)

    materialized = align()
    total = torch.cuda.mem_get_info(cuda_device)[1]
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda device=None: (0, total))
    monkeypatch.setattr(torch.cuda, 'memory_reserved',
                        torch.cuda.memory_allocated)
    streamed = align()
    assert [r['streamed'] for r in runs] == [False, True]
    m, s = runs
    assert all(torch.equal(a, b) for a, b in zip(m['paths'], s['paths']))
    assert m['scores'] == s['scores'] and m['margin'] == s['margin']
    assert m['margin'] > tm.COARSE_MARGIN_FLOOR
    for a, b in zip(materialized, streamed):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dp_kernels_match_plain_on_card(cuda_device):
    """dp_forward / dp_backtrace (csrc/coarse_dp.cu) against the plain
    loops on tie-heavy maps: bit-equal rows, equal paths, one launch
    counted per call, the cluster growing with the width; dp_backtrace on
    rows that trip its guard."""
    from describealign_tpu_torch.ops import coarse_dp
    rng = np.random.default_rng(12)
    for n, d in ((1, 11), (9, 33), (64, 1025), (5, 17500), (64, 61438)):
        m = (rng.integers(0, 24, (n, d)) / 8).astype(np.float32)
        lanes = np.arange(d)[None, :]
        m[np.abs(lanes - (np.arange(n) * 10 % (d - 1))[:, None]) <= 25] = -1e30
        scores = torch.from_numpy(m).to(cuda_device)
        prev = torch.from_numpy(
            (rng.integers(0, 400, d) / 8).astype(np.float32)).to(cuda_device)
        before = (coarse_dp.dp_forward.launches,
                  coarse_dp.dp_backtrace.launches)
        rows = coarse_dp.dp_forward(prev, scores)
        assert torch.equal(rows, coarse_dp.dp_forward_plain(prev, scores))
        assert coarse_dp.dp_forward.cluster == (1 if d <= 1024 else
                                                2 if d <= 2048 else 16)
        for o_last in (None, torch.tensor(int(rng.integers(0, d)),
                                          device=cuda_device)):
            path = coarse_dp.dp_backtrace(o_last, rows)
            assert torch.equal(path,
                               coarse_dp.dp_backtrace_plain(o_last, rows))
        torch.cuda.synchronize()
        assert (coarse_dp.dp_forward.launches,
                coarse_dp.dp_backtrace.launches) == (before[0] + 1,
                                                     before[1] + 2)
    host, tripped = coarse_dp.guard_rows(100, 5000, 3)
    rows = torch.from_numpy(host).to(cuda_device)
    assert tripped > 40
    assert torch.equal(coarse_dp.dp_backtrace(None, rows),
                       coarse_dp.dp_backtrace_plain(None, rows))


@pytest.mark.parametrize("nb,kv,k,b0,n", [
    (5, 7, 128, 0, 5), (70, 500, 128, 64, 6), (13, 241, 256, 0, 13),
    (130, 1000, 256, 64, 64), (200, 16638, 128, 0, 200),
    # the 64-block x 128-lane tile's edges (64 lanes above K 128)
    (13, 128, 128, 0, 13), (9, 129, 128, 0, 9), (13, 65, 256, 0, 13),
    (70, 129, 128, 0, 65), (150, 300, 128, 37, 100), (70, 161, 256, 3, 67),
    (30, 140, 96, 0, 30)])
def test_coarse_map_kernel_matches_plain_on_card(cuda_device, nb, kv, k, b0,
                                                 n):
    """block_scores (csrc/coarse_map.cu) against block_scores_plain on
    edge shapes, with no, one and two suppress paths (near lane 0 and near
    Kv): the map within rtol 1e-5 / atol 1e-4, the suppressed lanes equal,
    one launch counted per call."""
    from describealign_tpu_torch.ops import coarse_map as cm
    rng = np.random.default_rng(nb + kv)
    nb_pad = -(-nb // 64) * 64
    a = rng.standard_normal((nb_pad * 10, k)).astype(np.float32) / k ** 0.5
    a[nb * 10:] = 0
    v = rng.standard_normal((7, kv, k)).astype(np.float32) / k ** 0.5
    a, v = (torch.from_numpy(x).to(cuda_device) for x in (a, v))
    paths = torch.from_numpy(np.stack([
        rng.integers(0, 26, nb),
        rng.integers(max(0, kv - 26), kv, nb)]).astype(np.int32)).to(
        cuda_device)
    for sup in (None, paths[:1].contiguous(), paths):
        before = cm.block_scores.launches
        got = cm.block_scores(a, v, b0, n, sup)
        torch.cuda.synchronize()
        assert cm.block_scores.launches == before + 1
        want = cm.block_scores_plain(a, v, b0, n, sup)
        assert torch.equal(got == -1e30, want == -1e30)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_coarse_map_kernel_tracks_on_card(cuda_device):
    """The coarse pass of a real pair with the kernel's map and with the
    plain map: equal k-best tracks, streamed and materialized, and scores
    within rtol 1e-5."""
    from describealign_tpu_torch.alignment import matching as tm
    from describealign_tpu_torch.ops import coarse_map as cm
    state = _state(cuda_device)
    ms_a, norms_a, a_mask, ms_v, norms_v, v_mask = state[:6]
    desc_a = tm._coarse_descriptors(ms_a[:3], norms_a[:3], a_mask)
    desc_v = torch.stack([tm._coarse_descriptors(ms_v[:3], norms_v[:3],
                                                 v_mask, p)
                          for p in tm.SUB_LANE_SHIFTS])
    nb = desc_a.shape[0] // tm.COARSE_PER_BLOCK
    kernel = cm.block_scores
    try:
        cm.block_scores = cm.block_scores_plain
        plain = tm._k_best_tracks(desc_a, desc_v, nb, streamed=False)
    finally:
        cm.block_scores = kernel
    for streamed in (True, False):
        before = cm.block_scores.launches
        paths, scores = tm._k_best_tracks(desc_a, desc_v, nb, streamed)
        torch.cuda.synchronize()
        tiles = -(-nb // tm.COARSE_CHUNK)
        assert cm.block_scores.launches - before == (
            2 * tiles * tm.N_TRACKS if streamed else 1)
        for p, q in zip(paths, plain[0]):
            assert torch.equal(p, q)
        np.testing.assert_allclose([float(x) for x in scores],
                                   [float(x) for x in plain[1]], rtol=1e-5)


def test_batch_matches_single_on_card(cuda_device):
    """align_batch_from_pcm on the card (its default device) against
    align_from_pcm pair by pair: equal apart from the margin, which the
    batch ships as an f16 word."""
    from describealign_tpu_torch.alignment import api
    pairs = []
    for seed in (3, 11, 23):
        video, audio, _ = build_pair(content_seconds=40.0, narration=(),
                                     lead_in=6.0, seed=seed)
        pairs.append((np.clip(video, -32768, 32767).astype(np.int16),
                      np.clip(audio, -32768, 32767).astype(np.int16)))
    for got, (v, a) in zip(api.align_batch_from_pcm(pairs), pairs):
        want = api.align_from_pcm(v, a)
        for i in (0, 1, 3):
            np.testing.assert_array_equal(got[i], want[i])
        assert got[2] == want[2] and got[4] == want[4]
        np.testing.assert_allclose(got[5], want[5], rtol=1e-3)


def _feature_inputs(device):
    """(mono, stereo) int16 PCM on the card: 3 s and 2.5 s plus a partial
    frame, speech-like, from a seed."""
    out = []
    for seconds, channels, seed in ((3.0, 1, 5), (2.5, 2, 6)):
        video, _, _ = build_pair(content_seconds=seconds, narration=(),
                                 seed=seed, channels=channels)
        pcm = np.clip(video, -32768, 32767).astype(np.int16)[:, :-37]
        out.append(torch.from_numpy(np.ascontiguousarray(pcm)).to(device))
    return out


def test_feature_kernels_match_plain_on_card(cuda_device):
    """K1 (pcm_frontend) and K2 (polyphase_blur, every stage of the
    cascade, and polyphase_cascade, the stream's six stages in one grouped
    launch) against their plain versions on the same CUDA tensors: FIR
    outputs bit-equal, crossing counts exact, energy within rtol 1e-6 (the
    kernel sums in the plain version's order, so it is equal too); int16
    and f32 input, mono on 16 bytes and a ragged stereo row off them (the
    scalar staging loop); one launch counted per call, the cascade's
    included."""
    from describealign_tpu_torch.ops import features as tf
    from describealign_tpu_torch.ops import features_kernel as fk
    for pcm in _feature_inputs(cuda_device):
        for x in (pcm, pcm.float()):
            before = fk.pcm_frontend_cuda.launches
            got = tf.pcm_frontend(x)
            torch.cuda.synchronize()
            assert fk.pcm_frontend_cuda.launches == before + 1
            want = tf.pcm_frontend_plain(
                x.half().float() if x.dtype == torch.int16 else x)
            torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
            for g, w in zip(got[1:], want[1:]):
                assert torch.equal(g, w)
        energy, crossings, bottom1, band1 = got
        bottom2 = tf.polyphase_blur(bottom1, 7, 3)
        for args, kw in (((energy, 1, 13), dict(epilogue='energy')),
                         ((crossings, 1, 13), {}),
                         ((band1, 42, 15), dict(epilogue='band')),
                         ((bottom1, 7, 3), {}),
                         ((bottom1, 6, 15), dict(r=7, bottom=bottom2,
                                                 epilogue='band')),
                         ((bottom2, 1, 15), dict(r=6, epilogue='band'))):
            before = fk.polyphase_blur_cuda.launches
            got_k = tf.polyphase_blur(*args, **kw)
            torch.cuda.synchronize()
            assert fk.polyphase_blur_cuda.launches == before + 1
            assert torch.equal(got_k, tf.polyphase_blur_plain(*args, **kw))
        want = tf.polyphase_cascade_plain(*got)
        before = fk.polyphase_blur_cuda.launches
        streams = tf.polyphase_cascade(*got)
        torch.cuda.synchronize()
        assert fk.polyphase_blur_cuda.launches == before + 1
        for g, w in zip(streams, want):
            assert torch.equal(g, w)


def test_fine_kernel_unequal_widths_on_card(cuda_device):
    """The fine kernel with the audio and the video stream at their own
    widths (the device-feature path's buckets) against its plain version:
    equal candidate sets on every block of both tracks, apart from
    candidates on the quality gate's floor (within 1e-4 of it, at most one
    per 20k: kernel and plain sum the correlations in other orders, as
    chip_smoke.py allows)."""
    from describealign_tpu_torch.alignment import matching
    from describealign_tpu_torch.ops import features as tf
    from describealign_tpu_torch.ops import fine_kernel as fk
    from describealign_tpu_torch.alignment import api, preprocess
    video, audio, _ = build_pair(content_seconds=40.0,
                                 narration=((15.0, 8.0), (28.0, 6.0)),
                                 lead_in=10.0, seed=11)
    feats = []
    for x in (audio, video):
        pcm = torch.from_numpy(api._pad_pcm_i16(
            np.clip(x, -32768, 32767).astype(np.int16))).to(cuda_device)
        feats.append(tf.feature_stack(pcm, pcm.shape[1] // 210))
    (ms_a, norms_a), (ms_v, norms_v) = (preprocess.preprocess_features(f)
                                        for f in feats)
    floor = 1e-4 * float(np.exp(np.float64(fk.EXP_COEF) * fk.LOG_CUT))
    assert ms_a.shape[1] != ms_v.shape[1]
    na, nv = audio.shape[1] // 210, video.shape[1] // 210
    a_mask, v_mask, starts, _, _ = matching._coarse_tracks(
        ms_a, norms_a, feats[0][0], na, ms_v, norms_v, feats[1][0], nv)
    nb = starts.shape[1]
    a_starts = torch.arange(nb, dtype=torch.int32,
                            device=cuda_device) * matching.BLOCK
    for t in range(starts.shape[0]):
        args = (ms_a, norms_a, a_mask.float(), ms_v, norms_v, v_mask.float(),
                starts[t].contiguous(), a_starts)
        qk, ok = fk.fine_match(*args)
        qp, op = fk.fine_match_plain(*args)
        keys = []
        for q, o in ((qk, ok), (qp, op)):
            b, l, k = torch.nonzero(q > 0, as_tuple=True)
            keys.append(dict(zip(zip(b.tolist(), l.tolist(),
                                     (o[b, l, k] + starts[t][b]).tolist()),
                                 q[b, l, k].tolist())))
        only = set(keys[0]) ^ set(keys[1])
        assert len(keys[1]) > 1000
        assert len(only) <= len(keys[1]) // 20000 + 1
        assert all(max(keys[0].get(k, 0.0), keys[1].get(k, 0.0))
                   <= floor * (1 + 1e-4) for k in only), sorted(only)
        # the common candidates' qualities as in
        # test_fine_kernel_matches_plain_on_card
        common = [k for k in keys[1] if k in keys[0]]
        err = np.array([abs(keys[0][k] - keys[1][k]) for k in common])
        rel = err / np.array([keys[1][k] for k in common])
        assert np.percentile(rel, 99) < 1e-3
        assert err.max() < 1e-2 and rel.max() < 2e-3


def test_device_features_batch_matches_single_on_card(cuda_device):
    """align_batch_from_pcm(features='device') on the card against
    align_from_pcm(features='device') pair by pair (equal tuples), and the
    card against the CPU within 10 ms at every node."""
    from describealign_tpu_torch.alignment import api
    pairs = []
    for seed, lead in ((3, 6.0), (11, 20.0)):
        video, audio, _ = build_pair(content_seconds=40.0, narration=(),
                                     lead_in=lead, seed=seed)
        pairs.append((np.clip(video, -32768, 32767).astype(np.int16),
                      np.clip(audio, -32768, 32767).astype(np.int16)))
    batch = api.align_batch_from_pcm(pairs, features='device')
    for got, (v, a) in zip(batch, pairs):
        want = api.align_from_pcm(v, a, features='device')
        for i in (0, 1, 3):
            np.testing.assert_array_equal(got[i], want[i])
        assert got[2] == want[2] and got[4] == want[4] and got[5] == want[5]
        cpu = api.align_from_pcm(v, a, features='device', device='cpu')
        assert np.max(np.abs(np.interp(cpu[0], got[0], got[1])
                             - cpu[1])) <= 0.010


def _fit_problems(n_pad, sizes, seed):
    """(b, c, kappa, rho1, rho2) f32 numpy batches of fit problems with
    `sizes` real nodes padded to n_pad, prepared as alignment/fit_device.py
    prepares them (a slope problem with a few rate changes and outliers)."""
    from describealign_tpu_torch.alignment import fit_device as fd
    rng = np.random.default_rng(seed)
    preps = []
    for n in sizes:
        x = np.cumsum(rng.integers(1, 40, n + 1)).astype(np.float64)
        slope = np.where(np.arange(n + 1) < n // 2, 1.0, 1.02)
        y = np.cumsum(np.concatenate([[300.0], np.diff(x) * slope[1:]]))
        y += rng.normal(0, 0.6, n + 1)
        xd = np.diff(x)
        r = np.diff(y) / xd
        preps.append(fd._prep_problem(r, np.minimum(2.0, 10.0) * xd,
                                      np.full(max(n - 1, 1), 4e4), n_pad))
    return [np.stack([np.asarray(p[i], np.float64) for p in preps])
            .astype(np.float32) for i in range(5)]


def test_fit_admm_kernel_matches_plain_on_card(cuda_device):
    """fused_lasso_admm (csrc/fit_admm.cu) against its plain version on
    the same CUDA tensors: t and z bit-equal, signed zeros included, one
    launch per call; n_pad 16 with 3-4 real nodes, 512, 4096, 8192 and
    16384 (each a different split of the arrays between shared memory and
    the global scratch, fit_kernel.shared_slots), batches of one and
    three."""
    from describealign_tpu_torch.ops import fit_kernel as fk
    for n_pad, sizes in ((16, (3, 4)), (512, (400,)), (4096, (4000, 2500,
                                                               3000)),
                         (8192, (5761,)), (16384, (13653,))):
        args = [torch.from_numpy(a).to(cuda_device)
                for a in _fit_problems(n_pad, sizes, n_pad)]
        before = fk.fused_lasso_admm.launches
        t, z = fk.fused_lasso_admm(*args)
        torch.cuda.synchronize()
        assert fk.fused_lasso_admm.launches == before + 1
        tp, zp = fk.fused_lasso_admm_plain(*args)
        assert torch.equal(t, tp), n_pad
        assert torch.equal(z, zp), n_pad
        assert torch.equal(torch.signbit(z), torch.signbit(zp))
        assert bool((z != 0).any()) and bool((z == 0).any())


def test_pv_lock_kernel_matches_plain_on_card(cuda_device):
    """pv_phase_lock (csrc/pv_lock.cu) against its plain version on the
    same CUDA spectra: bit-equal output and carry, one launch per call;
    stereo noise spectra as one block and walked in blocks with the
    carry, and integer spectra whose magnitudes tie."""
    from describealign_tpu_torch.ops import pv_kernel as pk
    rng = np.random.default_rng(9)
    omega = torch.from_numpy((2 * np.pi * np.arange(pk.BINS) * 256 / 1024)
                             .astype(np.float32)).to(cuda_device)
    for ties in (False, True):
        re = rng.standard_normal((2, 600, pk.BINS)) * 3e4
        im = rng.standard_normal((2, 600, pk.BINS)) * 3e4
        if ties:
            re, im = np.round(re / 3e4), np.round(im / 3e4)
        spec = torch.from_numpy((re + 1j * im).astype(np.complex64)).to(
            cuda_device)
        for rate in (1.03, 1 / 0.97):
            want, carry_w = pk.pv_phase_lock_plain(spec, omega,
                                                   float(np.float32(rate)))
            before = pk.pv_phase_lock.launches
            got, carry = pk.pv_phase_lock(spec, omega, rate)
            torch.cuda.synchronize()
            assert pk.pv_phase_lock.launches == before + 1
            assert torch.equal(got, want) and torch.equal(carry, carry_w)
            parts, carry = [], None
            for k0 in range(0, 600, 250):
                out, carry = pk.pv_phase_lock(
                    spec[:, k0:k0 + 250].contiguous(), omega, rate, carry)
                parts.append(out)
            assert torch.equal(torch.cat(parts, 1), want)
            assert torch.equal(carry, carry_w)


def test_device_stretch_on_card(cuda_device):
    """The device phase vocoder and resampler on the card against the same
    functions on the CPU (plain versions): cuFFT and the CPU's FFT differ
    by rounding, so within the CPU tests' bars against JAX."""
    from describealign_tpu_torch.stretch import phase_vocoder as pv
    from describealign_tpu_torch.stretch import resample as rs
    rng = np.random.default_rng(2)
    sig = (rng.standard_normal((2, 44100 * 4)) * 3000).astype(np.float32)
    num_out = int(sig.shape[1] * 0.97)
    gpu = pv.pv_stretch(sig, num_out, backend="device", device=cuda_device)
    cpu = pv.pv_stretch(sig, num_out, backend="device", device="cpu")
    rms = np.sqrt(np.mean((gpu - cpu) ** 2)) / np.sqrt(np.mean(cpu ** 2))
    assert gpu.shape == (2, num_out) and rms < 5e-3
    g = rs.resample_segment(sig, 5.0, sig.shape[1], num_out,
                            backend="device", device=cuda_device)
    c = rs.resample_segment(sig, 5.0, sig.shape[1], num_out,
                            backend="device", device="cpu")
    step = np.spacing(np.maximum(np.maximum(np.abs(g), np.abs(c)),
                                 1.0).astype(np.float16)).astype(np.float32)
    assert (np.abs(g - c) <= step).all()


def test_last_device_modules_on_card(cuda_device):
    """The mel frontend, sequence sharding and the data-parallel batch on
    the card: K1's crossings with one sample's crossing cancelled
    (cancel_crossing; a halo's zero or a negative sample) equal to the
    plain kill on the CPU; four shards' interior frames equal to the
    unsharded extractor's on the card, every frame within rtol 1e-5 /
    atol 1e-6 of the same four shards on the CPU; the mel streams within rtol 1e-4 / atol 1e-5 of the CPU's (cuFFT
    and pocketfft round differently); the batch on a 2-slot mesh equal to
    the serial batch within 1e-6 s."""
    from describealign_tpu_torch.alignment import api
    from describealign_tpu_torch.ops import features as tf
    from describealign_tpu_torch.ops import features_kernel as fk
    from describealign_tpu_torch.parallel.seqshard import (
        HALO, sequence_sharded_features)
    rng = np.random.default_rng(60)
    # sample `at`: a halo's zero after a negative sample, a negative
    # sample after a positive one (a crossing), a negative one after a
    # negative one (none)
    for channels, at_value, before_value in (
            (1, 0.0, -1234.0), (2, 0.0, -1234.0), (1, -900.0, 800.0),
            (2, -900.0, 800.0), (1, -900.0, -800.0), (2, -900.0, -800.0)):
        data = (rng.standard_normal((channels, 210 * 300)) * 3000).astype(
            np.float32)
        data[:, -1] = before_value
        at = data.shape[1]
        x = torch.from_numpy(np.concatenate(
            [data, np.zeros((channels, HALO), np.float32)], axis=1))
        x[:, at] = at_value
        before = fk.pcm_frontend_cuda.launches
        got = tf.pcm_frontend(x.to(cuda_device), kill_crossing_at=at)[1]
        assert fk.pcm_frontend_cuda.launches == before + 1
        assert torch.equal(got.cpu(), tf.pcm_frontend_plain(
            x, kill_crossing_at=at)[1])
    video, audio, _ = build_pair(content_seconds=14.0, narration=(),
                                 lead_in=2.0, seed=3)
    s = video.shape[1] - video.shape[1] % (210 * 4)
    pcm = video[:, :s]
    n = s // 210
    sharded = sequence_sharded_features(pcm, [cuda_device] * 4)
    whole = tf.extract_features(pcm, device=cuda_device)
    for j in range(5):
        assert torch.equal(sharded[j][8:n - 8], whole[j][8:n - 8])
    torch.testing.assert_close(
        sharded.cpu(), sequence_sharded_features(pcm, ['cpu'] * 4),
        rtol=1e-5, atol=1e-6)
    mel = tf.extract_features(pcm, device=cuda_device, frontend='mel')
    for g, c in zip(mel, tf.extract_features(pcm, device='cpu',
                                             frontend='mel')):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-5)
    pairs = []
    for seed in (31, 32):
        v, a, _ = build_pair(content_seconds=16.0, narration=(),
                             lead_in=2.0 + seed % 3, seed=seed)
        pairs.append((np.clip(v, -32768, 32767).astype(np.int16),
                      np.clip(a, -32768, 32767).astype(np.int16)))
    got = api.align_batch_from_pcm(pairs, mesh=[cuda_device] * 2)
    want = api.align_batch_from_pcm(pairs, device=cuda_device)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], atol=1e-6)
        np.testing.assert_allclose(g[1], w[1], atol=1e-6)
        assert abs(g[2] - w[2]) < 1e-9


def test_gui_worker_on_card(cuda_device, tmp_path):
    """The GUI's combiner on the card: run_combine_to_queue on its default
    device ('cuda') in the spawned child gui.core.start_worker starts (as
    CombineFrame does), on a 14-s stereo WAV pair in stretch mode. The
    child exits 0, no transcript line is tagged error, and the output WAV
    and the report are written."""
    import queue as queue_mod
    import time

    from describealign_tpu_torch.gui import core
    from describealign_tpu_torch.media.decode import write_wav
    video, audio, _ = build_pair(content_seconds=12.0, narration=(),
                                 lead_in=2.0, seed=5, channels=2)
    write_wav(tmp_path / "film.wav", video)
    write_wav(tmp_path / "desc.wav", audio)
    settings = dict(stretch_audio=True, prepend="ad_",
                    no_pitch_correction=False,
                    output_dir=str(tmp_path / "out"),
                    alignment_dir=str(tmp_path / "plots"))
    q, worker = core.start_worker([str(tmp_path / "film.wav")],
                                  [str(tmp_path / "desc.wav")], settings)
    transcript, deadline = core.TranscriptModel(), time.monotonic() + 300
    while worker.is_alive() or not q.empty():
        try:
            transcript.feed(q.get(timeout=0.2))
        except queue_mod.Empty:
            if time.monotonic() > deadline:
                worker.terminate()
                raise TimeoutError("the combine worker did not finish")
    worker.join()
    assert worker.exitcode == 0
    tags = [core.classify_line(ln) for ln in transcript.lines]
    assert "error" not in tags, transcript.text()
    assert transcript.lines[-1].startswith("All files processed.")
    assert (tmp_path / "out" / "ad_film.wav").stat().st_size > 1e5
    assert "Start Offset:" in (tmp_path / "plots" / "film.txt").read_text()
