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
