"""Card-only checks of the CUDA fine kernel against its plain version.

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
