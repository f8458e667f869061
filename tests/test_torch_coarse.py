"""Port parity: the coarse pass (score map, k-best max-plus DP, margin),
JAX vs torch on the CPU.

The DP is max-plus over f32 sums whose slope terms are exact multiples of
0.5, so fed the same score map it must give bit-equal paths and scores.
End to end the score maps differ in summation order (XLA vs torch GEMM),
which leaves the chosen lanes - hence starts_tracks - bit-equal and the
margin (a difference of two track scores) within rtol 1e-5, the bar of
tests/test_parallel.py for XLA vs XLA batched."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from describealign_tpu.alignment import api as japi
from describealign_tpu.alignment import matching as jm
from describealign_tpu.alignment import preprocess as jpre
from describealign_tpu.utils.synthmedia import build_pair
from describealign_tpu_torch.alignment import api as tapi
from describealign_tpu_torch.alignment import matching as tm
from describealign_tpu_torch.alignment import preprocess as tpre

PAIRS = {
    "canonical45": dict(content_seconds=45.0,
                        narration=((15.0, 3.0), (30.0, 4.0)), seed=7),
    "lead_in": dict(content_seconds=30.0, narration=((12.0, 3.0),),
                    lead_in=6.0, seed=11),
    "lowmargin40": dict(content_seconds=40.0, narration=((8.0, 3.0),),
                        lead_in=2.0, seed=78),
}


def _f16_features(name):
    video, audio, _ = build_pair(**PAIRS[name])
    v = np.clip(video, -32768, 32767).astype(np.int16)
    a = np.clip(audio, -32768, 32767).astype(np.int16)
    npad = max(japi._bucket_pad(v.shape[1] // 210),
               japi._bucket_pad(a.shape[1] // 210))
    fv, nv = japi.host_features_padded(v, v.shape[1], npad)
    fa, na = japi.host_features_padded(a, a.shape[1], npad)
    return fa.astype(np.float16), na, fv.astype(np.float16), nv


def test_constants_equal():
    for name in ("COARSE_STRIDE", "BLOCK", "COARSE_PER_BLOCK",
                 "FINE_HALF_BAND", "FINE_W", "TOP_K", "COARSE_STREAMS",
                 "COARSE_RETRY_STREAMS", "QUAL_PROB_CUTOFF", "QUAL_SCALE",
                 "QUAL_MAX", "NB_EXPONENT", "BAND_GATE", "DP_SLOPE_COST",
                 "DP_JUMP_COST", "SUB_LANE_SHIFTS", "COARSE_CHUNK",
                 "COARSE_STREAM_ELEMS", "QUAL_CODE_BASE", "FINE_CHUNK",
                 "COARSE_MARGIN_FLOOR", "N_TRACKS", "SUPPRESS_LANES"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert tapi.BUCKET_FRAMES == japi.BUCKET_FRAMES
    assert tapi.PAD_MARGIN == japi.PAD_MARGIN
    np.testing.assert_array_equal(tpre.mean_sub_taps(),
                                  jpre.mean_sub_taps())
    for npad in (210 * 20, 13440, 26880 * 3):
        assert tm.nb_for(npad) == jm.nb_for(npad)
        assert tapi._bucket_pad(npad) == japi._bucket_pad(npad)


def _jax_score_map(name, nf=3):
    fa, na, fv, nv = _f16_features(name)
    ms_a, norms_a = jpre.preprocess_features(fa.astype(np.float32))
    ms_v, norms_v = jpre.preprocess_features(fv.astype(np.float32))
    a_mask = jpre.valid_audio_mask(jnp.asarray(fa[0], jnp.float32), na)
    v_mask = jpre.valid_video_mask(jnp.asarray(fv[0], jnp.float32), nv)
    desc_a = jm._coarse_descriptors(ms_a[:nf], norms_a[:nf], a_mask)
    desc_v = [jm._coarse_descriptors(ms_v[:nf], norms_v[:nf], v_mask, p)
              for p in jm.SUB_LANE_SHIFTS]
    return np.asarray(jm._block_scores_local(desc_a, desc_v))


@pytest.mark.parametrize("name", ["canonical45", "random"])
def test_coarse_dp_same_map_bit_equal(name):
    """Both k-best tracks of the DP on one score map: bit-equal paths and
    scores (the second track runs on the map with the first suppressed)."""
    if name == "random":
        p_map = np.random.default_rng(1).standard_normal(
            (40, 700)).astype(np.float32)
    else:
        p_map = _jax_score_map(name)
    lanes = np.arange(p_map.shape[1])[None, :]
    sup_j = jnp.asarray(p_map)
    sup_t = torch.from_numpy(p_map)
    for _ in range(jm.N_TRACKS):
        path_j, score_j = jm._coarse_dp(sup_j)
        path_t, score_t = tm._coarse_dp(sup_t)
        np.testing.assert_array_equal(path_t.numpy(), np.asarray(path_j))
        assert path_t.dtype == torch.int32
        assert float(score_t) == float(score_j)
        near = np.abs(lanes - np.asarray(path_j)[:, None]) <= jm.SUPPRESS_LANES
        sup_j = jnp.where(near, -1e30, sup_j)
        sup_t = torch.where(torch.from_numpy(near), -1e30, sup_t)


def test_score_map_parity():
    """The coarse score map (GEMM + skew-max + phase fold) agrees to f32
    summation-order noise."""
    p_j = _jax_score_map("lead_in")
    fa, na, fv, nv = _f16_features("lead_in")
    ms_a, norms_a = tpre.preprocess_features(torch.from_numpy(fa))
    ms_v, norms_v = tpre.preprocess_features(torch.from_numpy(fv))
    a_mask = tpre.valid_audio_mask(torch.from_numpy(fa[0]).float(), na)
    v_mask = tpre.valid_video_mask(torch.from_numpy(fv[0]).float(), nv)
    desc_a = tm._coarse_descriptors(ms_a[:3], norms_a[:3], a_mask)
    desc_v = [tm._coarse_descriptors(ms_v[:3], norms_v[:3], v_mask, p)
              for p in tm.SUB_LANE_SHIFTS]
    p_t = tm._block_scores_local(desc_a, desc_v).numpy()
    assert p_t.shape == p_j.shape
    np.testing.assert_allclose(p_t, p_j, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name,nf", [("canonical45", None),
                                     ("lead_in", None),
                                     ("lowmargin40", None),
                                     ("lowmargin40", 5)])
def test_match_coarse_parity(name, nf):
    fa, na, fv, nv = _f16_features(name)
    if nf is None:
        j_state = [np.asarray(s) for s in jm.match_coarse(fa, na, fv, nv)]
        j_starts, j_margin = j_state[6], float(j_state[7])
    else:
        ms_a, norms_a = jpre.preprocess_features(fa.astype(np.float32))
        ms_v, norms_v = jpre.preprocess_features(fv.astype(np.float32))
        _, _, starts, _, margin = jm._coarse_tracks(
            ms_a, norms_a, jnp.asarray(fa[0], jnp.float32), na,
            ms_v, norms_v, jnp.asarray(fv[0], jnp.float32), nv, nf=nf)
        starts = np.asarray(starts)
        b_pad = -(-starts.shape[1] // jm.FINE_CHUNK) * jm.FINE_CHUNK
        j_starts = np.pad(starts, ((0, 0), (0, b_pad - starts.shape[1])),
                          mode='edge')
        j_margin = float(margin)
    t_state = tm.match_coarse(torch.from_numpy(fa), na, torch.from_numpy(fv),
                              nv, nf=nf)
    np.testing.assert_array_equal(t_state[6].numpy(), j_starts)
    assert t_state[6].dtype == torch.int32
    np.testing.assert_allclose(float(t_state[7]), j_margin, rtol=1e-5)
    if nf is None:
        for k in (2, 5):     # the masks ride in the state
            np.testing.assert_array_equal(t_state[k].numpy(), j_state[k])
