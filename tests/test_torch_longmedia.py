"""Port parity: the streamed coarse DP for long media
(matching._coarse_dp_streamed), JAX vs torch on the CPU.

Above COARSE_STREAM_ELEMS score-map elements both packages compute the
score map in 64-block tiles inside the DP and recompute each tile from a
checkpointed cost row in the backtrace. The descriptors here are seeded
multiples of 1/16 in [-1/2, 1/2], so every GEMM sum is exact in f32 in any
order: the JAX and torch score tiles are then equal bit for bit, and so
must be the paths and the track scores. Against the port's materialized DP
the arithmetic is the same code in the same order, so paths and scores are
bit-equal. On real features (the canonical 45-s pair) the GEMMs sum in
other orders: starts_tracks bit-equal and the margin within rtol 1e-5, as
in tests/test_torch_coarse.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from describealign_tpu.alignment import matching as jm
from describealign_tpu.alignment import preprocess as jpre
from describealign_tpu_torch.alignment import matching as tm
from describealign_tpu_torch.alignment import preprocess as tpre
from tests.test_torch_coarse import _f16_features


def _descriptors(nb, kv, seed):
    """(audio (10 nb + rest, 128), 7 x video (kv, 128)) f32 on a 1/16 grid."""
    rng = np.random.default_rng(seed)

    def grid(*shape):
        return (rng.integers(-8, 9, shape) / 16).astype(np.float32)
    ka = nb * tm.COARSE_PER_BLOCK + (3 if nb % tm.COARSE_CHUNK else 0)
    return grid(ka, 128), [grid(kv, 128) for _ in tm.SUB_LANE_SHIFTS]


def _jax_k_best(desc_a, desc_v, nb):
    """The JAX streamed DP run k-best, as its _coarse_tracks runs it: the
    first track without suppression, the second with the first
    suppressed."""
    paths, scores = [], []
    for _ in range(jm.N_TRACKS):
        path, score = jm._coarse_dp_streamed(
            jnp.asarray(desc_a), [jnp.asarray(d) for d in desc_v], nb, paths)
        paths.append(path)
        scores.append(float(score))
    return [np.asarray(p) for p in paths], scores


@pytest.mark.parametrize("nb,kv", [(64, 1000), (150, 1200), (201, 1100)])
def test_streamed_dp_matches_jax_and_materialized(nb, kv):
    desc_a, desc_v = _descriptors(nb, kv, seed=nb)
    j_paths, j_scores = _jax_k_best(desc_a, desc_v, nb)
    t_a = torch.from_numpy(desc_a)
    t_v = [torch.from_numpy(d) for d in desc_v]
    t_paths, t_scores = tm._k_best_tracks(t_a, t_v, nb, streamed=True)
    m_paths, m_scores = tm._k_best_tracks(t_a, t_v, nb, streamed=False)
    assert all(p.dtype == torch.int32 and p.shape == (nb,) for p in t_paths)
    for tp, jp, mp in zip(t_paths, j_paths, m_paths):
        np.testing.assert_array_equal(tp.numpy(), jp)
        assert torch.equal(tp, mp)
    assert [float(x) for x in t_scores] == j_scores
    assert [float(x) for x in t_scores] == [float(x) for x in m_scores]
    assert len(np.unique(j_paths[0])) > nb // 2     # a track, not a lane


def test_coarse_tracks_streamed_branch_matches_jax(monkeypatch):
    """The port's _coarse_tracks forced onto the streamed branch (the
    threshold patched to 0 in the port only) against the JAX package's
    materialized branch on the canonical 45-s pair."""
    fa, na, fv, nv = _f16_features("canonical45")
    ms_a, norms_a = jpre.preprocess_features(fa.astype(np.float32))
    ms_v, norms_v = jpre.preprocess_features(fv.astype(np.float32))
    _, _, j_starts, _, j_margin = jm._coarse_tracks(
        ms_a, norms_a, jnp.asarray(fa[0], jnp.float32), na,
        ms_v, norms_v, jnp.asarray(fv[0], jnp.float32), nv)

    def no_materialized_dp(p_map):
        raise AssertionError("the materialized DP ran")

    monkeypatch.setattr(tm, "COARSE_STREAM_ELEMS", 0)
    monkeypatch.setattr(tm, "_coarse_dp", no_materialized_dp)
    marks = []
    tfa, tfv = torch.from_numpy(fa).float(), torch.from_numpy(fv).float()
    t_ms_a, t_norms_a = tpre.preprocess_features(tfa)
    t_ms_v, t_norms_v = tpre.preprocess_features(tfv)
    _, _, t_starts, _, t_margin = tm._coarse_tracks(
        t_ms_a, t_norms_a, tfa[0], na, t_ms_v, t_norms_v, tfv[0], nv,
        mark=marks.append)
    np.testing.assert_array_equal(t_starts.numpy(), np.asarray(j_starts))
    np.testing.assert_allclose(float(t_margin), float(j_margin), rtol=1e-5)
    assert marks == ["coarse_map", "coarse_dp"]
