"""The coarse score map's plain version and the kernel's tiling twin
(ops/coarse_map.py) on the CPU, against the JAX package.

block_scores_plain is the arithmetic the port ran before the kernel, so it
is held bit for bit to that code (copied below as _old_chunk_scores).
block_scores_twin walks csrc/coarse_map.cu's tiles (64-block row tiles x
128 lanes, 64 above K 128, read p rows into the resident video rows,
the two consumers' alternating p and their final merge; the zero-filled
rows and columns, the per-k-step 3xTF32 partials, the suppression); it
sums
in another order than the JAX GEMM, so its map is held to
tests/test_torch_coarse.py's bar, rtol 1e-5 / atol 1e-4, and the k-best
tracks it leads to must be the JAX package's lane for lane (scores within
rtol 1e-5; bit-equal on descriptors whose every sum is exact).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from describealign_tpu.alignment import matching as jm
from describealign_tpu.alignment import preprocess as jpre
from describealign_tpu_torch.alignment import matching as tm
from describealign_tpu_torch.alignment import preprocess as tpre
from describealign_tpu_torch.ops import coarse_map as cm
from tests.test_torch_coarse import _f16_features
from tests.test_torch_longmedia import _descriptors as _grid_descriptors
from tests.test_torch_longmedia import _jax_k_best

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this file: the twin runs thousands of small
    products, and in the tier-1 run six workers' full thread pools
    oversubscribe the cores (this file took ~10 min of one worker there;
    ~20 s alone). The comparisons hold at any thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _old_chunk_scores(desc_a_padded, desc_v_list, c):
    """The port's _chunk_scores before the kernel, verbatim."""
    kv = desc_v_list[0].shape[0]
    rows = desc_a_padded[c * tm.COARSE_CHUNK * tm.COARSE_PER_BLOCK:
                         (c + 1) * tm.COARSE_CHUNK * tm.COARSE_PER_BLOCK]
    out = None
    for desc_v in desc_v_list:
        s = torch.matmul(rows, desc_v.T).reshape(
            tm.COARSE_CHUNK, tm.COARSE_PER_BLOCK, kv)
        s = torch.nn.functional.pad(s, (0, tm.COARSE_PER_BLOCK))
        aligned = s[:, 0, :kv]
        for p in range(1, tm.COARSE_PER_BLOCK):
            aligned = torch.maximum(aligned, s[:, p, p:p + kv])
        out = aligned if out is None else torch.maximum(out, aligned)
    return out


def _random(nb, kv, k, seed):
    """(audio padded to whole chunks, (7, Kv, K) video) f32 descriptors."""
    rng = np.random.default_rng(seed)
    nb_pad = -(-nb // tm.COARSE_CHUNK) * tm.COARSE_CHUNK
    a = (rng.standard_normal((nb_pad * tm.COARSE_PER_BLOCK, k))
         / np.sqrt(k)).astype(np.float32)
    a[nb * tm.COARSE_PER_BLOCK:] = 0
    v = (rng.standard_normal((len(tm.SUB_LANE_SHIFTS), kv, k))
         / np.sqrt(k)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(v)


def _descriptor_pair(name, nf):
    """The JAX package's and the port's coarse descriptors of a pair."""
    fa, na, fv, nv = _f16_features(name)
    ms_a, norms_a = jpre.preprocess_features(fa.astype(np.float32))
    ms_v, norms_v = jpre.preprocess_features(fv.astype(np.float32))
    a_mask = jpre.valid_audio_mask(jnp.asarray(fa[0], jnp.float32), na)
    v_mask = jpre.valid_video_mask(jnp.asarray(fv[0], jnp.float32), nv)
    j_a = jm._coarse_descriptors(ms_a[:nf], norms_a[:nf], a_mask)
    j_v = [jm._coarse_descriptors(ms_v[:nf], norms_v[:nf], v_mask, p)
           for p in jm.SUB_LANE_SHIFTS]
    ms_a, norms_a = tpre.preprocess_features(torch.from_numpy(fa))
    ms_v, norms_v = tpre.preprocess_features(torch.from_numpy(fv))
    a_mask = tpre.valid_audio_mask(torch.from_numpy(fa[0]).float(), na)
    v_mask = tpre.valid_video_mask(torch.from_numpy(fv[0]).float(), nv)
    t_a = tm._coarse_descriptors(ms_a[:nf], norms_a[:nf], a_mask)
    t_v = torch.stack([tm._coarse_descriptors(ms_v[:nf], norms_v[:nf],
                                              v_mask, p)
                       for p in tm.SUB_LANE_SHIFTS])
    return j_a, j_v, t_a, t_v


def _padded(desc_a):
    nb = desc_a.shape[0] // tm.COARSE_PER_BLOCK
    nb_pad = -(-nb // tm.COARSE_CHUNK) * tm.COARSE_CHUNK
    return torch.nn.functional.pad(
        desc_a, (0, 0, 0, nb_pad * tm.COARSE_PER_BLOCK - desc_a.shape[0])), nb


def test_plain_bit_equal_to_old_chunk_scores():
    """The map, each chunk's tile and a suppressed streamed tile: the plain
    version gives the old code's bits."""
    a, v = _random(150, 700, 128, seed=4)
    ka = 150 * tm.COARSE_PER_BLOCK
    old = torch.cat([_old_chunk_scores(a, list(v), c)
                     for c in range(a.shape[0] // 640)])[:150]
    assert torch.equal(tm._block_scores_local(a[:ka], list(v)), old)
    assert torch.equal(tm._block_scores_local(a[:ka], v), old)
    for c in range(3):
        assert torch.equal(cm.block_scores(a, v, 64 * c, 64),
                           _old_chunk_scores(a, list(v), c))
    vp = torch.from_numpy(np.random.default_rng(0).integers(
        0, 700, 150).astype(np.int32))
    lanes = torch.arange(700, dtype=torch.int32)[None, :]
    want = torch.where(torch.abs(lanes - vp[128:150, None]) <= 25,
                       torch.full((), -1e30),
                       _old_chunk_scores(a, list(v), 2)[:22]).contiguous()
    got = cm.block_scores(a, v, 128, 22, vp[None, :].contiguous())
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,nf", [("canonical45", 3), ("lead_in", 3),
                                     ("lowmargin40", 3), ("lowmargin40", 5)])
def test_twin_map_matches_jax(name, nf):
    """The twin's map against the JAX _block_scores_local (K 128 for 3
    streams, 256 for the 5-stream retry)."""
    j_a, j_v, t_a, t_v = _descriptor_pair(name, nf)
    p_j = np.asarray(jm._block_scores_local(j_a, j_v))
    a, nb = _padded(t_a)
    assert t_v.shape[2] == (128 if nf == 3 else 256)
    p_t = cm.block_scores_twin(a, t_v, 0, nb).numpy()
    assert p_t.shape == p_j.shape
    np.testing.assert_allclose(p_t, p_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nb,kv,k,b0,n", [
    (5, 7, 128, 0, 5),          # Kv below the 9-row skew halo, one part tile
    (70, 500, 128, 64, 6),      # Kv off the 128-lane tile, a partial tile
    (13, 241, 256, 0, 13),      # K 256, Kv off its 64-lane tile
    (130, 1000, 128, 64, 64),   # a full 64-block tile at b0 > 0
    (70, 129, 128, 0, 65),      # blocks off 64, Kv one past the lane tile
    (150, 300, 128, 37, 100),   # a partial tile at b0 > 0 off 64
    (70, 65, 256, 3, 67),       # K 256: two row tiles, Kv 64 + 1
    (30, 140, 96, 0, 30),       # K 96: three slabs of the K-128 tile
])
def test_twin_edges_match_plain(nb, kv, k, b0, n):
    """Edge shapes of the kernel's tiles, with no, one and two suppress
    paths (one near lane 0, one near Kv): the twin against the plain
    version."""
    a, v = _random(nb, kv, k, seed=nb + kv)
    rng = np.random.default_rng(kv)
    near0 = rng.integers(0, 26, nb)
    near_kv = rng.integers(max(0, kv - 26), kv, nb)
    paths = torch.from_numpy(np.stack([near0, near_kv]).astype(np.int32))
    for sup in (None, paths[:1].contiguous(), paths):
        want = cm.block_scores_plain(a, v, b0, n, sup)
        got = cm.block_scores_twin(a, v, b0, n, sup)
        assert got.shape == (n, kv)
        assert torch.equal(got == -1e30, want == -1e30)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
    if sup is not None:
        lanes = np.arange(kv)[None, :]
        near = (np.abs(lanes - near0[b0:b0 + n, None]) <= 25) | (
            np.abs(lanes - near_kv[b0:b0 + n, None]) <= 25)
        assert np.array_equal(got.numpy() == -1e30, near)


def _twin_k_best(monkeypatch, desc_a, desc_v, nb, streamed):
    monkeypatch.setattr(cm, "block_scores", cm.block_scores_twin)
    return tm._k_best_tracks(desc_a, desc_v, nb, streamed=streamed)


@functools.lru_cache(maxsize=None)
def _k_best_cases():
    """[(port desc_a, port desc_v, nb, JAX paths, JAX scores, exact)]: the
    canonical pair's descriptors, then seeded ones on a 1/16 grid whose
    every sum is exact in f32."""
    j_a, j_v, t_a, t_v = _descriptor_pair("canonical45", 3)
    nb = t_a.shape[0] // tm.COARSE_PER_BLOCK
    cases = [(t_a, t_v, nb) + _jax_k_best(
        np.asarray(j_a), [np.asarray(d) for d in j_v], nb) + (False,)]
    desc_a, desc_v = _grid_descriptors(70, 600, seed=70)
    cases.append((torch.from_numpy(desc_a),
                  [torch.from_numpy(d) for d in desc_v], 70)
                 + _jax_k_best(desc_a, desc_v, 70) + (True,))
    return cases


@pytest.mark.parametrize("streamed", [True, False])
def test_twin_k_best_tracks_match_jax_streamed(monkeypatch, streamed):
    """Both k-best tracks from the twin's tiles (streamed: per 64-block
    tile with the first track suppressed inside; materialized: one map)
    against the JAX _coarse_dp_streamed: the same lanes on the canonical
    pair's descriptors, scores within rtol 1e-5; bit-equal scores too on
    descriptors whose sums are exact."""
    for desc_a, desc_v, nb, j_paths, j_scores, exact in _k_best_cases():
        paths, scores = _twin_k_best(monkeypatch, desc_a, desc_v, nb,
                                     streamed)
        for p, jp in zip(paths, j_paths):
            np.testing.assert_array_equal(p.numpy(), jp)
        got = [float(s) for s in scores]
        if exact:
            assert got == j_scores
        else:
            np.testing.assert_allclose(got, j_scores, rtol=1e-5)


def test_block_scores_wrapper_contract():
    """The CPU takes the plain version and counts no launch; inputs the
    kernel cannot take raise before any launch."""
    a, v = _random(20, 300, 128, seed=1)
    before = cm.block_scores.launches
    assert torch.equal(cm.block_scores(a, v, 0, 20),
                       cm.block_scores_plain(a, v, 0, 20))
    assert cm.block_scores.launches == before
    with pytest.raises(ValueError, match="multiple of 32"):
        cm.block_scores(a[:, :100].contiguous(), v[:, :, :100].contiguous(),
                        0, 20)
    with pytest.raises(ValueError, match="descriptor rows"):
        cm.block_scores(a[:150], v, 10, 10)
    with pytest.raises(ValueError, match="int32 lane paths"):
        cm.block_scores(a, v, 0, 20, torch.zeros((1, 20), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(7, Kv, 128\)"):
        cm.block_scores(a, v[:6], 0, 20)


def test_tf32_split_is_the_rna_rounding():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero; hi + lo carries x to ~2^-22 of its size."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        4096).astype(np.float32))
    x[:4] = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 0.0])
    hi, lo = cm._split_tf32(x)
    assert not torch.any(hi.view(torch.int32) & 0x1FFF)
    assert not torch.any(lo.view(torch.int32) & 0x1FFF)
    assert hi[:4].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 0.0]
    err = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(err <= 2.0 ** -21 * x.double().abs())
