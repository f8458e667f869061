"""Port parity: the device-feature path, JAX vs torch on the CPU.

ops/features.py (the plain version of the two CUDA feature kernels, and
the CPU path of the port's extractor), lis.lis_from_match,
matching.extract_and_match, the features='device' branches of
align_from_pcm / align_batch_from_pcm and pipeline.features_for, each
against the JAX package's counterpart (DESCRIBEALIGN_FEATURES=device for
the entry points) on inputs made from a seed with numpy; and a tiling twin
of each kernel (csrc/features_dev.cu's blocks, halos and loop order in
torch) against the plain version, bit for bit.

Tolerances, and why:
- feature streams vs the JAX package's jitted extractor: the bars of
  tests/test_features.py:31,40,52 (energy rtol 2e-5 / atol 2e-7, zero
  crossings 2e-5 / 2e-5, bands 5e-5 / 5e-6). XLA on the CPU contracts
  `out + tap * x` into fused multiply-adds and sums the energy in its own
  order; the port rounds each product and add (measured: ~1.4e-7
  relative);
- _downsample_blur vs eager JAX: bit-equal (eager JAX runs each multiply
  and add as its own computation, so nothing is contracted);
- the twins vs the plain version, lis_from_match vs JAX: bit-equal;
- extract_and_match: coarse starts bit-equal, fine candidate sets equal
  apart from candidates on the quality gate's floor (within 1e-4 of it),
  margin rtol 1e-5 (the features differ by the contraction above);
- align_from_pcm: fit nodes within 10 ms and similarity within 0.5
  points (PERF.md section 2); the LIS paths are asserted equal too.
"""
import numpy as np
import pytest
import torch

from describealign_tpu.alignment import api as japi
from describealign_tpu.alignment import lis as jlis
from describealign_tpu.alignment import matching as jm
from describealign_tpu.ops import features as jfeat
from describealign_tpu import pipeline as jpipe
from describealign_tpu.utils.synthmedia import build_pair
from describealign_tpu_torch import features_for
from describealign_tpu_torch.alignment import api as tapi
from describealign_tpu_torch.alignment import lis as tlis
from describealign_tpu_torch.alignment import matching as tm
from describealign_tpu_torch.ops import features as tfeat
from describealign_tpu_torch.ops import features_kernel as tfk
from describealign_tpu_torch.ops import fine_kernel
from describealign_tpu_torch.ops.windows import hann_taps

# test_features.py's bars: (rtol, atol) per stream
STREAM_TOL = [(2e-5, 2e-7), (2e-5, 2e-5)] + [(5e-5, 5e-6)] * 3
TOL_S = 0.010
GATE_REL = 1e-4

# csrc/features_dev.cu's decomposition
FR, FRAME, HALO, ZC_SPLIT, K2_OUT = 16, 210, 16, 16, 128
RUN = FR * FRAME

PAIRS = {
    # both streams in one 64-s bucket
    "same_bucket": dict(content_seconds=45.0,
                        narration=((15.0, 3.0), (30.0, 4.0)), seed=7),
    # video 40 s, description 64 s: the streams pad to different buckets
    "two_buckets": dict(content_seconds=40.0,
                        narration=((15.0, 8.0), (28.0, 6.0)), lead_in=10.0,
                        seed=11),
}


def _pcm(seconds, channels, seed, samples=None):
    """test_features.make_pcm's signal as int16: tones + noise with silent
    gaps; `samples` overrides the length."""
    rng = np.random.default_rng(seed)
    s = samples or int(44100 * seconds)
    t = np.arange(s) / 44100.
    sig = (4000 * np.sin(2 * np.pi * 440 * t)
           + 2000 * np.sin(2 * np.pi * 3217 * t)
           + 1500 * rng.standard_normal(s))
    env = (np.sin(2 * np.pi * t / 2.3) > -0.4).astype(float)
    pcm = np.tile((sig * env)[None, :], (channels, 1))
    if channels > 1:
        pcm[1] *= 0.7
    return np.clip(np.round(pcm), -32768, 32767).astype(np.int16)


def _i16_pair(name):
    video, audio, _ = build_pair(**PAIRS[name])
    return (np.clip(video, -32768, 32767).astype(np.int16),
            np.clip(audio, -32768, 32767).astype(np.int16))


# ---------------------------------------------------------------------------
# The feature functions against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 2], ids=["mono", "stereo"])
def streams(request):
    """(port streams, JAX streams) on 3 s of PCM: the port's
    extract_features on the CPU, the JAX package's jitted
    extract_features (its energy_feature, zero_crossing_feature and
    freq_band_features)."""
    pcm = _pcm(3.0, request.param, 0).astype(np.float16).astype(np.float32)
    want = [np.asarray(f) for f in jfeat.extract_features(pcm)]
    t = torch.from_numpy(pcm)
    got = tfeat.extract_features(t, device="cpu")
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("k", range(5), ids=["energy", "crossings", "band1",
                                             "band2", "band3"])
def test_feature_functions_match_jax(streams, k):
    got, want = streams
    assert got[k].shape == want[k].shape and got[k].dtype == np.float32
    rtol, atol = STREAM_TOL[k]
    np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol)


@pytest.mark.parametrize("ds,blur", [(5, 3), (42, 15), (7, 3), (6, 15),
                                     (1, 15), (1, 13)])
def test_downsample_blur_bit_equal_to_eager_jax(ds, blur):
    """Every (ds, blur) of the cascade: per-phase strided taps, each phase
    centred on its own tap count, phase partials added in order. A length
    that is not a multiple of ds checks the trim."""
    x = np.random.default_rng(ds * 100 + blur).standard_normal(
        4000 + ds - 1).astype(np.float32) * 1e3
    want = np.asarray(jfeat._downsample_blur(x, ds, blur))
    got = tfeat._downsample_blur(torch.from_numpy(x), ds, blur).numpy()
    np.testing.assert_array_equal(got, want)


def test_extract_features_and_device_argument():
    """extract_features takes numpy or tensors, int16 or float, as f32
    values (no f16 rounding: the JAX package's cast), and puts the streams
    on `device`."""
    pcm = _pcm(3.0, 2, 3)           # the stereo fixture's compiled shape
    a = tfeat.extract_features(pcm, device='cpu')
    b = tfeat.extract_features(torch.from_numpy(pcm.astype(np.float32)),
                               device='cpu')
    want = [np.asarray(f) for f in jfeat.extract_features(pcm)]
    for x, y, w, (rtol, atol) in zip(a, b, want, STREAM_TOL):
        assert x.device.type == 'cpu' and torch.equal(x, y)
        np.testing.assert_allclose(x.numpy(), w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Tiling twins of the CUDA kernels, bit-equal to the plain version
# ---------------------------------------------------------------------------

def _staged(x, starts, width):
    """(blocks, width): x[start + p], zero outside [0, len(x))."""
    idx = starts[:, None] + torch.arange(width)[None, :]
    ok = (idx >= 0) & (idx < x.shape[0])
    return torch.where(ok, x[idx.clamp(0, x.shape[0] - 1)],
                       torch.zeros(()))


def _polyphase_twin(y, taps, ds, j):
    """polyphase_at: phase i's t_i taps around its centre (t_i - 1) // 2,
    products and adds in the kernel's order; y(q) reads index q."""
    length = len(taps)
    out = None
    for i in range(ds):
        t = (length - i + ds - 1) // ds
        c = (t - 1) // 2
        part = float(taps[i]) * y(ds * (j + c) + i)
        for m in range(1, t):
            part = part + float(taps[i + ds * m]) * y(ds * (j + c - m) + i)
        out = part if i == 0 else out + part
    return out


def frontend_twin(pcm):
    """K1 as the kernel computes it: blocks of FR frames staged with a
    HALO on each side, one channel at a time; energy per 105-block thread,
    crossings in ZC_SPLIT strided partial counts per frame, the channel
    mean to the f16 grid, stage 1 read from the staged arr."""
    c, s = pcm.shape
    n_blocks = -(-s // RUN)
    base = torch.arange(n_blocks) * RUN - HALO
    width = RUN + 2 * HALO
    e_acc = torch.zeros(n_blocks, 2 * FR)
    zc = torch.zeros(n_blocks, FR, ZC_SPLIT, dtype=torch.int64)
    frames = HALO + FRAME * torch.arange(FR)
    s_arr = None
    for ch in range(c):
        s_x = _staged(pcm[ch], base, width)
        s_arr = s_x if ch == 0 else s_arr + s_x
        blocks = s_x[:, HALO:HALO + RUN].reshape(n_blocks, 2 * FR, 105)
        for i in range(105):
            e_acc = e_acc + blocks[:, :, i] * blocks[:, :, i]
        sign = torch.signbit(s_x)
        for zr in range(ZC_SPLIT):
            for i in range(zr, FRAME, ZC_SPLIT):
                zc[:, :, zr] += sign[:, frames + i] != sign[:, frames + i - 1]
    energy = (e_acc / (105 * c)).reshape(-1)[:s // 105]
    crossings = zc.sum(2).reshape(-1)[:s // FRAME] * (2 if c == 1 else 1)

    trim = s // FRAME * FRAME
    if c > 1:
        s_arr = (s_arr / c).half().float()
    s_abs = base[:, None] + torch.arange(width)[None, :]
    s_arr = torch.where((s_abs >= 0) & (s_abs < trim), s_arr,
                        torch.zeros(()))

    def arr(q):
        return s_arr.gather(1, q - base[:, None])
    j = (base[:, None] + HALO) // 5 + torch.arange(RUN // 5)[None, :]
    bottom = _polyphase_twin(arr, hann_taps(17), 5, j)
    band = None
    for i in range(5):
        d = arr(5 * j + i) - bottom
        band = d * d if band is None else band + d * d
    n1 = trim // 5
    return (energy, crossings.float(), bottom.reshape(-1)[:n1],
            band.reshape(-1)[:n1])


def blur_twin(x, ds, blur, r=0, bottom=None, epilogue=None):
    """K2 as the kernel computes it: blocks of K2_OUT outputs, each stages
    its input span (with the prologue applied, zero outside [0, n)) plus
    the phase-0 halo, then polyphase_at per output and the epilogue."""
    length = ds * blur
    taps = hann_taps(length + 2)
    n_y = x.shape[0] // r if r else x.shape[0]
    n = n_y - n_y % ds
    stride = 2 if epilogue == 'energy' else 1
    n_out = -(-n // 2) if epilogue == 'energy' else n // ds
    t0 = -(-length // ds)
    hb, ha = t0 // 2, (t0 - 1) // 2
    o0 = torch.arange(-(-n_out // K2_OUT)) * K2_OUT
    span = (K2_OUT - 1) * stride + 1
    q0 = ds * (o0 * stride - hb)
    q = q0[:, None] + torch.arange(ds * (span + hb + ha))[None, :]
    ok = (q >= 0) & (q < n)
    qc = q.clamp(0, n - 1)
    if r == 0:
        v = x[qc]
    else:
        b = bottom[qc] if bottom is not None else torch.zeros(())
        v = None
        for i in range(r):
            d = x[r * qc + i] - b
            v = d * d if v is None else v + d * d
    s_y = torch.where(ok, v, torch.zeros(()))

    def y(qq):
        return s_y.gather(1, qq - q0[:, None])
    o = o0[:, None] + torch.arange(K2_OUT)[None, :]
    out = _polyphase_twin(y, taps, ds, o * stride)
    if epilogue == 'band':
        out = out / 210.
    if epilogue:
        out = torch.log10(1. + out) / 2.
    return out.reshape(-1)[:n_out]


# (samples, channels): shorter than one block; block edges with a partial
# frame and an odd count of 105-sample blocks; several blocks, stereo
TWIN_CASES = [(2 * RUN // 3, 1), (3 * RUN + 2 * FRAME + 150, 1),
              (5 * RUN + 7 * FRAME + 105 + 9, 2), (4 * RUN, 3)]


@pytest.mark.parametrize("s,c", TWIN_CASES)
def test_kernel_twins_bit_equal_to_plain(s, c):
    pcm = torch.from_numpy(_pcm(0, c, s, samples=s)).half().float()
    plain = tfeat.pcm_frontend_plain(pcm)
    twin = frontend_twin(pcm)
    for name, p, t in zip(("energy", "crossings", "bottom", "band"), plain,
                          twin):
        assert p.shape == t.shape and torch.equal(p, t), name
    energy, crossings, bottom1, band1 = plain
    bottom2 = tfeat.polyphase_blur_plain(bottom1, 7, 3)
    for args, kw in (((energy, 1, 13), dict(epilogue='energy')),
                     ((crossings, 1, 13), {}),
                     ((band1, 42, 15), dict(epilogue='band')),
                     ((bottom1, 7, 3), {}),
                     ((bottom1, 6, 15), dict(r=7, bottom=bottom2,
                                             epilogue='band')),
                     ((bottom2, 1, 15), dict(r=6, epilogue='band'))):
        p = tfeat.polyphase_blur_plain(*args, **kw)
        t = blur_twin(*args, **kw)
        assert p.shape == t.shape and torch.equal(p, t), (args[1:], kw)


def test_twin_centres_phases_with_unequal_tap_counts():
    """polyphase_at's per-phase count and centre for L not a multiple of
    ds (17 taps over 5 phases: 4, 4, 3, 3, 3), against _conv_same on each
    strided phase added in phase order."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        500).astype(np.float32))
    taps = hann_taps(19)
    want = None
    for i in range(5):
        part = tfeat._conv_same(x[i::5], taps[i::5])
        want = part if want is None else want + part

    def y(q):
        return torch.where((q >= 0) & (q < 500), x[q.clamp(0, 499)],
                           torch.zeros(()))
    got = _polyphase_twin(y, taps, 5, torch.arange(100))
    assert torch.equal(got, want)


def test_cuda_wrappers_refuse_cpu_tensors():
    pcm = torch.zeros((1, 4200), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.pcm_frontend_cuda(pcm)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.polyphase_blur_cuda(torch.zeros(100), 1, 13)
    assert tfk.pcm_frontend_cuda.launches == 0
    assert tfk.polyphase_blur_cuda.launches == 0


def test_feature_work_counts_bench_bytes():
    """The bench pair's 73,382,400 + 59,270,400 padded mono samples: K1
    reads 2 B and writes ~1.66 B per sample (485 MB in all)."""
    k1 = sum(tfk.feature_work(1, s)['pcm_frontend']
             for s in (73382400, 59270400))
    assert abs(k1 / 132652800 - (2 + 4 * (1 / 105 + 1 / 210 + 2 / 5))) < 1e-6
    assert 484e6 < k1 < 486e6


# ---------------------------------------------------------------------------
# lis_from_match, extract_and_match and the entry points against JAX
# ---------------------------------------------------------------------------

def test_lis_from_match_bit_equal_to_jax():
    rng = np.random.default_rng(9)
    nb, k, g = 40, 12, 3
    quals = np.where(rng.random((nb, 210, k)) < 0.3,
                     rng.random((nb, 210, k)) * 50, 0).astype(np.float32)
    quals[:, :, :2] = np.round(quals[:, :, :2])        # ties
    offs = rng.integers(0, 768, (nb, 210, k)).astype(np.int16)
    starts = (np.arange(nb)[:, None] * 210
              + rng.integers(-300, 300, (nb, g))).clip(0).astype(np.int32)
    want = jlis.lis_from_match(quals, offs, starts)
    got = tlis.lis_from_match(quals, offs, starts)
    assert len(want[0]) > 100
    for w, x in zip(want, got):
        assert x.dtype == np.int64
        np.testing.assert_array_equal(x, w)


@pytest.fixture(scope="module", params=sorted(PAIRS))
def matched(request):
    """extract_and_match of both packages on one pair's padded PCM."""
    v, a = _i16_pair(request.param)
    na, nv = a.shape[1] // 210, v.shape[1] // 210
    pa, pv = japi._pad_pcm_i16(a), japi._pad_pcm_i16(v)
    want = [np.asarray(x) for x in jm.extract_and_match(pa, na, pv, nv)]
    got = [x.numpy() for x in tm.extract_and_match(
        torch.from_numpy(pa), na, torch.from_numpy(pv), nv)]
    return request.param, want, got


def _keyed(quals, offs, starts):
    """{(block, frame, video frame): quality} of the nonzero slots."""
    per_group = quals.shape[2] // starts.shape[1]
    vids = (np.repeat(starts, per_group, axis=1)[:, None, :]
            + offs.astype(np.int64))
    b, l, j = np.nonzero(quals > 0)
    return dict(zip(zip(b.tolist(), l.tolist(), vids[b, l, j].tolist()),
                    quals[b, l, j].tolist()))


def test_extract_and_match_matches_jax(matched):
    name, want, got = matched
    wq, wo, ws, wfa, wfv, wm = want
    gq, go, gs, gfa, gfv, gm = got
    if name == "two_buckets":
        assert gfa.shape[1] != gfv.shape[1]
    assert gfa.shape == wfa.shape and gfv.shape == wfv.shape
    for g, w in ((gfa, wfa), (gfv, wfv)):
        for row, (rtol, atol) in enumerate(STREAM_TOL):
            np.testing.assert_allclose(g[row], w[row], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(gs, ws)          # coarse starts
    np.testing.assert_allclose(gm, wm, rtol=1e-5)
    assert gq.dtype == np.float32 and gq.shape == wq.shape
    dk, dw = _keyed(gq, go, gs), _keyed(wq, wo, ws)
    assert len(dw) > 1000
    floor = 1e-4 * float(np.exp(np.float64(fine_kernel.EXP_COEF)
                                * fine_kernel.LOG_CUT))
    only = set(dk) ^ set(dw)
    assert all(max(dk.get(k, 0.0), dw.get(k, 0.0)) <= floor * (1 + GATE_REL)
               for k in only), sorted(only)[:5]
    assert len(only) <= len(dw) // 20000 + 1
    common = [k for k in dw if k in dk]
    rel = np.array([abs(dk[k] - dw[k]) / dw[k] for k in common])
    assert np.percentile(rel, 99) < 1e-3


def _assert_close_result(got, want):
    assert len(got) == len(want) == 6
    node_err = np.max(np.abs(np.interp(want[0], got[0], got[1]) - want[1]))
    assert node_err <= TOL_S
    assert abs(float(got[0][0] - got[1][0])
               - float(want[0][0] - want[1][0])) <= TOL_S
    assert abs(got[2] - want[2]) <= 0.5
    assert abs(got[4] - want[4]) <= 1e-4
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5)


def test_align_from_pcm_device_matches_jax(matched, monkeypatch, capsys):
    name, out_j, out_t = matched
    v, a = _i16_pair(name)
    monkeypatch.setenv("DESCRIBEALIGN_FEATURES", "device")
    capsys.readouterr()
    want = japi.align_from_pcm(v, a)
    want_out = capsys.readouterr().out
    got = tapi.align_from_pcm(v, a, device='cpu', features='device')
    got_out = capsys.readouterr().out
    _assert_close_result(got, want)
    assert got_out == want_out and "memorizing video" in got_out
    # the LIS paths: bit-equal on these pairs
    y_j, x_j = jlis.lis_from_match(*out_j[:3])
    y_t, x_t = tlis.lis_from_match(out_t[0], out_t[1].astype(np.int16),
                                   out_t[2])
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(x_t, x_j)


def test_device_timings_and_padded_pcm():
    """The timings keys of the host path, 'features' first; combine()'s
    call with padded PCM and true sample counts is the unpadded call on
    a PCM one bucket longer (the JAX package pads padded PCM again)."""
    v, a = _i16_pair("same_bucket")
    split = {}
    got = tapi.align_from_pcm(v, a, device='cpu', features='device',
                              timings=split)
    assert list(split) == ['features', 'coarse_map', 'coarse_dp', 'fine',
                           'lis_tail']
    vp, ap = tapi._pad_pcm_i16(v), tapi._pad_pcm_i16(a)
    padded = tapi.align_from_pcm(vp, ap, device='cpu', features='device',
                                 video_samples=v.shape[1],
                                 audio_samples=a.shape[1],
                                 combine_prints=True)
    _assert_close_result(padded, got)


def test_batch_device_equals_single():
    """align_batch_from_pcm(features='device') against align_from_pcm
    pair by pair: the same tuples, the margin included (both f32)."""
    pairs = [_i16_pair(name) for name in sorted(PAIRS)]
    pairs.append(pairs[0])
    batch = tapi.align_batch_from_pcm(pairs, device='cpu',
                                      features='device', device_depth=1,
                                      host_workers=2)
    for got, (v, a) in zip(batch, pairs):
        want = tapi.align_from_pcm(v, a, device='cpu', features='device')
        for i in (0, 1, 3):
            np.testing.assert_array_equal(got[i], want[i])
        assert got[2] == want[2] and got[4] == want[4]
        assert got[5] == want[5]


def test_feature_path_names_checked():
    v, a = _i16_pair("same_bucket")
    for call in (lambda: tapi.align_from_pcm(v, a, device='cpu',
                                             features='gpu'),
                 lambda: tapi.align_batch_from_pcm([(v, a)], device='cpu',
                                                   features='gpu')):
        with pytest.raises(ValueError, match="features='gpu'"):
            call()


def test_features_for_matches_jax():
    pcm = _pcm(5.0, 1, 21)
    want, n_want = jpipe.features_for(pcm)
    got, n_got = features_for(pcm, device='cpu')
    assert n_got == n_want == pcm.shape[1] // 210
    for g, w, (rtol, atol) in zip(got, want, STREAM_TOL):
        assert isinstance(g, np.ndarray) and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
