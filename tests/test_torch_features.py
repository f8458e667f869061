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

# csrc/features_dev.cu's decomposition: K1 windows, ring, stage-1 threads
FR, FRAME, HALO = 16, 210, 8
RUN = FR * FRAME
STAGE = RUN + 2 * HALO
N1, R1 = RUN // 5, 4

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

def _chunk_read(row, q, elem, lim):
    """row[q] as a 16-byte cp.async chunk stages it: the chunk of 16 // elem
    values that starts at q rounded down to a chunk copies its bytes that
    lie in [0, lim) and zero-fills the rest (the src-size operand)."""
    e = 16 // elem
    chunk = torch.div(q, e, rounding_mode='floor') * e
    nbytes = torch.where((chunk < 0) | (chunk >= lim), 0,
                         ((lim - chunk) * elem).clamp(max=16))
    ok = (q - chunk) * elem < nbytes
    return torch.where(ok, row[q.clamp(0, row.shape[0] - 1)],
                       torch.zeros((), dtype=row.dtype))


def _scalar_read(row, q, lim):
    """row[q], zero outside [0, lim): the scalar staging loop."""
    return torch.where((q >= 0) & (q < lim), row[q.clamp(0, row.shape[0] - 1)],
                       torch.zeros((), dtype=row.dtype))


def k1_schedule(n_windows, grid, slots):
    """K1's ring walk: CTA b stages windows b, b + grid, ... slots - 1
    ahead, each into the slot the previous window's end barrier released,
    and computes window w from slot (its iteration) % slots; asserts the
    slot holds w. Returns {window: (cta, slot)}."""
    seen = {}
    for b in range(min(grid, n_windows)):
        ring, w_next = [None] * slots, b
        for u in range(slots - 1):
            if w_next < n_windows:
                ring[u] = w_next
            w_next += grid
        slot, w = 0, b
        while w < n_windows:
            fill = slots - 1 if slot == 0 else slot - 1
            if w_next < n_windows:
                ring[fill] = w_next
            w_next += grid
            assert ring[slot] == w, (b, w, slot, ring)
            seen[w] = (b, slot)
            slot = 0 if slot + 1 == slots else slot + 1
            w += grid
    assert sorted(seen) == list(range(n_windows))
    return seen


def frontend_twin(pcm, grid=3, slots=4):
    """K1 as the kernel computes it, from int16 (or f32) PCM: windows of FR
    frames walked through a ring of `slots` by `grid` persistent CTAs,
    every channel's row staged with an 8-sample halo in 16-byte chunks
    (rows on 16 bytes) or by the scalar loop, kept in the input type and
    converted at use; lane k of warp 0 sums block k's squares channel by
    channel and counts its sign transitions, lanes 2f, 2f + 1 make frame
    f's count; stage-1 thread t computes outputs 4t..4t+3 of its window
    from arr at staged positions 20t + 3 .. 20t + 32, zero from the trim
    on, and stores those below n_bottom."""
    c, s = pcm.shape
    elem = pcm.element_size()
    n_windows = -(-s // RUN)
    k1_schedule(n_windows, grid, slots)
    vec = c == 1 or (s * elem) % 16 == 0
    q = (torch.arange(n_windows) * RUN - HALO)[:, None] + torch.arange(STAGE)
    xs = torch.stack([_chunk_read(pcm[ch], q, elem, s) if vec
                      else _scalar_read(pcm[ch], q, s) for ch in range(c)], 1)
    v = xs.half().float() if pcm.dtype == torch.int16 else xs

    lanes = HALO + 105 * torch.arange(2 * FR)
    e = torch.zeros(n_windows, 2 * FR)
    zc = torch.zeros(n_windows, 2 * FR, dtype=torch.int64)
    for ch in range(c):
        sp = torch.signbit(v[:, ch, lanes - 1])
        for i in range(105):
            x = v[:, ch, lanes + i]
            e = e + x * x
            sv = torch.signbit(x)
            zc += sv != sp
            sp = sv
    energy = (e / (105 * c)).reshape(-1)[:s // 105]
    pair = zc[:, 0::2] + zc[:, 1::2]
    crossings = (pair * (2 if c == 1 else 1)).reshape(-1)[:s // FRAME]

    trim = s // FRAME * FRAME
    lim = (trim - q[:, :1]).clamp(0, STAGE)
    arr = v[:, 0]
    if c > 1:
        for ch in range(1, c):
            arr = arr + v[:, ch]
        arr = (arr / c).half().float()
    arr = torch.where(torch.arange(STAGE)[None, :] < lim, arr,
                      torch.zeros(()))
    t = torch.arange(N1 // R1)[:, None]
    a = arr[:, 20 * t + 3 + torch.arange(5 * (R1 + 2))[None, :]]
    taps = [float(x) for x in hann_taps(17)]
    bottom, band = [], []
    for r in range(R1):
        part = [taps[i] * a[..., 5 * r + 10 + i] for i in range(5)]
        part = [part[i] + taps[i + 5] * a[..., 5 * r + 5 + i]
                for i in range(5)]
        part = [part[i] + taps[i + 10] * a[..., 5 * r + i] for i in range(5)]
        b = part[0]
        for i in range(1, 5):
            b = b + part[i]
        sq = None
        for i in range(5):
            d = a[..., 5 * r + 5 + i] - b
            sq = d * d if sq is None else sq + d * d
        bottom.append(b)
        band.append(sq)
    n1 = trim // 5
    return (energy, crossings.float(),
            torch.stack(bottom, -1).reshape(-1)[:n1],
            torch.stack(band, -1).reshape(-1)[:n1])


def _stage_twin(st, x, bot, blocks):
    """One K2 stage as its CTAs `blocks` (stage-local) compute it: each
    stages y's span and halo (16-byte chunks, zero outside [0, n)) or x's
    and bottom's and applies the prologue; phase item (g, i) takes phase
    i of outputs 9g .. 9g + 8 from a register window, blur-tap chains in
    tap order; one thread per output adds the phase partials in phase
    order and applies the epilogue. Returns (blocks' first outputs, their
    outputs)."""
    ds, blur, rr, per = st['ds'], st['blur'], st['r'], st['per_block']
    stride = 2 if st['epilogue'] == 1 else 1
    hb = blur - 1 - (blur - 1) // 2
    n = st['n']
    o0 = blocks * per
    span_y = ds * (stride * (per - 1) + blur)
    q = (ds * (stride * o0 - hb))[:, None] + torch.arange(span_y)[None, :]
    if st['prologue'] == 0:
        s_y = _chunk_read(x, q, 4, n)
    else:
        xq = rr * q[:, :1] + torch.arange(rr * span_y)[None, :]
        s_x = _chunk_read(x, xq, 4, rr * n)
        b = _chunk_read(bot, q, 4, n) if st['prologue'] == 1 else 0.
        v = None
        for i in range(rr):
            d = s_x[:, i::rr] - b
            v = d * d if v is None else v + d * d
        s_y = torch.where((q >= 0) & (q < n), v, torch.zeros(()))
    out = _fir_twin(s_y, ds, blur, stride, per)
    if st['epilogue'] == 2:
        out = out / 210.
    if st['epilogue']:
        out = torch.log10(1. + out) / 2.
    return o0, out


def _fir_twin(s_y, ds, blur, stride, per):
    """The phase items and the phase sum of one block row of staged y:
    (blocks, per) sums before the epilogue."""
    w = stride * (tfk.R2 - 1) + blur
    g = torch.arange(per // tfk.R2)[:, None, None]
    i = torch.arange(ds)[None, :, None]
    win = s_y[:, i + ds * (stride * tfk.R2 * g + torch.arange(w))]
    taps = torch.from_numpy(hann_taps(ds * blur + 2))
    tp = taps[torch.arange(ds)[:, None] + ds * torch.arange(blur)[None, :]]
    parts = []
    for r in range(tfk.R2):
        part = tp[:, 0] * win[..., stride * r + blur - 1]
        for m in range(1, blur):
            part = part + tp[:, m] * win[..., stride * r + blur - 1 - m]
        parts.append(part)
    p = torch.stack(parts, 2).reshape(s_y.shape[0], per, ds)
    out = p[..., 0]
    for k in range(1, ds):
        out = out + p[..., k]
    return out


def _band_epilogue(v):
    return torch.log10(1. + v / 210.) / 2.


def _fused_twin(st, bottom1, blocks):
    """Prologue 3 as its CTAs compute it: bottom 1 staged over 7 q - 7 ..
    7 q + 13 for the bottom-2 values q = 6 o0 - 42 .. 6 (o0 + per) + 41
    the block's band-2 and band-3 outputs read; bottom 2 recomputed there
    (7 phases of 3 taps), y2 (residual squares) and y3 (squares of 6) from
    it, then both FIRs. Returns (first outputs, band 2, band 3)."""
    per = st['per_block']
    o0 = blocks * per
    span2 = 6 * (per - 1 + 15)
    q2 = (6 * o0 - 42)[:, None] + torch.arange(span2)[None, :]
    n2 = st['n_src'] // 7
    b1 = _chunk_read(bottom1, 7 * q2[:, :1] - 7
                     + torch.arange(7 * span2 + 14)[None, :], 4, st['n_src'])
    taps = [float(t) for t in hann_taps(23)]
    b2 = None
    for i in range(7):
        part = taps[i] * b1[:, 14 + i::7][:, :span2]
        part = part + taps[i + 7] * b1[:, 7 + i::7][:, :span2]
        part = part + taps[i + 14] * b1[:, i::7][:, :span2]
        b2 = part if b2 is None else b2 + part
    b2 = torch.where((q2 >= 0) & (q2 < n2), b2, torch.zeros(()))
    y2 = None
    for i in range(7):
        d = b1[:, 7 + i::7][:, :span2] - b2
        y2 = d * d if y2 is None else y2 + d * d
    y2 = torch.where((q2 >= 0) & (q2 < st['n']), y2, torch.zeros(()))
    q3 = (o0 - 7)[:, None] + torch.arange(per + 14)[None, :]
    y3 = None
    for i in range(6):
        d = b2[:, i::6][:, :per + 14]
        y3 = d * d if y3 is None else y3 + d * d
    y3 = torch.where((q3 >= 0) & (q3 < n2 // 6), y3, torch.zeros(()))
    return (o0, _band_epilogue(_fir_twin(y2, 6, 15, 1, per)),
            _band_epilogue(_fir_twin(y3, 1, 15, 1, per)))


def group_twin(table, inputs):
    """One grouped K2 launch: every CTA of the grid finds its stage as the
    kernel does (the last stage whose first_block it has reached) and
    computes its outputs; each output is written by exactly one CTA."""
    grid = sum(st['n_blocks'] for st in table)
    blk = torch.arange(grid)
    stage = torch.zeros(grid, dtype=torch.int64)
    for k in range(1, len(table)):
        stage += blk >= table[k]['first_block']
    outs = []
    for k, (st, (x, bot)) in enumerate(zip(table, inputs)):
        local = blk[stage == k] - st['first_block']
        assert torch.equal(local, torch.arange(st['n_blocks']))
        if st['prologue'] == 3:
            o0, *vals = _fused_twin(st, x, local)
        else:
            o0, *vals = _stage_twin(st, x, bot, local)
        o = o0[:, None] + torch.arange(st['per_block'])[None, :]
        keep = o < st['n_out']
        assert keep.sum() == st['n_out']
        for v in vals:
            out = torch.full((st['n_out'],), float('nan'))
            out[o[keep]] = v[keep]
            outs.append(out)
    return outs


def blur_twin(x, ds, blur, r=0, bottom=None, epilogue=None):
    """polyphase_blur_cuda's one-stage table through group_twin."""
    table = tfk.stage_table([tfk.plan_stage(x.shape[0], ds, blur, r,
                                            bottom is not None, epilogue)])
    return group_twin(table, [(x, bottom)])[0]


def cascade_twin(energy, crossings, bottom1, band1):
    """polyphase_cascade_cuda's grouped launch through group_twin."""
    table = tfk.cascade_table(energy.shape[0], crossings.shape[0],
                              bottom1.shape[0], band1.shape[0])
    return group_twin(table, [(energy, None), (crossings, None),
                              (band1, None), (bottom1, None)])


# the cascade's six stages on K1's outputs (ops/features.py)
def _cascade_stages(energy, crossings, bottom1, band1):
    bottom2 = tfeat.polyphase_blur_plain(bottom1, 7, 3)
    return (((energy, 1, 13), dict(epilogue='energy')),
            ((crossings, 1, 13), {}),
            ((band1, 42, 15), dict(epilogue='band')),
            ((bottom1, 7, 3), {}),
            ((bottom1, 6, 15), dict(r=7, bottom=bottom2, epilogue='band')),
            ((bottom2, 1, 15), dict(r=6, epilogue='band')))


# (samples, channels, dtype): shorter than one window; a ragged last
# window with a partial frame (C = 1, S % 8 != 0, still on 16 bytes);
# stereo and 3 channels on 16 bytes; stereo and 3 channels off them (the
# scalar staging loop); f32 input, on and off 16 bytes
TWIN_CASES = [(2 * RUN // 3, 1, 'i16'), (3 * RUN + 2 * FRAME + 150, 1, 'i16'),
              (5 * RUN + 7 * FRAME + 105 + 9, 2, 'i16'), (4 * RUN, 3, 'i16'),
              (2 * RUN + 5 * FRAME + 3, 2, 'i16'), (RUN + 37, 3, 'i16'),
              (3 * RUN + 2 * FRAME + 150, 1, 'f32'),
              (2 * RUN + 5 * FRAME + 2, 2, 'f32')]


@pytest.mark.parametrize("s,c,dtype", TWIN_CASES)
def test_kernel_twins_bit_equal_to_plain(s, c, dtype):
    pcm = torch.from_numpy(_pcm(0, c, s, samples=s))
    if dtype == 'f32':
        pcm = pcm.float() * 0.37
    plain = tfeat.pcm_frontend_plain(pcm.half().float() if dtype == 'i16'
                                     else pcm)
    twin = frontend_twin(pcm, grid=2)
    for name, p, t in zip(("energy", "crossings", "bottom", "band"), plain,
                          twin):
        assert p.shape == t.shape and torch.equal(p, t), name
    for args, kw in _cascade_stages(*plain):
        p = tfeat.polyphase_blur_plain(*args, **kw)
        t = blur_twin(*args, **kw)
        assert p.shape == t.shape and torch.equal(p, t), (args[1:], kw)
    want = tfeat.polyphase_cascade_plain(*plain)
    for k, (p, t) in enumerate(zip(want, cascade_twin(*plain))):
        assert p.shape == t.shape and torch.equal(p, t), k


@pytest.mark.parametrize("slots", [1, 2, 3, 4])
def test_k1_ring_walk(slots):
    """Every window is computed once, from the slot that holds it, for
    grids below, at and above the window count."""
    for n_windows in (1, 2, 7, 40):
        for grid in (1, 3, 7, 64):
            seen = k1_schedule(n_windows, grid, slots)
            assert all(b == w % grid for w, (b, _) in seen.items())


@pytest.mark.parametrize("s", [2 * RUN // 3, 5 * RUN + 7 * FRAME + 114,
                               59270400, 73382400])
def test_stage_tables_cover_every_output_once(s):
    """The Python-built table of the cascade's grouped launch: each CTA
    finds one stage, stage k's CTAs are first_block .. first_block +
    n_blocks - 1, and their outputs cover every output of the stage once;
    outputs per CTA a multiple of R2, shared memory within the target."""
    n_e, n_f = s // 105, s // 210
    n1 = n_f * 42
    table = tfk.cascade_table(n_e, n_f, n1, n1)
    first = np.array([st['first_block'] for st in table])
    grid = sum(st['n_blocks'] for st in table)
    owner = np.searchsorted(first, np.arange(grid), side='right') - 1
    for k, st in enumerate(table):
        assert st['per_block'] % tfk.R2 == 0
        assert 4 * tfk.stage_smem_floats(st) <= tfk.K2_SMEM_TARGET
        mine = np.nonzero(owner == k)[0] - st['first_block']
        np.testing.assert_array_equal(mine, np.arange(st['n_blocks']))
        o = (mine[:, None] * st['per_block']
             + np.arange(st['per_block'])[None, :]).ravel()
        counts = np.bincount(o[o < st['n_out']], minlength=st['n_out'])
        assert len(counts) == st['n_out'] and (counts == 1).all()
    assert [st['n_out'] for st in table] == [-(-n_e // 2)] + [n_f] * 3
    assert [st['prologue'] for st in table] == [0, 0, 0, 3]


def test_twin_centres_phases_with_unequal_tap_counts():
    """_downsample_blur's per-phase count and centre for L not a multiple
    of ds (17 taps over 5 phases: 4, 4, 3, 3, 3), against _conv_same on
    each strided phase added in phase order."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        500).astype(np.float32))
    taps = hann_taps(19)
    want = None
    for i in range(5):
        part = tfeat._conv_same(x[i::5], taps[i::5])
        want = part if want is None else want + part
    got = None
    for i in range(5):
        t = (17 - i + 4) // 5
        c = (t - 1) // 2
        j = torch.arange(100)
        part = None
        for m in range(t):
            q = 5 * (j + c - m) + i
            y = torch.where((q >= 0) & (q < 500), x[q.clamp(0, 499)],
                            torch.zeros(()))
            part = float(taps[i + 5 * m]) * y if part is None else (
                part + float(taps[i + 5 * m]) * y)
        got = part if got is None else got + part
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
    reads 2 B and writes ~1.66 B per sample (485 MB in all); the cascade
    must read K1's four outputs once and write the five streams, 92 f32
    per frame (232 MB)."""
    work = [tfk.feature_work(1, s) for s in (73382400, 59270400)]
    k1 = sum(w['pcm_frontend'] for w in work)
    assert abs(k1 / 132652800 - (2 + 4 * (1 / 105 + 1 / 210 + 2 / 5))) < 1e-6
    assert 484e6 < k1 < 486e6
    frames = (73382400 + 59270400) // 210
    assert sum(w['polyphase_blur'] for w in work) == 4 * 92 * frames
    assert 232e6 < 4 * 92 * frames < 233e6


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
