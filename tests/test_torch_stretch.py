"""Port parity: the stretch backends (stretch/phase_vocoder.py,
stretch/resample.py, stretch/segments.py, the recurrence of
ops/pv_kernel.py) against the JAX package's, on the CPU.

- The host phase vocoder is the JAX package's code on the same host
  library: bit-equal.
- The device phase vocoder (`_pv_device`: torch.fft, the recurrence's
  plain version on the CPU) against the JAX `_pv_segment` (XLA): the two
  FFTs differ by rounding (~1e-7 of a frame's peak), which is invisible in
  the bins that carry the signal, but a rounding-sized change can flip a
  bin's round(dphi / 2 pi) or move identity locking's choice between
  near-equal neighbours; each such flip turns the bin's synthesis phase.
  Measured: on a tone every sample but the segment's last N_FFT within one
  f16 grid step of the larger value, or 0.25 where that step is finer (the
  f32 outputs differ by up to 0.21 before the write-back; the last frames
  read into the zeros after the segment, where bins of ~1e-3 of the peak
  carry the transient: up to 88 there), the RMS of the difference 1.7e-4
  of the signal's; on stereo noise 2.2e-3, with the flips counted.
- The device resampler against the JAX `_resample_full`: within one f16
  grid step of the output (2^-10 below 1); its float32 positions are
  rounded once, as XLA's fused multiply-add rounds them.
- The recurrence's plain version against the JAX package's numpy
  `_phase_lock` within its own test's atol 1e-5 (tests/test_stretch.py),
  and the kernels' tiling twin (a numpy emulation of csrc/pv_lock.cu's
  three passes: the prologue's per-lane records with the locking choice
  as byte-permute selectors, the walk's contiguous bin runs per lane with
  the shuffles at their edges and zero ends, the write-back in the walk's
  order and the epilogue's gather, the block carry) bit-equal to the plain version,
  ties at run boundaries included.
"""
import os

import numpy as np
import pytest
import torch

from describealign_tpu.alignment import native as jnative
from describealign_tpu.stretch import phase_vocoder as jpv
from describealign_tpu.stretch import resample as jrs
from describealign_tpu.stretch import segments as jseg
from describealign_tpu_torch.ops import pv_kernel as pk
from describealign_tpu_torch.stretch import phase_vocoder as tpv
from describealign_tpu_torch.stretch import resample as trs
from describealign_tpu_torch.stretch import segments as tseg

SR = 44100
NOISE_RMS_REL = 5e-3        # device PV vs JAX on noise: RMS of the diff
TONE_RMS_REL = 1e-3         # ... on a tone
MAX_FLIP_SHARE = 1e-3       # flipped wraps among the bins that matter


def tone(freq, seconds, amp=8000.0, channels=1):
    t = np.arange(int(seconds * SR)) / SR
    sig = (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    return np.tile(sig, (channels, 1))


def noise(seconds, seed, channels=2, amp=3000.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((channels, int(seconds * SR)))
            * amp).astype(np.float32)


def f16_step(x):
    """The f16 grid's spacing at max(|x|, 1): the write-back's resolution,
    floored at 2^-10 where the grid is finer than the f32 values' own
    rounding near zero (measured there: up to 5e-6)."""
    return np.spacing(np.maximum(np.abs(x), 1.0).astype(np.float16)
                      ).astype(np.float32)


def rms(x):
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def jax_pv(sig, num_out, monkeypatch, backend):
    monkeypatch.setenv("DESCRIBEALIGN_PV", backend)
    try:
        return jpv.pv_stretch(sig, num_out)
    finally:
        monkeypatch.delenv("DESCRIBEALIGN_PV")


# ---------------------------------------------------------------------------
# the phase-lock recurrence
# ---------------------------------------------------------------------------

def _lock_inputs(seed, ties):
    rng = np.random.default_rng(seed)
    c, f, bins = 2, 9, 33
    phase_a = rng.uniform(-np.pi, np.pi, (c, f, bins)).astype(np.float32)
    if ties:    # magnitudes on a coarse grid: equal neighbours everywhere
        mag = rng.integers(0, 3, (c, f, bins)).astype(np.float32)
    else:
        mag = rng.uniform(0.0, 10.0, (c, f, bins)).astype(np.float32)
    ior = rng.uniform(-1.0, 1.0, (c, f, bins)).astype(np.float32)
    init = rng.uniform(-np.pi, np.pi, (c, bins)).astype(np.float32)
    return phase_a, mag, ior, init


@pytest.mark.parametrize("case", ["whole", "carry", "ties_whole",
                                  "ties_carry"])
def test_phase_lock_plain_matches_jax_numpy(case, monkeypatch):
    phase_a, mag, ior, init = _lock_inputs(11, case.startswith("ties"))
    if case.endswith("whole"):
        ior, init = ior[:, 1:], None
    monkeypatch.setattr(jnative, "native_lib", lambda: None)
    want = jpv._phase_lock(phase_a, mag, ior, init)
    got = pk.phase_lock_plain(*[None if a is None else torch.from_numpy(a)
                                for a in (phase_a, mag, ior, init)])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the port's host path, the host library's recurrence, agrees too
    host = tpv._phase_lock(np.ascontiguousarray(phase_a), mag,
                           np.ascontiguousarray(ior), init)
    np.testing.assert_allclose(host, want, rtol=0, atol=1e-5)


def test_pv_phase_lock_blocks_equal_whole():
    rng = np.random.default_rng(5)
    spec = torch.from_numpy((rng.standard_normal((2, 40, pk.BINS))
                             + 1j * rng.standard_normal((2, 40, pk.BINS)))
                            .astype(np.complex64))
    omega = torch.from_numpy((2 * np.pi * np.arange(pk.BINS) * 256 / 1024)
                             .astype(np.float32))
    before = pk.pv_phase_lock.launches
    whole, carry_w = pk.pv_phase_lock(spec, omega, 1.03)
    parts, carry = [], None
    for k0 in range(0, 40, 13):
        out, carry = pk.pv_phase_lock(spec[:, k0:k0 + 13].contiguous(),
                                      omega, 1.03, carry)
        parts.append(out)
    assert torch.equal(torch.cat(parts, 1), whole)
    assert torch.equal(carry, carry_w)
    assert pk.pv_phase_lock.launches == before  # the CPU launches none


def test_pv_phase_lock_checks():
    spec = torch.zeros((1, 4, pk.BINS), dtype=torch.complex64)
    omega = torch.zeros(pk.BINS)
    with pytest.raises(ValueError, match="complex64"):
        pk.pv_phase_lock(spec.real.contiguous(), omega, 1.0)
    with pytest.raises(ValueError, match="carry"):
        pk.pv_phase_lock(spec, omega, 1.0, torch.zeros((2, 2, pk.BINS)))
    with pytest.raises(ValueError, match="omega"):
        pk.pv_phase_lock(spec, torch.zeros(7), 1.0)
    nbytes, flops = pk.pv_lock_work(2, 100)
    assert nbytes == 16 * 2 * 100 * pk.BINS and flops == 20 * 2 * 100 * pk.BINS


# ---------------------------------------------------------------------------
# the phase vocoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tone", "noise"])
def test_pv_host_bit_equal_to_jax(name, monkeypatch):
    sig = tone(440, 3.0) if name == "tone" else noise(4.0, 0)
    num_out = int(sig.shape[1] * (1.08 if name == "tone" else 0.93))
    got = tpv.pv_stretch(sig, num_out, backend="host")
    np.testing.assert_array_equal(got, jax_pv(sig, num_out, monkeypatch,
                                              "host"))


def _wrap_flips(sig, num_out):
    """Bins (with at least 1e-4 of their frame's peak magnitude) whose
    round(dphi / 2 pi) differs between the JAX and the torch analysis
    FFTs, and how many such bins there are."""
    import jax.numpy as jnp
    c, n_in = sig.shape
    rate = np.float32(n_in / num_out)
    f = -(-num_out // tpv.HOP_SYN)
    pos = np.round(np.arange(f, dtype=np.float32)
                   * (np.float32(tpv.HOP_SYN) * rate)).astype(np.int64)
    pad = np.zeros((c, pos[-1] + tpv.N_FFT), np.float32)
    pad[:, :n_in] = sig
    frames = pad[:, pos[:, None] + np.arange(tpv.N_FFT)] * tpv._WINDOW
    omega = (2 * np.pi * np.arange(pk.BINS) * tpv.HOP_SYN
             / tpv.N_FFT).astype(np.float32)

    def wraps(spec):
        pa = np.arctan2(spec.imag, spec.real).astype(np.float32)
        dphi = pa[:, 1:] - pa[:, :-1] - omega * rate
        return np.rint(dphi / np.float32(2 * np.pi))
    sj = np.asarray(jnp.fft.rfft(jnp.asarray(frames), axis=2))
    st = torch.fft.rfft(torch.from_numpy(frames), dim=2).numpy()
    mag = np.abs(sj[:, 1:])
    matters = mag >= 1e-4 * mag.max(axis=2, keepdims=True)
    return int(np.sum((wraps(sj) != wraps(st)) & matters)), int(matters.sum())


@pytest.mark.parametrize("name", ["tone", "noise"])
def test_pv_device_matches_jax(name, monkeypatch):
    sig = tone(440, 3.0) if name == "tone" else noise(4.0, 0)
    num_out = int(sig.shape[1] * (1.08 if name == "tone" else 0.93))
    got = tpv.pv_stretch(sig, num_out, backend="device", device="cpu")
    want = jax_pv(sig, num_out, monkeypatch, "device")
    assert got.shape == want.shape == (sig.shape[0], num_out)
    diff = got - want
    flips, bins = _wrap_flips(sig, num_out)
    assert flips <= MAX_FLIP_SHARE * bins, (flips, bins)
    if name == "tone":
        # but in the last N_FFT samples: one f16 grid step of the larger
        # value, or 0.25 where that step is finer than the f32 outputs'
        # own difference (measured 0.21 before the write-back)
        body = slice(0, num_out - tpv.N_FFT)
        step = f16_step(np.maximum(np.abs(got[:, body]),
                                   np.abs(want[:, body])))
        assert (np.abs(diff[:, body]) <= np.maximum(step, 0.25)).all()
        assert rms(diff) < TONE_RMS_REL * rms(want)
    else:
        assert rms(diff) < NOISE_RMS_REL * rms(want)
    # and the device PV is a phase vocoder like the host one
    host = tpv.pv_stretch(sig, num_out, backend="host")
    assert rms(got - host) < NOISE_RMS_REL * rms(host)


def test_pv_device_block_carry_equals_one_block():
    sig = noise(3.0, 1)
    num_out = int(sig.shape[1] / 1.04)
    rate = sig.shape[1] / num_out
    whole = tpv._pv_device(sig, rate, num_out, "cpu", block_frames=1 << 20)
    for blk in (37, 256):
        np.testing.assert_array_equal(
            tpv._pv_device(sig, rate, num_out, "cpu", block_frames=blk),
            whole)


def test_pv_stretch_rejects_unknown_backend():
    with pytest.raises(ValueError, match="phase-vocoder backend"):
        tpv.pv_stretch(tone(440, 2.0), 90000, backend="gpu")


# ---------------------------------------------------------------------------
# the resampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_start,x_end,ratio", [
    (7.0, -3.0, 1.04), (0.0, 0.0, 0.97), (1000.0, 0.0, 1.003)])
def test_resample_device_matches_jax(x_start, x_end, ratio, monkeypatch):
    """Inside the array, from its first sample (the base clipped to 1)
    and up to its last (the bucket's zeros read past it)."""
    sig = np.concatenate([tone(440, 2.0, amp=5000), tone(523, 2.0, amp=5000)])
    x_end = sig.shape[1] + x_end
    num_out = int((x_end - x_start) * ratio)
    got = trs.resample_segment(sig, x_start, x_end, num_out,
                               backend="device", device="cpu")
    monkeypatch.setenv("DESCRIBEALIGN_RESAMPLE", "device")
    want = jrs.resample_segment(sig, x_start, x_end, num_out)
    assert got.shape == want.shape == (2, num_out)
    step = f16_step(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= step).all()
    # the host path is the JAX package's host path
    monkeypatch.delenv("DESCRIBEALIGN_RESAMPLE")
    np.testing.assert_array_equal(
        trs.resample_segment(sig, x_start, x_end, num_out),
        jrs.resample_segment(sig, x_start, x_end, num_out))


# ---------------------------------------------------------------------------
# segment replacement
# ---------------------------------------------------------------------------

COMBOS = [(s, p, r) for s in ("wsola", "pv") for p in ("host", "device")
          for r in ("host", "device")]


@pytest.mark.parametrize("last", ["resampled", "stretched"])
@pytest.mark.parametrize("stretcher,pv_backend,resample_backend", COMBOS)
def test_replace_aligned_segments_matches_jax(stretcher, pv_backend,
                                              resample_backend, last,
                                              monkeypatch, capsys):
    """Two 5-s video segments, one 3 % off (the stretcher), one 0.4 % (the
    resampler); `last` is the one that reads up to the description's last
    sample."""
    audio = np.concatenate([tone(440, 10.17, amp=5000),
                            noise(10.17, 4, channels=1, amp=1500)])
    video = np.concatenate([tone(300, 12.0), tone(310, 12.0)])
    a_t = np.array([0.0, 5.15 if last == "resampled" else 5.02, 10.17])
    v_t = np.array([0.0, 5.0, 10.0])
    got = video.copy()
    tseg.replace_aligned_segments(got, audio, a_t, v_t, False, stretcher,
                                  pv_backend, resample_backend, device="cpu")
    printed = capsys.readouterr().out
    monkeypatch.setenv("DESCRIBEALIGN_STRETCH", stretcher)
    monkeypatch.setenv("DESCRIBEALIGN_PV", pv_backend)
    monkeypatch.setenv("DESCRIBEALIGN_RESAMPLE", resample_backend)
    want = video.copy()
    jseg.replace_aligned_segments(want, audio, a_t, v_t, False)
    assert capsys.readouterr().out == printed
    first, second = slice(0, int(5.0 * SR)), slice(int(5.0 * SR),
                                                  int(10.0 * SR))
    stretched, resampled = ((first, second) if last == "resampled"
                            else (second, first))
    np.testing.assert_array_equal(got[:, int(10.0 * SR):],
                                  want[:, int(10.0 * SR):])
    if stretcher == "wsola" or pv_backend == "host":
        np.testing.assert_array_equal(got[:, stretched], want[:, stretched])
    else:
        d = got[:, stretched] - want[:, stretched]
        assert rms(d) < NOISE_RMS_REL * rms(want[:, stretched])
    if resample_backend == "host":
        np.testing.assert_array_equal(got[:, resampled], want[:, resampled])
    else:
        g, w = got[:, resampled], want[:, resampled]
        assert (np.abs(g - w)
                <= f16_step(np.maximum(np.abs(g), np.abs(w)))).all()


def test_replace_aligned_segments_rejects_unknown_stretcher():
    with pytest.raises(ValueError, match="stretcher"):
        tseg.replace_aligned_segments(np.zeros((1, 10)), np.zeros((1, 10)),
                                      [0.0], [0.0], False, "ola")


# ---------------------------------------------------------------------------
# combine() with the phase vocoder, against the JAX CLI
# ---------------------------------------------------------------------------

def test_combine_pv_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """A 3 %-slowed description (the bench's rate pair, cut to 40 s): the
    port's combine(stretcher='pv') writes the JAX CLI's WAV bytes (the JAX
    package with DESCRIBEALIGN_STRETCH=pv; both PVs on the host)."""
    from scipy.signal import resample_poly

    from describealign_tpu import cli as jcli
    from describealign_tpu.media.decode import write_wav
    from describealign_tpu_torch import pipeline as tpipe
    from tests.synth import speech_like
    content = speech_like(40.0, seed=606)
    slowed = resample_poly(content, 103, 100)
    lead = speech_like(6.0, seed=1606, amp=5000.0)
    v = np.clip(np.round(content), -32768, 32767).astype(np.int16)
    a = np.clip(np.round(np.concatenate([lead, slowed])), -32768,
                32767).astype(np.int16)
    write_wav(tmp_path / "film.wav", np.stack([v, v // 2]))
    write_wav(tmp_path / "desc.wav", np.stack([a, a // 2]))
    media = [str(tmp_path / "film.wav"), str(tmp_path / "desc.wav")]
    runs = {}
    for name in ("port", "jax"):
        out, plots = str(tmp_path / name / "o"), str(tmp_path / name / "p")
        if name == "port":
            tpipe.combine([media[0]], [media[1]], stretch_audio=True,
                          yes=True, output_dir=out, alignment_dir=plots,
                          device="cpu", stretcher="pv")
        else:
            monkeypatch.setenv("DESCRIBEALIGN_STRETCH", "pv")
            jcli.command_line_interface(media + [
                "--stretch_audio", "--yes", "--output_dir", out,
                "--alignment_dir", plots])
        runs[name] = capsys.readouterr().out
        with open(os.path.join(out, "ad_film.wav"), "rb") as f:
            runs[name + "_wav"] = f.read()
    assert "stretching audio" in runs["port"]
    assert runs["port_wav"] == runs["jax_wav"]
    # the alignment found the 3 % rate: the PV, not the resampler, ran
    with open(tmp_path / "port" / "p" / "film.txt") as f:
        report = f.read()
    rate = float(report.split("Median Rate Change:")[1].split("%")[0])
    assert 2.0 < abs(rate) < 4.0, report


# ---------------------------------------------------------------------------
# the kernel's tiling twin
# ---------------------------------------------------------------------------

def pv_twin(spec, omega, rate, block_frames):
    """csrc/pv_lock.cu's three passes emulated in numpy f32, in launches of
    block_frames frames with the carry. Prologue: per lane's run of bins
    and frame pa, the wrapped increment's q and the locking choice as a
    selector word (byte-permute selectors: take the left / the right
    neighbour's rotation or keep; zeros past both edges, dead runs zero).
    Walk: each lane of the walking warps owns a contiguous run of bins in
    registers (runs past the bins read zero records and stay zero); per
    frame the own rotations, the neighbours across run edges (the
    shuffles, and across warps the edge values exchanged under the
    walkers' barrier: the previous run's last, the next run's first; zero
    at the ends), the two byte permutes on the rotations' bits and
    the locked phase, written back in the walk's order. Epilogue: lk gathered back to bins, mag (cos, sin). The
    transcendental functions come from the plain version's torch calls on
    the whole array, the rest is elementwise f32."""
    f32 = np.float32
    c, f, bins = spec.shape
    run, lanes, _, lk_run = pk.walk_layout()
    b_run = np.arange(lanes)[:, None] * run + np.arange(run)[None, :]
    live = b_run < bins
    mag_all = torch.hypot(spec.real, spec.imag).numpy()
    pa_all = torch.atan2(spec.imag, spec.real).numpy()
    om = (omega * torch.tensor(rate)).numpy()
    rate, two_pi = f32(rate), f32(pk.TWO_PI)
    locked = np.empty((c, f, bins), np.float32)
    carry = None

    def by_run(x):
        """(..., bins) -> (..., lanes, run), zeros past the bins."""
        out = np.zeros(x.shape[:-1] + (lanes * run,), x.dtype)
        out[..., :bins] = x
        return out.reshape(x.shape[:-1] + (lanes, run))

    def permute(x, y, sel):
        """prmt(x, y, sel) for the selectors the walk meets: KEEP, TAKE and
        0 (no record: byte 0 of x four times)."""
        sel = sel & 0xFFFF
        assert np.isin(sel, (pk.KEEP, pk.TAKE, 0)).all()
        return np.where(sel == pk.TAKE, y, np.where(
            sel == 0, (x & 0xFF) * np.uint32(0x01010101), x))

    for k0 in range(0, f, block_frames):
        k1 = min(k0 + block_frames, f)
        fb = k1 - k0
        pa, mag = pa_all[:, k0:k1], mag_all[:, k0:k1]
        # prologue
        first = pa[:, :1] if carry is None else carry[0][:, None]
        prev = np.concatenate([first, pa[:, :-1]], 1)
        dphi = ((pa - prev).astype(f32) - om).astype(f32)
        dphi = (dphi - two_pi * np.rint(dphi / two_pi)).astype(f32)
        q = ((om + dphi).astype(f32) / rate).astype(f32)
        if carry is None:
            q[:, 0] = 0
        zero = np.zeros((c, fb, 1), np.float32)
        lm = np.concatenate([zero, mag[:, :, :-1]], 2)
        rm = np.concatenate([mag[:, :, 1:], zero], 2)
        take_l = lm > np.maximum(mag, rm)
        take_r = ~take_l & (rm > mag)
        sel = (np.where(take_l, pk.TAKE, pk.KEEP)
               | np.where(take_r, pk.TAKE, pk.KEEP) << 16).astype(np.uint32)
        rec_pa, rec_q = by_run(pa), by_run(q)
        rec_sel = by_run(sel)
        rec_sel[:, :, ~live] = pk.KEEP | pk.KEEP << 16
        rec_sel[:, :, b_run[:, 0] >= bins] = 0    # dead runs: zero records
        # walk, one CTA per channel; lk written back in the walk's order
        lkbuf = np.full(c * fb * lanes * lk_run, np.nan, np.float32)
        lk_out = np.empty((c, bins), np.float32)
        for ch in range(c):
            lk = np.zeros((lanes, run), np.float32)
            if carry is not None:
                lk[live] = carry[1, ch, b_run[live]]
            for kk in range(fb):
                p_, q_, s_ = rec_pa[ch, kk], rec_q[ch, kk], rec_sel[ch, kk]
                if kk == 0 and carry is None:
                    lk = p_.copy()
                else:
                    rot = ((lk + q_).astype(f32) - p_).astype(f32)
                    left = np.concatenate([[0], rot[:-1, -1]]).astype(f32)
                    right = np.concatenate([rot[1:, 0], [0]]).astype(f32)
                    lft = np.concatenate([left[:, None], rot[:, :-1]], 1)
                    rgt = np.concatenate([rot[:, 1:], right[:, None]], 1)
                    bits = [x.view(np.uint32) for x in (rot, lft, rgt)]
                    dom = permute(permute(bits[0], bits[1], s_), bits[2],
                                  s_ >> 16).view(np.float32)
                    lk = (p_ + dom).astype(f32)
                lkbuf[pk.lk_index(kk, b_run, fb, ch)] = lk
            lk_out[ch] = lk[live]
        # epilogue
        kb = np.arange(fb)[:, None]
        for ch in range(c):
            locked[ch, k0:k1] = lkbuf[pk.lk_index(kb, np.arange(bins), fb,
                                                  ch)]
        carry = np.stack([pa[:, -1], lk_out])
    lk = torch.from_numpy(locked)
    mg = torch.from_numpy(mag_all)
    return (torch.complex(mg * torch.cos(lk), mg * torch.sin(lk)),
            torch.from_numpy(carry))


def _run_boundary_ties(re, im):
    """Equal magnitudes across every run boundary of the walk (bins 8 | 9,
    17 | 18, ...; 287 | 288 between its two warps) and at bins 16 | 17: bin b
    mirrors bin b - 1 (the real part negated), so the magnitudes tie bit
    for bit while the phases differ."""
    run = pk.walk_layout()[0]
    for b in sorted(set(range(run, pk.BINS, run)) | {17}):
        re[..., b], im[..., b] = -re[..., b - 1], im[..., b - 1]
    return re, im


@pytest.mark.parametrize("block_frames,ties", [(1 << 20, False), (7, False),
                                               (6, True), (5, "runs")])
def test_pv_twin_bit_equal_to_plain(block_frames, ties):
    rng = np.random.default_rng(3)
    shape = (2, 30, pk.BINS)
    re, im = rng.standard_normal(shape), rng.standard_normal(shape)
    if ties is True:    # integer spectra: equal neighbouring magnitudes
        re, im = np.round(re * 2), np.round(im * 2)
    elif ties == "runs":
        re, im = _run_boundary_ties(re, im)
        mag = np.hypot(re, im)
        assert (mag[..., 16] == mag[..., 17]).all()
    spec = torch.from_numpy((re + 1j * im).astype(np.complex64))
    omega = torch.from_numpy((2 * np.pi * np.arange(pk.BINS) * 256 / 1024)
                             .astype(np.float32))
    rate = float(np.float32(1.0 / 0.97))
    want, carry_w = pk.pv_phase_lock_plain(spec, omega, rate)
    got, carry_g = pv_twin(spec, omega, rate, block_frames)
    assert torch.equal(got, want)
    assert torch.equal(carry_g, carry_w)


def test_pv_walk_layout():
    """The walking warps' lanes own contiguous runs of 9 covering every
    bin; each lane's record keeps the vector loads' 16-byte alignment; the
    write-back index is one to one."""
    run, lanes, rec, lk_run = pk.walk_layout()
    assert (run, lanes) == (9, 32 * pk.WALK_WARPS)
    assert run * lanes >= pk.MAX_BINS
    assert rec == lanes * 16 * (-(-3 * run // 4)) and rec % 16 == 0
    assert lk_run % 4 == 0 and lk_run >= run
    f = 9
    idx = pk.lk_index(np.arange(f)[:, None], np.arange(pk.BINS)[None], f)
    assert len(np.unique(idx)) == idx.size


@pytest.mark.parametrize("shape", ["block", "segment"])
def test_pv_lock_work_counts(shape):
    """The bound's bytes at the path's block and the rate pair's whole
    segment (227,390 stereo frames): 16 bytes per bin and frame, the
    function's least; the three passes as built move more."""
    f = 8192 if shape == "block" else 227390
    nbytes, flops = pk.pv_lock_work(2, f)
    assert nbytes == 16 * 2 * f * 513 and flops == 20 * 2 * f * 513
    if shape == "segment":
        assert abs(nbytes / 3.35e12 * 1e3 - 1.114) < 1e-3
    passes = pk.pv_pass_bytes(2, f)
    _, lanes, rec, lk_run = pk.walk_layout()
    assert passes["walk"] == 2 * f * (rec + 4 * lanes * lk_run)
    assert passes["prologue"] == 2 * f * (8 * 513 + rec)
    assert passes["epilogue"] == 2 * f * 20 * 513
    assert sum(passes.values()) > nbytes
