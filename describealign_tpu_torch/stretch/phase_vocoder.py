"""Pitch-preserving time stretch: the phase vocoder, on the host or on the
device.

The port of describealign_tpu/stretch/phase_vocoder.py: the segment is
cut into Hann-windowed analysis frames at hop HOP_SYN * rate, the phases
advance with the classic phase-vocoder recurrence plus identity phase
locking (Laroche & Dolson style), and the inverse FFTs overlap-add at
HOP_SYN with a window-sum normalisation. Rates are within +/-10 % (the
segment rule).

- backend='host' (the JAX package's default): `_pv_host`, numpy + scipy
  over bounded frame blocks with the native `pv_phase_lock[_carry]`
  recurrence - the JAX package's host PV, copied unchanged.
- backend='device': `_pv_device`, the JAX package's `_pv_segment` in
  torch on `device` (torch.fft for the FFTs, cuFFT on the card; the frame
  recurrence in the hand-written kernel of ops/pv_kernel.py on CUDA, its
  plain version on the CPU), walked in bounded frame blocks that carry the
  last analysis phase and the last locked phase. Its output equals the
  JAX program's bucketed one: frames are read from the zero-padded segment
  without the bucket's position clip (which never binds for a live frame)
  and only live frames are computed (the others add nothing below
  num_out). Unlike `_pv_host`, which clips frame positions at n_in + 7,
  the last live frame may read further into the zeros, as JAX's does.
"""
import numpy as np
import torch

from ..constants import AUDIO_SAMPLE_RATE
from ..ops.windows import hann_window

N_FFT = 1024
HOP_SYN = 256
_BINS = N_FFT // 2 + 1
_WINDOW = hann_window(N_FFT).astype(np.float32)
MIN_BUCKET = AUDIO_SAMPLE_RATE * 2  # segments are >= 2 s by the rules
PV_BACKENDS = ('host', 'device')


def _phase_lock(phase_a, mag, inst_over_rate, init_locked=None):
    """Locked synthesis phases (the host library's C++ recurrence). The
    frame recurrence is sequential because the locked phase is the carry.

    init_locked=None: whole-segment semantics (frame 0's phases pass
    through; inst_over_rate is (C, F-1, BINS)). With init_locked (C, BINS):
    chunked semantics - every frame runs the recurrence seeded by the
    previous block's last locked phases, and inst_over_rate[k] is the
    increment from frame k-1 (shape (C, F, BINS))."""
    import ctypes

    from ..alignment.native import native_lib

    def f32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    c, f, bins = phase_a.shape
    lib = native_lib()
    phases = np.empty_like(phase_a)
    if init_locked is None:
        rc = lib.pv_phase_lock(
            f32p(phase_a), f32p(mag), f32p(inst_over_rate),
            ctypes.c_int64(c), ctypes.c_int64(f), ctypes.c_int64(bins),
            f32p(phases))
    else:
        init_locked = np.ascontiguousarray(init_locked, np.float32)
        rc = lib.pv_phase_lock_carry(
            f32p(phase_a), f32p(mag), f32p(inst_over_rate),
            f32p(init_locked),
            ctypes.c_int64(c), ctypes.c_int64(f), ctypes.c_int64(bins),
            f32p(phases))
    if rc != 0:
        raise RuntimeError(f"native pv_phase_lock failed ({rc})")
    return phases


# frames per streamed block of the host PV: the spectral working set is
# ~9 arrays x (C, BLKF, N_FFT) f32 = ~70 MB at stereo/2048, vs GBs for
# media-length segments materialized whole (a 22-min all-stretched segment
# is ~230k frames)
_HOST_BLK_FRAMES = 2048


def _pv_host(seg, rate, num_out):
    """Host phase vocoder: the same math as the device path, vectorized
    numpy/scipy over bounded frame blocks (the locked phase carries across
    blocks, so block boundaries are exact - identical arithmetic to the
    whole-segment pipeline; only the overlap-add's FP accumulation order
    differs at block seams, inside the final f16 write-back grid)."""
    import scipy.fft

    c, n_in = seg.shape
    f = -(-num_out // HOP_SYN)                      # frames with k*HOP < out
    pad = np.zeros((c, n_in + N_FFT + 8), np.float32)
    pad[:, :n_in] = seg
    # row-gather through a sliding-window view copies contiguous frames
    # (4 KB memcpy each) instead of the elementwise 2-D fancy-index gather
    sw = np.lib.stride_tricks.sliding_window_view(pad, N_FFT, axis=1)
    omega = (2 * np.pi * np.arange(_BINS) * HOP_SYN / N_FFT).astype(np.float32)
    omega_rate = omega[None, None, :] * rate

    out_len = f * HOP_SYN + N_FFT
    out = np.zeros((c, out_len), np.float32)
    wsum = np.zeros(out_len, np.float32)
    w2 = (_WINDOW * _WINDOW).astype(np.float32)

    prev_phase_a = None                 # (C, 1, BINS) last frame of block
    prev_locked = None                  # (C, BINS) carried locked phases
    for b0 in range(0, f, _HOST_BLK_FRAMES):
        b1 = min(b0 + _HOST_BLK_FRAMES, f)
        fb = b1 - b0
        k = np.arange(b0, b1)
        pos = np.clip(np.round(k * (HOP_SYN * rate)).astype(np.int64), 0,
                      pad.shape[1] - N_FFT - 1)
        frames = np.empty((c, fb, N_FFT), np.float32)
        for ch in range(c):
            np.multiply(sw[ch][pos], _WINDOW[None, :], out=frames[ch])
        spec = scipy.fft.rfft(frames, axis=2)       # (C, fb, BINS) complex64
        # sqrt(re^2+im^2) skips complex abs's overflow-safe hypot (values
        # are bounded by N_FFT * PCM amplitude, far inside f32 range)
        re, im = spec.real, spec.imag
        mag = np.ascontiguousarray(
            np.sqrt(re * re + im * im, dtype=np.float32))
        phase_a = np.ascontiguousarray(np.arctan2(im, re).astype(np.float32))
        # all-frames phase increments are vectorized; the frame recurrence
        # stays a loop because the LOCKED phase is what carries forward
        if b0 == 0:
            dphi = phase_a[:, 1:] - phase_a[:, :-1] - omega_rate
            dphi -= 2 * np.pi * np.round(dphi / (2 * np.pi))
            inst_over_rate = np.ascontiguousarray(
                (omega_rate + dphi) / rate, np.float32)
            phases = _phase_lock(phase_a, mag, inst_over_rate)
        else:
            pa_ext = np.concatenate([prev_phase_a, phase_a], axis=1)
            dphi = pa_ext[:, 1:] - pa_ext[:, :-1] - omega_rate
            dphi -= 2 * np.pi * np.round(dphi / (2 * np.pi))
            inst_over_rate = np.ascontiguousarray(
                (omega_rate + dphi) / rate, np.float32)
            phases = _phase_lock(phase_a, mag, inst_over_rate, prev_locked)
        prev_phase_a = phase_a[:, -1:].copy()
        prev_locked = phases[:, -1].copy()
        # stay in single precision: 1j*phases would promote to complex128
        spec_out = np.empty(phases.shape, np.complex64)
        np.multiply(mag, np.cos(phases), out=spec_out.real)
        np.multiply(mag, np.sin(phases), out=spec_out.imag)
        frames_out = scipy.fft.irfft(spec_out, n=N_FFT, axis=2)  # f32
        np.multiply(frames_out, _WINDOW[None, None, :], out=frames_out)

        base = b0 * HOP_SYN
        for g in range(N_FFT // HOP_SYN):           # 4 shifted group adds
            lo = g * HOP_SYN
            out[:, base + lo:base + lo + fb * HOP_SYN] += \
                frames_out[:, :, lo:lo + HOP_SYN].reshape(c, fb * HOP_SYN)
            wsum[base + lo:base + lo + fb * HOP_SYN] += \
                np.tile(w2[lo:lo + HOP_SYN], fb)
    return out[:, :num_out] / np.maximum(wsum[None, :num_out], 1e-3)


# frames per block of the device PV: ~4 (C, BLK, N_FFT) f32 / complex
# working arrays, 64 MiB each at stereo - a few hundred MiB of device
# memory, where a 22-min all-stretched segment whole would take GiBs
DEVICE_BLK_FRAMES = 8192
_GROUPS = N_FFT // HOP_SYN


def _window_sums():
    """(4, HOP_SYN) f32: the window-sum at an output position covered by
    the frames m-3..m (row 3, interior) and by the first 1-3 frames of a
    segment (rows 0-2), accumulated in frame order from 0 as the JAX
    scatter-add accumulates them."""
    w2 = (_WINDOW * _WINDOW).astype(np.float32).reshape(_GROUPS, HOP_SYN)
    rows = np.zeros((_GROUPS, HOP_SYN), np.float32)
    for m in range(_GROUPS):                        # frames 0..m cover it
        acc = np.zeros(HOP_SYN, np.float32)
        for g in range(m, -1, -1):                  # frame m - g, in order
            acc = acc + w2[g]
        rows[m] = acc
    return rows


def _pv_device(seg, rate, num_out, device, block_frames=DEVICE_BLK_FRAMES):
    """The JAX package's `_pv_segment` on `device`: seg (C, n_in) f32
    numpy, rate input samples per output sample. Returns (C, num_out) f32
    numpy (before the f16 write-back)."""
    from ..ops.pv_kernel import pv_phase_lock
    device = torch.device(device)
    c, n_in = seg.shape
    f = -(-num_out // HOP_SYN)                      # live frames
    rate32 = np.float32(rate)
    hop_rate = float(np.float32(HOP_SYN) * rate32)  # HOP_SYN * rate in f32
    # analysis positions of every live frame, f32 as JAX computes them
    pos = torch.round(torch.arange(f, dtype=torch.float32, device=device)
                      * hop_rate).to(torch.int64)
    pad_len = max(n_in, int(pos[-1]) + N_FFT)
    seg_dev = torch.zeros((c, pad_len), dtype=torch.float32, device=device)
    seg_dev[:, :n_in] = torch.from_numpy(np.ascontiguousarray(seg)).to(device)
    windows = seg_dev.unfold(1, N_FFT, 1)           # (C, L - N_FFT + 1, N)
    window = torch.from_numpy(_WINDOW).to(device)
    omega = torch.from_numpy((2 * np.pi * np.arange(_BINS) * HOP_SYN
                              / N_FFT).astype(np.float32)).to(device)
    sums = torch.from_numpy(_window_sums()).to(device)
    wfull = sums[_GROUPS - 1]
    out = np.empty((c, num_out), np.float32)
    tail = torch.zeros((c, N_FFT - HOP_SYN), dtype=torch.float32,
                       device=device)                # earlier frames' sums
    carry = None
    for k0 in range(0, f, block_frames):
        k1 = min(k0 + block_frames, f)
        fb = k1 - k0
        frames = windows.index_select(1, pos[k0:k1]) * window
        spec = torch.fft.rfft(frames, dim=2)
        spec, carry = pv_phase_lock(spec, omega, rate32, carry)
        frames_out = torch.fft.irfft(spec, n=N_FFT, dim=2) * window
        # overlap-add in frame order: position m*HOP + r takes frame m-3
        # (group 3) first, then m-2, m-1, m, after the earlier blocks'
        acc = torch.zeros((c, fb * HOP_SYN + N_FFT - HOP_SYN),
                          dtype=torch.float32, device=device)
        acc[:, :N_FFT - HOP_SYN] = tail
        for g in range(_GROUPS - 1, -1, -1):
            lo = g * HOP_SYN
            acc[:, lo:lo + fb * HOP_SYN] += \
                frames_out[:, :, lo:lo + HOP_SYN].reshape(c, fb * HOP_SYN)
        tail = acc[:, fb * HOP_SYN:].clone()
        # the window sums of this block's final samples
        wsum = wfull.repeat(fb)
        if k0 == 0:
            head = min(_GROUPS - 1, fb)
            wsum[:head * HOP_SYN] = sums[:head].reshape(-1)
        lo_out, hi_out = k0 * HOP_SYN, min(k1 * HOP_SYN, num_out)
        block = acc[:, :hi_out - lo_out] / torch.clamp(
            wsum[:hi_out - lo_out], min=1e-3)
        out[:, lo_out:hi_out] = block.cpu().numpy()
    return out


def pv_stretch(seg, num_out, backend='host', device='cuda'):
    """Stretch seg (C, n_in) to (C, num_out) with pitch preserved.

    backend: 'host' (the default, as in the JAX package) or 'device' (on
    `device`: the hand-written kernel on CUDA, its plain version on the
    CPU). Returns (C, num_out) float32 on the f16 grid.
    """
    if backend not in PV_BACKENDS:
        raise ValueError(f"unknown phase-vocoder backend: {backend!r} "
                         f"(expected one of {PV_BACKENDS})")
    seg = np.asarray(seg, np.float32)
    rate = seg.shape[1] / num_out
    if backend == 'host':
        out = _pv_host(seg, rate, num_out)
    else:
        out = _pv_device(seg, rate, num_out, device)
    return out.astype(np.float16).astype(np.float32)
