"""Feature extraction on tensors: raw PCM (channels, samples) to the
reference's 5 feature streams at 210 frames/sec (describealign.py:545-593).

Port of describealign_tpu/ops/features.py, whose energy_feature,
zero_crossing_feature and freq_band_features make the streams that
extract_features returns here:

  0. smoothed log energy
  1. zero-crossing rate
  2-4. cascaded frequency-band log energies (frontend='mel': the mel band
     energies of ops/mel.mel_band_features instead)

The work is split the way the two hand-written CUDA kernels split it
(csrc/features_dev.cu, wrapped by ops/features_kernel.py):

- `pcm_frontend` (K1): one pass over the PCM giving the per-105-sample
  energy, the per-210-sample zero-crossing counts, and the cascade's
  stage 1 (`bottom` = _downsample_blur(arr, 5, 3) and its residual band
  energy);
- `polyphase_blur` (K2): _downsample_blur(y, ds, blur) with an optional
  squared-residual or square prologue building y, and the log epilogues;
  `polyphase_cascade`, a stream's six such stages off K1's outputs, which
  the kernel runs in one grouped launch.

Each dispatches on the tensor's device: CPU tensors run the plain
versions below, CUDA tensors launch the kernel or raise. There is no
fallback from CUDA to the plain version.

The plain versions repeat the JAX package's arithmetic in its order, in
f32: shift-add "same" convolutions (no conv1d: cuDNN runs f32
convolutions in TF32 by default), each product and each add rounded. Two
places differ from the JAX package and are held to it by tolerance: XLA
on the CPU may contract `out + tap * x` into a fused multiply-add, and the
energy's sum of squares runs channel by channel, sample by sample (the
order the kernel uses), where XLA reduces in its own order.
"""
import numpy as np
import torch

from .mel import check_frontend, mel_band_features
from .windows import hann_taps

FRAME = 210                       # samples per 210-fps feature frame
ENERGY_BLOCK = 105                # samples per energy block (2 per frame)
CASCADE = (5, 7, 6)               # freq_band_features' decimation factors
SMOOTH = 13                       # _conv_same(., hann_taps(15)): 13 taps


def _conv_same(x, taps):
    """np.convolve(x, taps, mode='same') with zero padding, f32, as
    shift-and-add: out[i] = sum_m taps[m] * x[i + c - m], m in order."""
    x = x.float()
    taps = np.asarray(taps, np.float32)
    t = len(taps)
    n = x.shape[0]
    c = (t - 1) // 2
    xpad = torch.nn.functional.pad(x, (t - 1, t - 1))
    out = None
    for m in range(t):
        start = c - m + (t - 1)
        term = float(taps[m]) * xpad[start:start + n]
        out = term if out is None else out + term
    return out


def _downsample_blur(arr, downsample, blur):
    """Polyphase hann lowpass + decimate-by-`downsample`: the sum, in phase
    order, of the 'same' convolutions of arr[i::ds] with taps[i::ds], each
    around its own centre."""
    taps = hann_taps(downsample * blur + 2)
    n = arr.shape[0] - arr.shape[0] % downsample
    arr = arr[:n]
    out = None
    for i in range(downsample):
        part = _conv_same(arr[i::downsample], taps[i::downsample])
        out = part if out is None else out + part
    return out


def _div(x, d):
    """x / d rounded as IEEE division. A Python scalar divisor would not
    do: torch on CUDA multiplies by its reciprocal instead, which can miss
    the quotient by an ulp (the kernels divide)."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def _squares(x, bottom, r):
    """y[q] = sum_i (x[r q + i] - bottom[q])^2, i in order (bottom None:
    sum_i x[r q + i]^2, the last cascade stage's zero bottom)."""
    x2d = x[:x.shape[0] - x.shape[0] % r].reshape(-1, r)
    out = None
    for i in range(r):
        d = x2d[:, i] if bottom is None else x2d[:, i] - bottom
        out = d * d if out is None else out + d * d
    return out


def _log_epilogue(v):
    return torch.log10(1. + v) / 2.


def pcm_frontend_plain(pcm, kill_crossing_at=None, kill_enabled=True):
    """K1's plain version. pcm: (C, S) f32 samples (on the f16 grid when
    they come from int16). Returns (energy (S // 105,): the mean square of
    each 105-sample block over the channels; crossings (S // 210,): signbit
    transitions per frame summed over channels, x2 for mono; bottom and
    band (S // 210 * 42,): stage 1 of the cascade).

    kill_crossing_at: an optional sample index whose crossing is not
    counted when kill_enabled, as in the JAX zero_crossing_feature (the
    sequence-sharded extractor cancels the last shard's artificial
    data-to-zero-halo crossing with it)."""
    c, s = pcm.shape
    n = s - s % ENERGY_BLOCK
    sq = pcm[:, :n].reshape(c, -1, ENERGY_BLOCK)
    sq = sq * sq
    acc = torch.zeros(n // ENERGY_BLOCK, dtype=torch.float32,
                      device=pcm.device)
    for ch in range(c):
        for i in range(ENERGY_BLOCK):
            acc = acc + sq[ch, :, i]
    energy = _div(acc, 105. * c)

    sign = torch.signbit(pcm)
    prev = torch.cat([torch.zeros((c, 1), dtype=torch.bool,
                                  device=pcm.device), sign[:, :-1]], dim=1)
    xings = sign != prev
    if kill_crossing_at is not None and kill_enabled:
        xings[:, kill_crossing_at] = False
    n = s - s % FRAME
    crossings = torch.sum(xings[:, :n].reshape(c, -1, FRAME),
                          dim=(0, 2)).float()
    if c == 1:
        crossings = crossings * 2

    if c > 1:
        total = pcm[0]
        for ch in range(1, c):
            total = total + pcm[ch]
        arr = _div(total, c).half().float()     # f16 grid parity
    else:
        arr = pcm[0]
    arr = arr[:n]
    bottom = _downsample_blur(arr, CASCADE[0], 3)
    return energy, crossings, bottom, _squares(arr, bottom, CASCADE[0])


def polyphase_blur_plain(x, ds, blur, r=0, bottom=None, epilogue=None):
    """K2's plain version: _downsample_blur(y, ds, blur) with y = x (r = 0)
    or y = _squares(x, bottom, r); epilogue None, 'energy' (log10(1 + v) / 2
    of every 2nd output, ds = 1) or 'band' (log10(1 + v / 210) / 2)."""
    y = x if r == 0 else _squares(x, bottom, r)
    out = _downsample_blur(y, ds, blur)
    if epilogue == 'energy':
        return _log_epilogue(out)[::2]
    if epilogue == 'band':
        return _log_epilogue(_div(out, 210.))
    return out


def cancel_crossing(crossings, pcm, at):
    """Take sample `at`'s crossing, where K1 counted one, out of its
    frame's count: a crossing is a sign-bit change from pcm[:, at - 1] to
    pcm[:, at] (from a cleared sign bit at sample 0), per channel, x2 for
    mono, as K1 counts; a sample of the trailing part frame, which K1
    does not count, changes nothing. The counts are integers in f32, so
    this is exact. Runs on the device without a host wait."""
    c = pcm.shape[0]
    if at // FRAME >= crossings.shape[0]:
        return crossings
    sign = torch.signbit(pcm[:, at])
    prev = (torch.signbit(pcm[:, at - 1]) if at > 0
            else torch.zeros_like(sign))
    lost = (sign != prev).sum().float() * (2 if c == 1 else 1)
    crossings = crossings.clone()
    crossings[at // FRAME] -= lost
    return crossings


def pcm_frontend(pcm, kill_crossing_at=None):
    """K1 on the PCM's device: the plain version on the CPU; on CUDA the
    kernel, which also takes int16 PCM (rounded to f16 as it loads).
    kill_crossing_at: as in pcm_frontend_plain; on CUDA cancel_crossing
    takes it out of the kernel's counts before they are smoothed (K1 has
    no such argument)."""
    if pcm.device.type == 'cpu':
        if pcm.dtype == torch.int16:
            pcm = pcm.half()
        return pcm_frontend_plain(pcm.float(), kill_crossing_at)
    from .features_kernel import pcm_frontend_cuda
    energy, crossings, bottom, band = pcm_frontend_cuda(pcm)
    if kill_crossing_at is not None:
        crossings = cancel_crossing(crossings, pcm, kill_crossing_at)
    return energy, crossings, bottom, band


def polyphase_blur(x, ds, blur, r=0, bottom=None, epilogue=None):
    """K2 on x's device: the plain version on the CPU, the kernel on CUDA."""
    if x.device.type == 'cpu':
        return polyphase_blur_plain(x, ds, blur, r, bottom, epilogue)
    from .features_kernel import polyphase_blur_cuda
    return polyphase_blur_cuda(x, ds, blur, r, bottom, epilogue)


def polyphase_cascade_plain(energy, crossings, bottom1, band1):
    """The cascade's plain version: the five streams (smoothed energy,
    smoothed crossings, bands 1-3) off K1's outputs, six
    polyphase_blur_plain calls, bottom 2 the blur that band 2 and band 3
    read."""
    bottom2 = polyphase_blur_plain(bottom1, CASCADE[1], 3)
    return (polyphase_blur_plain(energy, 1, SMOOTH, epilogue='energy'),
            polyphase_blur_plain(crossings, 1, SMOOTH),
            polyphase_blur_plain(band1, FRAME // 5, 15, epilogue='band'),
            polyphase_blur_plain(bottom1, FRAME // 35, 15, r=CASCADE[1],
                                 bottom=bottom2, epilogue='band'),
            polyphase_blur_plain(bottom2, 1, 15, r=CASCADE[2],
                                 epilogue='band'))


def polyphase_cascade(energy, crossings, bottom1, band1):
    """The cascade on the inputs' device: the plain version on the CPU, one
    grouped K2 launch on CUDA."""
    if energy.device.type == 'cpu':
        return polyphase_cascade_plain(energy, crossings, bottom1, band1)
    from .features_kernel import polyphase_cascade_cuda
    return polyphase_cascade_cuda(energy, crossings, bottom1, band1)


def _streams(pcm):
    """The 5 streams off one pcm_frontend and one polyphase_cascade."""
    return polyphase_cascade(*pcm_frontend(pcm))


def _mel_streams(pcm):
    """The mel frontend's 5 streams: energy and crossings off K1 and two
    K2 smoothing launches (the cascade's first two stages), the mel bands
    off ops/mel.mel_band_features."""
    energy, crossings, _, _ = pcm_frontend(pcm)
    return (polyphase_blur(energy, 1, SMOOTH, epilogue='energy'),
            polyphase_blur(crossings, 1, SMOOTH),
            *mel_band_features(pcm))


def extract_features(pcm, device='cuda', frontend='cascade'):
    """All 5 feature streams for one PCM array (channels, samples), a numpy
    array or a tensor, on `device`; frontend 'cascade' or 'mel'
    (features.py:142-159, where DESCRIBEALIGN_FRONTEND chooses).

    Returns a tuple of 5 f32 tensors at 210 fps. Lengths may differ by one
    frame between streams (energy keeps a half-block tail), as in the
    reference. The samples are taken as f32 values, as the JAX package's
    extract_features takes them."""
    check_frontend(frontend)
    pcm = torch.as_tensor(pcm).to(device=device, dtype=torch.float32)
    return _mel_streams(pcm) if frontend == 'mel' else _streams(pcm)


def feature_stack(pcm, n_frames):
    """(5, n_frames) f32 stack of the streams, each cut to n_frames
    (matching.extract_and_match's feats_of). pcm: (C, S) int16 PCM, rounded
    to f16 as the JAX package casts it (matching.py:441)."""
    return torch.stack([f[:n_frames] for f in _streams(pcm)])
