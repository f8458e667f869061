"""Alignment preprocessing on tensors: local-mean subtraction, windowed
norms, masks.

Port of describealign_tpu/alignment/preprocess.py (reference semantics
describealign.py:595-633): a 41-tap hann local mean is subtracted from each
feature, 41-frame L2 norms are clipped at .001, quiet frames (energy <= .5)
are excluded, and video anchors keep every 4th non-quiet frame. Both the
mean and the norms are shift-and-add sums in the JAX package's order (a
conv1d would reorder them); the norms' sum may still differ from XLA's by
an ulp.
"""
import torch

from ..constants import TIMESTEPS_PER_SECOND
from ..ops.windows import hann_window

SAMPLES_PER_NODE = 210 // TIMESTEPS_PER_SECOND  # 21
WINDOW = 2 * SAMPLES_PER_NODE - 1               # 41


def mean_sub_taps():
    w = hann_window(2 * SAMPLES_PER_NODE + 1)[1:-1]
    return (w / w.sum()).astype('float32')


def _conv_same(x, taps):
    """np.convolve(x, taps, mode='same') along the last axis, f32, zero
    padded, as shift-and-add in ops/features._conv_same's order.

    XLA's CPU backend contracts each `out + taps[m] * x` into one fused
    multiply-add; each step here is that FMA: the f32 product is exact in
    f64, so the f64 sum rounded to f32 is the fused result (barring a
    double-rounding tie, ~1e-9 per element). This keeps the port's mean
    within an ulp of the JAX package's even where feature - mean cancels,
    and makes the CPU and CUDA paths agree bit for bit."""
    t = len(taps)
    n = x.shape[-1]
    c = (t - 1) // 2
    xpad = torch.nn.functional.pad(x.double(), (t - 1, t - 1))
    out = None
    # out[i] = sum_m taps[m] * x[i + c - m]
    for m in range(t):
        start = c - m + (t - 1)
        term = float(taps[m]) * xpad[..., start:start + n]
        out = term if out is None else term + out.double()
        out = out.float()
    return out


def uniform_norm(feature_ms):
    """Windowed L2 norm over 41 frames along the last axis, clipped at
    .001; the last 40 entries (incomplete windows) hold the clip floor."""
    sq = feature_ms ** 2
    n = sq.shape[-1] - (WINDOW - 1)
    window_sums = None
    for m in range(WINDOW):
        term = sq[..., m:m + n]
        window_sums = term if window_sums is None else window_sums + term
    norms = torch.clamp(torch.sqrt(window_sums), min=0.001)
    return torch.nn.functional.pad(norms, (0, WINDOW - 1), value=0.001)


def valid_audio_mask(energy_padded, true_len):
    """Non-quiet frames eligible as match anchors (reference 657-658)."""
    idx = torch.arange(energy_padded.shape[0], device=energy_padded.device)
    return (idx < true_len - WINDOW) & (energy_padded > 0.5)


def valid_video_mask(energy_padded, true_len):
    """Every 4th frame of the non-quiet subsequence (reference 629-633)."""
    base = valid_audio_mask(energy_padded, true_len)
    rank = torch.cumsum(base.to(torch.int32), 0) - 1
    return base & (rank % 4 == 0)


def preprocess_features(features_stacked):
    """(F, Npad) stacked features -> (ms, norms), both (F, Npad) f32."""
    feats = features_stacked.float()
    ms = feats - _conv_same(feats, mean_sub_taps())
    return ms, uniform_norm(ms)
