"""The plain reference of the coarse stage for the device-feature route
(align_from_pcm(..., features='device')), in IEEE fp32, and the
comparison of the program's score-map rows with it.

On that route the program uploads each track's int16 PCM, padded to its
own 64-s bucket, and computes the five feature streams on the card in f32,
zero from the true length on; the coarse stage reads them as they are,
each track at its own width, with no f16 round trip. So the plain map is
followed here from the plain fp32 cascade of each track's PCM, padded as
the route pads it, cut to the true frames and zero past them, each at its
own width; references/coarse_plain.py's map starts from stacks of one
common width on the f16 grid, the host route's upload, and cannot stand
in for it.

map_gap holds the score-map rows that the timed path itself produced (the
probe of ops.coarse_map.block_scores during the window) against the same
rows of this plain map. The rows are followed from the route's own
feature stacks, so a timed path whose features depart from the plain
cascade (other numerics, another padding, another cut) makes other rows,
and map_gap finds it: features rounded to bfloat16 move the rows by
~1e-3 of their range, fifty times the limit. The route's stacks
themselves are not seen by the benchmark's probes, which record the host
route's stacks only, so no feature_gap is read here.

Everything here is worked out again, and nothing of the program is
imported: the cascade's three coarse streams, the local-mean subtraction
and the windowed norms, the masks, the 41-frame descriptors every 21
frames in 7 video phases and the block score map are the same frozen
copies of the port's plain CPU versions as in coarse_plain.py (which a
reference may not import).

control=True puts two controls in the program's place and reads the
nearer to the plain map: the score map in TF32, and the map followed from
the cascade computed in bfloat16.
"""
import contextlib
import math

import numpy as np
import torch

FRAME = 210                 # samples per 210-fps frame
ENERGY_BLOCK = 105
SMOOTH = 13
WINDOW = 41
COARSE_STRIDE = 21
COARSE_PER_BLOCK = 10
SUB_LANE_SHIFTS = (0, 3, 6, 9, 12, 15, 18)
COARSE_STREAMS = 3
COARSE_CHUNK = 64
PCM_BUCKET = FRAME * 210 * 64          # samples in a 64-s bucket
PAD_MARGIN = 210 + WINDOW              # frames kept clear past the end


# --- windows -----------------------------------------------------------------

def hann_taps(n_plus_2):
    """hann(n+2) without its zero ends, normalized to unit sum, f32."""
    k = np.arange(n_plus_2)
    w = (0.5 - 0.5 * np.cos(2 * np.pi * k / (n_plus_2 - 1)))[1:-1]
    w = w.astype(np.float32)
    return w / np.sum(w)


def mean_sub_taps():
    w = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(2 * 21 + 1) / (2 * 21)))
    w = w[1:-1]
    return (w / w.sum()).astype(np.float32)


# --- the three coarse streams from the padded PCM ----------------------------

def padded_len(samples):
    """The route's padded length of a track of `samples` samples: the true
    length and a margin of PAD_MARGIN frames, rounded up to the bucket."""
    return -(-(samples + PAD_MARGIN * FRAME) // PCM_BUCKET) * PCM_BUCKET


def _conv_same_f32(x, taps):
    """np.convolve(x, taps, 'same'), f32 shift-and-add in tap order."""
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
    taps = hann_taps(downsample * blur + 2)
    n = arr.shape[0] - arr.shape[0] % downsample
    arr = arr[:n]
    out = None
    for i in range(downsample):
        part = _conv_same_f32(arr[i::downsample], taps[i::downsample])
        out = part if out is None else out + part
    return out


def _div(x, d):
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _log_epilogue(v):
    return torch.log10(1. + v) / 2.


def coarse_streams(pcm_i16, device, dtype=torch.float32):
    """Streams 0-2 (smoothed log energy, zero-crossing rate, first
    cascade band) of (C, S) int16 PCM at 210 fps, computed in dtype (f32;
    bfloat16 for the control) and returned as f32."""
    pcm = torch.from_numpy(np.ascontiguousarray(pcm_i16)).to(device)
    pcm = pcm.half().to(dtype)
    c, s = pcm.shape
    n = s - s % ENERGY_BLOCK
    sq = pcm[:, :n].reshape(c, -1, ENERGY_BLOCK)
    sq = sq * sq
    acc = torch.zeros(n // ENERGY_BLOCK, dtype=dtype, device=device)
    for ch in range(c):
        for i in range(ENERGY_BLOCK):
            acc = acc + sq[ch, :, i]
    energy = _div(acc, 105. * c)
    del sq

    sign = torch.signbit(pcm)
    prev = torch.cat([torch.zeros((c, 1), dtype=torch.bool, device=device),
                      sign[:, :-1]], dim=1)
    n = s - s % FRAME
    crossings = torch.sum((sign != prev)[:, :n].reshape(c, -1, FRAME),
                          dim=(0, 2)).to(dtype)
    del sign, prev
    if c == 1:
        crossings = crossings * 2
        arr = pcm[0]
    else:
        arr = _div(pcm.sum(0), c).half().to(dtype)
    arr = arr[:n]
    bottom = _downsample_blur(arr, 5, 3)
    x2d = arr.reshape(-1, 5)
    band = None
    for i in range(5):
        d = x2d[:, i] - bottom
        band = d * d if band is None else band + d * d
    del arr, x2d, bottom
    return tuple(f.float() for f in (
        _log_epilogue(_downsample_blur(energy, 1, SMOOTH))[::2],
        _downsample_blur(crossings, 1, SMOOTH),
        _log_epilogue(_div(_downsample_blur(band, FRAME // 5, 15), 210.))))


def plain_stack(pcm_i16, n, device, dtype=torch.float32):
    """(3, padded_len(S) // 210) f32: the coarse streams of (C, S) int16
    PCM zero-padded to its bucket, as the route uploads it, cut to the n
    true frames and zero past them, as the route reads them."""
    c, s = pcm_i16.shape
    pcm = np.zeros((c, padded_len(s)), np.int16)
    pcm[:, :s] = pcm_i16
    out = torch.stack(coarse_streams(pcm, device, dtype))
    out[:, n:] = 0.
    return out


# --- preprocessing -----------------------------------------------------------

def _conv_same_fma(x, taps):
    """The local mean's 'same' convolution, each step an f32 fused
    multiply-add (the f32 product is exact in f64)."""
    t = len(taps)
    n = x.shape[-1]
    c = (t - 1) // 2
    xpad = torch.nn.functional.pad(x.double(), (t - 1, t - 1))
    out = None
    for m in range(t):
        start = c - m + (t - 1)
        term = float(taps[m]) * xpad[..., start:start + n]
        out = term if out is None else term + out.double()
        out = out.float()
    return out


def preprocess(feats):
    ms = feats - _conv_same_fma(feats, mean_sub_taps())
    sq = ms ** 2
    n = sq.shape[-1] - (WINDOW - 1)
    sums = None
    for m in range(WINDOW):
        term = sq[..., m:m + n]
        sums = term if sums is None else sums + term
    norms = torch.clamp(torch.sqrt(sums), min=0.001)
    return ms, torch.nn.functional.pad(norms, (0, WINDOW - 1), value=0.001)


def audio_mask(energy, true_len):
    idx = torch.arange(energy.shape[0], device=energy.device)
    return (idx < true_len - WINDOW) & (energy > 0.5)


def video_mask(energy, true_len):
    base = audio_mask(energy, true_len)
    rank = torch.cumsum(base.to(torch.int32), 0) - 1
    return base & (rank % 4 == 0)


def descriptors(ms, norms, mask, phase=0):
    f, n = ms.shape
    k = (n - WINDOW - max(SUB_LANE_SHIFTS)) // COARSE_STRIDE + 1
    starts = torch.arange(k, device=ms.device) * COARSE_STRIDE + phase
    idx = starts[:, None] + torch.arange(WINDOW, device=ms.device)[None, :]
    desc = ms[:, idx] / norms[:, starts][:, :, None]
    desc = desc * mask[starts].float()[None, :, None]
    desc = desc.permute(1, 0, 2).reshape(k, f * WINDOW)
    width = -(-(f * WINDOW) // 128) * 128
    return torch.nn.functional.pad(desc, (0, width - f * WINDOW))


# --- score map ---------------------------------------------------------------

def _tf32_round(x):
    """x rounded to TF32 (10 mantissa bits, nearest), as f32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(tf32, device):
    if torch.device(device).type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def score_map(desc_a, desc_v, tf32=False):
    """(nb, Kv) block score map: P[b, v] = max over phases and the
    block's rows p of S[10 b + p, v + p], zero past Kv."""
    kv = desc_v.shape[1]
    nb = desc_a.shape[0] // COARSE_PER_BLOCK
    rows_per = COARSE_CHUNK * COARSE_PER_BLOCK
    n_chunks = -(-nb // COARSE_CHUNK)
    short = n_chunks * rows_per - desc_a.shape[0]
    if short > 0:
        desc_a = torch.nn.functional.pad(desc_a, (0, 0, 0, short))
    emulate = tf32 and desc_a.device.type != "cuda"
    if emulate:
        desc_a, desc_v = _tf32_round(desc_a), _tf32_round(desc_v)
    out = torch.empty((n_chunks * COARSE_CHUNK, kv), dtype=torch.float32,
                      device=desc_a.device)
    with _matmul_precision(tf32, desc_a.device):
        for c in range(n_chunks):
            rows = desc_a[c * rows_per:(c + 1) * rows_per]
            best = None
            for phase in desc_v:
                s = torch.matmul(rows, phase.T).reshape(
                    COARSE_CHUNK, COARSE_PER_BLOCK, kv)
                s = torch.nn.functional.pad(s, (0, COARSE_PER_BLOCK))
                aligned = s[:, 0, :kv]
                for p in range(1, COARSE_PER_BLOCK):
                    aligned = torch.maximum(aligned, s[:, p, p:p + kv])
                best = aligned if best is None else torch.maximum(best,
                                                                  aligned)
            out[c * COARSE_CHUNK:(c + 1) * COARSE_CHUNK] = best
    return out[:nb]


def map_gap(got, want):
    """The widest gap between two blocks of map rows, as a share of the
    reference rows' largest magnitude."""
    got = got.to(want.device).float()
    gap = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    return gap if math.isfinite(gap) else float("inf")


# --- one pair ----------------------------------------------------------------

class Pair:
    """The coarse stage of one PCM pair on the device route, worked out
    again from the plain cascade, each track at its own width; dtype
    bfloat16 computes the cascade as the feature control."""

    def __init__(self, pair, device, dtype=torch.float32):
        nv, na = pair.frames()
        feats_v = plain_stack(pair.video, nv, device, dtype)
        feats_a = plain_stack(pair.audio, na, device, dtype)
        ms_a, norms_a = preprocess(feats_a)
        ms_v, norms_v = preprocess(feats_v)
        a_mask = audio_mask(feats_a[0], na)
        v_mask = video_mask(feats_v[0], nv)
        self.desc_a = descriptors(ms_a, norms_a, a_mask)
        self.desc_v = torch.stack([descriptors(ms_v, norms_v, v_mask, ph)
                                   for ph in SUB_LANE_SHIFTS])

    def rows(self, b0, m, tf32=False):
        """Rows b0 .. b0 + m - 1 of the plain block score map (each row
        reads only its own block's 10 descriptors)."""
        per = COARSE_PER_BLOCK
        return score_map(self.desc_a[b0 * per:(b0 + m) * per], self.desc_v,
                         tf32)


def compare(samples, config, device, control=False, margins=None):
    """The gaps of samples: (gen.Pair, the program's coarse margin, its
    map rows (first block, rows) or None, its host feature stacks). Only
    the map rows are read: returns {"map_gap": one gap per sample, inf
    where the program gave no map rows}. The coarse margin (margins) and
    the feature streams are not compared on this route. control=True
    reads the nearer of the two controls in the program's place."""
    out = {"map_gap": []}
    for pair, _, rows, _ in samples:
        if rows is None:
            out["map_gap"].append(float("inf"))
            continue
        b0, m = rows[0], rows[1].shape[0]
        ref = Pair(pair, device)
        want = ref.rows(b0, m)
        if control:
            low = Pair(pair, device, torch.bfloat16).rows(b0, m)
            gap = min(map_gap(ref.rows(b0, m, tf32=True), want),
                      map_gap(low, want))
        else:
            gap = map_gap(rows[1], want)
        out["map_gap"].append(gap)
        del ref
    return out
