"""The plain reference of the coarse stage, in IEEE fp32, and the
comparison of the program's coarse margin with it.

The coarse margin is what the matcher's first stage makes of a pair: the
score of the best monotone track through the coarse score map, less the
score of the best track that keeps 25 lanes clear of it, over the audio
blocks that hold any anchor. It is a sum of ~10^3-10^4 of the map's
maxima of 123-term dot products, so it carries the arithmetic of the
score map and the DP: an fp32 map and a TF32 one read apart by ~10^-5,
two fp32 maps of different summation order by ~10^-8.

Everything here is worked out again: at the PCM level the three coarse
feature streams from the int16 PCM (the cascade's smoothed log energy,
zero-crossing rate and first band, on the f16 grid of the samples),
compared with the program's feature stack, from which (rounded to f16,
as the program uploads it) the coarse stage is followed (see Pair); at
the feature level the benchmark's feature streams, padded to the shape
bucket and rounded to f16. Then the local-mean subtraction and the
windowed norms, the masks, the 41-frame descriptors every 21 frames in 7
video phases, the block score map (a torch.matmul per phase, skew-maxed
over each block's 10 rows and max-folded over the phases), and the max-
plus DP twice. These are frozen copies of the PyTorch port's plain CPU
versions (ops/features.py, alignment/preprocess.py, alignment/
matching.py, ops/coarse_map.py, ops/coarse_dp.py), in plain torch;
nothing of the program is imported.

The controls: tf32=True computes the score map's products in TF32, on a
card through cuBLAS with TF32 allowed, on the CPU by rounding both
operands to TF32's 10-bit mantissa first; the feature streams' control
is the cascade computed in bfloat16.
"""
import contextlib
import math

import numpy as np
import torch

# --- geometry and DP constants ----------------------------------------------
FRAME = 210                 # samples per 210-fps frame
ENERGY_BLOCK = 105
SMOOTH = 13
WINDOW = 41
COARSE_STRIDE = 21
COARSE_PER_BLOCK = 10
SUB_LANE_SHIFTS = (0, 3, 6, 9, 12, 15, 18)
COARSE_STREAMS = 3
COARSE_CHUNK = 64
SUPPRESS_LANES = 25
DP_SLOPE_COST = 0.5
DP_JUMP_COST = 1.0
NEG = -1e30
BUCKET_FRAMES = 210 * 64
PAD_MARGIN = 210 + WINDOW


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


# --- the three coarse streams from PCM ---------------------------------------

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


def bucket(n):
    return -(-(n + PAD_MARGIN) // BUCKET_FRAMES) * BUCKET_FRAMES


def stacked(streams, n, npad, device):
    """(3, npad) f32: the streams cut to n frames, zero past them, on the
    f16 grid (the width of the program's upload)."""
    out = torch.zeros((COARSE_STREAMS, npad), dtype=torch.float32,
                      device=device)
    for j, f in enumerate(streams[:COARSE_STREAMS]):
        f = torch.as_tensor(f, device=device)
        k = min(n, f.shape[0])
        out[j, :k] = f[:k].float()
    return out.half().float()


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


# --- score map and DP --------------------------------------------------------

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


def dp_forward(scores):
    """The DP's cost rows from a zero row: each row relaxes the last by
    the nominal 10-lane advance, the |.| slope cost and a flat jump, then
    adds its scores."""
    n, d = scores.shape
    dev = scores.device
    slope = DP_SLOPE_COST * torch.arange(d, dtype=torch.float32, device=dev)
    floor = torch.full((COARSE_PER_BLOCK,), NEG, device=dev)
    prev = torch.zeros(d, dtype=torch.float32, device=dev)
    rows = torch.empty_like(scores)
    for r in range(n):
        prev10 = torch.cat([floor, prev[:-COARSE_PER_BLOCK]])
        fwd = torch.cummax(prev10 + slope, 0).values - slope
        bwd = torch.cummax((prev10 - slope).flip(0), 0).values.flip(0) + slope
        prev = torch.maximum(torch.maximum(fwd, bwd),
                             torch.max(prev) - DP_JUMP_COST) + scores[r]
        rows[r] = prev
    return rows


def dp_backtrace(rows):
    """The best track's lane per block, from the last row's first maximal
    lane back (move vs jump, first maximal lane)."""
    n, d = rows.shape
    dev = rows.device
    lanes = torch.arange(d, dtype=torch.float32, device=dev)
    path = torch.empty(n, dtype=torch.int64, device=dev)
    o = torch.argmax(rows[-1])
    path[-1] = o
    for r in range(n - 2, -1, -1):
        moved = rows[r] - DP_SLOPE_COST * torch.abs(
            lanes - (o - COARSE_PER_BLOCK).float())
        jumped = torch.max(rows[r]) - DP_JUMP_COST
        o = torch.where(torch.max(moved) >= jumped, torch.argmax(moved),
                        torch.argmax(rows[r]))
        path[r] = o
    return path


def margin_from_map(p_map, a_mask):
    """(track-1 score - track-2 score) / anchor blocks, as a Python
    float."""
    nb, kv = p_map.shape
    rows = dp_forward(p_map)
    path = dp_backtrace(rows)
    score1 = rows[-1].max()
    del rows
    lanes = torch.arange(kv, dtype=torch.int64, device=p_map.device)[None, :]
    p_map = torch.where(torch.abs(lanes - path[:, None]) <= SUPPRESS_LANES,
                        torch.full((), NEG, device=p_map.device), p_map)
    score2 = dp_forward(p_map)[-1].max()
    anchors = a_mask[torch.arange(nb * COARSE_PER_BLOCK,
                                  device=a_mask.device) * COARSE_STRIDE]
    n_anchor = int(torch.any(anchors.reshape(nb, COARSE_PER_BLOCK),
                             dim=1).sum())
    return float((score1 - score2) / max(n_anchor, 1))


# --- one pair ----------------------------------------------------------------

def feature_gap(got, want, n):
    """The widest gap between two sets of streams over the first n
    frames, per stream as a share of the reference stream's largest
    magnitude; the worst stream's."""
    worst = 0.0
    for g, w in zip(got, want):
        g = torch.as_tensor(g[:n], device=w.device).float()
        w = w[:n]
        worst = max(worst, float((g - w).abs().max()
                                 / w.abs().max().clamp(min=1e-30)))
    return worst if math.isfinite(worst) else float("inf")


class Pair:
    """The coarse stage of one benchmark pair, worked out again.

    At the PCM level the program's feature stack (program_feats: its
    (video, description) (5, Npad) f32 stacks as the program uploads them)
    is the start: the coarse stage is so sensitive to the f16 rounding of
    the upload that one f16 step of a few of ~10^5 values, from a last-bit
    difference between two sound extractors, moves the margin as far as
    TF32 does. So the margin is followed from the program's stack, and the
    stack itself is checked apart against the plain cascade
    (feature_gap). Without program_feats the reference's own stack is
    used. At the feature level the benchmark's streams are the start.
    control=True puts the controls in the program's place: the cascade in
    bfloat16, and the score map in TF32."""

    def __init__(self, pair, config, device, program_feats=None,
                 control=False):
        nv, na = pair.frames()
        self.feature_gap = None
        self.control = control
        if config["level"] == "pcm":
            own = [coarse_streams(x, device) for x in (pair.video,
                                                       pair.audio)]
            if control:
                low = [coarse_streams(x, device, torch.bfloat16)
                       for x in (pair.video, pair.audio)]
                self.feature_gap = max(feature_gap(lo, ref, n)
                                       for lo, ref, n in zip(low, own,
                                                             (nv, na)))
                del low
            elif program_feats is not None:
                self.feature_gap = max(feature_gap(f, ref, n)
                                       for f, ref, n in zip(program_feats,
                                                            own, (nv, na)))
            if program_feats is not None:
                npad = program_feats[0].shape[1]
                own = [f[:COARSE_STREAMS] for f in program_feats]
            else:
                npad = max(bucket(nv), bucket(na))
        else:
            npad = max(bucket(na), bucket(nv))
            own = [pair.video, pair.audio]
        feats_v = stacked(own[0], nv, npad, device)
        feats_a = stacked(own[1], na, npad, device)
        del own
        ms_a, norms_a = preprocess(feats_a)
        ms_v, norms_v = preprocess(feats_v)
        self.a_mask = audio_mask(feats_a[0], na)
        v_mask = video_mask(feats_v[0], nv)
        self.desc_a = descriptors(ms_a, norms_a, self.a_mask)
        self.desc_v = torch.stack([descriptors(ms_v, norms_v, v_mask, ph)
                                   for ph in SUB_LANE_SHIFTS])

    def margin(self, tf32=False):
        return margin_from_map(score_map(self.desc_a, self.desc_v, tf32),
                               self.a_mask)


def map_gap(got, want):
    """The widest gap between two blocks of map rows, as a share of the
    reference rows' largest magnitude."""
    got = got.to(want.device).float()
    gap = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
    return gap if math.isfinite(gap) else float("inf")


def compare(samples, config, device, control=False, margins=None):
    """The gaps of samples: (gen.Pair, the program's coarse margin or None,
    its map rows (first block, rows) or None, its feature stacks or None).
    Returns {"map_gap", "feature_gap"} and, with margins (by default where
    the configuration gives margin_gap a limit), "margin_gap": lists of
    the gaps of the program's map rows, at the PCM level its feature
    streams (none where its stacks were not seen), and its margin (inf
    where the program gave none), from the plain fp32 reference's.
    control=True reads the controls in the program's place."""
    if margins is None:
        margins = "margin_gap_limit" in config["guarantees"]
    out = {"map_gap": [], "feature_gap": []}
    if margins:
        out["margin_gap"] = []
    for pair, got, rows, feats in samples:
        ref = Pair(pair, config, device, feats, control)
        p_map = score_map(ref.desc_a, ref.desc_v)
        if margins:
            want = margin_from_map(p_map, ref.a_mask)
            if control:
                got = ref.margin(tf32=True)
            gap = float("inf") if got is None else abs(float(got) - want)
            out["margin_gap"].append(gap if math.isfinite(gap)
                                     else float("inf"))
        if rows is None:
            out["map_gap"].append(float("inf"))
        else:
            b0, m = rows[0], rows[1].shape[0]
            if control:
                lo = ref.desc_a[b0 * COARSE_PER_BLOCK:
                                (b0 + m) * COARSE_PER_BLOCK]
                mine = score_map(lo, ref.desc_v, tf32=True)
            else:
                mine = rows[1]
            out["map_gap"].append(map_gap(mine, p_map[b0:b0 + m]))
        if ref.feature_gap is not None:
            out["feature_gap"].append(ref.feature_gap)
        del ref, p_map
    return out
