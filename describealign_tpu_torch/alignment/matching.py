"""Match generation on tensors: coarse offset search + fine banded
correlation.

Port of describealign_tpu/alignment/matching.py (see its docstring for the
design and the reference semantics). The coarse pass builds normalized
41-frame descriptors every 21 frames, scores them all-pairs with
`torch.matmul` in 64-block chunks, folds the 7 sub-lane video phases and
the 10 within-block rows into a (blocks, video lanes) score map by a skew
max, and runs an exact max-plus DP twice (k-best, the second track with
the first suppressed). The fine pass correlates every 210-frame audio
block against a 768-frame video band around each track with the fine
kernel (ops/fine_kernel.py), gates the rescue track, and packs the
candidates into the u8-quality transport rows the native LIS reads.

The DP is a plain torch loop in this slice (about 30 small launches per
audio block and track); long media above COARSE_STREAM_ELEMS is not
ported yet.
"""
import torch

from .preprocess import (WINDOW, preprocess_features, valid_audio_mask,
                         valid_video_mask)

# --- geometry constants (matching.py:44-71) --------------------------------
COARSE_STRIDE = 21
BLOCK = 210
COARSE_PER_BLOCK = BLOCK // COARSE_STRIDE  # 10
FINE_HALF_BAND = 279
FINE_W = BLOCK + 2 * FINE_HALF_BAND        # 768
TOP_K = 8
COARSE_STREAMS = 3
COARSE_RETRY_STREAMS = 5

# --- quality / DP constants (matching.py:74-96) -----------------------------
QUAL_PROB_CUTOFF = 1e-8
QUAL_SCALE = 1e-12
QUAL_MAX = 50.0
NB_EXPONENT = 2.9
BAND_GATE = 0.2
DP_SLOPE_COST = 0.5
DP_JUMP_COST = 1.0

SUB_LANE_SHIFTS = (0, 3, 6, 9, 12, 15, 18)
COARSE_CHUNK = 64
COARSE_STREAM_ELEMS = 192 * 1024 * 1024
QUAL_CODE_BASE = 0xA0
FINE_CHUNK = 256
COARSE_MARGIN_FLOOR = 0.04
N_TRACKS = 2
SUPPRESS_LANES = 25


def nb_for(npad):
    """Number of fine blocks for a given padded feature length."""
    ka = (npad - WINDOW - max(SUB_LANE_SHIFTS)) // COARSE_STRIDE + 1
    return ka // COARSE_PER_BLOCK


# ---------------------------------------------------------------------------
# Coarse pass
# ---------------------------------------------------------------------------

def _coarse_descriptors(ms, norms, mask, phase=0):
    """(K, 128*ceil(F*41/128)) normalized, masked window descriptors at
    COARSE_STRIDE (+ phase); zero rows for invalid anchors."""
    f, n = ms.shape
    k = (n - WINDOW - max(SUB_LANE_SHIFTS)) // COARSE_STRIDE + 1
    starts = torch.arange(k, device=ms.device) * COARSE_STRIDE + phase
    idx = starts[:, None] + torch.arange(WINDOW, device=ms.device)[None, :]
    desc = ms[:, idx] / norms[:, starts][:, :, None]            # (F, K, 41)
    desc = desc * mask[starts].float()[None, :, None]
    desc = desc.permute(1, 0, 2).reshape(k, f * WINDOW)
    width = -(-(f * WINDOW) // 128) * 128
    return torch.nn.functional.pad(desc, (0, width - f * WINDOW))


def _chunk_scores(desc_a_padded, desc_v_list, c):
    """(COARSE_CHUNK, Kv) score tile for the blocks of chunk c: the
    (640 x Kv) product per video phase, skew-maxed over the 10 coarse rows
    of each block (P[b, v] = max_p S[10b + p, v + p], zero past Kv) and
    max-folded across phases."""
    kv = desc_v_list[0].shape[0]
    rows = desc_a_padded[c * COARSE_CHUNK * COARSE_PER_BLOCK:
                         (c + 1) * COARSE_CHUNK * COARSE_PER_BLOCK]
    out = None
    for desc_v in desc_v_list:
        s = torch.matmul(rows, desc_v.T).reshape(
            COARSE_CHUNK, COARSE_PER_BLOCK, kv)
        s = torch.nn.functional.pad(s, (0, COARSE_PER_BLOCK))
        aligned = s[:, 0, :kv]
        for p in range(1, COARSE_PER_BLOCK):
            aligned = torch.maximum(aligned, s[:, p, p:p + kv])
        out = aligned if out is None else torch.maximum(out, aligned)
    return out


def _block_scores_local(desc_a, desc_v_list):
    """Video-coordinate block score map P[b, v] (matching.py:194-222)."""
    ka = desc_a.shape[0]
    nb = ka // COARSE_PER_BLOCK
    nb_pad = -(-nb // COARSE_CHUNK) * COARSE_CHUNK
    desc_a = torch.nn.functional.pad(
        desc_a, (0, 0, 0, nb_pad * COARSE_PER_BLOCK - ka))
    return torch.cat([_chunk_scores(desc_a, desc_v_list, c)
                      for c in range(nb_pad // COARSE_CHUNK)])[:nb]


def _dp_relax(prev, slope, floor):
    """One max-plus relaxation: shift by the nominal 10-lane advance, exact
    |.| distance transform by two running cummax passes, capped by a flat
    jump. slope = DP_SLOPE_COST * lane (exact in f32, as in the JAX DP);
    floor = the (10,) -1e30 row shifted in."""
    prev10 = torch.cat([floor, prev[:-COARSE_PER_BLOCK]])
    fwd = torch.cummax(prev10 + slope, 0).values - slope
    bwd = torch.cummax((prev10 - slope).flip(0), 0).values.flip(0) + slope
    return torch.maximum(torch.maximum(fwd, bwd),
                         torch.max(prev) - DP_JUMP_COST)


def _dp_backstep(o_next, cost_prev, lanes):
    """Predecessor lane of o_next given the previous cost row (move vs
    jump; argmax takes the first maximal lane, as jnp.argmax)."""
    moved = cost_prev - DP_SLOPE_COST * torch.abs(
        lanes - (o_next - COARSE_PER_BLOCK).float())
    jumped = torch.max(cost_prev) - DP_JUMP_COST
    return torch.where(torch.max(moved) >= jumped, torch.argmax(moved),
                       torch.argmax(cost_prev))


def _coarse_dp(p_map):
    """Monotone track DP over the (B, D) score map (matching.py:252-280).
    Returns (per-block video lane path (B,) i32, the track's score)."""
    nb, d = p_map.shape
    dev = p_map.device
    lanes = torch.arange(d, dtype=torch.float32, device=dev)
    slope = DP_SLOPE_COST * lanes
    floor = torch.full((COARSE_PER_BLOCK,), -1e30, device=dev)
    cost = torch.empty_like(p_map)
    prev = torch.zeros(d, dtype=torch.float32, device=dev)
    for b in range(nb):
        prev = _dp_relax(prev, slope, floor) + p_map[b]
        cost[b] = prev
    o = torch.argmax(cost[-1])
    path = torch.empty(nb, dtype=torch.int64, device=p_map.device)
    path[-1] = o
    for b in range(nb - 2, -1, -1):
        o = _dp_backstep(o, cost[b], lanes)
        path[b] = o
    return path.to(torch.int32), cost[-1][path[-1]]


def _coarse_tracks(ms_a, norms_a, energy_a, len_a,
                   ms_v, norms_v, energy_v, len_v, nf=None, mark=None):
    """Masks + coarse score map + k-best DP tracks (matching.py:1100-1177).

    Returns (a_mask, v_mask, starts_tracks (T, B) i32 band starts,
    centers (B,) best-track offset frames, margin f32 scalar), where
    margin = (track-1 score - track-2 score) / anchor blocks.
    """
    nv_pad = ms_v.shape[1]
    dev = ms_a.device
    a_mask = valid_audio_mask(energy_a, len_a)
    v_mask = valid_video_mask(energy_v, len_v)

    nf = COARSE_STREAMS if nf is None else nf
    desc_a = _coarse_descriptors(ms_a[:nf], norms_a[:nf], a_mask)
    desc_v_list = [_coarse_descriptors(ms_v[:nf], norms_v[:nf], v_mask,
                                       phase) for phase in SUB_LANE_SHIFTS]
    ka = desc_a.shape[0]
    kv = desc_v_list[0].shape[0]
    nb = ka // COARSE_PER_BLOCK
    if nb * kv > COARSE_STREAM_ELEMS:
        raise NotImplementedError(
            f"coarse score map of {nb} x {kv} exceeds COARSE_STREAM_ELEMS="
            f"{COARSE_STREAM_ELEMS}: the streamed coarse DP for long media "
            f"is not ported yet")

    p_map = _block_scores_local(desc_a, desc_v_list)
    if mark:
        mark('coarse_map')
    lanes = torch.arange(kv, dtype=torch.int32, device=dev)[None, :]
    v_paths, scores = [], []
    suppressed = p_map
    for _ in range(N_TRACKS):
        v_path, score = _coarse_dp(suppressed)
        v_paths.append(v_path)
        scores.append(score)
        suppressed = torch.where(
            torch.abs(lanes - v_path[:, None]) <= SUPPRESS_LANES,
            torch.tensor(-1e30, dtype=torch.float32, device=dev), suppressed)

    # anchor blocks: audio blocks contributing any eligible coarse descriptor
    anchor_rows = a_mask[torch.arange(ka, device=dev) * COARSE_STRIDE]
    n_anchor = torch.sum(torch.any(
        anchor_rows[:nb * COARSE_PER_BLOCK].reshape(nb, COARSE_PER_BLOCK),
        dim=1).to(torch.int32))
    margin = ((scores[0] - scores[1])
              / torch.clamp(n_anchor, min=1).to(torch.float32))

    blocks = torch.arange(nb, dtype=torch.int32, device=dev) * BLOCK
    starts_tracks = []
    centers0 = None
    for v_path in v_paths:
        centers = v_path * COARSE_STRIDE - blocks
        if centers0 is None:
            centers0 = centers
        starts_tracks.append(torch.clamp(
            blocks + centers - FINE_HALF_BAND, 0,
            nv_pad - (FINE_W + WINDOW - 1)))
    if mark:
        mark('coarse_dp')
    return a_mask, v_mask, torch.stack(starts_tracks), centers0, margin


def match_coarse(feats_a, len_a, feats_v, len_v, nf=None, mark=None):
    """Preprocess + coarse k-best tracks (matching.py:539-564).

    feats_*: (5, Npad) raw feature stacks on the target device (any float
    dtype; the f16 upload is widened here); len_*: true frame counts; nf:
    coarse descriptor streams (None = COARSE_STREAMS; the low-confidence
    retry passes COARSE_RETRY_STREAMS).

    Returns (ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts_tracks
    (T, B_pad) i32 padded with the last block's starts to a FINE_CHUNK
    multiple, margin f32 scalar).
    """
    feats_a = feats_a.float()
    feats_v = feats_v.float()
    ms_a, norms_a = preprocess_features(feats_a)
    ms_v, norms_v = preprocess_features(feats_v)
    a_mask, v_mask, starts_tracks, _, margin = _coarse_tracks(
        ms_a, norms_a, feats_a[0], len_a, ms_v, norms_v, feats_v[0], len_v,
        nf=nf, mark=mark)
    nb = starts_tracks.shape[1]
    b_pad = -(-nb // FINE_CHUNK) * FINE_CHUNK
    starts_tracks = torch.cat(
        [starts_tracks,
         starts_tracks[:, -1:].expand(-1, b_pad - nb)], dim=1)
    return ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts_tracks, margin


# ---------------------------------------------------------------------------
# Fine pass
# ---------------------------------------------------------------------------

def _consistent_blocks(quals_g, offs_g):
    """(B,) bool: the block's top-1 in-band offsets have a mode (widened
    +/-2 frames) of >= 15 live frames (matching.py:1231-1244)."""
    b_n = quals_g.shape[0]
    dev = quals_g.device
    live = (quals_g[:, :, 0] > 0).float()
    d = (offs_g[:, :, 0].to(torch.int64)
         - torch.arange(BLOCK, device=dev)[None, :] + BLOCK)
    d = torch.clamp(d, 0, FINE_W + BLOCK)
    counts = torch.zeros((b_n, FINE_W + BLOCK + 1), dtype=torch.float32,
                         device=dev)
    counts.scatter_add_(1, d, live)
    widened = sum(torch.roll(counts, s, dims=1) for s in range(-2, 3))
    return torch.max(widened, dim=1).values >= 15.0


def _fine_tracks(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask,
                 starts_tracks, b0, count, nb_valid):
    """Fine pass + rescue gating for `count` blocks starting at block b0
    (matching.py:1180-1257).

    Returns (quals (count, 210, G*K) f32, offs (count, 210, G*K) i32,
    starts_grouped (count, G) i32); slot j of band 1 spans groups 0-1,
    rescue band g >= 2 is one group of TOP_K//2 slots. Blocks >= nb_valid
    (chunk padding) emit zero qualities; they are not computed at all,
    since every consumer reads a zero-quality slot as empty.
    """
    from ..ops.fine_kernel import fine_match
    dev = ms_a.device
    live_blocks = max(0, min(count, int(nb_valid) - int(b0)))
    b_global = b0 + torch.arange(live_blocks, dtype=torch.int32, device=dev)
    a_mask_f = a_mask.float()
    v_mask_f = v_mask.float()

    all_quals, all_offs = [], []
    for t in range(starts_tracks.shape[0]):
        quals = torch.zeros((count, BLOCK, TOP_K), dtype=torch.float32,
                            device=dev)
        offs = torch.zeros((count, BLOCK, TOP_K), dtype=torch.int32,
                           device=dev)
        if live_blocks:
            quals[:live_blocks], offs[:live_blocks] = fine_match(
                ms_a, norms_a, a_mask_f, ms_v, norms_v, v_mask_f,
                starts_tracks[t, :live_blocks].contiguous(),
                (b_global * BLOCK).contiguous())
        all_quals.append(quals)
        all_offs.append(offs)

    half = TOP_K // 2
    even_frame = (torch.arange(BLOCK, device=dev) % 2 == 0)[None, :, None]
    rescue_quals = []
    for q, o in zip(all_quals[1:], all_offs[1:]):
        keep = _consistent_blocks(q, o)[:, None, None]
        rescue_quals.append(torch.where(keep & even_frame, q[:, :, :half],
                                        torch.zeros((), device=dev)))
    quals = torch.cat([all_quals[0]] + rescue_quals, dim=2)
    offs = torch.cat([all_offs[0]] + [o[:, :, :half] for o in all_offs[1:]],
                     dim=2)
    starts = torch.stack([starts_tracks[0], starts_tracks[0]]
                         + list(starts_tracks[1:]), dim=1)
    return quals, offs, starts


# --- quality transport grid (matching.py:497-526) ---------------------------

def _qual_quantize_u8(quals_f32):
    """f32 qualities -> u8 codes on the 6-bit-truncated f16 grid: code =
    ((f16_bits + 0x20) >> 6) - 0xA0, 0 for empty (non-positive) slots."""
    bits = quals_f32.to(torch.float16).view(torch.int16).to(torch.int32)
    bits = bits & 0xFFFF
    code = torch.clamp(((bits + 0x20) >> 6) - QUAL_CODE_BASE, 0, 255)
    code = torch.where(quals_f32 > 0, code, torch.zeros_like(code))
    return code.to(torch.uint8)


def _qual_dequantize_f16(code_u8):
    code = code_u8.to(torch.int32)
    bits = torch.where(code > 0, (code + QUAL_CODE_BASE) << 6,
                       torch.zeros_like(code))
    return bits.to(torch.int16).view(torch.float16)


def _pack_slots(q, o):
    """(C, rows, k) qualities/offsets -> (C, rows * words) int16 transport
    words: k u8 codes, k u8 offset low bytes, then k/4 high-bit bytes (2
    bits per slot, slot j in byte j//4 at bit 2*(j%4)) padded to an even
    byte count (matching.py:601-620; decoded by dp.cpp
    lis_stream_feed_packed and api._unpack_chunk)."""
    c, rows, k = q.shape
    codes = _qual_quantize_u8(q).contiguous()
    o = o.to(torch.int32)
    lo = (o & 255).to(torch.uint8).contiguous()
    shifts = torch.tensor([1, 4, 16, 64], dtype=torch.int32, device=o.device)
    hi_b = torch.sum(((o >> 8) & 3).reshape(c, rows, k // 4, 4) * shifts,
                     dim=3).to(torch.uint8)
    if hi_b.shape[2] % 2:
        hi_b = torch.nn.functional.pad(hi_b, (0, 1))
    words = [p.contiguous().view(torch.int16) for p in (codes, lo, hi_b)]
    return torch.cat(words, dim=2).reshape(c, -1)


def match_fine_chunk(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask,
                     starts_tracks, b0, nb_valid):
    """Fine pass + rescue gating + packing for FINE_CHUNK blocks starting
    at block b0 (matching.py:577-598). Returns the chunk's (FINE_CHUNK, W)
    int16 transport rows: band-1 slots at every frame, rescue slots at even
    frames."""
    starts_chunk = starts_tracks[:, b0:b0 + FINE_CHUNK]
    quals, offs, _ = _fine_tracks(ms_a, norms_a, a_mask, ms_v, norms_v,
                                  v_mask, starts_chunk, b0, FINE_CHUNK,
                                  nb_valid)
    band1 = _pack_slots(quals[:, :, :TOP_K], offs[:, :, :TOP_K])
    rescue = _pack_slots(quals[:, ::2, TOP_K:], offs[:, ::2, TOP_K:])
    return torch.cat([band1, rescue], dim=1)


def match_stream(feats_a, len_a, feats_v, len_v, nf=None, mark=None):
    """The streaming matcher (matching.py:1018-1060): coarse tracks, then
    one match_fine_chunk per FINE_CHUNK blocks with the last chunk trimmed
    to the true block count. Returns (chunks: list of (rows, W) int16
    device tensors in audio order, starts_tracks (T, B_pad) i32, n_chunks,
    margin f32 scalar)."""
    state = match_coarse(feats_a, len_a, feats_v, len_v, nf=nf, mark=mark)
    starts_tracks = state[6]
    n_chunks = starts_tracks.shape[1] // FINE_CHUNK
    nb = nb_for(feats_a.shape[1])
    chunks = []
    for c in range(n_chunks):
        chunk = match_fine_chunk(*state[:6], starts_tracks, c * FINE_CHUNK,
                                 nb)
        chunks.append(chunk[:min(FINE_CHUNK, nb - c * FINE_CHUNK)])
    if mark:
        mark('fine')
    return chunks, starts_tracks, n_chunks, state[7]
