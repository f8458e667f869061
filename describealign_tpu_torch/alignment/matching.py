"""Match generation on tensors: coarse offset search + fine banded
correlation.

Port of describealign_tpu/alignment/matching.py (see its docstring for the
design and the reference semantics). The coarse pass builds normalized
41-frame descriptors every 21 frames, scores them all-pairs, folds the 7
sub-lane video phases and the 10 within-block rows into a (blocks, video
lanes) score map by a skew max (ops/coarse_map.py: one hand-written CUDA
kernel on the card, the plain torch GEMMs and maxima on the CPU), and runs
an exact max-plus DP twice (k-best, the second track with the first
suppressed). The fine pass correlates every 210-frame audio
block against a 768-frame video band around each track with the fine
kernel (ops/fine_kernel.py), gates the rescue track, and packs the
candidates into the u8-quality transport rows the native LIS reads.

The device-feature path (extract_and_match) computes the feature stacks
from int16 PCM on the device (ops/features.py: two CUDA kernels on the
card) and runs the single-shot matcher (_match_core: the fine pass over
all blocks at once, qualities left unquantized).

The DP's steps run in ops/coarse_dp.py (dp_forward, dp_backtrace: two
hand-written CUDA kernels on the card, torch loops on the CPU). Above
COARSE_STREAM_ELEMS score-map elements (long media: a 95-minute film) it
may run streamed, with the score map in 64-block tiles and one checkpointed
cost row per tile, as the JAX package does: always on the CPU, and on the
card when the materialized map does not fit in its free memory
(coarse_streamed).
"""
import numpy as np
import torch

from ..utils import spans
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
# Device memory a materialized coarse pass above COARSE_STREAM_ELEMS must
# leave free beyond its counted peak (coarse_peak_bytes): room for what is
# allocated outside that count after the query - kernel modules loaded
# lazily on their first launch, library workspaces, another process on a
# shared card - and for cached blocks the allocator cannot hand out whole.
# 2 GiB is under 3 % of an 80-GB card and about two thirds of the film's
# own peak (3.16 GiB), so an input whose map only just fits streams rather
# than failing for want of memory.
COARSE_HEADROOM_BYTES = 2 * 1024 ** 3
# Coarse passes the budget of a materialized map covers at once on one
# device: a batch's dispatching thread and up to 4 low-confidence retries
# on its pool (host_workers' default is at most 4, api.align_batch_from_pcm).
# The single entries run one pass at a time and are budgeted the same, so
# the film (5 x 3.16 GiB + the headroom, 17.8 GiB) streams only on a card
# with less free.
COARSE_PASSES = 5
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


def _phase_stack(desc_v):
    """The 7 video phases' descriptors as one contiguous (7, Kv, K) tensor
    (a list of the phases is stacked)."""
    if isinstance(desc_v, torch.Tensor):
        return desc_v
    return torch.stack(list(desc_v))


def _block_scores_local(desc_a, desc_v):
    """Video-coordinate block score map P[b, v] (matching.py:171-222): per
    video phase the descriptor product, skew-maxed over the 10 coarse rows
    of each block (P[b, v] = max_p S[10b + p, v + p], zero past Kv) and
    max-folded across phases, in one block_scores call over every block."""
    from ..ops.coarse_map import block_scores
    nb = desc_a.shape[0] // COARSE_PER_BLOCK
    return block_scores(desc_a, _phase_stack(desc_v), 0, nb)


def _coarse_dp(p_map):
    """Monotone track DP over the (B, D) score map (matching.py:252-280):
    one dp_forward over the whole map and one dp_backtrace.
    Returns (per-block video lane path (B,) i32, the track's score)."""
    from ..ops.coarse_dp import dp_backtrace, dp_forward
    d = p_map.shape[1]
    cost = dp_forward(torch.zeros(d, dtype=torch.float32,
                                  device=p_map.device), p_map)
    path = dp_backtrace(None, cost)
    # index_select, not cost[-1][path[-1]]: an index read on the host would
    # make the dispatching thread wait for the whole DP
    return path.to(torch.int32), cost[-1].index_select(0, path[-1:])[0]


def _coarse_dp_streamed(desc_a, desc_v, nb, suppress_paths=()):
    """Memory-bounded twin of _block_scores_local + _coarse_dp
    (matching.py:294-375): the score map is computed in COARSE_CHUNK-block
    tiles inside the DP, the forward pass keeps the cost row from before
    each chunk, and the backtrace recomputes each chunk's tile and cost
    rows from that checkpoint. Twice the score compute, for (chunks + 64)
    rows of memory instead of 3 x (nb, kv). One dp_forward per tile and
    pass and one dp_backtrace per tile, on the same block_scores as the
    materialized pair, so the paths and the score are bit-equal to it.

    suppress_paths: earlier k-best tracks' (nb,) lane paths; lanes within
    SUPPRESS_LANES of them score -1e30 (inside block_scores).
    """
    from ..ops.coarse_dp import dp_backtrace, dp_forward
    from ..ops.coarse_map import block_scores
    desc_v = _phase_stack(desc_v)
    kv = desc_v.shape[1]
    dev = desc_a.device
    n_chunks = -(-nb // COARSE_CHUNK)
    suppress = torch.stack(list(suppress_paths)) if suppress_paths else None

    def chunk_rows(c, prev):
        """Cost rows of chunk c's true blocks, from the row before it.
        Rows past nb are never computed: the tile stops at nb, so the
        last row is cost[nb - 1] (the JAX scan passes it through)."""
        b0 = c * COARSE_CHUNK
        n = min(COARSE_CHUNK, nb - b0)
        return dp_forward(prev, block_scores(desc_a, desc_v, b0, n,
                                             suppress))

    ckpts = torch.empty((n_chunks, kv), dtype=torch.float32, device=dev)
    prev = torch.zeros(kv, dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        ckpts[c] = prev                      # the PRE-chunk row
        prev = chunk_rows(c, prev)[-1]
    path = torch.empty(nb, dtype=torch.int64, device=dev)
    o = None
    for c in range(n_chunks - 1, -1, -1):
        rows = chunk_rows(c, ckpts[c])
        b0 = c * COARSE_CHUNK
        # block nb - 1 (the last tile's last row) takes the first maximal
        # lane of its own row; every block b < nb - 1 backsteps from o
        tile = dp_backtrace(o if b0 + rows.shape[0] < nb else None, rows)
        path[b0:b0 + rows.shape[0]] = tile
        o = tile[0]
    return path.to(torch.int32), prev.index_select(0, path[-1:])[0]


def _k_best_tracks(desc_a, desc_v, nb, streamed, mark=None):
    """The N_TRACKS k-best coarse tracks (matching.py:1132-1152): the DP
    run again with each earlier track's lanes (+/- SUPPRESS_LANES)
    suppressed. streamed selects _coarse_dp_streamed, else the score map is
    materialized and run through _coarse_dp; both give bit-equal results.
    desc_v: the video phases' (7, Kv, K) descriptors, or a list of them.
    Returns (v_paths: list of (nb,) i32, scores: list of f32 scalars)."""
    desc_v = _phase_stack(desc_v)
    v_paths, scores = [], []
    if streamed:
        # the score map is computed inside the streamed DP, so
        # 'coarse_map' covers the descriptors only
        if mark:
            mark('coarse_map')
        for _ in range(N_TRACKS):
            v_path, score = _coarse_dp_streamed(desc_a, desc_v, nb,
                                                v_paths)
            v_paths.append(v_path)
            scores.append(score)
        return v_paths, scores
    p_map = _block_scores_local(desc_a, desc_v)
    if mark:
        mark('coarse_map')
    lanes = torch.arange(p_map.shape[1], dtype=torch.int32,
                         device=desc_a.device)[None, :]
    for _ in range(N_TRACKS):
        if v_paths:
            # the last track's lanes, suppressed in place: no track reads
            # the map unsuppressed again (coarse_peak_bytes counts this)
            near = (lanes - v_paths[-1][:, None]).abs_() <= SUPPRESS_LANES
            p_map.masked_fill_(near, -1e30)
            del near
        v_path, score = _coarse_dp(p_map)
        v_paths.append(v_path)
        scores.append(score)
    return v_paths, scores


def coarse_peak_bytes(nb, kv):
    """Device bytes the materialized branch of _k_best_tracks allocates at
    its peak beyond its inputs, counted from the code: the (nb, kv) f32
    map, and with it either one _coarse_dp's f32 cost rows (8 B an element)
    or the suppression's int32 lane distances and bool mask (9 B); plus
    the per-lane and per-block vectors (the lanes, the DP's zero row,
    paths, the backtrace's scratch: under 32 B a lane or block)."""
    return 9 * nb * kv + 32 * (nb + kv)


def coarse_streamed(nb, kv, device):
    """Whether the coarse pass over an (nb, kv) score map on `device` runs
    streamed (_coarse_dp_streamed) rather than materialized:

    - at or below COARSE_STREAM_ELEMS map elements: materialized, and no
      memory is queried;
    - above it on a device other than CUDA: streamed, as in the JAX
      package, so the two take the same branch for every input;
    - above it on a CUDA device: materialized when COARSE_PASSES times
      coarse_peak_bytes, plus COARSE_HEADROOM_BYTES, fit in its free
      memory (cudaMemGetInfo's free bytes and what the caching allocator
      holds reserved but unallocated), else streamed.

    The budget is not passed down from the routes: it covers the most
    passes a batch runs at once with its default host_workers, each as if
    none had allocated yet, so passes that query at the same moment all
    fit. A batch given more host_workers may retry more films at once than
    that covers."""
    if nb * kv <= COARSE_STREAM_ELEMS:
        return False
    device = torch.device(device)
    if device.type != 'cuda':
        return True
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    return (COARSE_PASSES * coarse_peak_bytes(nb, kv) + COARSE_HEADROOM_BYTES
            > free)


def _coarse_margin(scores, a_mask, nb):
    """(track-1 score - track-2 score) / anchor blocks, the audio blocks
    that contribute any eligible coarse descriptor."""
    anchor_rows = a_mask[torch.arange(nb * COARSE_PER_BLOCK,
                                      device=a_mask.device) * COARSE_STRIDE]
    n_anchor = torch.sum(torch.any(
        anchor_rows.reshape(nb, COARSE_PER_BLOCK), dim=1).to(torch.int32))
    return ((scores[0] - scores[1])
            / torch.clamp(n_anchor, min=1).to(torch.float32))


def _coarse_tracks(ms_a, norms_a, energy_a, len_a,
                   ms_v, norms_v, energy_v, len_v, nf=None, mark=None):
    """Masks + coarse score map + k-best DP tracks (matching.py:1100-1177).
    Materialized or streamed as coarse_streamed decides (streamed above
    COARSE_STREAM_ELEMS on the CPU, as in the JAX package; on the card only
    where the map does not fit); each pass counts 'coarse.streamed' or
    'coarse.materialized'.

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
    desc_v = torch.stack([_coarse_descriptors(ms_v[:nf], norms_v[:nf],
                                              v_mask, phase)
                          for phase in SUB_LANE_SHIFTS])
    ka = desc_a.shape[0]
    kv = desc_v.shape[1]
    nb = ka // COARSE_PER_BLOCK
    streamed = coarse_streamed(nb, kv, dev)
    spans.count('coarse.streamed' if streamed else 'coarse.materialized')
    v_paths, scores = _k_best_tracks(desc_a, desc_v, nb, streamed, mark)
    margin = _coarse_margin(scores, a_mask, nb)

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
    # 1 << (2 * (j % 4)), made on the device: a tensor copied from the host
    # would make the dispatching thread wait for the stream
    shifts = 4 ** torch.arange(4, dtype=torch.int32, device=o.device)
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


# --- the batch path's one-buffer transport (matching.py:650-682) ------------

def _margin_words_i16(margin, rows):
    """(rows, 2) int16 column pair: [bitcast f16 margin, 0] per row."""
    m16 = margin.to(torch.float16).reshape(1, 1).view(torch.int16)
    return torch.cat([m16.expand(rows, 1),
                      torch.zeros((rows, 1), dtype=torch.int16,
                                  device=margin.device)], dim=1)


def margin_from_i16(word):
    """Host decoder of _margin_words_i16's f16 word."""
    return float(np.array(word, np.int16).view(np.float16))


def concat_chunks_with_starts(chunks, starts_tracks, margin):
    """Batch transport: the streamed chunks concatenated along blocks, then
    the coarse margin (one f16 word + one pad word), then each block's band
    starts bitcast into 2*T trailing int16 words per row - one
    (nb, W + 2 + 2*T) int16 buffer, so a pair is one device-to-host copy.
    Split back by api's batch consumer."""
    packed = torch.cat(chunks, dim=0)                       # (nb, W)
    # the chunks are trimmed to the true block count; so are the starts
    st16 = (starts_tracks.T[:packed.shape[0]].to(torch.int32).contiguous()
            .view(torch.int16))                             # (nb, 2*T)
    return torch.cat([packed, _margin_words_i16(margin, packed.shape[0]),
                      st16], dim=1)


def match_stream(feats_a, len_a, feats_v, len_v, nf=None, mark=None):
    """The streaming matcher (matching.py:1018-1060): coarse tracks, then
    one match_fine_chunk per FINE_CHUNK blocks with the last chunk trimmed
    to the true block count. Returns (chunks: list of (rows, W) int16
    device tensors in audio order, starts_tracks (T, B_pad) i32, n_chunks,
    margin f32 scalar)."""
    with spans.span('match'):
        state = match_coarse(feats_a, len_a, feats_v, len_v, nf=nf,
                             mark=mark)
        starts_tracks = state[6]
        n_chunks = starts_tracks.shape[1] // FINE_CHUNK
        nb = nb_for(feats_a.shape[1])
        chunks = []
        for c in range(n_chunks):
            chunk = match_fine_chunk(*state[:6], starts_tracks,
                                     c * FINE_CHUNK, nb)
            chunks.append(chunk[:min(FINE_CHUNK, nb - c * FINE_CHUNK)])
        if mark:
            mark('fine')
        return chunks, starts_tracks, n_chunks, state[7]


def match_stream_pair(dev_av, len_a, len_v):
    """match_stream off one combined (2, 5, Npad) upload ([0] = audio /
    description features, [1] = video), the batch path's matcher
    (matching.py:1028-1032). On the card it is a few dozen launches with no
    host wait in between: the JAX package's one-dispatch matcher
    (_match_pair_fused) needs no other counterpart."""
    return match_stream(dev_av[0], len_a, dev_av[1], len_v)


# ---------------------------------------------------------------------------
# The single-shot matcher and the device-feature path
# ---------------------------------------------------------------------------

def _match_core(ms_a, norms_a, energy_a, len_a,
                ms_v, norms_v, energy_v, len_v, nf=None, mark=None):
    """All-in-one matcher (matching.py:1260-1279): the coarse tracks, then
    the fine pass over every block at once (one fine_match call per track).

    ms_*, norms_*: (5, Npad_*) preprocessed features (the two widths may
    differ); energy_*: (Npad_*,) raw energy feature; len_*: true frame
    counts. Returns (quals (B, 210, G*K) f32 unquantized, offs (B, 210,
    G*K) i32, starts (B, G) i32, centers (B,) best-track offset frames,
    margin f32 scalar); slot j's video frame is starts[b, j // (K // 2)]
    + offs[b, l, j]."""
    a_mask, v_mask, starts_tracks, centers, margin = _coarse_tracks(
        ms_a, norms_a, energy_a, len_a, ms_v, norms_v, energy_v, len_v,
        nf=nf, mark=mark)
    nb = starts_tracks.shape[1]
    quals, offs, starts = _fine_tracks(ms_a, norms_a, a_mask, ms_v, norms_v,
                                       v_mask, starts_tracks, 0, nb, nb)
    if mark:
        mark('fine')
    return quals, offs, starts, centers, margin


def extract_and_match(pcm_a_i16, len_a, pcm_v_i16, len_v, mark=None):
    """The device-feature pipeline (matching.py:423-459): int16 PCM ->
    features -> preprocess -> single-shot match, all on the PCM's device.

    pcm_*_i16: (C, S_pad) int16 tensors, each padded to its own bucket;
    len_*: true 210-fps frame counts. The features are f32 (no f16 round
    trip), cut to S_pad // 210 frames and zero from the true length on.
    mark: an optional stage timer ('features', then match's stages).

    Returns (quals, offs, starts, feats_a (5, S_pad_a // 210),
    feats_v (5, S_pad_v // 210), margin)."""
    from ..ops.features import feature_stack
    with spans.span('match'):
        feats = []
        for pcm, n_true in ((pcm_a_i16, len_a), (pcm_v_i16, len_v)):
            f = feature_stack(pcm, pcm.shape[1] // BLOCK)
            idx = torch.arange(f.shape[1], device=f.device)[None, :]
            feats.append(torch.where(idx < n_true, f,
                                     torch.zeros((), device=f.device)))
        feats_a, feats_v = feats
        if mark:
            mark('features')
        ms_a, norms_a = preprocess_features(feats_a)
        ms_v, norms_v = preprocess_features(feats_v)
        quals, offs, starts, _, margin = _match_core(
            ms_a, norms_a, feats_a[0], len_a, ms_v, norms_v, feats_v[0],
            len_v, mark=mark)
        return quals, offs, starts, feats_a, feats_v, margin
