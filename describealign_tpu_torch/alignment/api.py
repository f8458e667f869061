"""align_from_pcm() / align(): the single-pair alignment entry points.

Port of describealign_tpu/alignment/api.py's default path: host C++
features (ops/host_features) -> common-bucket padding -> f16 feature
upload -> the streamed torch matcher (coarse tracks, then the fine kernel
per 256-block chunk, packed into the dense int16 transport) -> the native
streaming LIS -> host tail (continuity filter, rescale, compression, L1
fit, pass 2, outputs) with the 5-stream coarse retry on low confidence.
Return tuples and printed progress / WARNING lines are the JAX package's.

Not ported (link workarounds of the TPU setup, not semantics): the compact
per-chunk transport, the pull thread pool and the profiler directory. The
port reads no DESCRIBEALIGN_* setting; its defaults are the JAX package's.
"""
import ctypes
import time

import numpy as np
import torch

from ..ops.host_features import extract_features_host
from . import continuity, fit, lis, matching, preprocess, refine
from .native import native_lib
from .outputs import similarity_and_nodes
from .refine_native import refine_dp_flat

BUCKET_FRAMES = 210 * 64          # shape bucket quantum (64 s)
PAD_MARGIN = 210 + preprocess.WINDOW
DEFAULT_FIT_BACKEND = 'native'


def _bucket_pad(n):
    return -(-(n + PAD_MARGIN) // BUCKET_FRAMES) * BUCKET_FRAMES


def _stack_padded(features, nmin, npad):
    out = np.zeros((5, npad), np.float32)
    for j, f in enumerate(features):
        out[j, :nmin] = np.asarray(f[:nmin], np.float32)
    return out


def _fail_if_short(path_len, num_video, num_audio):
    # reference semantics (describealign.py:698, 991)
    if path_len < max(min(num_video, num_audio) / 500., 5 * 210):
        raise RuntimeError("Alignment failed, are the input files mismatched?")


def host_features_padded(pcm_i16, true_samples=None, npad=None):
    """Host feature extraction into the bucket-padded (5, Npad) f32 stack;
    frames past the true length are zero. Returns (stack, n_frames)."""
    true_samples = true_samples or pcm_i16.shape[1]
    n = int(true_samples) // 210
    if npad is None:
        npad = _bucket_pad(n)
    out = np.zeros((5, max(npad, n + 3)), np.float32)
    fs = extract_features_host(pcm_i16, true_samples, out=out)
    if fs and len(fs[0]) and fs[0].base is out:
        out[:, n:] = 0.0
        return np.ascontiguousarray(out[:, :npad]), n
    out = np.zeros((5, npad), np.float32)
    for j, f in enumerate(fs):
        k = min(len(f), n)
        out[j, :k] = f[:k]
    return out, n


def _upload(feats_np, device):
    """The f16 feature round trip of the JAX package's upload
    (api.py:185,192): the matcher sees f16-rounded features."""
    return torch.from_numpy(feats_np.astype(np.float16)).to(device)


def _timer(timings, device):
    """A mark(stage) callable that adds the wall time since the previous
    mark to timings[stage], after waiting for the device."""
    last = [time.perf_counter()]

    def mark(stage):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timings[stage] = timings.get(stage, 0.0) + now - last[0]
        last[0] = now
    return mark


def align_from_pcm(video_pcm_i16, audio_pcm_i16, fit_backend=None,
                   device='cuda', timings=None):
    """int16 PCM (channels, samples) in, alignment out.

    device: where the matcher runs. timings: an optional dict that
    receives per-stage seconds ('features', 'coarse_map', 'coarse_dp',
    'fine', 'lis_tail'); the device is then synchronized at every stage
    boundary.

    Returns (audio_times_s, video_times_s, similarity_percent, path,
    median_slope, coarse_margin) - align()'s 5-tuple plus the margin; the
    caller surfaces the low-confidence WARNING via warn_low_confidence.
    """
    device = torch.device(device)
    fit_backend = fit_backend or DEFAULT_FIT_BACKEND
    mark = _timer(timings, device) if timings is not None else None
    print("  memorizing video...        \r", end='')
    # both streams pad to the COMMON bucket
    sv = video_pcm_i16.shape[1]
    sa = audio_pcm_i16.shape[1]
    npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
    feats_v_np, nv = host_features_padded(video_pcm_i16, sv, npad)
    dev_v = _upload(feats_v_np, device)
    feats_a_np, na = host_features_padded(audio_pcm_i16, sa, npad)
    dev_a = _upload(feats_a_np, device)
    print("  matching audio...  \r", end='')
    if mark:
        mark('features')
    y, x, margin = _streamed_lis(dev_a, na, dev_v, nv, mark=mark)
    result = _host_stages_from_path(y, x, feats_a_np, feats_v_np, na, nv,
                                    fit_backend, margin=margin,
                                    device=device)
    if mark:
        mark('lis_tail')
    return result


def align(video_features, audio_desc_features, video_energy,
          audio_desc_energy, fit_backend=None, video_frames=None,
          audio_frames=None, device='cuda'):
    """Feature-list entry (reference-compatible module API): returns the
    reference's 5-tuple and prints the low-confidence WARNING line."""
    device = torch.device(device)
    fit_backend = fit_backend or DEFAULT_FIT_BACKEND
    na = min(len(f) for f in audio_desc_features)
    nv = min(len(f) for f in video_features)
    if audio_frames is not None:
        na = min(na, int(audio_frames))
    if video_frames is not None:
        nv = min(nv, int(video_frames))

    print("  memorizing video...        \r", end='')
    npad = max(_bucket_pad(na), _bucket_pad(nv))
    feats_a_np = _stack_padded(audio_desc_features, na, npad)
    feats_v_np = _stack_padded(video_features, nv, npad)

    print("  matching audio...  \r", end='')
    y, x, margin = _streamed_lis(_upload(feats_a_np, device), na,
                                 _upload(feats_v_np, device), nv)
    result = _host_stages_from_path(y, x, feats_a_np, feats_v_np, na, nv,
                                    fit_backend, margin=margin,
                                    device=device)
    warn_low_confidence(result[5])
    return result[:5]


def _streamed_lis(dev_a, na, dev_v, nv, nf=None, mark=None):
    """Streamed matcher + native streaming LIS. Returns (video_path,
    audio_path, coarse margin as a Python float)."""
    chunks, starts_tracks, _, margin = matching.match_stream(
        dev_a, na, dev_v, nv, nf=nf, mark=mark)
    y, x = _consume_stream((ch.cpu().numpy() for ch in chunks),
                           starts_tracks.cpu().numpy())
    return y, x, float(margin)


def _consume_stream(packed_iter, starts_tracks):
    """Feed packed chunk buffers (numpy, audio order) into a fresh native
    LIS and return the (video_path, audio_path) chain (api.py:836-883)."""
    # grouped starts for the LIS: band 1 twice (half-spans) + rescues
    starts_grouped = np.stack(
        [starts_tracks[0], starts_tracks[0]] + list(starts_tracks[1:]),
        axis=1).astype(np.int32)                      # (B_pad, G)
    # the frontier spans the video length plus the int16 offset range
    max_key = int(starts_grouped.max()) + 32768
    k1 = matching.TOP_K
    k2 = (starts_grouped.shape[1] - 2) * (matching.TOP_K // 2)
    with lis.LisStream(max_key) as ctx:
        row = 0
        for packed in packed_iter:
            nblk = packed.shape[0]
            ctx.feed_packed(packed, starts_grouped[row:row + nblk],
                            a_base=row * 210, blk=210, k1=k1, k2=k2)
            row += nblk
        return ctx.finish()


def warn_low_confidence(margin):
    """Print the low-confidence WARNING line when the coarse k-best margin
    is below the calibrated floor (matching.COARSE_MARGIN_FLOOR)."""
    if margin is not None and margin < matching.COARSE_MARGIN_FLOOR:
        print(f"  WARNING: low alignment confidence (coarse margin "
              f"{margin:.3f}), likely mismatched or heavily distorted "
              f"files")


def _host_stages_from_path(y, x, feats_a_np, feats_v_np, na, nv,
                           fit_backend, margin=None, device='cuda'):
    """Host tail with the 5-stream coarse retry (api.py:1115-1143): a
    path-length failure or a margin below the floor re-runs the coarse pass
    over all 5 feature streams before the original result or raise
    stands."""
    try:
        r = _host_stages_from_path_inner(y, x, feats_a_np, feats_v_np,
                                         na, nv, fit_backend)
    except RuntimeError:
        # the reference's "Alignment failed" path-length raise
        if margin is not None:
            retried = _coarse_retry(feats_a_np, feats_v_np, na, nv,
                                    fit_backend, None, device)
            if retried is not None:
                return retried
        raise
    if margin is not None and margin < matching.COARSE_MARGIN_FLOOR:
        retried = _coarse_retry(feats_a_np, feats_v_np, na, nv,
                                fit_backend, margin, device)
        if retried is not None:
            return retried
    return r + (margin,)


def _coarse_retry(feats_a_np, feats_v_np, na, nv, fit_backend, margin,
                  device):
    """Low-confidence escalation (api.py:1150-1197): re-run the matcher
    with the coarse pass over all 5 streams. The retried result replaces
    the original only when its margin, scaled to the 3-stream calibration
    of the floor, clears the floor and (unless margin is None, the raise
    path) the original margin. The streamed matcher serves the retry: it
    is path-equivalent to the JAX package's single-shot retry matcher.

    A failure of the retried host tail (its path too short, a fit that
    fails) leaves the original result standing. Errors of the matcher -
    the fine kernel, CUDA, device memory - propagate: the JAX package
    swallows them too, but there they never came from a hand-written
    kernel."""
    print("  rechecking alignment (full-band descriptors)...\r", end='')
    y, x, m_r = _streamed_lis(
        _upload(feats_a_np, device), na, _upload(feats_v_np, device), nv,
        nf=matching.COARSE_RETRY_STREAMS)
    m_r = m_r * matching.COARSE_STREAMS / matching.COARSE_RETRY_STREAMS
    bar = (matching.COARSE_MARGIN_FLOOR if margin is None else
           max(margin, matching.COARSE_MARGIN_FLOOR))
    if not (np.isfinite(m_r) and m_r > bar):
        return None
    try:
        r = _host_stages_from_path_inner(y, x, feats_a_np, feats_v_np,
                                         na, nv, fit_backend)
    except (RuntimeError, ValueError):
        return None
    return r + (m_r,)


def _rescale_native(feats_a_np, feats_v_np, na, nv, xi, yi):
    """Least-squares gain match of the first 3 video streams to the
    audio's scale (reference 733-741) in one native pass per stream.
    Returns (audio_scaled, video_scaled), (N, 3) f32 each."""
    fp = ctypes.POINTER(ctypes.c_float)
    lp = ctypes.POINTER(ctypes.c_int64)
    audio_scaled = np.empty((na, 3), np.float32)
    video_scaled = np.empty((nv, 3), np.float32)
    lib = native_lib()
    for j in range(3):
        rc = lib.rescale_feature(
            feats_v_np[j].ctypes.data_as(fp), ctypes.c_int64(nv),
            feats_a_np[j].ctypes.data_as(fp), ctypes.c_int64(na),
            yi.ctypes.data_as(lp), xi.ctypes.data_as(lp),
            ctypes.c_int64(len(xi)),
            ctypes.cast(audio_scaled.ctypes.data + 4 * j, fp),
            ctypes.cast(video_scaled.ctypes.data + 4 * j, fp),
            ctypes.c_int64(3))
        if rc != 0:
            raise ValueError("native rescale_feature failed")
    return audio_scaled, video_scaled


def _host_stages_from_path_inner(y, x, feats_a_np, feats_v_np, na, nv,
                                 fit_backend):
    """Filter -> rescale -> compress -> fit -> pass 2 -> outputs
    (api.py:1220-1286)."""
    _fail_if_short(len(x), nv, na)

    print("  refining match: pass 1 of 2...\r", end='')
    x, y = continuity.continuity_filter(
        np.asarray(x, np.float64), np.asarray(y, np.float64))

    yi = np.ascontiguousarray(y, np.int64)
    xi = np.ascontiguousarray(x, np.int64)
    audio_scaled, video_scaled = _rescale_native(
        np.ascontiguousarray(feats_a_np, np.float32),
        np.ascontiguousarray(feats_v_np, np.float32), na, nv, xi, yi)

    cx, cy = continuity.compress_path(x, y)
    fit_result = fit.solve_l1_fit(cx, cy, backend=fit_backend)
    smooth_path = list(zip(cx, fit_result['smooth_y']))

    print("  refining match: pass 2 of 2...\r", end='')
    clusters = refine.build_line_clusters(smooth_path, fit_result['slopes'])
    pj, pc, pq, offsets = refine.build_points_flat(clusters, audio_scaled,
                                                   video_scaled)
    path = refine_dp_flat(pj, pc, pq, offsets, len(clusters),
                          len(video_scaled))
    _fail_if_short(len(path), nv, na)

    audio_times, video_times, similarity_percent, path_s = \
        similarity_and_nodes(path, len(audio_scaled), len(video_scaled),
                             na, nv)
    return (audio_times, video_times, similarity_percent, path_s,
            fit_result['median_slope'])
