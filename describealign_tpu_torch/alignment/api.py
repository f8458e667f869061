"""align_from_pcm() / align() / align_batch_from_pcm(): the alignment entry
points.

Port of describealign_tpu/alignment/api.py's default path: host C++
features (ops/host_features) -> common-bucket padding -> f16 feature
upload -> the streamed torch matcher (coarse tracks, then the fine kernel
per 256-block chunk, packed into the dense int16 transport) -> the native
streaming LIS -> host tail (continuity filter, rescale, compression, L1
fit, pass 2, outputs) with the 5-stream coarse retry on low confidence.
Return tuples and printed progress / WARNING lines are the JAX package's.

align_batch_from_pcm pipelines a list of pairs: two feature threads
extract each pair's two streams ahead of it, the calling thread uploads
them and dispatches each pair's matcher, pool threads wait for each
pair's one result buffer and run the host stages. align_from_pcm
extracts the video's stream on a helper thread beside the description's.

features='device' (both PCM entry points; the JAX package reads
DESCRIBEALIGN_FEATURES=device) uploads the int16 PCM instead, each stream
padded to its own bucket, and runs matching.extract_and_match: the five
streams computed on the device in f32 (ops/features.py, two CUDA kernels
on the card), the single-shot matcher, and the native lis_from_match on
the unquantized qualities (api.py:208-221, 265-311).

frontend='mel' (the PCM entry points and combine(); the JAX package reads
DESCRIBEALIGN_FRONTEND=mel) takes streams 2-4 of the host features from
the mel filterbank (ops/mel.py). The JAX device-feature matcher always
computes the cascade, so frontend='mel' with features='device' raises
here. mesh= on align_batch_from_pcm matches the pairs data-parallel over a
list of devices (parallel/batch.py, api.py:667-717).

Not ported (link workarounds of the TPU setup, not semantics): the compact
transports, the pull modes and the separate pull pool, and the profiler
directory. The port reads no DESCRIBEALIGN_* setting; its defaults are the
JAX package's.
"""
import collections
import contextlib
import ctypes
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops.host_features import extract_features_host
from ..ops.mel import check_frontend
from ..utils import spans
from . import continuity, fit, lis, matching, preprocess, refine
from .native import native_lib
from .outputs import similarity_and_nodes
from .refine_native import refine_dp_flat

BUCKET_FRAMES = 210 * 64          # shape bucket quantum (64 s)
PAD_MARGIN = 210 + preprocess.WINDOW
PCM_BUCKET = 210 * BUCKET_FRAMES  # samples; 210 samples per feature frame
DEFAULT_FIT_BACKEND = 'native'
FEATURE_PATHS = ('host', 'device')


def _bucket_pad(n):
    return -(-(n + PAD_MARGIN) // BUCKET_FRAMES) * BUCKET_FRAMES


def _padded_len(s):
    return (-(-(s + PAD_MARGIN * 210) // PCM_BUCKET)) * PCM_BUCKET


def _pad_pcm_i16(pcm_i16):
    """Zero-pad (channels, samples) PCM to its bucket (api.py:92-96)."""
    target = _padded_len(pcm_i16.shape[1])
    if pcm_i16.shape[1] == target:
        return pcm_i16  # already bucket-padded (decode-ahead thread)
    return np.pad(pcm_i16, ((0, 0), (0, target - pcm_i16.shape[1])))


def _stack_padded(features, nmin, npad):
    out = np.zeros((5, npad), np.float32)
    for j, f in enumerate(features):
        out[j, :nmin] = np.asarray(f[:nmin], np.float32)
    return out


def _fail_if_short(path_len, num_video, num_audio):
    # reference semantics (describealign.py:698, 991)
    if path_len < max(min(num_video, num_audio) / 500., 5 * 210):
        raise RuntimeError("Alignment failed, are the input files mismatched?")


def host_features_padded(pcm_i16, true_samples=None, npad=None,
                         frontend='cascade'):
    """Host feature extraction into the bucket-padded (5, Npad) f32 stack;
    frames past the true length are zero. Returns (stack, n_frames).
    frontend: 'cascade' or 'mel' (ops/host_features)."""
    with spans.span('features.host'):
        true_samples = true_samples or pcm_i16.shape[1]
        n = int(true_samples) // 210
        if npad is None:
            npad = _bucket_pad(n)
        out = np.zeros((5, max(npad, n + 3)), np.float32)
        fs = extract_features_host(pcm_i16, true_samples, out=out,
                                   frontend=frontend)
        if fs and len(fs[0]) and fs[0].base is out:
            out[:, n:] = 0.0
            return np.ascontiguousarray(out[:, :npad]), n
        out = np.zeros((5, npad), np.float32)
        for j, f in enumerate(fs):
            k = min(len(f), n)
            out[j, :k] = f[:k]
        return out, n


def _stream_features(request, token, pcm_i16, true_samples, npad, frontend):
    """host_features_padded of one stream on a helper thread, under
    `request` (installed there, so its spans go to the caller's request)
    and, if `token`, a host token. It calls the module's
    host_features_padded by name, on the caller's own PCM array."""
    with spans.installed(request), \
            (_host_token() if token else contextlib.nullcontext()):
        return host_features_padded(pcm_i16, true_samples, npad, frontend)


def _feature_path(features, frontend='cascade'):
    """features itself, or a ValueError: an unknown path or frontend, or
    the mel frontend with device features (the device-feature matcher
    computes the cascade; the JAX package would silently compute cascade
    features there, matching.py:440-445)."""
    if features not in FEATURE_PATHS:
        raise ValueError(f"features={features!r}: expected one of "
                         f"{FEATURE_PATHS}")
    if check_frontend(frontend) == 'mel' and features == 'device':
        raise ValueError("frontend='mel' with features='device': the "
                         "device-feature matcher computes the cascade "
                         "frontend only; use features='host' for mel")
    return features


def _pcm_to_device(pcm_i16, device):
    """(C, S) int16 PCM zero-padded to its bucket, as _pad_pcm_i16 pads it,
    on the device: on the card through pinned memory, copied without a
    host wait (the caching host allocator keeps the buffer until the copy
    is done). Spans: `features.stage`, the host copy into the buffer with
    its zero tail (synchronous, on the calling thread); `features.upload`,
    the copy to the device."""
    c, s = pcm_i16.shape
    with spans.span('features.stage'):
        if device.type != 'cuda':
            buf = torch.from_numpy(
                np.ascontiguousarray(_pad_pcm_i16(pcm_i16)))
        else:
            buf = torch.empty((c, _padded_len(s)), dtype=torch.int16,
                              pin_memory=True)
            host = buf.numpy()
            host[:, :s] = pcm_i16
            host[:, s:] = 0
    with spans.span('features.upload'):
        return buf.to(device, non_blocking=True)


def _single_shot_parts(out):
    """extract_and_match's outputs as the host stages take them: offsets
    as int16 (half the bytes of the fine pass's int32), the margin last."""
    quals, offs, starts, feats_a, feats_v, margin = out
    return quals, offs.to(torch.int16), starts, feats_a, feats_v, margin


def _host_stages_single_shot(parts, na, nv, fit_backend, device,
                             quiet=False):
    """lis_from_match on the single-shot matcher's unquantized qualities,
    then the host tail with the retry (api.py:1107-1112). parts: numpy
    arrays in _single_shot_parts' order."""
    quals, offs, starts, feats_a, feats_v, margin = parts
    y, x = lis.lis_from_match(quals, offs, starts)
    return _host_stages_from_path(y, x, feats_a, feats_v, na, nv,
                                  fit_backend, margin=float(margin),
                                  device=device, quiet=quiet)


def _upload(feats_np, device):
    """The f16 feature round trip of the JAX package's upload
    (api.py:185,192): the matcher sees f16-rounded features."""
    with spans.span('features.upload'):
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


@spans.entry('align')
def align_from_pcm(video_pcm_i16, audio_pcm_i16, fit_backend=None,
                   video_samples=None, audio_samples=None,
                   combine_prints=False, device='cuda', timings=None,
                   features='host', frontend='cascade'):
    """int16 PCM (channels, samples) in, alignment out.

    video_samples/audio_samples: true sample counts when the PCM arrays are
    already bucket-padded (by combine()'s decode-ahead thread).
    combine_prints=True emits the reference combine()'s per-stage progress
    lines (describealign.py:1100-1113) around the feature stages, in
    addition to align()'s own lines. device: where the matcher runs.
    timings: an optional dict that receives per-stage seconds ('features',
    'coarse_map', 'coarse_dp', 'fine', 'lis_tail'); the device is then
    synchronized at every stage boundary. 'lis_tail' is everything after
    the fine pass: the device-to-host waits for its results, the native
    LIS, the host tail and, when it runs, the 5-stream retry with its
    matcher. Finer, without a synchronization: run the call under
    torch.profiler.profile(...) and read utils.spans.snapshot() or the
    exported trace (utils/spans.py). features: 'host' (the native C++
    extractor, both streams padded to a common bucket, f16 upload, the
    streamed matcher) or 'device' (int16 PCM upload, the device
    extractor, the single-shot matcher; 'features' is then the upload
    plus the extraction, and combine_prints adds no line, as in the JAX
    package). frontend: 'cascade' or 'mel' (host features only).

    Returns (audio_times_s, video_times_s, similarity_percent, path,
    median_slope, coarse_margin) - align()'s 5-tuple plus the margin; the
    caller surfaces the low-confidence WARNING via warn_low_confidence.
    """
    device = torch.device(device)
    fit_backend = fit_backend or DEFAULT_FIT_BACKEND
    mark = _timer(timings, device) if timings is not None else None
    if _feature_path(features, frontend) == 'device':
        spans.count('features.device')
        na = (audio_samples or audio_pcm_i16.shape[1]) // 210
        nv = (video_samples or video_pcm_i16.shape[1]) // 210
        print("  memorizing video...        \r", end='')
        dev_a = _pcm_to_device(audio_pcm_i16, device)
        dev_v = _pcm_to_device(video_pcm_i16, device)
        print("  matching audio...  \r", end='')
        parts = _single_shot_parts(matching.extract_and_match(
            dev_a, na, dev_v, nv, mark=mark))
        with spans.span('tail.fetch'):
            parts = [t.cpu().numpy() for t in parts]
        result = _host_stages_single_shot(parts, na, nv, fit_backend,
                                          device)
        if mark:
            mark('lis_tail')
        return result
    if combine_prints:
        print("  computing video features... \r", end='')
    else:
        print("  memorizing video...        \r", end='')
    # both streams pad to the COMMON bucket
    sv = video_samples or video_pcm_i16.shape[1]
    sa = audio_samples or audio_pcm_i16.shape[1]
    npad = max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
    # the video's stream on a helper thread beside the description's (the
    # native extractor releases the GIL); every line prints from here
    with ThreadPoolExecutor(max_workers=1) as helper:
        video = helper.submit(_stream_features, spans.current(), False,
                              video_pcm_i16, sv, npad, frontend)
        if combine_prints:
            # the audio stream was decoded ahead with the video; the
            # reference's line sequence is kept (describealign.py:1109-1113)
            print("  reading audio file...       \r", end='')
            print("  computing audio features...\r", end='')
        feats_a_np, na = host_features_padded(audio_pcm_i16, sa, npad,
                                              frontend)
        feats_v_np, nv = video.result()
    dev_v = _upload(feats_v_np, device)
    dev_a = _upload(feats_a_np, device)
    if combine_prints:
        print("  memorizing video...        \r", end='')
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


@spans.entry('align')
def align(video_features, audio_desc_features, video_energy,
          audio_desc_energy, fit_backend=None, video_frames=None,
          audio_frames=None, device='cuda', timings=None):
    """Feature-list entry (reference-compatible module API): returns the
    reference's 5-tuple and prints the low-confidence WARNING line.
    timings: as in align_from_pcm ('features' is the stacking and the
    upload); so are the spans."""
    device = torch.device(device)
    fit_backend = fit_backend or DEFAULT_FIT_BACKEND
    mark = _timer(timings, device) if timings is not None else None
    na = min(len(f) for f in audio_desc_features)
    nv = min(len(f) for f in video_features)
    if audio_frames is not None:
        na = min(na, int(audio_frames))
    if video_frames is not None:
        nv = min(nv, int(video_frames))

    print("  memorizing video...        \r", end='')
    npad = max(_bucket_pad(na), _bucket_pad(nv))
    with spans.span('features.stack'):
        feats_a_np = _stack_padded(audio_desc_features, na, npad)
        feats_v_np = _stack_padded(video_features, nv, npad)

    print("  matching audio...  \r", end='')
    dev_a = _upload(feats_a_np, device)
    dev_v = _upload(feats_v_np, device)
    if mark:
        mark('features')
    y, x, margin = _streamed_lis(dev_a, na, dev_v, nv, mark=mark)
    result = _host_stages_from_path(y, x, feats_a_np, feats_v_np, na, nv,
                                    fit_backend, margin=margin,
                                    device=device)
    if mark:
        mark('lis_tail')
    warn_low_confidence(result[5])
    return result[:5]


def _streamed_lis(dev_a, na, dev_v, nv, nf=None, mark=None):
    """Streamed matcher + native streaming LIS. Returns (video_path,
    audio_path, coarse margin as a Python float)."""
    chunks, starts_tracks, _, margin = matching.match_stream(
        dev_a, na, dev_v, nv, nf=nf, mark=mark)
    with spans.span('tail.fetch'):
        starts_tracks = starts_tracks.cpu().numpy()
    y, x = _consume_stream(_fetched(chunks), starts_tracks)
    with spans.span('tail.fetch'):
        margin = float(margin)
    return y, x, margin


def _fetched(chunks):
    """The device chunks as numpy arrays, each copied when the LIS asks."""
    for ch in chunks:
        with spans.span('tail.fetch'):
            packed = ch.cpu().numpy()
        yield packed


def _consume_stream(packed_iter, starts_tracks):
    """Feed packed chunk buffers (numpy, audio order) into a fresh native
    LIS and return the (video_path, audio_path) chain (api.py:836-883)."""
    with spans.span('tail.lis'):
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
                           fit_backend, margin=None, device='cuda',
                           quiet=False):
    """Host tail with the 5-stream coarse retry (api.py:1115-1143): a
    path-length failure or a margin below the floor re-runs the coarse pass
    over all 5 feature streams before the original result or raise
    stands. quiet: print no progress line (the batch path's threads)."""
    try:
        r = _host_stages_from_path_inner(y, x, feats_a_np, feats_v_np,
                                         na, nv, fit_backend, quiet, device)
    except RuntimeError:
        # the reference's "Alignment failed" path-length raise
        if margin is not None:
            spans.count('retry.short_path')
            retried = _coarse_retry(feats_a_np, feats_v_np, na, nv,
                                    fit_backend, None, device, quiet)
            if retried is not None:
                spans.count('retry.kept')
                return retried
        raise
    if margin is not None and margin < matching.COARSE_MARGIN_FLOOR:
        spans.count('retry.low_margin')
        retried = _coarse_retry(feats_a_np, feats_v_np, na, nv,
                                fit_backend, margin, device, quiet)
        if retried is not None:
            spans.count('retry.kept')
            return retried
    return r + (margin,)


def _coarse_retry(feats_a_np, feats_v_np, na, nv, fit_backend, margin,
                  device, quiet=False):
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
    with spans.span('tail.retry'):
        if not quiet:
            print("  rechecking alignment (full-band descriptors)...\r",
                  end='')
        y, x, m_r = _streamed_lis(
            _upload(feats_a_np, device), na, _upload(feats_v_np, device),
            nv, nf=matching.COARSE_RETRY_STREAMS)
        m_r = m_r * matching.COARSE_STREAMS / matching.COARSE_RETRY_STREAMS
        bar = (matching.COARSE_MARGIN_FLOOR if margin is None else
               max(margin, matching.COARSE_MARGIN_FLOOR))
        if not (np.isfinite(m_r) and m_r > bar):
            return None
        try:
            r = _host_stages_from_path_inner(y, x, feats_a_np, feats_v_np,
                                             na, nv, fit_backend, quiet,
                                             device)
        except (RuntimeError, ValueError):
            return None
        return r + (m_r,)


# One token per core around each heavy native section of the batch path
# (feature extraction, the LIS feed, the refinement tail): they release the
# GIL and have multi-MB working sets, so more of them in flight than cores
# only refills caches (api.py:896-917). Device dispatches and the waits for
# device results stay outside the token.
_HOST_TOKEN = threading.BoundedSemaphore(os.cpu_count() or 1)


@contextlib.contextmanager
def _host_token():
    """Hold _HOST_TOKEN for the duration; the wait for it is a span."""
    with spans.span('batch.token_wait'):
        _HOST_TOKEN.acquire()
    try:
        yield
    finally:
        _HOST_TOKEN.release()


def _require_device(device):
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is unavailable: describealign_tpu_torch "
                           "runs its matcher on an NVIDIA GPU (pass "
                           "device='cpu' to run it on the CPU)")
    return device


@spans.entry('batch')
def align_batch_from_pcm(pairs, fit_backend=None, device_depth=4,
                         host_workers=None, true_samples=None,
                         device='cuda', features='host', frontend='cascade',
                         mesh=None):
    """Batch fast path: list of (video_pcm_i16, audio_pcm_i16) pairs.

    With host features, two feature threads extract each pair's two
    streams ahead of its dispatch (for at most max(2, device_depth + 1)
    pairs beyond it); the calling thread uploads them and dispatches the
    pair's matcher, with at most device_depth + 1 pairs' device results
    outstanding; host_workers pool threads wait for each pair's result
    buffer and run the host stages (the native extractor, LIS, fit and
    pass 2 release the GIL). true_samples: per pair (video, audio) true
    sample counts when the PCM arrays are padded. device: where the
    matcher runs.
    features: as in align_from_pcm; 'device' dispatches each pair's PCM
    upload and extract_and_match (api.py:265-311). frontend: as in
    align_from_pcm.

    mesh: an optional sequence of devices (parallel.batch.make_mesh); the
    pairs are then matched data-parallel across them in mesh-sized groups,
    pair i on mesh[i % len(mesh)] (_align_batch_sharded, on the same
    pipeline; host features only), and `device` is not used.

    Returns a list of align_from_pcm's 6-tuples, one per pair, in input
    order. The first error of any pair is raised. Spans: as in
    align_from_pcm; each pair is a request of its own, a child of the
    batch's.
    """
    _feature_path(features, frontend)
    if mesh is not None and features == 'device':
        raise ValueError("mesh= with features='device': the data-parallel "
                         "batch matches host features only")
    if mesh is None:
        device = _require_device(device)
    else:
        mesh = [_require_device(d) for d in mesh]
        if not mesh:
            raise ValueError("mesh= holds no device (make_mesh() finds no "
                             "CUDA device here)")
    fit_backend = fit_backend or DEFAULT_FIT_BACKEND
    if host_workers is None:
        # cores + 1: one thread may wait for the device while the others
        # compute, without oversubscribing a small host
        host_workers = min(4, (os.cpu_count() or 1) + 1)
    if true_samples is None:
        true_samples = [(v.shape[1], a.shape[1]) for (v, a) in pairs]
    if mesh is not None:
        return _align_batch_sharded(pairs, true_samples, mesh, fit_backend,
                                    host_workers, device_depth, frontend)
    if features == 'device':
        return _align_batch_device(pairs, true_samples, fit_backend,
                                   host_workers, device_depth, device)
    return _align_batch_streamed(pairs, true_samples, fit_backend,
                                 host_workers, device_depth, device,
                                 frontend)


def _pull_dense_parts(buf, n_tracks):
    """Split a pair's (nb, W + 2 + 2*T) int16 buffer
    (matching.concat_chunks_with_starts) into (packed rows, starts_tracks
    (T, nb) i32, margin)."""
    w_st = 2 * n_tracks
    starts_tracks = np.ascontiguousarray(buf[:, -w_st:]).view(np.int32).T
    margin = matching.margin_from_i16(buf[0, -w_st - 2])
    # leading-columns VIEW: the strided native feed reads the packed rows
    # in place (no second media-scale copy)
    return buf[:, :-(w_st + 2)], starts_tracks, margin


def _pipelined(pairs, true_samples, dispatch, refine, host_workers,
               device_depth, mesh, frontend=None):
    """The batch pipeline of every batch route (api.py:265-311, 380-717).

    - the calling thread runs dispatch(v, a, sv, sa, npad, device) for
      each pair in order: it enqueues the pair's upload, matcher and
      device-to-host copies on the device's current stream and returns
      (parts, event) without waiting (event None on the CPU), then moves
      to the next pair;
    - a pool thread waits for the event, releases the pair's in-flight
      slot as soon as the bytes are on the host, and returns
      refine(parts, sv, sa, device): the CPU stages, under the core-count
      token.

    frontend: given by the host-feature routes. Each pair's two streams
    are then extracted ahead of its dispatch on the batch's feature pool,
    two threads, one task per stream (_stream_features: under the pair's
    request and a host token), submitted in pair order, for at most
    max(2, device_depth + 1) pairs beyond the one being dispatched; v and
    a are then the futures of the pair's video and description tasks.

    mesh: the devices; pair i runs on mesh[i % len(mesh)], and its npad is
    the common bucket of its group of len(mesh) pairs (the largest of the
    group's pairs' buckets, over its real pairs), so a one-device mesh
    gives each pair its own bucket.

    Outstanding device results stay bounded by device_depth (+1 being
    copied) per distinct device. The low-confidence retry runs its matcher
    from the pool thread, outside that bound, as in the JAX package: at
    most host_workers retries are in flight, each holding one pair's
    matcher state on its device, on the same stream as the dispatches.
    """
    n_dev = len(mesh)
    depth = max(2, device_depth + 1)
    in_flight = threading.Semaphore(depth * len(set(mesh)))
    buckets = [max(_bucket_pad(sv // 210), _bucket_pad(sa // 210))
               for sv, sa in true_samples]
    npads = [max(buckets[i - i % n_dev:i - i % n_dev + n_dev])
             for i in range(len(buckets))]

    def settle_and_refine(parts, done, sv, sa, request, device):
        with spans.installed(request):
            try:
                with spans.span('batch.result_wait'):
                    if done is not None:
                        done.synchronize()
            finally:
                in_flight.release()
            with _host_token(), spans.span('batch.refine'):
                return refine(parts, sv, sa, device)

    def on_device(fn):
        # the current device is per thread
        def run(*args):
            with _on(args[-1]):
                return fn(*args)
        return run

    def extract(j):
        # pair j's request, and its two streams' tasks (video, description)
        request = spans.fork()
        return request, [features.submit(_stream_features, request, True,
                                         pcm, s, npads[j], frontend)
                         for pcm, s in zip(pairs[j], true_samples[j])]

    futs = []
    ahead = collections.deque()     # extract(j) of pairs not yet dispatched
    pool = ThreadPoolExecutor(max_workers=host_workers)
    features = (ThreadPoolExecutor(max_workers=2) if frontend is not None
                else None)
    try:
        for i, ((v, a), (sv, sa)) in enumerate(zip(pairs, true_samples)):
            device = mesh[i % n_dev]
            if features is None:
                request = spans.fork()
            else:
                while len(ahead) < min(len(pairs) - i, 1 + depth):
                    ahead.append(extract(i + len(ahead)))
                request, (v, a) = ahead.popleft()
            with spans.installed(request):
                with spans.span('batch.slot_wait'):
                    in_flight.acquire()
                try:
                    with spans.span('batch.dispatch'):
                        parts, done = on_device(dispatch)(v, a, sv, sa,
                                                          npads[i], device)
                except BaseException:
                    # a failing dispatch must not keep its slot; the first
                    # error aborts the batch
                    in_flight.release()
                    raise
            futs.append(pool.submit(on_device(settle_and_refine), parts,
                                    done, sv, sa, request, device))
        with spans.span('batch.drain'):
            return [f.result() for f in futs]
    finally:
        # feature tasks not started are dropped, pairs already handed to
        # the pool finish (and release their slots); no thread is left
        # running when the call returns or raises
        if features is not None:
            features.shutdown(wait=True, cancel_futures=True)
        pool.shutdown(wait=True, cancel_futures=True)


def _on(device):
    """A context that makes `device` the current CUDA device (nothing for
    the CPU): launches, streams and events are per device."""
    return (torch.cuda.device(device) if device.type == 'cuda'
            else contextlib.nullcontext())


def _to_host(tensors, device):
    """Start copying device tensors into pinned host memory: (host
    tensors, the event that marks the copies done). On the CPU: (the
    tensors, None)."""
    if device.type != 'cuda':
        return list(tensors), None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    with torch.cuda.device(device):
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    return host, done


def _upload_pair_features(video, audio, npad, device):
    """Wait for a pair's two host feature stacks, then upload both as one
    pinned (2, 5, npad) f16 array ([0] = audio, [1] = video) without a
    host wait. video, audio: the futures of the pair's two feature tasks,
    each of host_features_padded's (stack, frames), started ahead of the
    dispatch on the batch's feature pool (_pipelined). Counts, per pair,
    whether both were done when asked (`features.ready`) or the call
    waited (`features.waited`). Returns (the device array, fa, fv, na,
    nv): the f32 features for the host stages and the true frame
    counts."""
    spans.count('features.ready' if video.done() and audio.done()
                else 'features.waited')
    fv, nv = video.result()
    fa, na = audio.result()
    with spans.span('features.upload'):
        fav_t = torch.empty((2, 5, npad), dtype=torch.float16,
                            pin_memory=device.type == 'cuda')
        fav = fav_t.numpy()
        fav[0] = fa
        fav[1] = fv
        return fav_t.to(device, non_blocking=True), fa, fv, na, nv


def _align_batch_streamed(pairs, true_samples, fit_backend, host_workers,
                          device_depth, device, frontend='cascade'):
    """The host-feature batch (api.py:380-664, dense transport): the
    feature pool extracts pair i's two streams ahead; the dispatching
    thread uploads them (_upload_pair_features), dispatches the matcher
    and the one-buffer transport and starts the buffer's copy; the pool
    thread runs the native LIS feed and the refinement tail
    (_pipelined)."""

    def dispatch(video, audio, sv, sa, npad, device):
        dev_av, fa, fv, na, nv = _upload_pair_features(video, audio, npad,
                                                       device)
        chunks, starts_dev, _, margin_dev = matching.match_stream_pair(
            dev_av, na, nv)
        combo = matching.concat_chunks_with_starts(chunks, starts_dev,
                                                   margin_dev)
        (host_buf,), done = _to_host([combo], device)
        return (host_buf, starts_dev.shape[0], fa, fv, na, nv), done

    def refine(parts, sv, sa, device):
        host_buf, n_tracks, fa, fv, na, nv = parts
        packed, starts_tracks, margin = _pull_dense_parts(host_buf.numpy(),
                                                          n_tracks)
        y, x = _consume_stream(iter([packed]), starts_tracks)
        return _host_stages_from_path(y, x, fa, fv, na, nv, fit_backend,
                                      margin=margin, device=device,
                                      quiet=True)

    return _pipelined(pairs, true_samples, dispatch, refine, host_workers,
                      device_depth, [device], frontend)


def _align_batch_device(pairs, true_samples, fit_backend, host_workers,
                        device_depth, device):
    """The device-feature batch (api.py:265-311): the dispatching thread
    uploads both streams' PCM, each padded to its own bucket, dispatches
    extract_and_match and starts the copies of its six outputs; the pool
    thread runs lis_from_match and the refinement tail (_pipelined)."""

    def dispatch(v, a, sv, sa, npad, device):
        spans.count('features.device')
        out = matching.extract_and_match(
            _pcm_to_device(a, device), sa // 210,
            _pcm_to_device(v, device), sv // 210)
        return _to_host(_single_shot_parts(out), device)

    def refine(parts, sv, sa, device):
        return _host_stages_single_shot([t.numpy() for t in parts],
                                        sa // 210, sv // 210, fit_backend,
                                        device, quiet=True)

    return _pipelined(pairs, true_samples, dispatch, refine, host_workers,
                      device_depth, [device])


def _align_batch_sharded(pairs, true_samples, mesh, fit_backend,
                         host_workers, device_depth, frontend='cascade'):
    """The data-parallel batch (api.py:667-717), on the batch pipeline
    (_pipelined): the pairs in groups of len(mesh), pair i on
    mesh[i % len(mesh)], each group's features padded to the group's
    COMMON bucket (it sets kv and the band clamps, so a pair may see
    another width than on the serial path), extracted ahead on the
    feature pool and uploaded as f16; the
    device side is parallel.batch.device_align_step (the single-shot
    matcher, the u8 quality transport); the pool threads run
    lis_from_match and the host tail with its retry on the pair's device
    (api.py:709-713: quiet, with the margin).

    The JAX package fills a ragged last group by repeating its last pair
    and drops those results; here the group is just smaller, with the
    bucket taken over its real pairs as there."""
    from ..parallel.batch import device_align_step

    def dispatch(video, audio, sv, sa, npad, device):
        dev_av, fa, fv, na, nv = _upload_pair_features(video, audio, npad,
                                                       device)
        host, done = _to_host(device_align_step(dev_av[0], na, dev_av[1],
                                                nv), device)
        return (host, fa, fv, na, nv), done

    def refine(parts, sv, sa, device):
        host, fa, fv, na, nv = parts
        quals, offs, starts, margin = (t.numpy() for t in host)
        return _host_stages_single_shot((quals, offs, starts, fa, fv,
                                         margin), na, nv, fit_backend,
                                        device, quiet=True)

    return _pipelined(pairs, true_samples, dispatch, refine, host_workers,
                      device_depth, mesh, frontend)


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
                                 fit_backend, quiet=False, device='cuda'):
    """Filter -> rescale -> compress -> fit -> pass 2 -> outputs
    (api.py:1220-1286). device: where fit_backend='device' runs its ADMM
    (the matcher's device; pool threads of the batch path launch there
    too)."""
    _fail_if_short(len(x), nv, na)

    if not quiet:
        print("  refining match: pass 1 of 2...\r", end='')
    with spans.span('tail.pass1'):
        x, y = continuity.continuity_filter(
            np.asarray(x, np.float64), np.asarray(y, np.float64))

        yi = np.ascontiguousarray(y, np.int64)
        xi = np.ascontiguousarray(x, np.int64)
        audio_scaled, video_scaled = _rescale_native(
            np.ascontiguousarray(feats_a_np, np.float32),
            np.ascontiguousarray(feats_v_np, np.float32), na, nv, xi, yi)

        cx, cy = continuity.compress_path(x, y)
        fit_result = fit.solve_l1_fit(cx, cy, backend=fit_backend,
                                      device=device)
        smooth_path = list(zip(cx, fit_result['smooth_y']))

    if not quiet:
        print("  refining match: pass 2 of 2...\r", end='')
    with spans.span('tail.pass2'):
        clusters = refine.build_line_clusters(smooth_path,
                                              fit_result['slopes'])
        pj, pc, pq, offsets = refine.build_points_flat(
            clusters, audio_scaled, video_scaled)
        path = refine_dp_flat(pj, pc, pq, offsets, len(clusters),
                              len(video_scaled))
        _fail_if_short(len(path), nv, na)

        audio_times, video_times, similarity_percent, path_s = \
            similarity_and_nodes(path, len(audio_scaled),
                                 len(video_scaled), na, nv)
    return (audio_times, video_times, similarity_percent, path_s,
            fit_result['median_slope'])
