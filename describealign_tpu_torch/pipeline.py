"""combine(): the main user-facing pipeline, the port of
describealign_tpu/pipeline.py.

Orchestration contract follows the reference combine()
(describealign.py:1031-1175): file discovery/pairing confirmation, ffmpeg
install flow, per-pair decode -> features -> align -> (video retime | audio
stretch) -> mux -> plot/report, with the same prints, warnings, skip/resume
rule, and defaults.

Directory runs with more than one pair to align go through the pipelined
batch aligner (align_batch_from_pcm) while the mux/report stages stay
per-pair in input order; a single pair runs through the sequential loop
with a one-pair decode-ahead thread. The matcher runs on `device` (default
'cuda'); there is no fallback to the CPU.
"""
import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .constants import (AUDIO_EXTENSIONS, AUDIO_SAMPLE_RATE,
                        DEFAULT_ALIGNMENT_DIR, DEFAULT_OUTPUT_DIR,
                        IS_RUNNING_WINDOWS, PLOT_ALIGNMENT_TO_FILE,
                        VIDEO_EXTENSIONS)
from .utils import aligncache
from .utils.files import ensure_folders_exist, get_sorted_filenames

PCM_BUCKET_SECONDS = 60


def _low_ram_std(arr):
    avg = np.mean(arr, dtype=np.float64)
    return np.sqrt(np.einsum('ij,ij->i', arr, arr, dtype=np.float64)
                   / arr.size - avg ** 2)


def features_for(pcm, device='cuda', frontend='cascade'):
    """Bucketed feature extraction utility for module users
    (pipeline.py:33-47): zero-pads PCM (channels, samples) to a 60-second
    quantum and returns (list of 5 numpy f32 streams, true 210fps frame
    count), suitable for the feature-list align() entry. The streams are
    computed on `device` (ops/features.extract_features) with the
    'cascade' or the 'mel' frontend."""
    from .ops.features import extract_features
    quantum = AUDIO_SAMPLE_RATE * PCM_BUCKET_SECONDS
    true_samples = pcm.shape[1]
    pad = (-true_samples) % quantum
    if pad:
        pcm = np.pad(pcm, ((0, 0), (0, pad)))
    feats = extract_features(pcm, device=device, frontend=frontend)
    return [f.cpu().numpy() for f in feats], true_samples // 210


# Pairs per align_batch_from_pcm call in directory mode. Groups bound peak
# memory (a group's decoded PCM is held until its pairs are consumed) while
# still amortizing the device pipeline across pairs.
BATCH_GROUP_SIZE = 8


def _use_batch(n_work):
    """Directory runs with more than one pair to align go through the
    pipelined batch path."""
    return n_work > 1


def _auto_mesh(device='cuda'):
    """The devices for directory batches (pipeline.py:63-88): every CUDA
    device of the host when there is more than one and `device` names no
    card of its own (the bare 'cuda'; pair i on card i % n,
    api._align_batch_sharded), else None (the single-device batch on
    `device`). The JAX package's DESCRIBEALIGN_MESH is not read."""
    device = torch.device(device)
    if (device.type == 'cuda' and device.index is None
            and torch.cuda.device_count() > 1):
        from .parallel.batch import make_mesh
        return make_mesh()
    return None


class _BatchAligner:
    """Background decode + batch-align engine for directory mode.

    A single worker thread decodes group-size slices of the work list and
    runs align_batch_from_pcm on each slice (which pipelines device
    dispatch and threads the host refinement); results arrive on a bounded
    queue in work-list order, so the main combine() loop consumes pair i's
    alignment while pairs i+1.. are still decoding/aligning. The queue
    bound caps retained PCM (stretch mode hands the decoded arrays back to
    the consumer for segment replacement).
    """

    def __init__(self, items, num_channels, keep_pcm, group, device,
                 features='host', frontend='cascade'):
        # items: list of (pair_index, video_file, audio_file) in input order
        self._items = items
        self._nch = num_channels
        self._keep_pcm = keep_pcm
        self._group = group
        self._device = device
        self._features = features
        self._frontend = frontend
        self._q = queue_mod.Queue(maxsize=max(2, group))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue_mod.Full:
                continue
        return False

    def _run(self):
        from .alignment.api import align_batch_from_pcm
        from .media.decode import parse_audio_int16
        try:
            # the data-parallel batch takes host features on the cards
            mesh = (_auto_mesh(self._device) if self._features == 'host'
                    else None)
            for g0 in range(0, len(self._items), self._group):
                if self._stop.is_set():
                    return
                group = self._items[g0:g0 + self._group]
                pcm = []
                lens = []
                for _, vf, af in group:
                    v = parse_audio_int16(vf, self._nch)
                    a = parse_audio_int16(af, self._nch)
                    pcm.append((v, a))
                    lens.append((v.shape[1], a.shape[1]))
                results = align_batch_from_pcm(pcm, true_samples=lens,
                                               device=self._device,
                                               features=self._features,
                                               frontend=self._frontend,
                                               mesh=mesh)
                for (idx, _, _), res, vap, ln in zip(group, results, pcm,
                                                     lens):
                    payload = (vap + ln) if self._keep_pcm else None
                    if not self._put(('ok', idx, res, payload)):
                        return
                del pcm
        except BaseException as exc:  # surfaced on the consumer thread
            self._put(('err', exc))

    def get(self, pair_index):
        kind, *rest = self._q.get()
        if kind == 'err':
            raise rest[0]
        idx, res, payload = rest
        if idx != pair_index:
            raise RuntimeError(
                f"batch aligner out of order: got pair {idx}, "
                f"expected {pair_index}")
        return res, payload

    def shutdown(self):
        self._stop.set()
        # drain so a worker blocked on a full queue can observe the stop
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass


def combine(video, audio, stretch_audio=False, yes=False, prepend="ad_",
            no_pitch_correction=False, output_dir=DEFAULT_OUTPUT_DIR,
            alignment_dir=DEFAULT_ALIGNMENT_DIR, device='cuda',
            features='host', stretcher='wsola', pv_backend='host',
            resample_backend='host', frontend='cascade'):
    """Combine videos with matching audio description files.

    Same public behavior as the JAX package's combine() and the reference's
    documented module API (reference README.md:136-140); device is where
    the matcher runs; features is where the features are extracted
    ('host' or 'device', see alignment.api.align_from_pcm; the JAX package
    reads DESCRIBEALIGN_FEATURES); frontend is 'cascade' or 'mel' (host
    features only; the JAX package reads DESCRIBEALIGN_FRONTEND). In
    stretch mode, stretcher ('wsola' or
    'pv'), pv_backend and resample_backend ('host' or 'device', on
    `device`) choose the stretch backends (stretch.segments; the JAX
    package reads DESCRIBEALIGN_STRETCH, DESCRIBEALIGN_PV and
    DESCRIBEALIGN_RESAMPLE), with the JAX package's defaults.
    """
    from . import __version__
    from .alignment.api import (_feature_path, _pad_pcm_i16,
                                _require_device, align_from_pcm,
                                warn_low_confidence)
    from .media import ffmpeg as ffmpeg_mod
    from .media.decode import parse_audio_int16
    from .media.mux import (encode_fit_as_ffmpeg_expr,
                            write_replaced_media_to_disk)
    from .media.probe import get_closest_key_frame_time
    from .report.plots import plot_alignment
    from .stretch.segments import check_backends, replace_aligned_segments

    device = _require_device(device)
    _feature_path(features, frontend)
    check_backends(stretcher, pv_backend, resample_backend)

    video_files, has_audio_extensions = get_sorted_filenames(
        video, VIDEO_EXTENSIONS, AUDIO_EXTENSIONS)
    if yes is False and sum(has_audio_extensions) > 0:
        print("")
        print("One or more audio files found in video input. Was this intentional?")
        print("If not, press ctrl+c to kill this script.")
        input("If this was intended, press Enter to continue...")
        print("")
    audio_desc_files, _ = get_sorted_filenames(audio, AUDIO_EXTENSIONS)
    if len(video_files) != len(audio_desc_files):
        error_msg = ["Number of valid files in input paths are not the same.",
                     f"The video path has {len(video_files)} files",
                     f"The audio path has {len(audio_desc_files)} files"]
        raise RuntimeError("\n".join(error_msg))

    print("")
    ensure_folders_exist([output_dir])
    if PLOT_ALIGNMENT_TO_FILE:
        ensure_folders_exist([alignment_dir])

    print("")
    for video_file, audio_desc_file in zip(video_files, audio_desc_files):
        print(os.path.split(video_file)[1])
        print(os.path.split(audio_desc_file)[1])
        print("")
    if yes is False:
        print("Are the above input file pairings correct?")
        print("If not, press ctrl+c to kill this script.")
        input("If they are correct, press Enter to continue...")
        print("")

    # all-WAV stretch jobs run entirely on the built-in codec; everything
    # else needs ffmpeg binaries, and their install flow runs when they
    # are missing (describealign.py:1065-1073)
    all_wav = (all(f.lower().endswith('.wav') for f in video_files)
               and all(f.lower().endswith('.wav') for f in audio_desc_files)
               and stretch_audio)
    if not all_wav and not ffmpeg_mod.is_ffmpeg_installed():
        ffmpeg_mod.install_ffmpeg_with_prompts()

    print(f"Processing files with v{__version__}:")

    num_channels = 2 if stretch_audio else 1
    out_names = [os.path.join(output_dir, prepend + os.path.split(vf)[1])
                 for vf in video_files]
    # Per-pair plan: resume skip (reference 1087-1089), cached alignment,
    # and whether the pair raises the stretch-required error. Precomputing
    # lets the batch aligner start on exactly the pairs that need work
    # while the loop below keeps the reference's per-pair prints.
    skip = [os.path.exists(o) and os.path.getsize(o) > 1e5
            for o in out_names]
    cached_outputs = {}
    align_needed = []
    for i, (vf, af, hax) in enumerate(zip(video_files, audio_desc_files,
                                          has_audio_extensions)):
        if skip[i]:
            continue
        if (not stretch_audio) & bool(hax):
            break  # the loop below raises at this pair; align nothing past it
        cached = aligncache.load(alignment_dir, vf, af, num_channels,
                                 frontend)
        if cached is not None:
            cached_outputs[i] = cached
        else:
            align_needed.append((i, vf, af))

    batcher = None
    batch_owned = set()
    if _use_batch(len(align_needed)):
        batcher = _BatchAligner(align_needed, num_channels,
                                keep_pcm=stretch_audio,
                                group=BATCH_GROUP_SIZE, device=device,
                                features=features, frontend=frontend)
        batch_owned = {i for i, _, _ in align_needed}

    # decode-ahead for the sequential path: decode the next pair in a
    # worker thread while the current pair aligns (the reference's
    # directory loop is sequential, describealign.py:1077)
    decode_pool = ThreadPoolExecutor(max_workers=1)

    def decode_pair(vf_af):
        # bucket-pad off the critical path; true lengths ride alongside
        vf, af = vf_af
        v = parse_audio_int16(vf, num_channels)
        a = parse_audio_int16(af, num_channels)
        return (_pad_pcm_i16(v), v.shape[1], _pad_pcm_i16(a), a.shape[1])

    pending = {}

    def prefetch(idx):
        # the batch engine owns decode for the pairs it aligns
        if (0 <= idx < len(video_files) and idx not in pending
                and idx not in batch_owned and not skip[idx]):
            pending[idx] = decode_pool.submit(
                decode_pair, (video_files[idx], audio_desc_files[idx]))

    try:
        for pair_index, (video_file, audio_desc_file, has_audio_extension) \
                in enumerate(zip(video_files, audio_desc_files,
                                 has_audio_extensions)):
            output_filename = out_names[pair_index]
            print(f" {output_filename}")

            if (not stretch_audio) & bool(has_audio_extension):
                raise RuntimeError(
                    "Argument --stretch_audio is required when both inputs "
                    "are audio files.")

            if skip[pair_index]:
                print("   output file already exists, skipping...")
                continue

            full_output_filename = os.path.abspath(output_filename)
            if IS_RUNNING_WINDOWS and len(full_output_filename) >= 260:
                print("  WARNING: very long output path, ffmpeg may fail...")

            cached = cached_outputs.get(pair_index)
            video_arr = audio_desc_arr = None
            if cached is not None and not stretch_audio:
                print("  using cached alignment...\r", end='')
                outputs = cached
            elif pair_index in batch_owned:
                print("  reading video file...\r", end='')
                outputs, payload = batcher.get(pair_index)
                aligncache.save(alignment_dir, video_file, audio_desc_file,
                                outputs, num_channels, frontend)
                if stretch_audio:
                    video_i16, audio_i16, video_samples, audio_samples = \
                        payload
                    video_arr = (video_i16[:, :video_samples]
                                 .astype(np.float16).astype(np.float32))
                    audio_desc_arr = (audio_i16[:, :audio_samples]
                                      .astype(np.float16).astype(np.float32))
                    del video_i16, audio_i16
            else:
                # reference per-stage progress lines (describealign.py:
                # 1097-1113); decode-ahead covers both streams under the
                # "reading video file" line, the feature/matcher lines are
                # printed by align_from_pcm(combine_prints=True)
                print("  reading video file...\r", end='')
                prefetch(pair_index)
                video_i16, video_samples, audio_i16, audio_samples = \
                    pending.pop(pair_index).result()
                prefetch(pair_index + 1)
                if stretch_audio:
                    video_arr = (video_i16[:, :video_samples]
                                 .astype(np.float16).astype(np.float32))
                    audio_desc_arr = (audio_i16[:, :audio_samples]
                                      .astype(np.float16).astype(np.float32))

                if cached is not None:
                    outputs = cached
                else:
                    # channel count follows the mode (1 default / 2
                    # stretch), like the reference's feature extraction
                    # (combine:1096)
                    outputs = align_from_pcm(video_i16, audio_i16,
                                             video_samples=video_samples,
                                             audio_samples=audio_samples,
                                             combine_prints=True,
                                             device=device,
                                             features=features,
                                             frontend=frontend)
                    aligncache.save(alignment_dir, video_file,
                                    audio_desc_file, outputs, num_channels,
                                    frontend)
                del video_i16, audio_i16
            audio_desc_times, video_times, similarity_percent, path, \
                median_slope = outputs[:5]
            coarse_margin = outputs[5] if len(outputs) > 5 else None

            warn_low_confidence(coarse_margin)
            if similarity_percent < 20:
                print(f"  WARNING: similarity {similarity_percent:.1f}%, "
                      f"likely mismatched files")
            if similarity_percent > 90:
                print(f"  WARNING: similarity {similarity_percent:.1f}%, "
                      f"likely undescribed media")
            if (median_slope < .1) or (median_slope > 10):
                print("  WARNING: median slope estimation failed, output "
                      "subtitles may be misaligned")
                median_slope = 1.

            if stretch_audio:
                # rescale RMS intensity of audio to match video; only ever
                # scale the louder one down to avoid overflow (reference
                # 1141-1148)
                scale_factor = (_low_ram_std(video_arr)
                                / _low_ram_std(audio_desc_arr))
                for ch, ch_scale in enumerate(scale_factor):
                    if ch_scale > 1:
                        video_arr[ch] /= ch_scale
                    else:
                        audio_desc_arr[ch] *= ch_scale

                replace_aligned_segments(video_arr, audio_desc_arr,
                                         audio_desc_times, video_times,
                                         no_pitch_correction, stretcher,
                                         pv_backend, resample_backend,
                                         device)
                del audio_desc_arr
                video_arr *= (2 ** 15 - 2.) / np.max(np.abs(video_arr))

                print("  processing output file...                   \r",
                      end='')
                ffmpeg_command = write_replaced_media_to_disk(
                    output_filename, video_arr,
                    None if has_audio_extension else video_file,
                    median_slope=median_slope)
                del video_arr
            else:
                video_offset = video_times[0] - audio_desc_times[0]
                after_start_key_frame = get_closest_key_frame_time(
                    video_file, video_offset)
                print("  processing output file...                   \r",
                      end='')
                setts_cmd = encode_fit_as_ffmpeg_expr(audio_desc_times,
                                                      video_times,
                                                      video_offset)
                ffmpeg_command = write_replaced_media_to_disk(
                    output_filename, None, video_file, audio_desc_file,
                    setts_cmd, video_offset, after_start_key_frame,
                    median_slope=median_slope)

            if PLOT_ALIGNMENT_TO_FILE:
                plot_filename_no_ext = os.path.join(
                    alignment_dir,
                    os.path.splitext(os.path.split(video_file)[1])[0])
                plot_alignment(plot_filename_no_ext, path, audio_desc_times,
                               video_times, similarity_percent, median_slope,
                               stretch_audio, no_pitch_correction,
                               ffmpeg_command)
    finally:
        if batcher is not None:
            batcher.shutdown()
        decode_pool.shutdown(wait=False)
    print("All files processed.       ")
