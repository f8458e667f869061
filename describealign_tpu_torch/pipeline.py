"""combine(): the main user-facing pipeline, the port of
describealign_tpu/pipeline.py.

Orchestration contract follows the reference combine()
(describealign.py:1031-1175): file discovery/pairing confirmation, ffmpeg
install flow, per-pair decode -> features -> align -> (video retime | audio
stretch) -> mux -> plot/report, with the same prints, warnings, skip/resume
rule, and defaults.

Every pair runs through the sequential loop with a one-pair decode-ahead
thread, the loop the JAX package keeps for single pairs and under
DESCRIBEALIGN_BATCH=0; its pipelined batch aligner for directories is not
ported yet. The matcher runs on `device` (default 'cuda'); there is no
fallback to the CPU.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .constants import (AUDIO_EXTENSIONS, DEFAULT_ALIGNMENT_DIR,
                        DEFAULT_OUTPUT_DIR, IS_RUNNING_WINDOWS,
                        PLOT_ALIGNMENT_TO_FILE, VIDEO_EXTENSIONS)
from .utils import aligncache
from .utils.files import ensure_folders_exist, get_sorted_filenames


def _low_ram_std(arr):
    avg = np.mean(arr, dtype=np.float64)
    return np.sqrt(np.einsum('ij,ij->i', arr, arr, dtype=np.float64)
                   / arr.size - avg ** 2)


def combine(video, audio, stretch_audio=False, yes=False, prepend="ad_",
            no_pitch_correction=False, output_dir=DEFAULT_OUTPUT_DIR,
            alignment_dir=DEFAULT_ALIGNMENT_DIR, device='cuda'):
    """Combine videos with matching audio description files.

    Same public behavior as the JAX package's combine() and the reference's
    documented module API (reference README.md:136-140); device is where
    the matcher runs.
    """
    from . import __version__
    from .alignment.api import align_from_pcm, warn_low_confidence
    from .alignment.api import _pad_pcm_i16
    from .media import ffmpeg as ffmpeg_mod
    from .media.decode import parse_audio_int16
    from .media.mux import (encode_fit_as_ffmpeg_expr,
                            write_replaced_media_to_disk)
    from .media.probe import get_closest_key_frame_time
    from .report.plots import plot_alignment
    from .stretch.segments import replace_aligned_segments

    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is unavailable: describealign_tpu_torch "
                           "runs its matcher on an NVIDIA GPU (pass "
                           "device='cpu' to run it on the CPU)")

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
    # resume rule (reference 1087-1089)
    skip = [os.path.exists(o) and os.path.getsize(o) > 1e5
            for o in out_names]

    # decode-ahead: decode the next pair in a worker thread while the
    # current pair aligns (the reference's directory loop is sequential,
    # describealign.py:1077)
    decode_pool = ThreadPoolExecutor(max_workers=1)

    def decode_pair(vf_af):
        # bucket-pad off the critical path; true lengths ride alongside
        vf, af = vf_af
        v = parse_audio_int16(vf, num_channels)
        a = parse_audio_int16(af, num_channels)
        return (_pad_pcm_i16(v), v.shape[1], _pad_pcm_i16(a), a.shape[1])

    pending = {}

    def prefetch(idx):
        if (0 <= idx < len(video_files) and idx not in pending
                and not skip[idx]):
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

            cached = aligncache.load(alignment_dir, video_file,
                                     audio_desc_file, num_channels)
            video_arr = audio_desc_arr = None
            if cached is not None and not stretch_audio:
                print("  using cached alignment...\r", end='')
                outputs = cached
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
                                             device=device)
                    aligncache.save(alignment_dir, video_file,
                                    audio_desc_file, outputs, num_channels)
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
                                         no_pitch_correction)
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
        decode_pool.shutdown(wait=False)
    print("All files processed.       ")
