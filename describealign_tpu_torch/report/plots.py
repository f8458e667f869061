"""Alignment plot (.png) and text report (.txt), a copy of
describealign_tpu/report/plots.py.

Format contract matches the reference (describealign.py:159-227): same axes,
labels, legend, downsampling, alpha rule, dpi, and the same .txt layout
(parameters, version + content hash, similarity, start offset, median rate
change, per-segment rate-change rows in h:mm:ss.mmm, ffmpeg command).

The .txt report is written in every case. The .png needs matplotlib; where
it does not import, one WARNING line says so and only the .txt is written
(the JAX package requires matplotlib).
"""
import os

import numpy as np

from ..constants import MAX_RATE_RATIO_DIFF_ALIGN, TIMESTEP_SIZE_SECONDS
from ..utils.hashing import get_version_hash


def _str_from_time(seconds):
    minutes, seconds = divmod(seconds, 60)
    hours, minutes = divmod(minutes, 60)
    return f"{hours:2.0f}:{minutes:02.0f}:{seconds:06.3f}"


def plot_alignment(plot_filename_no_ext, path, audio_times, video_times,
                   similarity_percent, median_slope, stretch_audio,
                   no_pitch_correction, ffmpeg_command):
    """Write <plot_filename_no_ext>.png when matplotlib imports, then
    <plot_filename_no_ext>.txt."""
    try:
        import matplotlib
    except ImportError:
        print("  WARNING: matplotlib is not installed, skipping the "
              "alignment plot (.png); writing the text report only")
    else:
        matplotlib.use('Agg', force=False)
        _plot_png(plot_filename_no_ext, path, audio_times, video_times,
                  similarity_percent, stretch_audio)
    write_text_report(plot_filename_no_ext + '.txt', audio_times, video_times,
                      similarity_percent, median_slope, stretch_audio,
                      no_pitch_correction, ffmpeg_command)


def _plot_png(plot_filename_no_ext, path, audio_times, video_times,
              similarity_percent, stretch_audio):
    import matplotlib.pyplot as plt

    downsample = 20
    path = path[::downsample]
    video_times_full, audio_times_full, _, quals, _ = path.T
    scatter_color = [.2, .4, .8]
    lcs_rgba = np.zeros((len(quals), 4))
    lcs_rgba[:, :3] = np.array(scatter_color)[None, :]
    lcs_rgba[:, 3] = np.clip(quals * 400. / len(quals), 0, 1)
    audio_offsets = audio_times_full - video_times_full
    plt.switch_backend('Agg')
    plt.scatter(video_times_full / 60., audio_offsets, s=3, c=lcs_rgba,
                label='Matches')
    audio_offsets = audio_times - video_times

    def expand_limits(start, end, ratio=.01):
        average = (end + start) / 2.
        half_diff = (end - start) / 2. * (1 + ratio)
        return (average - half_diff, average + half_diff)

    plt.xlim(expand_limits(*(0, np.max(video_times) / 60.)))
    plt.ylim(expand_limits(*(np.min(audio_offsets) - 10 * TIMESTEP_SIZE_SECONDS,
                             np.max(audio_offsets) + 10 * TIMESTEP_SIZE_SECONDS),
                           .05))
    if stretch_audio:
        plt.plot(video_times / 60., audio_offsets, 'r-', lw=.5,
                 label='Replaced Audio')
        audio_unreplaced, video_unreplaced = [], []
        for i in range(len(video_times) - 1):
            slope = ((audio_times[i + 1] - audio_times[i])
                     / (video_times[i + 1] - video_times[i]))
            if abs(1 - slope) > MAX_RATE_RATIO_DIFF_ALIGN:
                video_unreplaced.extend(video_times[i:i + 2])
                audio_unreplaced.extend(audio_times[i:i + 2])
                video_unreplaced.append(video_times[i + 1])
                audio_unreplaced.append(np.nan)
        if video_unreplaced:
            video_unreplaced = np.array(video_unreplaced)
            audio_unreplaced = np.array(audio_unreplaced)
            plt.plot(video_unreplaced / 60.,
                     audio_unreplaced - video_unreplaced, 'c-', lw=1,
                     label='Original Audio')
    else:
        plt.plot(video_times / 60., audio_offsets, 'r-', lw=1,
                 label='Combined Media')
    plt.xlabel('Original Video Time (minutes)')
    plt.ylabel('Original Audio Description Offset (seconds behind video)')
    plt.title(f"Alignment - Media Similarity {similarity_percent:.2f}%")
    plt.legend().legend_handles[0].set_color(scatter_color)
    plt.tight_layout()
    plt.savefig(plot_filename_no_ext + '.png', dpi=400)
    plt.clf()


def write_text_report(txt_path, audio_times, video_times, similarity_percent,
                      median_slope, stretch_audio, no_pitch_correction,
                      ffmpeg_command):
    from .. import __version__
    with open(txt_path, 'w') as file:
        parameters = {'stretch_audio': stretch_audio,
                      'no_pitch_correction': no_pitch_correction}
        print(f"Parameters: {parameters}", file=file)
        print(f"Version: {__version__}", file=file)
        print(f"Script Hash: {get_version_hash()}", file=file)
        video_offset = video_times[0] - audio_times[0]
        print(f"Input file similarity: {similarity_percent:.2f}%", file=file)
        print("Main changes needed to video to align it to audio input:",
              file=file)
        print(f"Start Offset: {-video_offset:.2f} seconds", file=file)
        print(f"Median Rate Change: {(median_slope - 1.) * 100:.2f}%",
              file=file)
        for i in range(len(video_times) - 1):
            slope = ((video_times[i + 1] - video_times[i])
                     / (audio_times[i + 1] - audio_times[i]))
            print(f"Rate change of {(slope - 1.) * 100:8.1f}% from "
                  f"{_str_from_time(video_times[i])} to "
                  f"{_str_from_time(video_times[i + 1])} aligning with audio "
                  f"from {_str_from_time(audio_times[i])} to "
                  f"{_str_from_time(audio_times[i + 1])}", file=file)
        print("", file=file)
        print("FFmpeg command:", file=file)
        print(ffmpeg_command, file=file)
