"""Output muxing: write combined media to disk (a copy of
describealign_tpu/media/mux.py).

Two modes, matching the reference contract (describealign.py:419-435,
465-517):

(a) stretch_audio: the stretched PCM is piped over stdin as the new default
    AAC track; the original video/audio/subtitle streams are stream-copied.
    AD dispositions and titles are set; the original first audio track is
    renamed "original" unless it is itself an AD track; the mkv
    max_interleave_delta=0 workaround is applied.

(b) default (video retime): the piecewise-linear fit is encoded as an ffmpeg
    `setts` bitstream-filter expression rewriting video (and subtitle) frame
    timestamps losslessly; the video is cut at a keyframe and both inputs get
    itsoffset shifts; no re-encode.
"""
import os

import numpy as np

from ..constants import AUDIO_SAMPLE_RATE
from .ffmpeg import compile_command_line, run_ffmpeg_command
from .probe import is_first_video_track_ad


def encode_fit_as_ffmpeg_expr(audio_desc_times, video_times, video_offset):
    """Encode the piecewise-linear fit as a setts PTS-rewrite expression.

    Each linear segment becomes one clip() term:
      TS + sum_i clip(TS - y_i/TB, 0, dy_i/TB) * (slope_i - 1)
    (reference: describealign.py:419-435; 4/9 decimal formatting preserved)
    """
    setts_cmd = ['TS', '+(0']
    x = np.asarray(audio_desc_times, dtype=float)
    y = np.asarray(video_times, dtype=float)
    diff_x = np.diff(x)
    diff_y = np.diff(y)
    slopes = diff_x / diff_y
    for i in range(len(x) - 1):
        setts_cmd.append(
            f'+clip(TS-{y[i] - video_offset:.4f}/TB,0,{max(0, diff_y[i]):.4f}/TB)'
            f'*{slopes[i] - 1:.9f}')
    setts_cmd.append(')')
    return ''.join(setts_cmd)


def write_replaced_media_to_disk(output_filename, media_arr, video_file=None,
                                 audio_desc_file=None, setts_cmd=None,
                                 video_offset=None, after_start_key_frame=None,
                                 median_slope=1.0):
    """Write the combined output; returns the loggable ffmpeg command line."""
    if media_arr is not None:
        # --- stretch_audio mode: pipe the replaced PCM in as the new track ---
        pipe_in = ['-f', 's16le', '-acodec', 'pcm_s16le', '-ac', '2',
                   '-ar', str(AUDIO_SAMPLE_RATE), '-i', 'pipe:']
        if video_file is None and str(output_filename).lower().endswith('.wav'):
            # audio-in/audio-out: the built-in WAV codec needs no ffmpeg
            from .ffmpeg import is_ffmpeg_installed
            if not is_ffmpeg_installed():
                from .decode import write_wav
                write_wav(output_filename, media_arr)
                return f"<built-in wav writer> {output_filename}"
        if video_file is None:
            # input "video" was itself an audio file; output plain audio
            args = pipe_in + ['-loglevel', 'error', '-y', str(output_filename)]
        else:
            kwargs = ['-c:a:0', 'aac',
                      '-disposition:a:0', 'default+visual_impaired+descriptions',
                      '-metadata:s:a:0', 'title=AD']
            # rename the original first audio track unless it is already AD
            # (e.g. the output of a previous run) - reference: 476-480
            if not is_first_video_track_ad(video_file):
                kwargs += ['-disposition:a:1', 'original',
                           '-metadata:s:a:1', 'title=original']
            else:
                kwargs += ['-disposition:a:1', 'visual_impaired+descriptions']
            args = (pipe_in
                    + ['-dn', '-i', str(video_file)]
                    + ['-map', '0', '-map', '1']
                    + ['-acodec', 'copy', '-vcodec', 'copy', '-scodec', 'copy']
                    + kwargs
                    # mkv "Starting new cluster" freeze workaround - ref: 481-487
                    + ['-max_interleave_delta', '0', '-loglevel', 'error',
                       '-y', str(output_filename)])
        pcm = np.asarray(media_arr).astype(np.int16).T.tobytes()
        run_ffmpeg_command(args, f"write output file: {output_filename}",
                           stdin_bytes=pcm)
    else:
        # --- default mode: retime video via setts bitstream filter ---
        start_offset = video_offset - after_start_key_frame
        # wav audio has no codec compatible with most video containers
        audio_codec = ('copy' if os.path.splitext(str(audio_desc_file))[1] != '.wav'
                       else 'aac')
        # flac may only have experimental support in some containers (e.g. mp4)
        standards = ('normal' if os.path.splitext(str(audio_desc_file))[1] != '.flac'
                     else 'experimental')
        # stretch subtitle durations with the video so they don't overlap/gap
        sub_stretch = f":duration='DURATION*{1. / median_slope:.6f}'"
        args = (['-itsoffset', f'{max(0, start_offset):.6f}',
                 '-i', str(audio_desc_file),
                 '-an', '-ss', f'{after_start_key_frame:.6f}',
                 '-itsoffset', f'{max(0, -start_offset):.6f}',
                 '-dn', '-i', str(video_file)]
                + ['-map', '0', '-map', '1']
                + ['-acodec', audio_codec, '-vcodec', 'copy', '-scodec', 'copy']
                # set pts and dts manually; ts= is not equivalent - ref: 501
                + ['-bsf:v', f"setts=pts='{setts_cmd}':dts='{setts_cmd}'",
                   '-bsf:s', f"setts=ts='{setts_cmd}'" + sub_stretch,
                   '-disposition:a:0', 'default+visual_impaired+descriptions',
                   '-metadata:s:a:0', 'title=AD',
                   '-strict', standards,
                   # frag_keyframe keeps players honoring start offsets - ref: 500
                   '-movflags', 'frag_keyframe',
                   '-max_interleave_delta', '0', '-loglevel', 'error',
                   '-y', str(output_filename)])
        run_ffmpeg_command(args, f"write output file: {output_filename}")
    try:
        return compile_command_line(args)
    except Exception:
        return ""
