"""Segment replacement: splice (stretched) description audio into the video
(describealign_tpu/stretch/segments.py with its defaults hard-wired).

Segment rules are identical to the reference (describealign.py:389-416):
- skip segments shorter than MIN_DURATION_TO_REPLACE_SECONDS or stretched
  by more than MAX_RATE_RATIO_DIFF_ALIGN
- use the plain (pitch-shifting) resampler when pitch correction is off,
  the ratio is imperceptible (<= JUST_NOTICEABLE_DIFF_IN_FREQ_RATIO), or
  the total offset is under MIN_STRETCH_OFFSET samples
- otherwise use the pitch-preserving stretcher: the reference-parity
  WSOLA DP splicer, the JAX package's default (the phase vocoder it offers
  as an option is not ported)
- same "  stretching audio: NN%" progress-line contract
"""
import numpy as np

from ..constants import (AUDIO_SAMPLE_RATE, JUST_NOTICEABLE_DIFF_IN_FREQ_RATIO,
                         MAX_RATE_RATIO_DIFF_ALIGN,
                         MIN_DURATION_TO_REPLACE_SECONDS, MIN_STRETCH_OFFSET)
from .resample import resample_segment
from .wsola import wsola_stretch


def replace_aligned_segments(video_arr, audio_desc_arr, audio_desc_times,
                             video_times, no_pitch_correction):
    x_samples = (np.asarray(audio_desc_times) * AUDIO_SAMPLE_RATE).astype(int)
    y_samples = (np.asarray(video_times) * AUDIO_SAMPLE_RATE).astype(int)
    diff_x = np.diff(x_samples)
    diff_y = np.diff(y_samples)
    slopes = diff_x / diff_y
    total_offset = diff_y - diff_x
    y_mid = (y_samples[:-1] + y_samples[1:]) // 2
    progress_interval = (video_arr.shape[1] // 100) + 1
    last_progress = -1
    for i in range(len(x_samples) - 1):
        if (diff_y[i] < MIN_DURATION_TO_REPLACE_SECONDS * AUDIO_SAMPLE_RATE
                or np.abs(1 - slopes[i]) > MAX_RATE_RATIO_DIFF_ALIGN):
            continue
        progress = int(y_mid[i] // progress_interval)
        if progress > last_progress:
            last_progress = progress
            print(f"  stretching audio:{progress:3d}%                        \r",
                  end='')
        y0, y1 = y_samples[i], y_samples[i + 1]
        x0, x1 = x_samples[i], x_samples[i + 1]
        if (no_pitch_correction
                or np.abs(1 - slopes[i]) <= JUST_NOTICEABLE_DIFF_IN_FREQ_RATIO
                or abs(total_offset[i]) < MIN_STRETCH_OFFSET):
            video_arr[:, y0:y1] = resample_segment(audio_desc_arr, x0, x1,
                                                   y1 - y0)
        else:
            # reference-parity splicer (describealign.py:296-387)
            wsola_stretch(audio_desc_arr[:, x0:x1], video_arr[:, y0:y1])
