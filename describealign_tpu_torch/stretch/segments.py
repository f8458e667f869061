"""Segment replacement: splice (stretched) description audio into the video
(describealign_tpu/stretch/segments.py; its three environment settings are
arguments here, with its defaults).

Segment rules are identical to the reference (describealign.py:389-416):
- skip segments shorter than MIN_DURATION_TO_REPLACE_SECONDS or stretched
  by more than MAX_RATE_RATIO_DIFF_ALIGN
- use the plain (pitch-shifting) resampler when pitch correction is off,
  the ratio is imperceptible (<= JUST_NOTICEABLE_DIFF_IN_FREQ_RATIO), or
  the total offset is under MIN_STRETCH_OFFSET samples (resample_backend
  'host' or 'device', the JAX package's DESCRIBEALIGN_RESAMPLE)
- otherwise use the pitch-preserving stretcher (the JAX package's
  DESCRIBEALIGN_STRETCH): the reference-parity WSOLA DP splicer by default
  (the reference's own algorithm for speech), or stretcher='pv', the phase
  vocoder on the host or, with pv_backend='device', on `device` (the JAX
  package's DESCRIBEALIGN_PV)
- same "  stretching audio: NN%" progress-line contract
"""
import numpy as np

from ..constants import (AUDIO_SAMPLE_RATE, JUST_NOTICEABLE_DIFF_IN_FREQ_RATIO,
                         MAX_RATE_RATIO_DIFF_ALIGN,
                         MIN_DURATION_TO_REPLACE_SECONDS, MIN_STRETCH_OFFSET)
from .phase_vocoder import PV_BACKENDS, pv_stretch
from .resample import RESAMPLE_BACKENDS, resample_segment
from .wsola import wsola_stretch

STRETCHERS = ('wsola', 'pv')


def check_backends(stretcher, pv_backend, resample_backend):
    """Raise ValueError naming an unknown stretcher or backend."""
    for name, value, allowed in (('stretcher', stretcher, STRETCHERS),
                                 ('pv_backend', pv_backend, PV_BACKENDS),
                                 ('resample_backend', resample_backend,
                                  RESAMPLE_BACKENDS)):
        if value not in allowed:
            raise ValueError(f"unknown {name}: {value!r} (expected one of "
                             f"{allowed})")


def replace_aligned_segments(video_arr, audio_desc_arr, audio_desc_times,
                             video_times, no_pitch_correction,
                             stretcher='wsola', pv_backend='host',
                             resample_backend='host', device='cuda'):
    check_backends(stretcher, pv_backend, resample_backend)
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
            video_arr[:, y0:y1] = resample_segment(
                audio_desc_arr, x0, x1, y1 - y0, backend=resample_backend,
                device=device)
        elif stretcher == 'pv':
            video_arr[:, y0:y1] = pv_stretch(audio_desc_arr[:, x0:x1],
                                             y1 - y0, backend=pv_backend,
                                             device=device)
        else:
            # reference-parity splicer (describealign.py:296-387)
            wsola_stretch(audio_desc_arr[:, x0:x1], video_arr[:, y0:y1])
