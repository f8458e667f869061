"""Global constants and tunables, a copy of describealign_tpu/constants.py.

Mirrors the reference's module-level tunables (describealign.py:25-36) so
the public behavior contract (extensions, thresholds, frame rates) is
identical.
"""
import os
import platform

VIDEO_EXTENSIONS = {'mp4', 'mkv', 'avi', 'mov', 'webm', 'm4v', 'flv', 'vob'}
AUDIO_EXTENSIONS = {'mp3', 'm4a', 'opus', 'wav', 'aac', 'flac', 'ac3', 'mka'}

PLOT_ALIGNMENT_TO_FILE = True

# Alignment timing (reference: describealign.py:29-31)
TIMESTEPS_PER_SECOND = 10          # factors must be subset of (2, 3, 5, 7)
TIMESTEP_SIZE_SECONDS = 1.0 / TIMESTEPS_PER_SECOND
AUDIO_SAMPLE_RATE = 44100
FEATURE_FPS = 210                  # feature streams run at 210 frames/sec

# Segment replacement thresholds (reference: describealign.py:32-36)
MAX_RATE_RATIO_DIFF_ALIGN = 0.1
MIN_DURATION_TO_REPLACE_SECONDS = 2
JUST_NOTICEABLE_DIFF_IN_FREQ_RATIO = 0.005
MIN_STRETCH_OFFSET = 30

IS_RUNNING_WINDOWS = platform.system() == 'Windows'
if IS_RUNNING_WINDOWS:
    DEFAULT_OUTPUT_DIR = 'videos_with_ad'
    DEFAULT_ALIGNMENT_DIR = 'alignment_plots'
else:
    DEFAULT_OUTPUT_DIR = os.path.expanduser('~') + '/videos_with_ad'
    DEFAULT_ALIGNMENT_DIR = os.path.expanduser('~') + '/alignment_plots'
