"""ffprobe helpers: keyframe times and stream dispositions (a copy of
describealign_tpu/media/probe.py).

Contract follows reference describealign.py:443-462.
"""
import numpy as np

from .ffmpeg import run_ffprobe_json


def get_key_frame_data(video_file, time=None, entry='pts_time'):
    """Keyframe PTS list for the first video stream (reference: 443-448)."""
    interval = f'%+{max(60, time + 40)}' if time is not None else '%'
    data = run_ffprobe_json(
        ['-select_streams', 'V', '-show_frames', '-skip_frame', 'nokey',
         '-read_intervals', interval, '-show_entries', 'frame=' + entry,
         str(video_file)],
        f"probe key frames of: {video_file}")
    frames = data.get('frames', [])
    return np.array([float(f[entry]) for f in frames if entry in f])


def get_closest_key_frame_time(video_file, time):
    """Midpoint between the keyframes bracketing `time` (reference: 450-458),
    so a stream-copy cut at this timestamp lands cleanly on a keyframe."""
    key_frame_times = get_key_frame_data(video_file, time)
    if len(key_frame_times) == 0:
        key_frame_times = np.array([0])
    next_times = key_frame_times[key_frame_times > time]
    prev_times = key_frame_times[key_frame_times <= time]
    next_key = np.min(next_times) if len(next_times) > 0 else time
    prev_key = np.max(prev_times) if len(prev_times) > 0 else next_key
    return (prev_key + next_key) / 2.0


def is_first_video_track_ad(video_file):
    """True when the first audio stream is already flagged as a description
    track (reference: 460-462) - used to decide track renaming on re-runs."""
    data = run_ffprobe_json(['-select_streams', 'a', '-show_streams',
                             str(video_file)],
                            f"probe audio streams of: {video_file}")
    streams = data.get('streams', [])
    if not streams:
        return False
    disp = streams[0].get('disposition', {})
    return bool(disp.get('descriptions') or disp.get('visual_impaired'))
