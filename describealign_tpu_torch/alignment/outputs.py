"""Final alignment outputs: similarity score and fit node list (a copy of
describealign_tpu/alignment/outputs.py).

Reference semantics (describealign.py:995-1027):
- similarity % = max coverage fraction of audio/video frames on the path
  whose qual is 0 or > .3 ("nondescription" frames)
- fit nodes are placed at cluster boundaries (+/- .1 frame) and at the path
  endpoints when they belong to their neighbor's cluster
- end segments longer than 2 frames are extrapolated to the media bounds
- all times convert to seconds at 210 fps
"""
import numpy as np


def similarity_and_nodes(path, num_audio, num_video,
                         audio_len_frames, video_len_frames):
    """path: (M, 5) rows (video, audio, cluster, qual, cum_qual).

    Returns (audio_times_s, video_times_s, similarity_percent,
    path_seconds (M,5)).
    """
    y, x, cluster_indices, quals, _ = path.T

    def _n_unique(v):
        # path coordinates are (near-)monotone: count group boundaries
        # instead of paying np.unique's sort; fall back for the rare
        # non-monotone video sequence (within-cluster backward jumps)
        if len(v) < 2:
            return len(v)
        d = np.diff(v)
        if np.all(d >= 0):
            return 1 + int(np.count_nonzero(d))
        return len(np.unique(v))

    nondesc = (quals == 0) | (quals > .3)
    sim_x = _n_unique(x[nondesc]) / num_audio
    sim_y = _n_unique(y[nondesc]) / num_video
    similarity_percent = 100 * max(sim_x, sim_y)

    parts = []
    if cluster_indices[0] == cluster_indices[1]:
        parts.append(np.array([[x[0], y[0]]]))
    breaks = np.flatnonzero(cluster_indices[:-1] != cluster_indices[1:])
    if len(breaks):
        inter = np.empty((2 * len(breaks), 2))
        inter[0::2, 0] = x[breaks] - .1
        inter[0::2, 1] = y[breaks] - .1
        inter[1::2, 0] = x[breaks + 1] + .1
        inter[1::2, 1] = y[breaks + 1] + .1
        parts.append(inter)
    if cluster_indices[-2] == cluster_indices[-1]:
        parts.append(np.array([[x[-1], y[-1]]]))
    nx, ny = np.concatenate(parts).T / 210.

    # extrapolate the first/last linear segments to the media bounds
    if (nx[1] - nx[0]) > 2:
        slope_start = (ny[1] - ny[0]) / (nx[1] - nx[0])
        nx[0] = 0
        ny[0] = ny[1] - (nx[1] * slope_start)
        if ny[0] < 0:
            nx[0] = nx[1] - (ny[1] / slope_start)
            ny[0] = 0
    if (nx[-1] - nx[-2]) > 2:
        slope_end = (ny[-1] - ny[-2]) / (nx[-1] - nx[-2])
        nx[-1] = (audio_len_frames - 1) / 210.
        ny[-1] = ny[-2] + ((nx[-1] - nx[-2]) * slope_end)
        if ny[-1] > ((video_len_frames - 1) / 210.):
            ny[-1] = (video_len_frames - 1) / 210.
            nx[-1] = nx[-2] + ((ny[-1] - ny[-2]) / slope_end)

    path_seconds = path.copy()
    path_seconds[:, :2] /= 210.
    return nx, ny, similarity_percent, path_seconds
