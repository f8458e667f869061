"""The plain reference of a layout configuration, and the comparison that
decides `correct`.

The generator records where it put every piece of the video's content in
the description (segments of (audio_start, audio_end, video_start,
video_end) seconds, linear inside each segment, a resampled piece
included). That record is the true map: for a probe instant a of the
description inside a segment, the content there is video time
    v(a) = v0 + (a - a0) * (v1 - v0) / (a1 - a0).
An answer's map is its fit nodes (audio_times, video_times), linear
between nodes, as the program returns them. Its gap at a probe is
|v_answer(a) - v(a)|, at probes every PROBE_STEP_S seconds of every
segment, EDGE_S clear of the segment's ends (a cut itself is a jump that
no node list draws exactly). Instants of narration hold no content of the
video and are not probed. An answer is judged by the share of probes
whose gap exceeds the configuration's tolerance (missed_pct); its widest
gap is reported beside it.

numpy only: nothing of the program and nothing it made is read here but
the answer under judgement.
"""
import numpy as np

PROBE_STEP_S = 0.5
EDGE_S = 1.0


def probes(segments):
    """(audio_times, true video_times) of every probe of the segments."""
    a_all, v_all = [], []
    for a0, a1, v0, v1 in segments:
        a = np.arange(a0 + EDGE_S, a1 - EDGE_S + 1e-9, PROBE_STEP_S)
        a_all.append(a)
        v_all.append(v0 + (a - a0) * (v1 - v0) / (a1 - a0))
    return np.concatenate(a_all), np.concatenate(v_all)


def gaps_ms(audio_times, video_times, segments):
    """The gap, in ms, between the answer's map and the true map at every
    probe; inf throughout for an answer whose nodes are not finite."""
    nx = np.asarray(audio_times, np.float64)
    ny = np.asarray(video_times, np.float64)
    a, v = probes(segments)
    if nx.size < 2 or not (np.all(np.isfinite(nx))
                           and np.all(np.isfinite(ny))):
        return np.full(a.shape, np.inf)
    return np.abs(np.interp(a, nx, ny) - v) * 1e3


def judge(audio_times, video_times, segments, tolerance_ms):
    """(missed_pct, widest gap in ms): the share of probes, in %, that
    the answer maps more than tolerance_ms away from the true map."""
    g = gaps_ms(audio_times, video_times, segments)
    return 100.0 * float(np.mean(g > tolerance_ms)), float(np.max(g))


def control_nodes(segments, late_s):
    """The control: the true map with the description placed late_s late
    against the picture, every node moved by the same amount."""
    nx, ny = [], []
    for a0, a1, v0, v1 in segments:
        nx += [a0, a1]
        ny += [v0 - late_s, v1 - late_s]
    return np.array(nx), np.array(ny)
