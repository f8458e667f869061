"""The coarse score map kernel's share of its roofline, in %: the least
time of the maps the traced alignments need (harness/roofline.py: one
nb x kv map per alignment, counted from its shapes) over the summed
device time of every coarse_score_map launch in them."""
from harness import roofline

KERNEL = "coarse_map_kernel"


def _frames(pair):
    if isinstance(pair.video, list):
        return min(len(f) for f in pair.video), min(len(f) for f in pair.audio)
    return pair.video.shape[1] // 210, pair.audio.shape[1] // 210


def read(run):
    tr = run.trace
    if tr is None or not tr.window:
        return None
    spent, launches = tr.kernel_s(KERNEL)
    if not launches or not spent or not run.pairs_done:
        return None
    least = 0.0
    for req in run.pairs_done:
        for pair in req:
            nb, kv = roofline.coarse_map_shape(*_frames(pair))
            t = roofline.least_time_s(*roofline.coarse_map_work(nb, kv),
                                      run.device_name)
            if t is None:
                return None
            least += t
    return 100.0 * least / spent
