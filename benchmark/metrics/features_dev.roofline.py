"""The device feature kernels' share of their roofline, in %: the least
time of the bytes that K1 (pcm_frontend) and K2 (the polyphase cascade)
must move for the traced alignments' two tracks, at the card's memory
peak (harness/roofline.py), over the summed device time of every
pcm_frontend_kernel and polyphase_group_kernel launch in the traced
window.

The bytes are counted here from the tracks' lengths, each padded to its
own 64-s bucket as the device route pads it, by a copy of the program's
count (ops/features_kernel.py::feature_work, as of its writing), so that
the bound reads the same work whatever implements it: K1 reads the int16
PCM once and writes its four outputs (energy per 105 samples, crossings
per frame, the first cascade stage's bottom and band per 5 samples); K2
reads those once and writes the five streams once. None where no such
launch is in the window (a host-feature route) or the card has no
published peak."""
from harness import roofline

KERNELS = ("pcm_frontend_kernel", "polyphase_group_kernel")
FRAME = 210                      # samples per 210-fps frame
ENERGY_BLOCK = 105               # samples per energy value
DS1 = 5                          # the first cascade stage's decimation
PCM_BUCKET = FRAME * 210 * 64    # samples in the 64-s shape bucket
PAD_MARGIN = 210 + 41            # frames of margin before the bucket


def padded_len(samples):
    return -(-(samples + PAD_MARGIN * FRAME) // PCM_BUCKET) * PCM_BUCKET


def feature_work(c, s, dtype_bytes=2):
    """The least bytes of K1 and K2 for one (C, S) stream."""
    f32 = 4
    n_e, n_f = s // ENERGY_BLOCK, s // FRAME
    n1 = n_f * FRAME // DS1
    k1 = c * s * dtype_bytes + (n_e + n_f + 2 * n1) * f32
    k2 = (n_e + n_f + 2 * n1 + -(-n_e // 2) + 4 * n_f) * f32
    return k1 + k2


def read(run):
    tr = run.trace
    if tr is None or not tr.window or not run.pairs_done:
        return None
    peaks = roofline.PEAKS.get(run.device_name)
    if peaks is None:
        return None
    spent, launches = 0.0, 0
    for name in KERNELS:
        s, n = tr.kernel_s(name)
        spent, launches = spent + s, launches + n
    if not launches or not spent:
        return None
    nbytes = sum(feature_work(pcm.shape[0], padded_len(pcm.shape[1]))
                 for req in run.pairs_done for pair in req
                 for pcm in (pair.video, pair.audio))
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / spent
