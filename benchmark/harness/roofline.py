"""Peaks of the card and the least time of a kernel's work, counted from
the algorithm's shapes, never from how a kernel implements it.

The coarse score map: every 21 frames an anchor starts a 41-frame window
of the 3 coarse streams (K = 3 x 41 = 123 values); each of the nb blocks
holds 10 audio anchors, the video side kv anchors in 7 sub-lane phases.
One map is 7 x 10 x K fused multiply-adds per (block, video lane)
element, whichever kernel computes it and however many launches it takes
(the streamed DP scores each tile four times: that is the program's
choice, not work the map needs). Its least bytes read the descriptors once
and write the map once. The padding lanes of the program's descriptors
(K padded to 128) are not counted: they are no work of the map.
"""

# Published dense peaks of the card (NVIDIA's H100 SXM data sheet, 700 W)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tf32_flops": 495e12,
                              "hbm_bytes_per_s": 3.35e12},
}

WINDOW = 41                # frames of a coarse descriptor
STRIDE = 21                # frames between coarse anchors
MAX_SHIFT = 18             # the largest of the 7 sub-lane phase shifts
PHASES = 7
PER_BLOCK = 10             # coarse anchors per 210-frame block
COARSE_STREAMS = 3
BUCKET_FRAMES = 210 * 64   # the shape bucket of the padded features
PAD_MARGIN = 210 + WINDOW


def bucket(n_frames):
    return -(-(n_frames + PAD_MARGIN) // BUCKET_FRAMES) * BUCKET_FRAMES


def coarse_map_shape(nv_frames, na_frames):
    """(nb, kv): blocks and video lanes of one pair's coarse score map;
    both streams pad to their common bucket."""
    npad = max(bucket(nv_frames), bucket(na_frames))
    ka = (npad - WINDOW - MAX_SHIFT) // STRIDE + 1
    return ka // PER_BLOCK, ka


def coarse_map_work(nb, kv, streams=COARSE_STREAMS):
    """(useful FMA, least bytes) of one nb x kv coarse score map."""
    k = streams * WINDOW
    fma = PHASES * PER_BLOCK * nb * kv * k
    nbytes = 4 * (PER_BLOCK * nb * k + PHASES * kv * k + nb * kv)
    return fma, nbytes


def least_time_s(fma, nbytes, device_name):
    """The least time of the work on the named card: the larger of its
    operations at the dense TF32 tensor peak (2 FLOP per FMA) and its
    bytes at the memory peak; None for a card without published peaks."""
    peaks = PEAKS.get(device_name)
    if peaks is None:
        return None
    return max(2 * fma / peaks["tf32_flops"],
               nbytes / peaks["hbm_bytes_per_s"])
