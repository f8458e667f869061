"""The fine matching pass: hand-written CUDA kernel + its plain version.

Replaces the Pallas TPU kernel describealign_tpu/ops/fine_kernel.py
(`_kernel`, launched by `fine_match_fused`). For each 210-frame audio block
it correlates the 5 mean-subtracted features over 41 taps against a
768-frame video band, gates the Naive-Bayes quality, and keeps a top-8 per
audio frame (see csrc/fine_match.cu for the design - 3xTF32 on the tensor
cores, one CTA per block - and what bounds it on the H100).

- `fine_match` dispatches on the tensors' device: CPU tensors go to
  `fine_match_plain`; CUDA tensors launch the kernel (built with nvcc at
  first use) or raise. There is no fallback from CUDA to the plain version.
- `fine_match_plain` mirrors the JAX package's CPU path,
  `matching._fine_block` (the XLA twin of the Pallas kernel), op for op,
  and returns the kernel's layout.
- `fine_match.launches` counts kernel launches (under a lock: the batch
  path's retry launches from pool threads).
"""
import ctypes
import math
import threading

import numpy as np
import torch

from ..alignment.matching import (BAND_GATE, BLOCK, FINE_HALF_BAND, FINE_W,
                                  NB_EXPONENT, QUAL_MAX, QUAL_PROB_CUTOFF,
                                  QUAL_SCALE, TOP_K)
from ..alignment.preprocess import WINDOW

SEG_A = 256 + WINDOW - 1        # audio start clamp span (fine_kernel.py:52)
SEG_V = FINE_W + WINDOW - 1     # video frames a band reads (808)
# the kernel's log-space gate and quality exponent, rounded to f32 as the
# Pallas kernel's weakly typed constants are
LOG_CUT = float(np.float32(math.log(QUAL_PROB_CUTOFF) / NB_EXPONENT))
EXP_COEF = float(np.float32(-NB_EXPONENT / 3.0))
PLAIN_GROUP = 32                # blocks per plain-version step (lax.map's)

_lib = None
_count_lock = threading.Lock()  # the batch path launches from pool threads too


def load_library():
    """The kernel's ctypes library, built from csrc/fine_match.cu."""
    global _lib
    if _lib is None:
        from ._build import load_library as _load
        lib = _load('fine_match', ['fine_match.cu'])
        lib.fine_match_launch.restype = ctypes.c_int
        lib.fine_match_launch.argtypes = (
            [ctypes.c_void_p] * 8
            + [ctypes.c_longlong] * 3 + [ctypes.c_float,
               ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p])
        _lib = lib
    return _lib


def _check(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, v_starts,
           a_starts):
    npad_a, npad_v = ms_a.shape[1], ms_v.shape[1]
    c = v_starts.shape[0]
    for name, t, shape, dtype in (
            ('ms_a', ms_a, (5, npad_a), torch.float32),
            ('norms_a', norms_a, (5, npad_a), torch.float32),
            ('a_mask', a_mask, (npad_a,), torch.float32),
            ('ms_v', ms_v, (5, npad_v), torch.float32),
            ('norms_v', norms_v, (5, npad_v), torch.float32),
            ('v_mask', v_mask, (npad_v,), torch.float32),
            ('v_starts', v_starts, (c,), torch.int32),
            ('a_starts', a_starts, (c,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fine_match: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if t.device != ms_a.device:
            raise ValueError(f"fine_match: {name} is on {t.device}, "
                             f"ms_a on {ms_a.device}")
        if not t.is_contiguous():
            raise ValueError(f"fine_match: {name} is not contiguous")
    if npad_a < SEG_A or npad_v < SEG_V:
        raise ValueError(f"fine_match: Npad {npad_a} (audio), {npad_v} "
                         f"(video) below {SEG_A}, {SEG_V}")


def fine_match(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, v_starts,
               a_starts):
    """Fused fine pass over one track's blocks.

    ms_a, norms_a: (5, Npad_a) f32, a_mask (Npad_a,) f32 0/1, and likewise
    the video's at its own width Npad_v; v_starts: (C,) i32 clipped band
    starts; a_starts: (C,) i32 first audio frame per block (clamped to
    [0, Npad_a - 296]; padded blocks are zeroed by the caller).
    Returns (quals (C, 210, 8) f32, offs (C, 210, 8) i32 in-band offsets;
    video frame = v_starts[c] + off); quality 0 marks an empty slot.
    """
    _check(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, v_starts, a_starts)
    dev = ms_a.device
    if dev.type == 'cpu':
        return fine_match_plain(ms_a, norms_a, a_mask, ms_v, norms_v,
                                v_mask, v_starts, a_starts)
    if dev.type != 'cuda':
        raise ValueError(f"fine_match: unsupported device {dev}")
    # the kernel stages windows with 16-byte copies from 16-byte aligned rows
    if ms_a.shape[1] % 4 or ms_v.shape[1] % 4:
        raise ValueError(f"fine_match: Npad {ms_a.shape[1]}, {ms_v.shape[1]}"
                         f" is not a multiple of 4")
    for name, t in (('ms_a', ms_a), ('ms_v', ms_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"fine_match: {name} is not 16-byte aligned")
    lib = load_library()
    c = v_starts.shape[0]
    quals = torch.empty((c, BLOCK, TOP_K), dtype=torch.float32, device=dev)
    offs = torch.empty((c, BLOCK, TOP_K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fine_match_launch(
            ms_a.data_ptr(), norms_a.data_ptr(), a_mask.data_ptr(),
            ms_v.data_ptr(), norms_v.data_ptr(), v_mask.data_ptr(),
            v_starts.data_ptr(), a_starts.data_ptr(), ms_a.shape[1],
            ms_v.shape[1], c,
            LOG_CUT, EXP_COEF, quals.data_ptr(), offs.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fine_match kernel launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        fine_match.launches += 1
    return quals, offs


fine_match.launches = 0


def fine_match_work(a_mask, v_mask, v_starts, a_starts):
    """What one fine_match call on these inputs must do, as (useful FMA,
    bytes). Useful FMA: per block, every audio row with a_mask > 0 times
    the video-mask columns of its band [l, l + 558], at 5 features x 41
    taps each. Bytes: each input frame a block reads, counted once over
    the call (the feature windows, norms and masks), and the outputs."""
    npad_a, npad_v = a_mask.shape[0], v_mask.shape[0]
    dev = a_mask.device
    a0 = torch.clamp(a_starts.long(), 0, npad_a - SEG_A)[:, None]
    v0 = torch.clamp(v_starts.long(), 0, npad_v - SEG_V)[:, None]
    rows = torch.arange(BLOCK, device=dev)
    vm = (v_mask[v0 + torch.arange(FINE_W, device=dev)] > 0).long()
    csum = torch.nn.functional.pad(torch.cumsum(vm, 1), (1, 0))
    in_band = csum[:, rows + 2 * FINE_HALF_BAND + 1] - csum[:, rows]
    fma = int(torch.sum(in_band * (a_mask[a0 + rows] > 0))) * 5 * WINDOW

    def frames(starts, count, npad, keep=None):
        used = torch.zeros(npad, dtype=torch.bool, device=dev)
        used[(starts + torch.arange(count, device=dev)).reshape(-1)] = True
        return int(torch.sum(used if keep is None else used & keep))

    f32 = 4
    nbytes = (frames(a0, BLOCK + WINDOW - 1, npad_a) * 5 * f32  # ms_a
              + frames(a0, BLOCK, npad_a) * 6 * f32             # norms_a, mask
              + frames(v0, SEG_V, npad_v) * 5 * f32             # ms_v
              + frames(v0, FINE_W, npad_v) * f32                # v_mask
              + frames(v0, FINE_W, npad_v, v_mask > 0) * 5 * f32  # norms_v
              + 2 * a_starts.numel() * 4                        # starts
              + a_starts.numel() * BLOCK * TOP_K * 8)           # outputs
    return fma, nbytes


def _windows(x, starts, count):
    """(G, F, count, 41) sliding windows x[:, s + i + t] for each start s."""
    idx = (starts[:, None, None]
           + torch.arange(count, device=x.device)[None, :, None]
           + torch.arange(WINDOW, device=x.device)[None, None, :])
    return x[:, idx].permute(1, 0, 2, 3)


def fine_match_plain(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, v_starts,
                     a_starts):
    """Plain torch version of the kernel with the same inputs and outputs,
    mirroring matching._fine_block (matching.py:382-416) op for op in
    PLAIN_GROUP-block steps; the top-8 is a stable descending sort, so ties
    keep the lower column first."""
    npad = ms_a.shape[1]
    dev = ms_a.device
    a_starts = torch.clamp(a_starts.long(), 0, npad - SEG_A)
    v_starts = v_starts.long()
    l_idx = torch.arange(BLOCK, device=dev)[:, None]
    e_idx = torch.arange(FINE_W, device=dev)[None, :]
    in_band = (e_idx >= l_idx) & (e_idx <= l_idx + 2 * FINE_HALF_BAND)
    scale = torch.full((), QUAL_SCALE, dtype=torch.float32, device=dev)
    quals, offs = [], []
    for g in range(0, v_starts.shape[0], PLAIN_GROUP):
        a0 = a_starts[g:g + PLAIN_GROUP]
        v0 = v_starts[g:g + PLAIN_GROUP]
        a_win = _windows(ms_a, a0, BLOCK)                 # (G, 5, 210, 41)
        v_win = _windows(ms_v, v0, FINE_W)                # (G, 5, 768, 41)
        dots = torch.einsum('gfld,gfed->gfle', a_win, v_win)
        ra = a0[:, None] + torch.arange(BLOCK, device=dev)[None, :]
        rv = v0[:, None] + torch.arange(FINE_W, device=dev)[None, :]
        na = norms_a[:, ra].permute(1, 0, 2)              # (G, 5, 210)
        nv = norms_v[:, rv].permute(1, 0, 2)              # (G, 5, 768)
        corr = dots / (na[:, :, :, None] * nv[:, :, None, :])
        one_m = torch.clamp(1.0 - corr[:, :3], min=1e-8)
        prob = (one_m[:, 0] * one_m[:, 1] * one_m[:, 2]) ** NB_EXPONENT
        band_ok = torch.maximum(corr[:, 3], corr[:, 4]) >= BAND_GATE
        qual = torch.clamp((prob / scale) ** (-1.0 / 3), max=QUAL_MAX)
        valid = (in_band[None] & (a_mask[ra] > 0)[:, :, None]
                 & (v_mask[rv] > 0)[:, None, :]
                 & (prob <= QUAL_PROB_CUTOFF) & band_ok)
        qual = torch.where(valid, qual, torch.zeros((), device=dev))
        top_q, top_e = torch.sort(qual, dim=2, descending=True, stable=True)
        quals.append(top_q[:, :, :TOP_K])
        offs.append(top_e[:, :, :TOP_K].to(torch.int32))
    if not quals:
        return (torch.zeros((0, BLOCK, TOP_K), device=dev),
                torch.zeros((0, BLOCK, TOP_K), dtype=torch.int32,
                            device=dev))
    return torch.cat(quals), torch.cat(offs)
