"""The coarse score map: a hand-written CUDA kernel, its plain version and
the kernel's tiling twin.

The JAX package computes the map as one fused XLA program per 64-block
chunk (describealign_tpu/alignment/matching.py `_chunk_scores`,
`_block_scores_local`, and the suppression of `_coarse_dp_streamed`): for
each of the 7 sub-lane video phases the (640 x Kv) descriptor product S,
the skew max over each block's 10 coarse rows, P[b, v] = max_p
S[10 b + p, v + p] (zero past Kv), a max over the phases, and in the
k-best second pass -1e30 on the lanes within SUPPRESS_LANES of the first
track. In eager torch that is 7 GEMMs, 7 pads and 63 maxima per chunk; the
port runs it in one kernel (csrc/coarse_map.cu: 3xTF32 on the tensor
cores, one CTA per 8 blocks x 240 lanes, see the source for the design
and its bound).

- `block_scores(desc_a, desc_v, b0, n, suppress)` dispatches on the
  tensors' device: CPU tensors go to `block_scores_plain`; CUDA tensors
  launch the kernel (built with nvcc at first use) or raise. There is no
  fallback from CUDA to the plain version. `block_scores.launches` counts
  the launches (under a lock: the batch path launches from pool threads).
- `block_scores_plain` is the arithmetic the port ran before the kernel,
  unchanged: per 64-block chunk and phase one `torch.matmul`, the pad and
  the maxima, then `torch.where` per suppress path.
- `block_scores_twin` walks the kernel's CTA tiles on the CPU: the 256
  computed columns of a 240-lane tile (the halo), the zero-filled rows and
  columns, the tf32 hi / lo split and the per-k-step partials summed in
  the kernel's order, the phase loop, the edge and suppression tests and
  the order of the maxima. The tensor core's own rounding inside a k-step
  is not emulated: the twin's k-step partials are fp32 products.
"""
import ctypes
import threading

import torch

from ..alignment.matching import (COARSE_CHUNK, COARSE_PER_BLOCK,
                                  SUB_LANE_SHIFTS, SUPPRESS_LANES)

NEG = -1e30                     # a suppressed lane's score
# the kernel's tile (csrc/coarse_map.cu)
CTA_BLOCKS = 8                  # audio blocks per CTA (80 descriptor rows)
CTA_COLUMNS = 256               # computed video columns per CTA
CTA_LANES = CTA_COLUMNS - 16    # output lanes per CTA: a 9-column halo,
                                # rounded up to two n8 tiles
K_SLAB = 32                     # K per pipeline stage; K must be a multiple
K_STEP = 8                      # the mma's k

_lib = None
_count_lock = threading.Lock()  # the batch path launches from pool threads


def load_library():
    """The kernel's ctypes library, built from csrc/coarse_map.cu. Raises
    if its tile is not the one block_scores_twin walks."""
    global _lib
    if _lib is None:
        from ._build import load_library as _load
        lib = _load('coarse_map', ['coarse_map.cu'])
        ptr, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.coarse_map_launch.restype = ctypes.c_int
        lib.coarse_map_launch.argtypes = [ptr] * 4 + [ll] * 7 + [ptr]
        lib.coarse_map_config.restype = None
        lib.coarse_map_config.argtypes = [ptr]
        cfg = kernel_config(lib)
        if (cfg["blocks"], cfg["lanes"], cfg["k_slab"]) != (
                CTA_BLOCKS, CTA_LANES, K_SLAB):
            raise RuntimeError(f"csrc/coarse_map.cu's tile {cfg} is not the "
                               f"twin's ({CTA_BLOCKS} blocks, {CTA_LANES} "
                               f"lanes, K slabs of {K_SLAB})")
        _lib = lib
    return _lib


def kernel_config(lib=None):
    """{blocks, lanes, threads, smem_bytes, k_slab} of the kernel's CTA, as
    the built library reports it."""
    cfg = (ctypes.c_int * 5)()
    (lib or load_library()).coarse_map_config(cfg)
    return dict(zip(("blocks", "lanes", "threads", "smem_bytes", "k_slab"),
                    cfg))


def _check(desc_a, desc_v, b0, n, suppress):
    dev = desc_a.device
    if desc_a.dim() != 2 or desc_a.dtype != torch.float32:
        raise ValueError(f"block_scores: desc_a is {tuple(desc_a.shape)} "
                         f"{desc_a.dtype}, expected (rows, K) float32")
    k = desc_a.shape[1]
    if (desc_v.dim() != 3 or desc_v.shape[0] != len(SUB_LANE_SHIFTS)
            or desc_v.shape[2] != k or desc_v.shape[1] < 1
            or desc_v.dtype != torch.float32):
        raise ValueError(f"block_scores: desc_v is {tuple(desc_v.shape)} "
                         f"{desc_v.dtype}, expected "
                         f"({len(SUB_LANE_SHIFTS)}, Kv, {k}) float32")
    if k % K_SLAB:
        raise ValueError(f"block_scores: K {k} is not a multiple of "
                         f"{K_SLAB}")
    if b0 < 0 or n < 1 or desc_a.shape[0] < COARSE_PER_BLOCK * (b0 + n):
        raise ValueError(f"block_scores: blocks [{b0}, {b0 + n}) need "
                         f"{COARSE_PER_BLOCK * (b0 + n)} descriptor rows, "
                         f"desc_a has {desc_a.shape[0]}")
    tensors = [desc_a, desc_v]
    if suppress is not None:
        if (suppress.dim() != 2 or suppress.dtype != torch.int32
                or suppress.shape[1] < b0 + n):
            raise ValueError(f"block_scores: suppress is "
                             f"{tuple(suppress.shape)} {suppress.dtype}, "
                             f"expected (t, >= {b0 + n}) int32 lane paths")
        tensors.append(suppress)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"block_scores: a tensor is on {t.device}, "
                             f"desc_a on {dev}")
        if not t.is_contiguous():
            raise ValueError("block_scores: inputs must be contiguous")


def block_scores(desc_a, desc_v, b0, n, suppress=None):
    """Score map rows of blocks b0 .. b0 + n - 1: (n, Kv) f32 with P[b - b0,
    v] = max over the phases ph and p < 10 of (desc_a desc_v[ph]^T)[10 b +
    p, v + p], 0 past Kv; -1e30 on lanes within SUPPRESS_LANES of
    suppress[i, b] for any i.

    desc_a: (rows >= 10 (b0 + n), K) f32 audio descriptors; desc_v: (7, Kv,
    K) f32, the video phases' descriptors; K a multiple of 32; suppress:
    None or (t, >= b0 + n) i32 lane paths indexed by absolute block."""
    _check(desc_a, desc_v, b0, n, suppress)
    dev = desc_a.device
    if dev.type == 'cpu':
        return block_scores_plain(desc_a, desc_v, b0, n, suppress)
    if dev.type != 'cuda':
        raise ValueError(f"block_scores: unsupported device {dev}")
    if desc_a.data_ptr() % 16 or desc_v.data_ptr() % 16:
        raise ValueError("block_scores: descriptors must be 16-byte aligned")
    lib = load_library()
    kv, k = desc_v.shape[1], desc_v.shape[2]
    out = torch.empty((n, kv), dtype=torch.float32, device=dev)
    n_sup = 0 if suppress is None else suppress.shape[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.coarse_map_launch(
            desc_a.data_ptr(), desc_v.data_ptr(),
            None if suppress is None else suppress.data_ptr(),
            out.data_ptr(), desc_a.shape[0], k, kv, b0, n, n_sup,
            0 if suppress is None else suppress.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"block_scores kernel launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        block_scores.launches += 1
    return out


block_scores.launches = 0


def _chunk_plain(desc_a_padded, desc_v, c):
    """(COARSE_CHUNK, Kv) tile of chunk c: per phase the (640 x Kv)
    product, skew-maxed over each block's 10 rows and max-folded."""
    kv = desc_v.shape[1]
    rows = desc_a_padded[c * COARSE_CHUNK * COARSE_PER_BLOCK:
                         (c + 1) * COARSE_CHUNK * COARSE_PER_BLOCK]
    out = None
    for phase in desc_v:
        s = torch.matmul(rows, phase.T).reshape(
            COARSE_CHUNK, COARSE_PER_BLOCK, kv)
        s = torch.nn.functional.pad(s, (0, COARSE_PER_BLOCK))
        aligned = s[:, 0, :kv]
        for p in range(1, COARSE_PER_BLOCK):
            aligned = torch.maximum(aligned, s[:, p, p:p + kv])
        out = aligned if out is None else torch.maximum(out, aligned)
    return out


def block_scores_plain(desc_a, desc_v, b0, n, suppress=None):
    """block_scores in plain torch, chunk by chunk as the port computed it
    before the kernel (the callers pad desc_a to whole chunks)."""
    kv = desc_v.shape[1]
    c0 = b0 // COARSE_CHUNK
    c1 = -(-(b0 + n) // COARSE_CHUNK)
    short = c1 * COARSE_CHUNK * COARSE_PER_BLOCK - desc_a.shape[0]
    if short > 0:
        desc_a = torch.nn.functional.pad(desc_a, (0, 0, 0, short))
    tiles = [_chunk_plain(desc_a, desc_v, c) for c in range(c0, c1)]
    s = torch.cat(tiles) if len(tiles) > 1 else tiles[0]
    s = s[b0 - c0 * COARSE_CHUNK:b0 - c0 * COARSE_CHUNK + n]
    if suppress is not None:
        lanes = torch.arange(kv, dtype=torch.int32,
                             device=desc_a.device)[None, :]
        neg = torch.full((), NEG, dtype=torch.float32, device=desc_a.device)
        for vp in suppress:
            s = torch.where(torch.abs(lanes - vp[b0:b0 + n, None])
                            <= SUPPRESS_LANES, neg, s)
    return s.contiguous()


def _tf32_rna(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _split_tf32(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _tile_products(a_hi, a_lo, b_hi, b_lo):
    """(tiles, rows, cols) S sub-tiles in the kernel's order: per k-step of
    8 the partial lo*hi + hi*lo + hi*hi, added to the running sum.
    a_*: (tiles, rows, K); b_*: (cols, K)."""
    steps = a_hi.shape[2] // K_STEP

    def a_steps(x):                         # (tiles, steps, rows, 8)
        return x.reshape(x.shape[0], x.shape[1], steps, K_STEP).transpose(
            1, 2)

    def b_steps(x):                         # (steps, 8, cols)
        return x.reshape(x.shape[0], steps, K_STEP).permute(1, 2, 0)
    ah, al = a_steps(a_hi), a_steps(a_lo)
    bh, bl = b_steps(b_hi), b_steps(b_lo)
    part = torch.matmul(al, bh)
    part = part + torch.matmul(ah, bl)
    part = part + torch.matmul(ah, bh)
    acc = torch.zeros_like(part[:, 0])
    for ks in range(steps):
        acc = acc + part[:, ks]
    return acc


def block_scores_twin(desc_a, desc_v, b0, n, suppress=None):
    """block_scores as the kernel tiles it, on the CPU (module docstring).
    Same arguments and result layout as block_scores. The CTAs of one
    lane range are computed together: they share nothing in the kernel."""
    _check(desc_a, desc_v, b0, n, suppress)
    kv = desc_v.shape[1]
    dev = desc_a.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # the staged A rows of every CTA: (row CTAs, 80, K), zero past the range
    n_bx = -(-n // CTA_BLOCKS)
    rows = ((b0 + CTA_BLOCKS * torch.arange(n_bx, device=dev))[:, None]
            * COARSE_PER_BLOCK
            + torch.arange(CTA_BLOCKS * COARSE_PER_BLOCK, device=dev))
    row_ok = (rows < COARSE_PER_BLOCK * (b0 + n))[:, :, None]
    rows = torch.where(row_ok[:, :, 0], rows, 0)
    a_hi, a_lo = (torch.where(row_ok, x[rows], zero)
                  for x in _split_tf32(desc_a))
    v_hi, v_lo = _split_tf32(desc_v)
    out = torch.empty((n_bx * CTA_BLOCKS, kv), dtype=torch.float32,
                      device=dev)
    for v0 in range(0, kv, CTA_LANES):
        cols = v0 + torch.arange(CTA_COLUMNS, device=dev)
        col_ok = (cols < kv)[:, None]
        cols = torch.where(cols < kv, cols, 0)
        # thread j of the epilogue: output lane v0 + j, j < 240
        lanes = v0 + torch.arange(CTA_LANES, device=dev)
        best = None
        for ph in range(len(SUB_LANE_SHIFTS)):
            s = _tile_products(a_hi, a_lo,
                               torch.where(col_ok, v_hi[ph, cols], zero),
                               torch.where(col_ok, v_lo[ph, cols], zero))
            m = None
            for p in range(COARSE_PER_BLOCK):
                sp = s[:, p::COARSE_PER_BLOCK, p:p + CTA_LANES]
                sp = torch.where(lanes + p < kv, sp, zero)
                m = sp if m is None else torch.maximum(m, sp)
            best = m if best is None else torch.maximum(best, m)
        nl = min(CTA_LANES, kv - v0)
        out[:, v0:v0 + nl] = best.reshape(-1, CTA_LANES)[:, :nl]
    out = out[:n]
    if suppress is not None:
        lanes_i = torch.arange(kv, device=dev, dtype=torch.int32)[None, :]
        for vp in suppress:
            out = torch.where(torch.abs(lanes_i - vp[b0:b0 + n, None])
                              <= SUPPRESS_LANES,
                              torch.full((), NEG, device=dev), out)
    return out.contiguous()


def block_scores_work(n, kv, k, n_sup=0):
    """(FMA, bytes) of one block_scores call: every S element the skew max
    reads (7 x 10 n x Kv x K FMA), and the inputs read once (n blocks'
    descriptor rows, the 7 phases' descriptors, the suppress paths' rows)
    plus the map written once."""
    phases = len(SUB_LANE_SHIFTS)
    fma = phases * COARSE_PER_BLOCK * n * kv * k
    nbytes = 4 * (COARSE_PER_BLOCK * n * k + phases * kv * k + n_sup * n
                  + n * kv)
    return fma, nbytes
