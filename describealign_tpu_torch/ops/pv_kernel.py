"""The phase vocoder's frame recurrence: hand-written CUDA kernels + their
plain version.

The JAX package's device phase vocoder (describealign_tpu/stretch/
phase_vocoder.py `_pv_segment`, 41-103) runs the phase propagation with
identity phase locking (`propagate`, 60-94) as a `lax.scan` over frames.
In eager torch each frame is ~12 small launches; the port runs it as three
kernels per block (csrc/pv_lock.cu): a prologue over every SM computes the
magnitudes, phases, wrapped increments and locking choices of all frames;
a walk, one warp per channel, carries the locked phases frame by frame
with no barrier (each lane a contiguous run of 17 bins, the run edges by
shuffles); an epilogue over every SM takes mag (cos, sin) of the locked
phases.

- `pv_phase_lock(spec, omega, rate, carry=None)` dispatches on the
  spectrum's device: CPU tensors go to `pv_phase_lock_plain`; CUDA tensors
  launch the kernels (built with nvcc at first use) or raise. There is no
  fallback from CUDA to the plain version.
- `pv_phase_lock_plain` computes the same in torch: magnitudes and phases
  (torch.hypot, torch.atan2), the wrapped increments for all frames, then
  `phase_lock_plain` - the JAX package's `_phase_lock` recurrence - frame
  by frame, and mag (cos, sin) of the locked phases.
- `pv_phase_lock.launches` counts wrapper calls that launch (one per
  block: the three kernels).
- `walk_layout()` and `lk_index()` give the walk's shape, its records
  and its write-back order; `pass_ms` times each kernel alone;
  `pv_lock_work(c, f)` the function's least bytes and operations,
  `pv_pass_bytes(c, f)` the bytes the three passes move as built, and
  `empty_steps_ms` measures an empty walk: the sequential floor.
"""
import ctypes
import threading

import numpy as np
import torch

BINS = 513                              # N_FFT // 2 + 1
MAX_BINS = 544                          # csrc/pv_lock.cu: bins a launch takes
TWO_PI = float(np.float32(2 * np.pi))   # the f32 constant JAX divides by
WALK_WARPS = 2                          # csrc/pv_lock.cu WARPS

_lib = None
_count_lock = threading.Lock()


def load_library():
    """The kernels' ctypes library, built from csrc/pv_lock.cu."""
    global _lib
    if _lib is None:
        from ._build import load_library as _load
        lib = _load('pv_lock', ['pv_lock.cu'])
        ptr, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_float)
        lib.pv_lock_launch.restype = i32
        lib.pv_lock_launch.argtypes = [ptr, ptr, ptr, f32, ptr, ptr, ptr, ll,
                                       ll, i32, i32, ptr]
        lib.pv_lock_scratch_bytes.restype = ll
        lib.pv_lock_scratch_bytes.argtypes = [ll, ll]
        lib.pv_walk_warps.restype = i32
        lib.pv_walk_warps.argtypes = []
        lib.pv_empty_walk_launch.restype = i32
        lib.pv_empty_walk_launch.argtypes = [ll, ll, ptr, ptr]
        if lib.pv_walk_warps() != WALK_WARPS:
            raise RuntimeError(f"csrc/pv_lock.cu walks on "
                               f"{lib.pv_walk_warps()} warps, WALK_WARPS "
                               f"says {WALK_WARPS}")
        _lib = lib
    return _lib


KEEP, TAKE = 0x3210, 0x7654             # csrc/pv_lock.cu's byte permutes


def walk_layout():
    """(run, lanes, record bytes, lk floats per lane) of the walk: lane t
    of its WALK_WARPS warps owns the contiguous bins t * run ... t * run +
    run - 1; a frame's record holds, per lane, its run's (pa, q, selector)
    words padded to 16 bytes (zeros for a run past the bins); the walk
    writes lk back with lk_run >= run floats per lane."""
    lanes = 32 * WALK_WARPS
    run = -(-MAX_BINS // lanes)
    return run, lanes, lanes * 16 * (-(-3 * run // 4)), -(-run // 4) * 4


def lk_index(k, b, f, ch=0):
    """The walk's write-back index of bin(s) b of frame(s) k of channel ch
    (f frames a channel): [channel][frame][lane][lk_run] (csrc/pv_lock.cu's
    epilogue)."""
    run, lanes, _, lk_run = walk_layout()
    b = np.asarray(b)
    return ((ch * f + np.asarray(k)) * lanes + b // run) * lk_run + b % run


def _check(spec, omega, carry):
    if spec.dim() != 3 or spec.dtype != torch.complex64 \
            or spec.shape[1] < 1 or not 2 <= spec.shape[2] <= MAX_BINS:
        raise ValueError(f"pv_phase_lock: spec is {tuple(spec.shape)} "
                         f"{spec.dtype}, expected (C, F >= 1, bins <= "
                         f"{MAX_BINS}) torch.complex64")
    c, _, bins = spec.shape
    for name, t, shape in (('omega', omega, (bins,)),
                           ('carry', carry, (2, c, bins))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"pv_phase_lock: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} torch.float32")
    for name, t in (('spec', spec), ('omega', omega), ('carry', carry)):
        if t is None:
            continue
        if t.device != spec.device:
            raise ValueError(f"pv_phase_lock: {name} is on {t.device}, "
                             f"spec on {spec.device}")
        if not t.is_contiguous():
            raise ValueError(f"pv_phase_lock: {name} is not contiguous")


def pv_phase_lock(spec, omega, rate, carry=None):
    """The locked synthesis spectrum of analysis frames spec (C, F, bins)
    complex64: omega (bins,) f32 the bins' phase advance per synthesis hop,
    rate the input samples per output sample (rounded to f32). carry: None
    for a segment's first block (frame 0 passes through) or (2, C, bins)
    f32, the last frame's (phase_a, locked phase) of the previous block.
    Returns (spec_out (C, F, bins) complex64, carry for the next block)."""
    _check(spec, omega, carry)
    dev = spec.device
    rate = float(np.float32(rate))
    if dev.type == 'cpu':
        return pv_phase_lock_plain(spec, omega, rate, carry)
    if dev.type != 'cuda':
        raise ValueError(f"pv_phase_lock: unsupported device {dev}")
    out, carry_out, _ = _launch(spec, omega, rate, carry, _PASSES)
    with _count_lock:
        pv_phase_lock.launches += 1
    return out, carry_out


pv_phase_lock.launches = 0


PASSES = ("prologue", "walk", "epilogue")      # csrc/pv_lock.cu's kernels
_PASSES = 7                                     # the mask of all three


def _launch(spec, omega, rate, carry, passes, bufs=None):
    """The kernels of the mask `passes` on CUDA tensors; bufs: (out,
    carry_out, scratch) to reuse. Returns (out, carry_out, scratch)."""
    lib = load_library()
    dev = spec.device
    c, f, bins = spec.shape
    out, carry_out, scratch = bufs or (
        torch.empty_like(spec),
        torch.empty((2, c, bins), dtype=torch.float32, device=dev),
        torch.empty(lib.pv_lock_scratch_bytes(c, f), dtype=torch.uint8,
                    device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pv_lock_launch(
            spec.data_ptr(), out.data_ptr(), omega.data_ptr(),
            float(np.float32(rate)),
            None if carry is None else carry.data_ptr(),
            carry_out.data_ptr(), scratch.data_ptr(), c, f, bins, passes,
            stream)
    if rc != 0:
        raise RuntimeError(f"pv_phase_lock kernel launch failed: CUDA error "
                           f"{rc}")
    return out, carry_out, scratch


def pass_ms(spec, omega, rate, carry=None, reps=3):
    """{pass: milliseconds} of each of the three kernels alone on CUDA
    tensors (CUDA events, the mean of `reps` launches after the whole
    function has run once on the same scratch); counts no launch."""
    _check(spec, omega, carry)
    bufs = _launch(spec, omega, rate, carry, _PASSES)
    times = {}
    for i, name in enumerate(PASSES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            _launch(spec, omega, rate, carry, 1 << i, bufs)
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / reps
    return times


def pv_lock_work(c, f, bins=BINS):
    """(bytes, flops) of c channels x f frames: the spectrum read once and
    written once (8 + 8 bytes per bin and frame); per bin and frame the
    magnitude and phase, the wrapped increment, the rotation, the locking
    selects, the locked phase and its product with (cos, sin), counting a
    hypot, atan2, cos or sin as one operation each (~20)."""
    n = int(c) * int(f) * int(bins)
    return 16 * n, 20 * n


def pv_pass_bytes(c, f, bins=BINS):
    """{pass: bytes} the three kernels move as built for c channels x f
    frames, each array counted once per pass: the prologue reads the
    spectrum (8 per bin) and writes the records, the walk reads the
    records and writes lk (lk_run floats per lane), the epilogue
    reads the spectrum and lk (4 per bin) and writes the output (8 per
    bin)."""
    rows = int(c) * int(f)
    _, lanes, rec, lk_run = walk_layout()
    return {"prologue": rows * (8 * bins + rec),
            "walk": rows * (rec + 4 * lanes * lk_run),
            "epilogue": rows * (8 * bins + 4 * bins + 8 * bins)}


def empty_steps_ms(frames, c):
    """Milliseconds of an empty walk of `frames` frames on c CTAs of the
    walking warps on the current CUDA device (a warm-up launch first): the
    adds, shuffles, edge exchanges and permutes of each frame without
    loads, what the sequential walk cannot go below."""
    lib = load_library()
    sink = torch.empty(c * 32 * WALK_WARPS, dtype=torch.float32,
                       device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.pv_empty_walk_launch(frames, c, sink.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"empty_steps_ms launch failed: CUDA error "
                               f"{rc}")
    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def phase_lock_plain(phase_a, mag, inst_over_rate, init_locked=None):
    """Locked synthesis phases, frame by frame: the JAX package's
    `_phase_lock` recurrence (phase_vocoder.py:106-162) in torch.

    init_locked None: whole-segment semantics (frame 0's phases pass
    through; inst_over_rate is (C, F-1, bins)). With init_locked (C, bins):
    every frame runs the recurrence seeded by it, and inst_over_rate[:, k]
    is the increment from frame k-1 (shape (C, F, bins))."""
    c, f, bins = phase_a.shape
    phases = torch.empty_like(phase_a)
    if init_locked is None:
        phases[:, 0] = phase_a[:, 0]
        prev_locked = phase_a[:, 0]
        k0 = 1
    else:
        prev_locked = init_locked
        k0 = 0
    zero = phase_a.new_zeros((c, 1))
    for k in range(k0, f):
        rot = prev_locked + inst_over_rate[:, k - k0] - phase_a[:, k]
        m = mag[:, k]
        left_m = torch.cat([zero, m[:, :-1]], 1)
        right_m = torch.cat([m[:, 1:], zero], 1)
        left_rot = torch.cat([zero, rot[:, :-1]], 1)
        right_rot = torch.cat([rot[:, 1:], zero], 1)
        dom_rot = torch.where(left_m > torch.maximum(m, right_m), left_rot,
                              torch.where(right_m > m, right_rot, rot))
        prev_locked = phase_a[:, k] + dom_rot
        phases[:, k] = prev_locked
    return phases


def pv_phase_lock_plain(spec, omega, rate, carry=None):
    """pv_phase_lock in torch; rate is an f32 value. The divisions are by
    tensors on the spectrum's device, never by a host scalar (torch turns
    that into a product with the reciprocal on CUDA)."""
    dev = spec.device
    rate_t = torch.tensor(rate, dtype=torch.float32, device=dev)
    two_pi = torch.tensor(TWO_PI, dtype=torch.float32, device=dev)
    mag = torch.hypot(spec.real, spec.imag)
    phase_a = torch.atan2(spec.imag, spec.real)
    omega_rate = omega * rate_t
    if carry is None:
        prev, cur, init = phase_a[:, :-1], phase_a[:, 1:], None
    else:
        prev = torch.cat([carry[0][:, None], phase_a[:, :-1]], 1)
        cur, init = phase_a, carry[1]
    dphi = cur - prev - omega_rate
    dphi = dphi - two_pi * torch.round(dphi / two_pi)
    inst_over_rate = (omega_rate + dphi) / rate_t
    phases = phase_lock_plain(phase_a, mag, inst_over_rate, init)
    out = torch.complex(mag * torch.cos(phases), mag * torch.sin(phases))
    return out, torch.stack([phase_a[:, -1], phases[:, -1]]).contiguous()
