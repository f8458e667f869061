"""The phase vocoder's frame recurrence: a hand-written CUDA kernel + its
plain version.

The JAX package's device phase vocoder (describealign_tpu/stretch/
phase_vocoder.py `_pv_segment`, 41-103) runs the phase propagation with
identity phase locking (`propagate`, 60-94) as a `lax.scan` over frames.
In eager torch each frame is ~12 small launches; the port runs it as one
kernel (csrc/pv_lock.cu: one CTA per channel, one thread per bin, frames
in order, a double-buffered shared row for the neighbours' rotations).

- `pv_phase_lock(spec, omega, rate, carry=None)` dispatches on the
  spectrum's device: CPU tensors go to `pv_phase_lock_plain`; CUDA tensors
  launch the kernel (built with nvcc at first use) or raise. There is no
  fallback from CUDA to the plain version.
- `pv_phase_lock_plain` computes the same in torch: magnitudes and phases
  (torch.hypot, torch.atan2), the wrapped increments for all frames, then
  `phase_lock_plain` - the JAX package's `_phase_lock` recurrence - frame
  by frame, and mag (cos, sin) of the locked phases.
- `pv_phase_lock.launches` counts kernel launches.
- `pv_lock_work(c, f)` counts bytes and operations for the bound;
  `empty_steps_ms` measures the frame-step floor.
"""
import ctypes
import threading

import numpy as np
import torch

BINS = 513                              # N_FFT // 2 + 1
TWO_PI = float(np.float32(2 * np.pi))   # the f32 constant JAX divides by

_lib = None
_count_lock = threading.Lock()


def load_library():
    """The kernel's ctypes library, built from csrc/pv_lock.cu."""
    global _lib
    if _lib is None:
        from ._build import load_library as _load
        lib = _load('pv_lock', ['pv_lock.cu'])
        ptr, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_float)
        lib.pv_lock_launch.restype = i32
        lib.pv_lock_launch.argtypes = [ptr, ptr, ptr, f32, ptr, ptr, ll, ll,
                                       i32, ptr]
        lib.pv_empty_steps_launch.restype = i32
        lib.pv_empty_steps_launch.argtypes = [ll, ll, ptr, ptr]
        _lib = lib
    return _lib


def _check(spec, omega, carry):
    if spec.dim() != 3 or spec.dtype != torch.complex64 \
            or spec.shape[1] < 1 or not 2 <= spec.shape[2] <= 544:
        raise ValueError(f"pv_phase_lock: spec is {tuple(spec.shape)} "
                         f"{spec.dtype}, expected (C, F >= 1, bins <= 544) "
                         f"torch.complex64")
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
    lib = load_library()
    c, f, bins = spec.shape
    out = torch.empty_like(spec)
    carry_out = torch.empty((2, c, bins), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pv_lock_launch(
            spec.data_ptr(), out.data_ptr(), omega.data_ptr(), rate,
            None if carry is None else carry.data_ptr(),
            carry_out.data_ptr(), c, f, bins, stream)
    if rc != 0:
        raise RuntimeError(f"pv_phase_lock kernel launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        pv_phase_lock.launches += 1
    return out, carry_out


pv_phase_lock.launches = 0


def pv_lock_work(c, f, bins=BINS):
    """(bytes, flops) of c channels x f frames: the spectrum read once and
    written once (8 + 8 bytes per bin and frame); per bin and frame the
    magnitude and phase, the wrapped increment, the rotation, the locking
    selects, the locked phase and its product with (cos, sin), counting a
    hypot, atan2, cos or sin as one operation each (~20)."""
    n = int(c) * int(f) * int(bins)
    return 16 * n, 20 * n


def empty_steps_ms(steps, c):
    """Milliseconds of `steps` empty frame steps (one barrier each) of c
    CTAs of the kernel's shape on the current CUDA device (a warm-up
    launch first): frames times this step is what the sequential scan
    cannot go below."""
    lib = load_library()
    sink = torch.empty(c, dtype=torch.float32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.pv_empty_steps_launch(steps, c, sink.data_ptr(), stream)
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
