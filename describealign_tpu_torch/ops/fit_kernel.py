"""The on-device L1 fit's ADMM: a hand-written CUDA kernel + its plain
version.

The JAX package runs `fit_device._fused_lasso_admm` (describealign_tpu/
alignment/fit_device.py:86-124) as one XLA program: 800 over-relaxed ADMM
iterations in a `lax.scan`, each a cyclic-reduction solve (`_cr_solve`,
35-78) of a constant tridiagonal system plus two soft-thresholds and two
dual updates; the batch is its `vmap` (170-175). In eager torch that is
~300 small launches per iteration, so the port runs it as one kernel
(csrc/fit_admm.cu: one CTA per problem walks every iteration, the
elimination factors computed once; the cyclic reduction's levels compact,
as the plain version's slices make them; d, the one array the solve's
steps carry, in shared memory at every n up to 16,384, then the factors,
the state and the constants as far as shared memory goes, the rest in an
L2-resident global scratch; the levels of at most 32 rows in one warp).

- `fused_lasso_admm(b, c, kappa, rho1, rho2, iters)` dispatches on the
  tensors' device: CPU tensors go to `fused_lasso_admm_plain`; CUDA tensors
  launch the kernel (built with nvcc at first use) or raise. There is no
  fallback from CUDA to the plain version.
- `fused_lasso_admm_plain` is the JAX function op for op in torch (f32,
  the static level loop, every product and sum rounded alone); the kernel
  is bit-equal to it.
- `fused_lasso_admm.launches` counts kernel launches.
- `fit_admm_work(n_pad, iters)` counts the bytes and operations of one
  problem, for the bound; `steps_per_solve` the CTA barriers and warp
  steps of a solve, `empty_steps_ms` / `empty_warp_steps_ms` measure one
  of each: the floor. `shared_slots(n_pad)` names the arrays the kernel
  keeps in shared memory.
"""
import ctypes
import threading

import numpy as np
import torch

ADMM_ITERS = 800
OVER_RELAX = 1.8
# csrc/fit_admm.cu: the slots of n floats in the order they claim shared
# memory (d, the compact levels of the right-hand side, takes two), the
# bytes a block may use, the warp levels' factor table beside them
SLOTS = ('D', 'D', 'AL', 'GA', 'CA', 'CC', 'CB', 'P', 'Z', 'A', 'E', 'B', 'R2',
         'CT', 'KT')
N_SLOTS = len(SLOTS)
SMEM_LIMIT = 232448
WARP_ROWS = 32                  # levels of at most this many rows: one warp
TAB_BYTES = 4 * (5 * (2 * WARP_ROWS - 1) + 1)

_lib = None
_count_lock = threading.Lock()  # the batch path fits on pool threads


def load_library():
    """The kernel's ctypes library, built from csrc/fit_admm.cu."""
    global _lib
    if _lib is None:
        from ._build import load_library as _load
        lib = _load('fit_admm', ['fit_admm.cu'])
        ptr, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_float)
        lib.fit_admm_launch.restype = i32
        lib.fit_admm_launch.argtypes = [ptr] * 8 + [ll, ll, i32, f32, f32,
                                                    ptr]
        lib.fit_empty_steps_launch.restype = i32
        lib.fit_empty_steps_launch.argtypes = [ll, ll, ptr, ptr]
        lib.fit_empty_warp_steps_launch.restype = i32
        lib.fit_empty_warp_steps_launch.argtypes = [ll, ptr, ptr]
        lib.fit_admm_shared_slots.restype = i32
        lib.fit_admm_shared_slots.argtypes = [ll]
        _lib = lib
    return _lib


def levels_of(n_pad):
    """Cyclic-reduction levels of an n_pad system (log2 n_pad)."""
    return int(n_pad).bit_length() - 1


def warp_levels(n_pad):
    """The top levels (at most WARP_ROWS rows) the kernel runs in warp 0."""
    return min(levels_of(n_pad), levels_of(WARP_ROWS) + 1)


def shared_slots(n_pad):
    """The slots csrc/fit_admm.cu keeps in shared memory at n_pad, as many
    of SLOTS as fit in SMEM_LIMIT beside the warp table (d's two together
    or none); the rest are in the global scratch."""
    fit = (SMEM_LIMIT - TAB_BYTES) // (4 * n_pad)
    return SLOTS[:0 if fit < 2 else min(N_SLOTS, fit)]


def _check(b, c, kappa, rho1, rho2):
    if b.dim() != 2:
        raise ValueError(f"fused_lasso_admm: b is {tuple(b.shape)}, "
                         f"expected (batch, n)")
    nb, n = b.shape
    if n < 16 or n & (n - 1):
        raise ValueError(f"fused_lasso_admm: n = {n} is not a power of two "
                         f">= 16")
    for name, t, shape in (('b', b, (nb, n)), ('c', c, (nb, n)),
                           ('kappa', kappa, (nb, n - 1)),
                           ('rho1', rho1, (nb,)),
                           ('rho2', rho2, (nb, n - 1))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"fused_lasso_admm: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} torch.float32")
        if t.device != b.device:
            raise ValueError(f"fused_lasso_admm: {name} is on {t.device}, "
                             f"b on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_lasso_admm: {name} is not contiguous")


def fused_lasso_admm(b, c, kappa, rho1, rho2, iters=ADMM_ITERS):
    """ADMM for min sum c|t - b| + sum kappa|Dt| on a batch of padded
    problems: b, c (B, n); kappa, rho2 (B, n - 1); rho1 (B,); all f32 on
    one device, n a power of two >= 16. Returns (t (B, n), z (B, n - 1)),
    z the exactly sparse TV copy."""
    _check(b, c, kappa, rho1, rho2)
    dev = b.device
    if dev.type == 'cpu':
        return fused_lasso_admm_plain(b, c, kappa, rho1, rho2, iters)
    if dev.type != 'cuda':
        raise ValueError(f"fused_lasso_admm: unsupported device {dev}")
    lib = load_library()
    nb, n = b.shape
    t = torch.empty_like(b)
    z = torch.empty_like(rho2)
    n_shared = lib.fit_admm_shared_slots(n)
    scratch = (torch.empty((nb, N_SLOTS - n_shared, n), dtype=torch.float32,
                           device=dev) if n_shared < N_SLOTS else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fit_admm_launch(
            b.data_ptr(), c.data_ptr(), kappa.data_ptr(), rho1.data_ptr(),
            rho2.data_ptr(), t.data_ptr(), z.data_ptr(),
            None if scratch is None else scratch.data_ptr(), nb, n,
            int(iters), float(np.float32(OVER_RELAX)),
            float(np.float32(1 - OVER_RELAX)), stream)
    if rc != 0:
        raise RuntimeError(f"fused_lasso_admm kernel launch failed: CUDA "
                           f"error {rc}")
    with _count_lock:
        fused_lasso_admm.launches += 1
    return t, z


fused_lasso_admm.launches = 0


def fit_admm_work(n_pad, iters=ADMM_ITERS):
    """(bytes, flops) one problem of n_pad needs: its inputs read once
    (b, c: n; kappa, rho2: n - 1; rho1) and t, z written once; per
    iteration the right-hand side (2 per edge for rho2 (z - e), 5 per
    element), the elimination of d (4 per eliminated row), the top
    equation, the back substitution (5 per row) and the two updates (11
    per element and per edge: abs, the clamp and the sign select
    counted)."""
    n = int(n_pad)
    nbytes = 4 * (2 * n + 2 * (n - 1) + 1 + n + (n - 1))
    per_iter = (5 * n + 2 * (n - 1) + 4 * (n - 1) + 1 + 5 * (n - 1)
                + 11 * n + 11 * (n - 1))
    return nbytes, per_iter * int(iters)


def empty_steps_ms(steps, n_pad):
    """Milliseconds of `steps` empty barrier steps of one CTA of the
    kernel's threads at n_pad on the current CUDA device (a warm-up launch
    first): with empty_warp_steps_ms, what the ADMM cannot go below."""
    lib = load_library()
    return _time_empty(lambda sink, stream: lib.fit_empty_steps_launch(
        steps, n_pad, sink, stream))


def empty_warp_steps_ms(steps):
    """Milliseconds of `steps` empty steps of one warp (__syncwarp and a
    carried shared word each) on the current CUDA device."""
    lib = load_library()
    return _time_empty(lambda sink, stream: lib.fit_empty_warp_steps_launch(
        steps, sink, stream))


def _time_empty(call):
    sink = torch.empty(1, dtype=torch.float32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = call(sink.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"empty step launch failed: CUDA error {rc}")
    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def steps_per_solve(n_pad, iters=ADMM_ITERS):
    """(CTA barriers, warp steps) of one solve. Per iteration: the
    right-hand side, the CTA levels of the elimination, the warp phase and
    the CTA levels of the back substitution, the updates, a barrier after
    each (2 (log2 n - warp levels) + 3); in the warp phase each warp level
    of the elimination and of the back substitution and the top equation,
    a __syncwarp after each (2 warp levels + 1)."""
    cta = levels_of(n_pad) - warp_levels(n_pad)
    return (int(iters) * (2 * cta + 3),
            int(iters) * (2 * warp_levels(n_pad) + 1))


# ---------------------------------------------------------------------------
# Plain versions (fit_device.py:35-124 of the JAX package, op for op)
# ---------------------------------------------------------------------------

def _cr_solve(diag, off, rhs):
    """Solve the symmetric tridiagonal systems A x = rhs by cyclic
    reduction. diag, rhs: (..., N); off: (..., N - 1) sub/super diagonal;
    N a power of two. Out-of-range neighbours are zero; every level is a
    static slice."""
    zero = rhs.new_zeros(rhs.shape[:-1] + (1,))
    one = rhs.new_ones(rhs.shape[:-1] + (1,))
    a = torch.cat([zero, off], -1)              # sub,   a[0] = 0
    c = torch.cat([off, zero], -1)              # super, c[-1] = 0
    b = diag
    d = rhs
    stack = []
    while b.shape[-1] > 1:
        # eliminate even-indexed unknowns from the odd-indexed equations
        be, be_next = b[..., 0::2], torch.cat([b[..., 2::2], one], -1)
        ao, co = a[..., 1::2], c[..., 1::2]
        alpha = ao / be                         # couples row i to row i-1
        gamma = co / be_next                    # couples row i to row i+1
        ae, ce = a[..., 0::2], c[..., 0::2]
        a_next = torch.cat([a[..., 2::2], zero], -1)
        ce_next = torch.cat([c[..., 2::2], zero], -1)
        de = d[..., 0::2]
        de_next = torch.cat([d[..., 2::2], zero], -1)
        stack.append((a, b, c, d))
        b = b[..., 1::2] - alpha * ce - gamma * a_next
        a = -alpha * ae
        c = -gamma * ce_next
        d = d[..., 1::2] - alpha * de - gamma * de_next

    x = d / b                                   # single equation at the top
    while stack:
        a0, b0, c0, d0 = stack.pop()
        # x holds the odd-indexed unknowns of this level; recover evens
        x_left = torch.cat([zero, x[..., :-1]], -1)
        xe = (d0[..., 0::2] - a0[..., 0::2] * x_left
              - c0[..., 0::2] * x) / b0[..., 0::2]
        x = torch.stack([xe, x], -1).reshape(b0.shape)
    return x


def _soft(v, thresh):
    """sign(v) * max(|v| - thresh, 0), as where(v < 0, -m, m)."""
    m = torch.clamp(torch.abs(v) - thresh, min=0.0)
    return torch.where(v < 0, -m, m)


def fused_lasso_admm_plain(b_vals, c_cost, kappa, rho1, rho2,
                           iters=ADMM_ITERS):
    """fused_lasso_admm as a torch loop: the JAX `_fused_lasso_admm`
    (vmapped over the leading dimension). rho2 is per edge; padding has
    c = 0 and kappa = 0. Returns (t, z)."""
    r1 = rho1[..., None]
    zero = b_vals.new_zeros(b_vals.shape[:-1] + (1,))
    # constant system matrix: rho1*I + D^T diag(rho2) D
    diag = r1 + torch.cat([zero, rho2], -1) + torch.cat([rho2, zero], -1)
    off = -rho2

    def dt(t):
        return t[..., 1:] - t[..., :-1]

    def dtt_w(z):                               # D^T diag(rho2) z
        w = rho2 * z
        return torch.cat([-w[..., :1], w[..., :-1] - w[..., 1:],
                          w[..., -1:]], -1)

    t = b_vals
    p = torch.zeros_like(b_vals)
    z = dt(t)
    a_dual = torch.zeros_like(b_vals)
    e_dual = torch.zeros_like(rho2)
    for _ in range(iters):
        rhs = r1 * (b_vals + p - a_dual) + dtt_w(z - e_dual)
        t = _cr_solve(diag, off, rhs)
        # over-relaxation on both constraints
        t_hat_p = OVER_RELAX * (t - b_vals) + (1 - OVER_RELAX) * p
        t_hat_z = OVER_RELAX * dt(t) + (1 - OVER_RELAX) * z
        p = _soft(t_hat_p + a_dual, c_cost / r1)
        z = _soft(t_hat_z + e_dual, kappa / rho2)
        a_dual = a_dual + t_hat_p - p
        e_dual = e_dual + t_hat_z - z
    return t, z
