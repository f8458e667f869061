"""The coarse max-plus DP: hand-written CUDA kernels + their plain versions.

The JAX package runs the coarse track DP (describealign_tpu/alignment/
matching.py `_coarse_dp`, `_coarse_dp_streamed`, built from `_dp_relax` and
`_dp_backstep`) as XLA `lax.scan` programs: one device dispatch for
thousands of strictly sequential steps. In eager torch the same loop is
about 29 small launches per step, so the port gives it persistent kernels
(csrc/coarse_dp.cu; they need an sm_90 card with cluster launch):

- `dp_forward(prev, scores)`: for each score row, relax the previous cost
  row (shift by the nominal 10-lane advance, exact |.| distance transform by
  a forward and a backward running max, capped by a flat jump), add the
  row, keep the result. One thread-block cluster walks every step, the row
  spread over its CTAs' shared memory; `forward_config` chooses the
  cluster size, the threads per CTA and the lanes per thread from the
  width, and `dp_forward.cluster` / `dp_forward.config` record the last
  launch's;
- `dp_backtrace(o_last, rows)`: walk the cost rows backwards, choosing at
  each the predecessor lane (move vs jump, first maximal lane on ties). A
  pre-pass takes every row's maximum and its first lane on all SMs (into
  scratch this wrapper allocates), then one warp walks a 5-lane window per
  row.

Both dispatch on the tensors' device: CPU tensors go to the plain versions
(`dp_forward_plain`, `dp_backtrace_plain`: torch loops, the arithmetic of
the JAX functions op for op); CUDA tensors launch the kernels (built with
nvcc at first use) or raise. There is no fallback from CUDA to the plain
versions. The kernels are bit-equal to the plain versions: max is exact in
any order, every add and subtract is one f32 rounding in both, and ties go
to the lower lane in both. `dp_forward.launches` and
`dp_backtrace.launches` count wrapper calls that launched.
"""
import ctypes
import threading

import torch

from ..alignment.matching import (COARSE_PER_BLOCK, DP_JUMP_COST,
                                  DP_SLOPE_COST)

NEG = -1e30                     # the cost shifted in below lane 10

# The forward kernel's launch shapes (csrc/coarse_dp.cu)
MAX_CLUSTER = 16                # CTAs of one cluster (above 8: non-portable)
MAX_THREADS = 1024
LANES = (1, 3, 5, 7, 9)         # lanes per thread: odd, for the shared banks
WIDE_LANES = 9                  # of the wide kernel
CTA_LANES = 1024                # a cluster doubles per this many lanes
CTA_THREADS = 768               # preferred ceiling of threads per CTA
# dp_backtrace walks a 5-lane window while |max(row)| is below this; from
# here on x - 1 may round to x, and the walk scans the whole row
WINDOW_LIMIT = 2.0 ** 22

_lib = None
_count_lock = threading.Lock()  # wrappers run on the batch path's threads


def load_library():
    """The kernels' ctypes library, built from csrc/coarse_dp.cu."""
    global _lib
    if _lib is None:
        from ._build import load_library as _load
        lib = _load('coarse_dp', ['coarse_dp.cu'])
        ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.dp_forward_launch.restype = i32
        lib.dp_forward_launch.argtypes = [ptr] * 3 + [ll] * 2 + [i32] * 4 \
            + [ptr]
        lib.dp_backtrace_launch.restype = i32
        lib.dp_backtrace_launch.argtypes = [ptr] * 4 + [ll] * 2 + [ptr]
        lib.dp_empty_step_launch.restype = i32
        lib.dp_empty_step_launch.argtypes = [ll] + [i32] * 3 + [ptr] * 2
        _lib = lib
    return _lib


def forward_config(d, cluster=None, threads=None, lanes=None, npass=None):
    """(cluster, threads, lanes, npass) of dp_forward's launch at width d.
    The cluster doubles with every CTA_LANES lanes up to MAX_CLUSTER; a
    thread takes the fewest lanes that keep its CTA at CTA_THREADS threads
    or fewer (measured: more threads of fewer lanes beat fewer of more).
    npass is 0 for the kernel that keeps the row in shared memory; widths
    above MAX_CLUSTER x MAX_THREADS x 9 take the wide kernel, each CTA
    npass passes over its slice. Given values are kept (npass > 0 asks for
    the wide kernel at any width)."""
    if cluster is None:
        cluster = 1
        while cluster < MAX_CLUSTER and d > cluster * CTA_LANES:
            cluster *= 2
    if cluster not in (1, 2, 4, 8, 16):
        raise ValueError(f"dp_forward: cluster {cluster} is no power of two "
                         f"up to {MAX_CLUSTER}")
    piece = -(-d // cluster)
    if npass is None:
        wide = lanes is None and threads is None \
            and piece > MAX_THREADS * WIDE_LANES
    else:
        wide = npass > 0
    if wide:
        threads, lanes = threads or MAX_THREADS, lanes or WIDE_LANES
        npass = npass or -(-piece // (threads * lanes))
    else:
        npass = 0
        if lanes is None:
            limit = threads or CTA_THREADS
            lanes = next((ln for ln in LANES if -(-piece // ln) <= limit),
                         LANES[-1])
        if threads is None:
            threads = 32 * -(-piece // (32 * lanes))
    if lanes not in ((WIDE_LANES,) if wide else LANES) or threads % 32 \
            or not 32 <= threads <= MAX_THREADS \
            or cluster * threads * lanes * max(npass, 1) < d:
        raise ValueError(f"dp_forward: {cluster} CTAs x {threads} threads x "
                         f"{lanes} lanes x {max(npass, 1)} passes cannot "
                         f"take width {d}")
    return cluster, threads, lanes, npass


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(shape)} {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_map(name, rows):
    if rows.dim() != 2 or rows.shape[0] < 1 \
            or rows.shape[1] <= COARSE_PER_BLOCK:
        raise ValueError(f"{name} is {tuple(rows.shape)}, expected (n >= 1, "
                         f"D > {COARSE_PER_BLOCK})")


def _launched(wrapper, rc):
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {rc}")
    with _count_lock:
        wrapper.launches += 1


def dp_forward(prev, scores, config=None):
    """Cost rows of the max-plus DP. prev: (D,) f32, the cost row before
    the first step; scores: (n, D) f32. Returns rows (n, D) f32 with
    rows[r] = relax(rows[r - 1]) + scores[r] (rows[-1] = prev). config:
    (cluster, threads, lanes, npass) for forward_config, None entries
    chosen from the width (for measurements; CUDA only)."""
    _check_map('dp_forward: scores', scores)
    dev = scores.device
    _check('dp_forward: scores', scores, scores.shape, torch.float32, dev)
    _check('dp_forward: prev', prev, scores.shape[1:], torch.float32, dev)
    if dev.type == 'cpu':
        return dp_forward_plain(prev, scores)
    if dev.type != 'cuda':
        raise ValueError(f"dp_forward: unsupported device {dev}")
    shape = forward_config(scores.shape[1], *(config or ()))
    lib = load_library()
    rows = torch.empty_like(scores)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dp_forward_launch(prev.data_ptr(), scores.data_ptr(),
                                   rows.data_ptr(), scores.shape[0],
                                   scores.shape[1], *shape, stream)
    _launched(dp_forward, rc)
    dp_forward.cluster, dp_forward.config = shape[0], shape
    return rows


dp_forward.launches = 0
dp_forward.cluster = None       # CTAs in the last launch's cluster
dp_forward.config = None        # its (cluster, threads, lanes, npass)


def dp_backtrace(o_last, rows):
    """Backtrace over the cost rows. rows: (n, D) f32. o_last: a 0-dim i64
    tensor on the rows' device, the lane chosen for the step after the last
    row, or None when the last row is the DP's last: then path[n - 1] is
    its first maximal lane. Returns path (n,) i64, path[r] the predecessor
    lane given rows[r]; path[0] hands over to the rows before."""
    _check_map('dp_backtrace: rows', rows)
    dev = rows.device
    _check('dp_backtrace: rows', rows, rows.shape, torch.float32, dev)
    if o_last is not None:
        _check('dp_backtrace: o_last', o_last, (), torch.int64, dev)
    if dev.type == 'cpu':
        return dp_backtrace_plain(o_last, rows)
    if dev.type != 'cuda':
        raise ValueError(f"dp_backtrace: unsupported device {dev}")
    lib = load_library()
    n = rows.shape[0]
    path = torch.empty(n, dtype=torch.int64, device=dev)
    # the pre-pass's row maxima (f32) and their first lanes (i32)
    scratch = torch.empty(2 * n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dp_backtrace_launch(
            None if o_last is None else o_last.data_ptr(), rows.data_ptr(),
            path.data_ptr(), scratch.data_ptr(), n, rows.shape[1], stream)
    _launched(dp_backtrace, rc)
    return path


dp_backtrace.launches = 0


def empty_step_ms(steps, cluster, threads, cta_barriers=2):
    """Milliseconds of `steps` empty steps of dp_forward's cluster on the
    current CUDA device: the 10-lane halo, the three-number exchange and
    the cluster barrier, plus cta_barriers __syncthreads per step, with no
    arithmetic. steps times this step is what the sequential scan cannot go
    below at that launch shape."""
    lib = load_library()
    sink = torch.empty(MAX_CLUSTER, dtype=torch.float32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.dp_empty_step_launch(steps, cluster, threads, cta_barriers,
                                      sink.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"empty_step_ms kernel launch failed: CUDA "
                               f"error {rc}")
    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def guard_rows(n, d, seed):
    """(n, D) f32 numpy cost rows for checks of dp_backtrace's guard, and
    how many of them trip it: rows of -1e30, rows with maxima around and
    above WINDOW_LIMIT, ordinary rows between."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = (rng.integers(0, 24, (n, d)) / 8).astype(np.float32)
    kind = rng.integers(0, 4, n)
    rows[kind == 0] = -1e30
    rows[kind == 1] *= np.float32(2.0 ** 21)
    rows[kind == 2] += np.float32(WINDOW_LIMIT)
    return rows, int((np.abs(rows.max(1)) >= WINDOW_LIMIT).sum())


def dp_work(n, d):
    """Bytes the two kernels must move for an (n, D) map: (dp_forward reads
    prev and the scores and writes the rows, dp_backtrace reads the rows
    and writes the path)."""
    return (2 * n * d + d) * 4, n * d * 4 + n * 8


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _dp_relax(prev, slope, floor):
    """One max-plus relaxation: shift by the nominal 10-lane advance, exact
    |.| distance transform by two running cummax passes, capped by a flat
    jump. slope = DP_SLOPE_COST * lane (exact in f32, as in the JAX DP);
    floor = the (10,) -1e30 row shifted in."""
    prev10 = torch.cat([floor, prev[:-COARSE_PER_BLOCK]])
    fwd = torch.cummax(prev10 + slope, 0).values - slope
    bwd = torch.cummax((prev10 - slope).flip(0), 0).values.flip(0) + slope
    return torch.maximum(torch.maximum(fwd, bwd),
                         torch.max(prev) - DP_JUMP_COST)


def _dp_backstep(o_next, cost_prev, lanes):
    """Predecessor lane of o_next given the previous cost row (move vs
    jump; argmax takes the first maximal lane, as jnp.argmax)."""
    moved = cost_prev - DP_SLOPE_COST * torch.abs(
        lanes - (o_next - COARSE_PER_BLOCK).float())
    jumped = torch.max(cost_prev) - DP_JUMP_COST
    return torch.where(torch.max(moved) >= jumped, torch.argmax(moved),
                       torch.argmax(cost_prev))


def dp_forward_plain(prev, scores):
    """dp_forward as a torch loop (matching.py:225-238, 263-269 of the JAX
    package)."""
    n, d = scores.shape
    dev = scores.device
    slope = DP_SLOPE_COST * torch.arange(d, dtype=torch.float32, device=dev)
    floor = torch.full((COARSE_PER_BLOCK,), NEG, device=dev)
    rows = torch.empty_like(scores)
    for r in range(n):
        prev = _dp_relax(prev, slope, floor) + scores[r]
        rows[r] = prev
    return rows


def dp_backtrace_plain(o_last, rows):
    """dp_backtrace as a torch loop (matching.py:241-249, 271-280 of the
    JAX package)."""
    n, d = rows.shape
    dev = rows.device
    lanes = torch.arange(d, dtype=torch.float32, device=dev)
    path = torch.empty(n, dtype=torch.int64, device=dev)
    first = n - 1
    if o_last is None:
        o_last = torch.argmax(rows[-1])
        path[-1] = o_last
        first = n - 2
    for r in range(first, -1, -1):
        o_last = _dp_backstep(o_last, rows[r], lanes)
        path[r] = o_last
    return path
