"""Port parity: the coarse DP's two steps (ops/coarse_dp.py), JAX vs torch
on the CPU, and the CUDA kernels' decomposition emulated in numpy.

The DP is max-plus: max is exact in any order, every add and subtract is
one f32 rounding and 0.5 * lane is exact, so the plain versions must equal
the JAX package's `_coarse_dp` bit for bit on the same score map - cost
rows, paths and scores, tolerance 0. What can differ is tie order, so the
maps here are made to tie: scores on a 1/8 grid, a suppressed band of
-1e30, repeated rows, widths that are no multiple of a warp or a sub-tile,
and a single-row map.

The kernels (csrc/coarse_dp.cu) cannot run here. Their decomposition does,
in numpy: dp_forward's warp ranges, 544-lane sub-tiles, 17-lane thread
segments, thread aggregates, exclusive warp scans, sub-tile suffix maxima
and cross-warp carries; dp_backtrace's per-thread strided (value, lane)
pairs, xor-tree warp reduction and second reduction over the warps, the
lower lane winning ties. Both must equal the plain versions bit for bit.
"""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from describealign_tpu.alignment import matching as jm
from describealign_tpu_torch.alignment import matching as tm
from describealign_tpu_torch.ops import coarse_dp

THREADS, WARPS, T = 1024, 32, 17          # csrc/coarse_dp.cu
SUB = 32 * T


def _map(kind, n, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((n, d)).astype(np.float32)
    m = (rng.integers(0, 24, (n, d)) / 8).astype(np.float32)   # plateaus
    if kind == "suppressed":
        lanes = np.arange(d)[None, :]
        diag = (np.arange(n) * 10 % (d - 1))[:, None]
        m[np.abs(lanes - diag) <= tm.SUPPRESS_LANES] = -1e30
        m[n // 2:n // 2 + 3] = m[n // 2]
    return m


MAPS = [("random", 40, 700, 1), ("plateau", 33, 701, 2),
        ("suppressed", 37, 1093, 3), ("plateau", 1, 257, 4),
        ("suppressed", 12, 11, 5)]


def _jax_rows(p_map):
    """The JAX DP's cost rows, one _dp_relax at a time."""
    d = p_map.shape[1]
    prev = jnp.zeros((d,), jnp.float32)
    rows = []
    for row in p_map:
        prev = jm._dp_relax(prev, d) + jnp.asarray(row)
        rows.append(np.asarray(prev))
    return np.stack(rows)


@pytest.mark.parametrize("kind,n,d,seed", MAPS)
def test_plain_dp_matches_jax_bit_for_bit(kind, n, d, seed):
    p_map = _map(kind, n, d, seed)
    t_map = torch.from_numpy(p_map)
    rows = coarse_dp.dp_forward_plain(torch.zeros(d), t_map)
    np.testing.assert_array_equal(rows.numpy(), _jax_rows(p_map))
    path = coarse_dp.dp_backtrace_plain(None, rows)
    j_path, j_score = jm._coarse_dp(jnp.asarray(p_map))
    np.testing.assert_array_equal(path.numpy(), np.asarray(j_path))
    assert float(rows[-1][path[-1]]) == float(j_score)
    # the composed port DP is these two calls
    t_path, t_score = tm._coarse_dp(t_map)
    assert torch.equal(t_path, path.to(torch.int32))
    assert float(t_score) == float(j_score)


def test_backtrace_hand_over_between_tiles():
    """A map walked in tiles, each backtrace starting from the lane the
    tile after it chose, gives the whole map's path (the streamed DP's
    hand-over); the JAX backstep agrees on the hand-over row."""
    p_map = _map("suppressed", 50, 900, 7)
    rows = coarse_dp.dp_forward_plain(torch.zeros(900),
                                      torch.from_numpy(p_map))
    whole = coarse_dp.dp_backtrace_plain(None, rows)
    tail = coarse_dp.dp_backtrace_plain(None, rows[30:])
    head = coarse_dp.dp_backtrace_plain(tail[0], rows[:30])
    assert torch.equal(torch.cat([head, tail]), whole)
    j_o = jm._dp_backstep(jnp.asarray(int(tail[0])),
                          jnp.asarray(rows[29].numpy()), 900)
    assert int(j_o) == int(head[-1])
    # the forward pass hands over the same way
    again = coarse_dp.dp_forward_plain(rows[29], torch.from_numpy(p_map[30:]))
    assert torch.equal(again, rows[30:])


# ---------------------------------------------------------------------------
# The kernels' decomposition, in numpy
# ---------------------------------------------------------------------------

def _emulate_forward(prev, scores):
    """dp_forward_kernel: warp w owns lanes [w nsub SUB, (w+1) nsub SUB),
    sub-tile k of it 544 lanes, thread l of the warp T consecutive ones."""
    n, d = scores.shape
    nsub = -(-(-(-d // WARPS)) // SUB)
    span = WARPS * nsub * SUB
    j = np.arange(span).reshape(WARPS, nsub, 32, T)
    s = np.float32(0.5) * j.astype(np.float32)
    ninf = np.float32(-np.inf)
    rows = np.empty_like(scores)
    for r in range(n):
        p = np.full(span, ninf, np.float32)          # lanes past D: -inf
        p[:10] = np.float32(-1e30)
        p[10:d] = prev[:d - 10]
        p = p.reshape(j.shape)
        a, b = p + s, p - s
        ta, tb = a.max(-1), b.max(-1)                # thread aggregates
        sub_a, sub_b = ta.max(-1), tb.max(-1)        # (warp, sub-tile)
        agg_a, agg_b = sub_a.max(-1), sub_b.max(-1)  # shared memory, by warp
        carry_f = np.array([agg_a[:w].max(initial=ninf)
                            for w in range(WARPS)], np.float32)
        carry_b = np.array([agg_b[w + 1:].max(initial=ninf)
                            for w in range(WARPS)], np.float32)
        jump = np.float32(prev.max() - np.float32(1.0))
        out = np.empty(j.shape, np.float32)
        for w in range(WARPS):
            cf_warp = carry_f[w]
            for k in range(nsub):
                suf_b = sub_b[w, k + 1:].max(initial=ninf)
                # exclusive scans of the 32 thread aggregates
                ex_a = np.concatenate([[ninf], np.maximum.accumulate(
                    ta[w, k])[:-1]]).astype(np.float32)
                ex_b = np.concatenate([np.maximum.accumulate(
                    tb[w, k][::-1])[::-1][1:], [ninf]]).astype(np.float32)
                cf = np.maximum(ex_a, cf_warp)
                cb = np.maximum(ex_b, max(suf_b, carry_b[w]))
                bwd = np.maximum(np.maximum.accumulate(
                    b[w, k][:, ::-1], axis=1)[:, ::-1], cb[:, None]) + s[w, k]
                fwd = np.maximum(np.maximum.accumulate(a[w, k], axis=1),
                                 cf[:, None]) - s[w, k]
                out[w, k] = np.maximum(np.maximum(fwd, bwd), jump)
                cf_warp = max(cf_warp, sub_a[w, k])
        prev = out.reshape(span)[:d] + scores[r]
        rows[r] = prev
    return rows


def _better(v, i, ov, oi):
    take = (ov > v) | ((ov == v) & (oi < i))
    return np.where(take, ov, v), np.where(take, oi, i)


def _block_argmax(vals):
    """First-index argmax the way the kernel reduces it: per thread over
    lanes tid, tid + 1024, ... with a strict >, then an xor tree over each
    warp's 32 threads, then the same tree over the 32 warps."""
    d = vals.shape[0]
    pad = -d % THREADS
    v = np.concatenate([vals, np.full(pad, -np.inf, np.float32)])
    grid = v.reshape(-1, THREADS)
    best_v = np.full(THREADS, -np.inf, np.float32)
    best_i = np.full(THREADS, 2**31 - 1, np.int64)
    for c in range(grid.shape[0]):
        take = grid[c] > best_v
        best_v = np.where(take, grid[c], best_v)
        best_i = np.where(take, c * THREADS + np.arange(THREADS), best_i)
    for width in (THREADS, WARPS):
        best_v = best_v.reshape(-1, 32)
        best_i = best_i.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):
            other = np.arange(32) ^ off
            best_v, best_i = _better(best_v, best_i, best_v[:, other],
                                     best_i[:, other])
        best_v, best_i = best_v[:, 0], best_i[:, 0]
    return np.float32(best_v[0]), int(best_i[0])


def _emulate_backtrace(o_last, rows):
    n, d = rows.shape
    lanes = np.arange(d, dtype=np.float32)
    path = np.empty(n, np.int64)
    o = 0 if o_last is None else int(o_last)
    for r in range(n - 1, -1, -1):
        moved = rows[r] - np.float32(0.5) * np.abs(
            lanes - np.float32(o - 10))
        mv, mi = _block_argmax(moved)
        cv, ci = _block_argmax(rows[r])
        first = o_last is None and r == n - 1
        o = mi if (not first and mv >= np.float32(cv - np.float32(1.0))) \
            else ci
        path[r] = o
    return path


@pytest.mark.parametrize("kind,n,d,seed", MAPS + [("plateau", 3, 17500, 6),
                                                  ("suppressed", 4, 2047, 8)])
def test_kernel_decomposition_matches_plain(kind, n, d, seed):
    scores = _map(kind, n, d, seed)
    rng = np.random.default_rng(seed + 50)
    prev = (rng.integers(0, 400, d) / 8).astype(np.float32)
    rows = coarse_dp.dp_forward_plain(torch.from_numpy(prev),
                                      torch.from_numpy(scores))
    np.testing.assert_array_equal(_emulate_forward(prev, scores),
                                  rows.numpy())
    for o_last in (None, torch.tensor(int(rng.integers(0, d)))):
        want = coarse_dp.dp_backtrace_plain(o_last, rows)
        np.testing.assert_array_equal(
            _emulate_backtrace(o_last, rows.numpy()), want.numpy())


def test_argmax_reduction_prefers_the_lower_lane():
    vals = np.zeros(5000, np.float32)
    vals[[4100, 1030, 3000]] = 2.0            # equal maxima in three threads
    assert _block_argmax(vals) == (np.float32(2.0), 1030)
    assert _block_argmax(np.full(2500, -1e30, np.float32))[1] == 0


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    """CPU tensors never count a kernel launch; wrong shapes, types and
    devices raise before anything runs."""
    before = (coarse_dp.dp_forward.launches, coarse_dp.dp_backtrace.launches)
    scores = torch.from_numpy(_map("plateau", 6, 300, 9))
    rows = coarse_dp.dp_forward(torch.zeros(300), scores)
    assert torch.equal(rows, coarse_dp.dp_forward_plain(torch.zeros(300),
                                                        scores))
    path = coarse_dp.dp_backtrace(None, rows)
    assert path.dtype == torch.int64 and path.shape == (6,)
    assert torch.equal(coarse_dp.dp_backtrace(path[3], rows[:3]), path[:3])
    assert (coarse_dp.dp_forward.launches,
            coarse_dp.dp_backtrace.launches) == before
    with pytest.raises(ValueError, match="expected"):
        coarse_dp.dp_forward(torch.zeros(299), scores)
    with pytest.raises(ValueError, match="expected"):
        coarse_dp.dp_forward(torch.zeros(300), scores.double())
    with pytest.raises(ValueError, match="D > 10"):
        coarse_dp.dp_forward(torch.zeros(10), torch.zeros(4, 10))
    with pytest.raises(ValueError, match="contiguous"):
        coarse_dp.dp_backtrace(None, rows[:, ::2])
    with pytest.raises(ValueError, match="o_last"):
        coarse_dp.dp_backtrace(torch.tensor(3, dtype=torch.int32), rows)
    assert coarse_dp.dp_work(2, 100) == ((2 * 2 * 100 + 100) * 4,
                                         2 * 100 * 4 + 2 * 8)


def test_launch_counts_survive_concurrent_launches():
    """The batch path's retry launches kernels from pool threads: the
    count is taken under a lock, so no increment is lost."""
    before = coarse_dp.dp_forward.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [coarse_dp._launched(coarse_dp.dp_forward, 0)
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert coarse_dp.dp_forward.launches == before + 32000
    finally:
        sys.setswitchinterval(interval)
        coarse_dp.dp_forward.launches = before
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        coarse_dp._launched(coarse_dp.dp_forward, 700)
    assert coarse_dp.dp_forward.launches == before
