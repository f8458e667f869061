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
in numpy. dp_forward: the cluster's slices for sizes 1, 2, 4, 8 and 16, the
read at offset -10 behind the left neighbour's 10-lane halo, the three
aggregates taken from the row before with the +10 fold (the forward one
without the slice's last 10 lanes for the right neighbour, their backward
one kept by the CTA itself), the thread chains, warp scans and warp totals;
the wide kernel's passes. dp_backtrace: the row pre-pass's strided (value,
lane) pairs and xor trees, the lower lane winning ties, the 5-lane window
and its guard. Both must equal the plain versions bit for bit.
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

ROWMAX_THREADS = 256                      # csrc/coarse_dp.cu
WINDOW, WINDOW_LIMIT = 2, coarse_dp.WINDOW_LIMIT
NINF = np.float32(-np.inf)
HALF = np.float32(0.5)


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

def _cta_scan(ta, tb):
    """block_scan: (cluster, threads) thread aggregates to the exclusive
    prefix maximum of ta and the exclusive suffix maximum of tb in thread
    order, by warps: a scan inside each warp, then the warps' totals."""
    c = ta.shape[0]
    wa = np.maximum.accumulate(ta.reshape(c, -1, 32), axis=2)
    wb = np.maximum.accumulate(tb.reshape(c, -1, 32)[:, :, ::-1],
                               axis=2)[:, :, ::-1]
    ea = np.concatenate([np.full_like(wa[:, :, :1], NINF), wa[:, :, :-1]], 2)
    eb = np.concatenate([wb[:, :, 1:], np.full_like(wb[:, :, :1], NINF)], 2)
    tot_a, tot_b = wa[:, :, -1], wb[:, :, 0]            # (cluster, warps)
    nw = tot_a.shape[1]
    for w in range(nw):
        ea[:, w] = np.maximum(ea[:, w], tot_a[:, :w].max(1, initial=NINF)
                              [:, None])
        eb[:, w] = np.maximum(eb[:, w], tot_b[:, w + 1:].max(1, initial=NINF)
                              [:, None])
    return (ea.reshape(c, -1), eb.reshape(c, -1), tot_a.max(1), tot_b.max(1))


def _emulate_forward(prev, scores, cluster, threads, lanes):
    """dp_forward_kernel<lanes>: CTA q owns lanes [q S, (q + 1) S), S =
    threads x lanes, thread t of it `lanes` consecutive ones."""
    n, d = scores.shape
    s_cta = threads * lanes
    span = cluster * s_cta
    assert span >= d
    j = np.arange(span).reshape(cluster, s_cta)
    slope = HALF * j.astype(np.float32)
    fold = HALF * (j + 10).astype(np.float32)
    tail = np.arange(s_cta) >= s_cta - 10

    def padded(row):
        v = np.full(span, NINF, np.float32)
        v[:d] = row
        return v.reshape(cluster, s_cta)

    def publish(v):
        """The slices behind their halos, and what each CTA receives."""
        halo = np.concatenate([np.full((1, 10), -1e30, np.float32),
                               v[:-1, s_cta - 10:]])
        fa = np.where(j + 10 < d, v + fold, NINF)
        fb = np.where(j + 10 < d, v - fold, NINF)
        a_head = fa[:, ~tail].max(1)
        a_full = np.maximum(a_head, fa[:, tail].max(1))
        carry_f = np.full(cluster, NINF, np.float32)
        carry_b = fb[:, tail].max(1)             # the CTA's own last lanes
        for q in range(cluster):
            for p in range(q):
                carry_f[q] = max(carry_f[q],
                                 a_head[p] if q == p + 1 else a_full[p])
            carry_b[q] = max(carry_b[q], fb[q + 1:].max(initial=NINF))
        # lanes 0..9 of prev10 lie left of every later CTA
        carry_f[1:] = np.maximum(carry_f[1:],
                                 np.float32(-1e30) + np.float32(4.5))
        return (np.concatenate([halo, v], 1), carry_f, carry_b,
                np.float32(v.max() - np.float32(1.0)))

    rows = np.empty_like(scores)
    state = publish(padded(prev))
    for r in range(n):
        sl, carry_f, carry_b, jump = state
        p = np.where(j < d, sl[:, :s_cta], NINF)   # the read at offset -10
        shape = (cluster, threads, lanes)
        f = np.maximum.accumulate((p + slope).reshape(shape), axis=2)
        b = np.maximum.accumulate((p - slope).reshape(shape)[:, :, ::-1],
                                  axis=2)[:, :, ::-1]
        ea, eb, _, _ = _cta_scan(f[:, :, -1], b[:, :, 0])
        cf = np.maximum(ea, carry_f[:, None])[:, :, None]
        cb = np.maximum(eb, carry_b[:, None])[:, :, None]
        s3 = slope.reshape(shape)
        best = np.maximum(np.maximum(np.maximum(f, cf) - s3,
                                     np.maximum(b, cb) + s3), jump)
        v = np.where(j < d, best.reshape(cluster, s_cta) + padded(scores[r]),
                     NINF)
        rows[r] = v.reshape(span)[:d]
        state = publish(v)
    return rows


def _emulate_forward_wide(prev, scores, cluster, threads, npass):
    """dp_forward_wide_kernel: CTA q owns npass passes of threads x 9
    lanes; aggregates in prev10's own lanes, the row read back whole."""
    n, d = scores.shape
    lanes = coarse_dp.WIDE_LANES
    span = cluster * npass * threads * lanes
    assert span >= d
    shape = (cluster, npass, threads, lanes)
    j = np.arange(span).reshape(shape)
    slope = HALF * j.astype(np.float32)
    rows = np.empty_like(scores)
    for r in range(n):
        p = np.full(span, NINF, np.float32)
        p[:10] = np.float32(-1e30)
        p[10:d] = prev[:d - 10]
        p = p.reshape(shape)
        own = np.full(span, NINF, np.float32)
        own[:d] = prev
        a, b = p + slope, p - slope
        pass_a, pass_b = a.max((2, 3)), b.max((2, 3))     # (cluster, npass)
        agg_a, agg_b = pass_a.max(1), pass_b.max(1)
        jump = np.float32(own.reshape(cluster, -1).max(1).max()
                          - np.float32(1.0))
        out = np.empty(shape, np.float32)
        for k in range(npass):
            f = np.maximum.accumulate(a[:, k], axis=2)
            bw = np.maximum.accumulate(b[:, k][:, :, ::-1],
                                       axis=2)[:, :, ::-1]
            ea, eb, tot_a, _ = _cta_scan(f[:, :, -1], bw[:, :, 0])
            np.testing.assert_array_equal(tot_a, pass_a[:, k])
            for q in range(cluster):
                run_f = max(agg_a[:q].max(initial=NINF),
                            pass_a[q, :k].max(initial=NINF))
                suffix = max(pass_b[q, k + 1:].max(initial=NINF),
                             agg_b[q + 1:].max(initial=NINF))
                cf = np.maximum(ea[q], run_f)[:, None]
                cb = np.maximum(eb[q], suffix)[:, None]
                out[q, k] = np.maximum(np.maximum(
                    np.maximum(f[q], cf) - slope[q, k],
                    np.maximum(bw[q], cb) + slope[q, k]), jump)
        prev = out.reshape(span)[:d] + scores[r]
        rows[r] = prev
    return rows


def _better(v, i, ov, oi):
    take = (ov > v) | ((ov == v) & (oi < i))
    return np.where(take, ov, v), np.where(take, oi, i)


def _strided_argmax(vals, lanes, threads):
    """First-index argmax of vals (at the given lane numbers) the way the
    kernels reduce it: per thread over its strided elements with a strict
    >, then an xor tree over each warp's 32 threads, then the same tree
    over the warps."""
    pad = -len(vals) % threads
    v = np.concatenate([vals, np.full(pad, NINF)]).reshape(-1, threads)
    at = np.concatenate([lanes, np.full(pad, 2**31 - 1)]).reshape(-1, threads)
    best_v = np.full(threads, NINF, np.float32)
    best_i = np.full(threads, 2**31 - 1, np.int64)
    for c in range(v.shape[0]):
        take = v[c] > best_v
        best_v = np.where(take, v[c], best_v)
        best_i = np.where(take, at[c], best_i)
    while best_v.size > 1:
        if best_v.size < 32:                    # fewer than 32 warps
            fill = 32 - best_v.size
            best_v = np.concatenate([best_v, np.full(fill, NINF)])
            best_i = np.concatenate([best_i, np.full(fill, 2**31 - 1)])
        best_v, best_i = best_v.reshape(-1, 32), best_i.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):
            other = np.arange(32) ^ off
            best_v, best_i = _better(best_v, best_i, best_v[:, other],
                                     best_i[:, other])
        best_v, best_i = best_v[:, 0], best_i[:, 0]
    return np.float32(best_v[0]), int(best_i[0])


def _block_argmax(vals):
    """dp_rowmax_kernel on one row."""
    return _strided_argmax(vals, np.arange(len(vals)), ROWMAX_THREADS)


def _emulate_backtrace(o_last, rows, stats=None):
    """The row pre-pass, then the one-warp walk: a 5-lane window around
    o - 10, the whole row where the row's maximum trips the guard."""
    n, d = rows.shape
    pre = [_block_argmax(row) for row in rows]
    path = np.empty(n, np.int64)
    r = n - 1
    if o_last is None:
        o = path[r] = pre[r][1]
        r -= 1
    else:
        o = int(o_last)
    for r in range(r, -1, -1):
        top, arg = pre[r]
        c = o - 10
        if abs(top) < WINDOW_LIMIT:
            lanes = np.arange(max(c - WINDOW, 0), min(c + WINDOW + 1, d))
        else:
            lanes = np.arange(d)
            if stats is not None:
                stats["guard"] = stats.get("guard", 0) + 1
        moved = rows[r][lanes] - HALF * np.abs(
            lanes.astype(np.float32) - np.float32(c))
        mv, mi = _strided_argmax(moved, lanes, 32)
        o = mi if mv >= np.float32(top - np.float32(1.0)) else arg
        path[r] = o
    return path


# (kind, n, D, seed, forced (cluster, threads, lanes) or None for the
# wrapper's own choice): every cluster size, a D smaller than the cluster,
# slices that end inside a warp, one lane and nine lanes per thread
DECOMPOSITIONS = [(*m, None) for m in MAPS] + [
    ("plateau", 3, 17500, 6, None), ("suppressed", 4, 2047, 8, None),
    ("suppressed", 12, 11, 9, (16, 32, 1)),
    ("plateau", 9, 700, 10, (2, 128, 3)), ("random", 9, 701, 11, (4, 64, 3)),
    ("suppressed", 9, 1093, 12, (8, 32, 5)),
    ("plateau", 6, 2047, 13, (16, 32, 7)),
    ("suppressed", 5, 4000, 14, (1, 448, 9)),
    ("plateau", 5, 300, 15, (16, 32, 1)), ("suppressed", 3, 61438, 16, None)]


@pytest.mark.parametrize("kind,n,d,seed,config", DECOMPOSITIONS)
def test_kernel_decomposition_matches_plain(kind, n, d, seed, config):
    scores = _map(kind, n, d, seed)
    rng = np.random.default_rng(seed + 50)
    prev = (rng.integers(0, 400, d) / 8).astype(np.float32)
    rows = coarse_dp.dp_forward_plain(torch.from_numpy(prev),
                                      torch.from_numpy(scores))
    cluster, threads, lanes, npass = coarse_dp.forward_config(
        d, *(config or ()))
    assert npass == 0
    np.testing.assert_array_equal(
        _emulate_forward(prev, scores, cluster, threads, lanes), rows.numpy())
    for o_last in (None, torch.tensor(int(rng.integers(0, d)))):
        want = coarse_dp.dp_backtrace_plain(o_last, rows)
        np.testing.assert_array_equal(
            _emulate_backtrace(o_last, rows.numpy()), want.numpy())


@pytest.mark.parametrize("kind,n,d,seed,cluster,npass", [
    ("suppressed", 5, 9000, 21, 16, 2), ("plateau", 4, 2500, 22, 2, 5),
    ("random", 4, 11, 23, 4, 1), ("suppressed", 4, 5759, 24, 4, 5)])
def test_wide_kernel_decomposition_matches_plain(kind, n, d, seed, cluster,
                                                 npass):
    scores = _map(kind, n, d, seed)
    rng = np.random.default_rng(seed + 50)
    prev = (rng.integers(0, 400, d) / 8).astype(np.float32)
    rows = coarse_dp.dp_forward_plain(torch.from_numpy(prev),
                                      torch.from_numpy(scores))
    config = coarse_dp.forward_config(d, cluster, 32, None, npass)
    assert config == (cluster, 32, coarse_dp.WIDE_LANES, npass)
    np.testing.assert_array_equal(
        _emulate_forward_wide(prev, scores, cluster, 32, npass), rows.numpy())


def test_forward_config_follows_the_width():
    """The cluster grows with the width, a CTA stays at 768 threads or
    fewer until a thread holds 9 lanes, and every shape covers its width."""
    cfg = coarse_dp.forward_config
    assert cfg(11) == (1, 32, 1, 0)
    assert cfg(1024)[0] == 1 and cfg(1025)[0] == 2 and cfg(8193)[0] == 16
    assert cfg(16638) == (16, 352, 3, 0)          # the bench pair's map
    assert cfg(61438) == (16, 768, 5, 0)          # the 95-minute film's
    assert cfg(16 * 1024 * 9) == (16, 1024, 9, 0)
    assert cfg(16 * 1024 * 9 + 1) == (16, 1024, 9, 2)
    assert cfg(12_000_000)[3] == 82
    for d in (11, 33, 513, 4097, 20000, 100000, 147457, 3_000_000):
        c, t, ln, npass = cfg(d)
        assert c * t * ln * max(npass, 1) >= d and t % 32 == 0 and t <= 1024
    assert cfg(16638, 8) == (8, 704, 3, 0)
    with pytest.raises(ValueError, match="cannot take width"):
        cfg(16638, 2, 64, 3)
    with pytest.raises(ValueError, match="power of two"):
        cfg(100, 3)


def _walk_case(row_values, o):
    """One backstep on one row through the emulation and the plain loop."""
    rows = np.asarray(row_values, np.float32)[None, :]
    o_t = torch.tensor(o)
    want = coarse_dp.dp_backtrace_plain(o_t, torch.from_numpy(rows))
    stats = {}
    got = _emulate_backtrace(o_t, rows, stats)
    np.testing.assert_array_equal(got, want.numpy())
    return int(got[0]), stats.get("guard", 0)


@pytest.mark.parametrize("case", ["clipped at lane 0", "left of lane 0",
                                  "clipped at D - 1", "ties in the window",
                                  "jump beats the window", "all -1e30",
                                  "maximum at 2^22", "D below the cluster"])
def test_backtrace_window_and_guard(case):
    d = 64
    flat = np.zeros(d, np.float32)
    if case == "clipped at lane 0":              # o < 12: window [0, c + 2]
        row = flat.copy()
        row[[0, 1, 2]] = 3.0
        assert _walk_case(row, 11) == (1, 0)     # c = 1: lane 1 costs nothing
        assert _walk_case(row, 10) == (0, 0)
    elif case == "left of lane 0":               # c + 2 < 0: no window lane
        row = flat.copy()
        row[5] = 2.0
        assert _walk_case(row, 3) == (5, 0)
    elif case == "clipped at D - 1":
        row = flat.copy()
        row[d - 1] = 3.0
        assert _walk_case(row, d - 1 + 10 + 2) == (d - 1, 0)   # c = D + 1
        assert _walk_case(row, d - 1 + 10) == (d - 1, 0)
    elif case == "ties in the window":           # equal moved values: lower
        row = flat.copy()
        row[[29, 31]] = 0.5                      # c = 30: 0, 0.5-0.5, 0, ...
        assert _walk_case(row, 40) == (29, 0)
        row[28] = 1.0                            # 1 - 1 = 0 ties too
        assert _walk_case(row, 40) == (28, 0)
    elif case == "jump beats the window":
        row = flat.copy()
        row[50] = 1.25                           # window max 0 < 1.25 - 1
        assert _walk_case(row, 40) == (50, 0)
        row[50] = 1.0                            # 0 >= 1 - 1: the move stays
        assert _walk_case(row, 40) == (30, 0)
    elif case == "all -1e30":                    # x - 1 == x: the whole row
        row = np.full(d, -1e30, np.float32)
        assert _walk_case(row, 40) == (0, 1)     # every moved value ties
        row[7] = np.float32(-1e30) * np.float32(1 - 2.0 ** -20)
        assert _walk_case(row, 40)[1] == 1
    elif case == "maximum at 2^22":
        for top, guarded in ((2.0 ** 22, 1), (2.0 ** 22 - 0.25, 0),
                             (-2.0 ** 23, 1)):
            row = np.full(d, top - 1.5 if top > 0 else top, np.float32)
            row[3] = top
            row[37] = np.float32(top) - np.float32(1.0)
            assert _walk_case(row, 40)[1] == guarded
    else:                                        # D = 11 on a 16-CTA cluster
        scores = _map("plateau", 8, 11, 31)
        rows = coarse_dp.dp_forward_plain(torch.zeros(11),
                                          torch.from_numpy(scores))
        np.testing.assert_array_equal(
            _emulate_forward(np.zeros(11, np.float32), scores, 16, 32, 1),
            rows.numpy())
        for o in range(11):
            want = coarse_dp.dp_backtrace_plain(torch.tensor(o), rows)
            np.testing.assert_array_equal(
                _emulate_backtrace(torch.tensor(o), rows.numpy()),
                want.numpy())


@pytest.mark.parametrize("kind", ["random", "plateau", "suppressed",
                                  "floor"])
def test_backtrace_window_sweep(kind):
    """150 maps of each kind, D 11-400, with and without a given last
    lane: the windowed walk equals the plain loop; the floor maps (rows of
    -1e30 after suppression) go through the guard."""
    rng = np.random.default_rng({"random": 1, "plateau": 2, "suppressed": 3,
                                 "floor": 4}[kind])
    guards = 0
    for run in range(150):
        d = int(rng.integers(11, 401))
        n = int(rng.integers(1, 13))
        if kind == "floor":
            rows = _map("plateau", n, d, 1000 + run)
            rows[rng.random(n) < 0.6] = -1e30
            if run % 3 == 0:
                rows *= np.float32(2.0 ** 21)    # maxima around 2^22
        else:
            scores = _map(kind, n, d, 1000 + run)
            rows = coarse_dp.dp_forward_plain(
                torch.zeros(d), torch.from_numpy(scores)).numpy()
        o_last = None if run % 2 else torch.tensor(int(rng.integers(0, d)))
        want = coarse_dp.dp_backtrace_plain(o_last, torch.from_numpy(rows))
        stats = {}
        np.testing.assert_array_equal(
            _emulate_backtrace(o_last, rows, stats), want.numpy())
        guards += stats.get("guard", 0)
    assert (guards > 100) == (kind == "floor")


def test_guard_rows_trip_the_guard():
    """The rows the card's checks use: most trip the guard, and the walk
    through them equals the plain loop."""
    rows, tripped = coarse_dp.guard_rows(40, 300, 5)
    assert rows.dtype == np.float32 and 15 <= tripped < 40
    for o_last in (None, torch.tensor(100)):
        stats = {}
        got = _emulate_backtrace(o_last, rows, stats)
        want = coarse_dp.dp_backtrace_plain(o_last, torch.from_numpy(rows))
        np.testing.assert_array_equal(got, want.numpy())
        assert stats["guard"] >= tripped - 1


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
