"""Port parity: the on-device L1 fit (alignment/fit_device.py, the ADMM of
ops/fit_kernel.py) against the JAX package's, on the CPU.

The JAX ADMM runs jitted (XLA on the CPU may contract a product and a sum
into one FMA); the port's plain version rounds each product and sum
alone, the order the CUDA kernel keeps on the card. So the ADMM's t agrees
to f32 rounding carried through 800 iterations of a solve that has not
fully settled (rtol 2e-4; measured up to 7.9e-5 against the vmapped JAX
program, 1.2e-5 against the single one), the breakpoint masks agree up to
a few edges whose z sits on the soft-threshold (none differ here), and the
fits built on them - each fused slope snapped to a weighted median - agree
in segment structure and slopes (equal on every case here) and in
smooth_y (within 0.05 frames, measured <= 0.006).

The kernel's tiling twin (a numpy emulation of csrc/fit_admm.cu: factors
computed once, in-place positions level by level, the strided thread
mapping, the per-problem global scratch) is bit-equal to the plain
version.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from describealign_tpu.alignment import fit as jfit
from describealign_tpu.alignment import fit_device as jfd
from describealign_tpu_torch.alignment import fit as tfit
from describealign_tpu_torch.alignment import fit_device as tfd
from describealign_tpu_torch.ops import fit_kernel as fk
from tests.test_fit import make_nodes

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_fit_device_expected.json")
T_RTOL = 2e-4           # ADMM t, relative
SMOOTH_ATOL = 0.05      # smooth_y, frames
MAX_BREAK_FLIPS = 2     # edges whose z != 0 differs between JAX and port


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in arrays]


@pytest.mark.parametrize("n", [16, 256, 4096])
def test_cr_solve_matches_jax(n):
    rng = np.random.default_rng(n)
    r2 = rng.uniform(0.1, 5.0, (n - 1,)).astype(np.float32)
    diag = (np.float32(1.3) + np.concatenate([[0], r2]).astype(np.float32)
            + np.concatenate([r2, [0]]).astype(np.float32))
    rhs = rng.normal(0, 3, n).astype(np.float32)
    want = np.asarray(jfd._cr_solve(jnp.asarray(diag), jnp.asarray(-r2),
                                    jnp.asarray(rhs)))
    got = tfd._cr_solve(*_tensors(diag, -r2, rhs)).numpy()
    # eager jnp ops round every product alone too: bit-equal here
    np.testing.assert_array_equal(got, want)
    # and it solves the system
    a = np.diag(diag.astype(np.float64)) - np.diag(r2, 1) - np.diag(r2, -1)
    np.testing.assert_allclose(a @ got, rhs, atol=1e-3 * np.abs(rhs).max())


def _stage1_problem(seed):
    x, y, _ = make_nodes(seed=seed)
    xd = np.diff(x)
    jc = jfit.compute_jump_costs(x, y)
    return (np.diff(y) / xd, np.minimum(2.0, jc) * xd,
            np.full(len(x) - 2, float(jfit.RATE_CHANGE_COST)))


def test_fused_lasso_admm_matches_jax():
    r, sc, k1 = _stage1_problem(0)
    n_pad = tfd.bucket(len(r))
    b_p, c_p, k_p, rho1, r2 = tfd._prep_problem(r, sc, k1, n_pad)
    tj, zj = jfd._fused_lasso_admm(jnp.asarray(b_p), jnp.asarray(c_p),
                                   jnp.asarray(k_p), rho1, jnp.asarray(r2))
    tp, zp = tfd._fused_lasso_admm(*_tensors(b_p[None], c_p[None],
                                             k_p[None], [rho1], r2[None]))
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(tj), rtol=T_RTOL)
    flips = int(np.sum((zp[0].numpy() != 0) != (np.asarray(zj) != 0)))
    assert flips <= MAX_BREAK_FLIPS, flips


def test_fused_lasso_l1_device_single_batched_and_jax():
    problems = [_stage1_problem(s) for s in (1, 2)]
    single = [tfd.fused_lasso_l1_device(*p, device="cpu") for p in problems]
    batched = tfd.fused_lasso_l1_device_batched(problems, device="cpu")
    want = jfd.fused_lasso_l1_device_batched(problems)
    for (ts, ms), (tb, mb), (tj, mj) in zip(single, batched, want):
        # one problem per launch or all in one: the same f32 operations
        np.testing.assert_array_equal(ts, tb)
        np.testing.assert_array_equal(ms, mb)
        np.testing.assert_allclose(tb, tj, rtol=T_RTOL)
        assert int(np.sum(mb != mj)) <= MAX_BREAK_FLIPS


def _assert_fits_agree(got, want):
    assert np.array_equal(np.unique(np.round(got['slopes'], 6)),
                          np.unique(np.round(want['slopes'], 6)))
    np.testing.assert_array_equal(got['slopes'], want['slopes'])
    np.testing.assert_allclose(got['smooth_y'], want['smooth_y'], rtol=0,
                               atol=SMOOTH_ATOL)
    assert abs(got['median_slope'] - want['median_slope']) < 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solve_l1_fit_device_matches_jax(seed):
    x, y, _ = make_nodes(seed=seed)
    got = tfit.solve_l1_fit(x, y, backend="device", device="cpu")
    _assert_fits_agree(got, jfit.solve_l1_fit(x, y, backend="device"))
    # tests/test_fit.py's bars against the exact LP (seeds 0 and 1) and on
    # the segment count (seed 3)
    if seed in (0, 1):
        ref = jfit.solve_l1_fit(x, y, backend="highs")
        assert abs(got['median_slope'] - ref['median_slope']) < 2e-2
        assert (len(np.unique(np.round(got['slopes'], 6)))
                == len(np.unique(np.round(ref['slopes'], 6))))
        err = np.abs(got['smooth_y'] - ref['smooth_y'])
        assert np.percentile(err, 90) < 1.0 and np.median(err) < 0.4
    if seed == 3:
        assert len(np.unique(np.round(got['slopes'], 6))) <= 25


@pytest.mark.parametrize("n", [3, 4, 10, 40])
def test_solve_l1_fit_device_tiny_node_counts(n):
    rng = np.random.default_rng(n)
    x = np.cumsum(rng.uniform(50, 200, n))
    y = x + 100 + rng.laplace(0, 0.3, n)
    got = tfit.solve_l1_fit(x, y, backend="device", device="cpu")
    assert np.isfinite(got["smooth_y"]).all()
    assert abs(got["median_slope"] - 1.0) < 0.05
    _assert_fits_agree(got, jfit.solve_l1_fit(x, y, backend="device"))


def test_solve_l1_fit_device_batched_equals_single():
    sets = [make_nodes(seed=s)[:2] for s in (0, 3)]
    batched = tfd.solve_l1_fit_device_batched(sets, device="cpu")
    for (x, y), b in zip(sets, batched):
        one = tfd.solve_l1_fit_device(x, y, device="cpu")
        for key in ("fit_err", "slopes", "smooth_y"):
            np.testing.assert_array_equal(b[key], one[key])
        assert b["median_slope"] == one["median_slope"]


def test_device_fit_nonconvergence_falls_back_to_native(monkeypatch,
                                                        capsys):
    x, y, _ = make_nodes(seed=1)

    def diverged(x, y, device='cuda'):
        return dict(fit_err=np.full(len(x), 1e3), slopes=np.ones(len(x) - 1),
                    median_slope=1.0, smooth_y=np.full(len(x), np.nan))

    monkeypatch.setattr(tfd, "solve_l1_fit_device", diverged)
    got = tfit.solve_l1_fit(x, y, backend="device", device="cpu")
    out = capsys.readouterr().out
    assert out == "  WARNING: device fit did not converge, using native...\n"
    native = tfit.solve_l1_fit(x, y, backend="native")
    for key in ("fit_err", "slopes", "smooth_y"):
        np.testing.assert_array_equal(got[key], native[key])
    # the JAX package prints the same line on the same condition
    monkeypatch.setattr(jfd, "solve_l1_fit_device", diverged)
    jfit.solve_l1_fit(x, y, backend="device")
    assert capsys.readouterr().out == out


def test_solve_l1_fit_default_alias_and_error_match_jax():
    """The public function's default is the JAX package's ('highs', the
    exact LP; it was 'native' in the port, another solver's answer), 'tv'
    is its alias of 'native', and an unknown backend raises the same
    error."""
    x, y, _ = make_nodes(seed=2)
    default = tfit.solve_l1_fit(x, y)
    highs = tfit.solve_l1_fit(x, y, backend="highs")
    native = tfit.solve_l1_fit(x, y, backend="native")
    for key in ("fit_err", "slopes", "smooth_y"):
        np.testing.assert_array_equal(default[key], highs[key])
        np.testing.assert_array_equal(default[key],
                                      jfit.solve_l1_fit(x, y)[key])
        np.testing.assert_array_equal(
            tfit.solve_l1_fit(x, y, backend="tv")[key], native[key])
    # the old default gave another answer on the same nodes
    assert not np.array_equal(default["smooth_y"], native["smooth_y"])
    with pytest.raises(ValueError) as port_err:
        tfit.solve_l1_fit(x, y, backend="lp")
    with pytest.raises(ValueError) as jax_err:
        jfit.solve_l1_fit(x, y, backend="lp")
    assert str(port_err.value) == str(jax_err.value)


def test_fit_admm_work_counts():
    nbytes, flops = fk.fit_admm_work(16, iters=1)
    assert nbytes == 4 * (2 * 16 + 2 * 15 + 1 + 16 + 15)
    assert flops == 5 * 16 + 2 * 15 + 4 * 15 + 1 + 5 * 15 + 11 * 16 + 11 * 15
    assert fk.fit_admm_work(4096)[1] == 800 * fk.fit_admm_work(4096, 1)[1]
    assert fk.steps_per_solve(4096) == 800 * 27
    assert fk.levels_of(16) == 4 and fk.levels_of(32768) == 15


def test_fused_lasso_admm_wrapper_checks():
    b = torch.zeros((1, 16))
    with pytest.raises(ValueError, match="power of two"):
        fk.fused_lasso_admm(torch.zeros((1, 24)), torch.zeros((1, 24)),
                            torch.zeros((1, 23)), torch.ones(1),
                            torch.ones((1, 23)))
    with pytest.raises(ValueError, match="rho1"):
        fk.fused_lasso_admm(b, b, torch.zeros((1, 15)), torch.ones(2),
                            torch.ones((1, 15)))
    with pytest.raises(ValueError, match="float32"):
        fk.fused_lasso_admm(b.double(), b, torch.zeros((1, 15)),
                            torch.ones(1), torch.ones((1, 15)))
    before = fk.fused_lasso_admm.launches
    fk.fused_lasso_admm(b, b, torch.zeros((1, 15)), torch.ones(1),
                        torch.ones((1, 15)), iters=2)
    assert fk.fused_lasso_admm.launches == before   # the CPU launches none


# ---------------------------------------------------------------------------
# The kernel's tiling twin
# ---------------------------------------------------------------------------

SLOTS = dict(B=0, CT=1, KT=2, R2=3, P=4, Z=5, A=6, E=7, D=8, WA=9, WB=10,
             WC=11, AL=12, GA=13)


def _soft32(v, thr):
    m = (np.abs(v) - thr).astype(np.float32)
    m = np.where(m < 0, np.float32(0), m)
    return np.where(v < 0, -m, m).astype(np.float32)


def admm_twin(b, c, k, rho1, rho2, iters, threads, shared_max_n=4096):
    """csrc/fit_admm.cu emulated in numpy f32: one CTA per problem of
    `threads` threads (thread tid takes j = tid, tid + threads, ... of a
    level), the 14 arrays in one per-problem buffer (a global scratch with
    per-problem offsets above shared_max_n), factors computed once, d
    reduced and back-substituted in place by position."""
    nb, n = b.shape
    levels = n.bit_length() - 1
    f32 = np.float32
    over, under = f32(fk.OVER_RELAX), f32(1 - fk.OVER_RELAX)
    scratch = np.full(nb * 14 * n, np.nan, np.float32)
    t_out = np.empty((nb, n), np.float32)
    z_out = np.empty((nb, n - 1), np.float32)

    def strided(count):
        """Items of one barrier step in the threads' order."""
        return [np.arange(m, min(m + threads, count))
                for m in range(0, count, threads)]

    for prob in range(nb):
        buf = (np.full(14 * n, np.nan, np.float32) if n <= shared_max_n
               else scratch[prob * 14 * n:(prob + 1) * 14 * n])
        S = {name: buf[slot * n:(slot + 1) * n]
             for name, slot in SLOTS.items()}
        B, CT, KT, R2, P, Z, A, E, D = (S[x] for x in "B CT KT R2 P Z A E D"
                                        .split())
        WA, WB, WC, AL, GA = S["WA"], S["WB"], S["WC"], S["AL"], S["GA"]
        r1 = f32(rho1[prob])
        bp, cp, kp, rp = b[prob], c[prob], k[prob], rho2[prob]
        for i in strided(n):
            B[i] = bp[i]
            CT[i] = cp[i] / r1
            rl = np.where(i > 0, rp[np.maximum(i - 1, 0)], f32(0))
            rr = np.where(i < n - 1, rp[np.minimum(i, n - 2)], f32(0))
            WB[i] = (r1 + rl).astype(f32) + rr
            WA[i] = np.where(i > 0, -rp[np.maximum(i - 1, 0)], f32(0))
            WC[i] = np.where(i < n - 1, -rp[np.minimum(i, n - 2)], f32(0))
            P[i] = 0
            A[i] = 0
            e = i[i < n - 1]
            R2[e] = rp[e]
            KT[e] = kp[e] / rp[e]
            Z[e] = bp[e + 1] - bp[e]
            E[e] = 0
        for lv in range(levels):
            s, rows, base = 1 << lv, n >> (lv + 1), n - (n >> lv)
            for j in strided(rows):
                q = 2 * s - 1 + j * 2 * s
                lft, rgt = q - s, q + s
                right = rgt < n
                rc = np.minimum(rgt, n - 1)
                alpha = WA[q] / WB[lft]
                gamma = WC[q] / np.where(right, WB[rc], f32(1))
                a_next = np.where(right, WA[rc], f32(0))
                ce_next = np.where(right, WC[rc], f32(0))
                nbv = (WB[q] - alpha * WC[lft]).astype(f32) - gamma * a_next
                na = -alpha * WA[lft]
                nc = -gamma * ce_next
                WB[q], WA[q], WC[q] = nbv, na, nc
                AL[base + j], GA[base + j] = alpha, gamma
        for _ in range(iters):
            for i in strided(n):
                ii = np.minimum(i, n - 2)
                il = np.maximum(i - 1, 0)
                w_i = np.where(i < n - 1, R2[ii] * (Z[ii] - E[ii]), f32(0))
                w_l = np.where(i > 0, R2[il] * (Z[il] - E[il]), f32(0))
                dtw = np.where(i == 0, -w_i,
                               np.where(i == n - 1, w_l, w_l - w_i))
                D[i] = r1 * ((B[i] + P[i]).astype(f32) - A[i]) + dtw
            for lv in range(levels):
                s, rows, base = 1 << lv, n >> (lv + 1), n - (n >> lv)
                for j in strided(rows):
                    q = 2 * s - 1 + j * 2 * s
                    rgt = q + s
                    de_next = np.where(rgt < n, D[np.minimum(rgt, n - 1)],
                                       f32(0))
                    D[q] = ((D[q] - AL[base + j] * D[q - s]).astype(f32)
                            - GA[base + j] * de_next)
            D[n - 1] = D[n - 1] / WB[n - 1]
            for lv in range(levels - 1, -1, -1):
                s, rows = 1 << lv, n >> (lv + 1)
                for j in strided(rows):
                    e = s - 1 + j * 2 * s
                    x_left = np.where(j > 0, D[np.maximum(e - s, 0)], f32(0))
                    x_right = D[e + s]
                    D[e] = (((D[e] - WA[e] * x_left).astype(f32)
                             - WC[e] * x_right).astype(f32) / WB[e])
            for i in strided(n):
                t = D[i].copy()
                thp = (over * (t - B[i])).astype(f32) + under * P[i]
                p = _soft32((thp + A[i]).astype(f32), CT[i])
                A[i] = (A[i] + thp).astype(f32) - p
                P[i] = p
                e = i[i < n - 1]
                thz = ((over * (D[e + 1] - D[e])).astype(f32)
                       + under * Z[e])
                z = _soft32((thz + E[e]).astype(f32), KT[e])
                E[e] = (E[e] + thz).astype(f32) - z
                Z[e] = z
        t_out[prob] = D
        z_out[prob] = Z[:n - 1]
    return t_out, z_out


@pytest.mark.parametrize("n,threads,shared_max_n", [
    (16, 32, 4096), (64, 8, 4096), (64, 16, 32), (128, 32, 64)])
def test_admm_twin_bit_equal_to_plain(n, threads, shared_max_n):
    """The kernel's decomposition (factors once, in-place levels, strided
    threads, shared or global state) gives the plain version's bits, on
    two real fit problems cut to n and one with 3 live nodes."""
    problems = [_stage1_problem(s) for s in (0, 3)]
    problems = [tuple(a[:min(len(a), n - 3)] for a in p) for p in problems]
    problems.append((np.array([1.0, 1.02, 0.99]), np.array([3.0, 5.0, 4.0]),
                     np.array([4e4, 4e4])))
    preps = [tfd._prep_problem(*p, n) for p in problems]
    b, c, k, r1, r2 = (np.stack([np.asarray(p[i], np.float64)
                                 for p in preps]).astype(np.float32)
                       for i in range(5))
    iters = 40
    tp, zp = fk.fused_lasso_admm_plain(*_tensors(b, c, k, r1, r2),
                                       iters=iters)
    tt, zt = admm_twin(b, c, k, r1, r2, iters, threads, shared_max_n)
    np.testing.assert_array_equal(tt, tp.numpy())
    np.testing.assert_array_equal(zt, zp.numpy())
    # signed zeros of z too: the breakpoints read z != 0
    np.testing.assert_array_equal(np.signbit(zt), np.signbit(zp.numpy()))
    assert (zt != 0).any() and (zt == 0).any()


def test_fit_device_fixture_reproduced():
    """tests/data/torch_fit_device_expected.json (the JAX package on the
    bench pair with the device fit, scripts/torch_expected_fit_device.py):
    its keys, and the port's device fit on the fixture's compressed nodes
    gives the JAX fit's breaks and slopes."""
    with open(FIXTURE) as f:
        want = json.load(f)
    for key in ("audio_times_s", "video_times_s", "similarity_percent",
                "median_slope", "start_offset_s", "stages", "nodes_x",
                "nodes_y"):
        assert key in want, key
    x = np.asarray(want["nodes_x"])
    y = np.asarray(want["nodes_y"])
    assert [s["n"] for s in want["stages"]] == [len(x) - 1, len(x)]
    assert [s["n_pad"] for s in want["stages"]] == [tfd.bucket(len(x) - 1),
                                                   tfd.bucket(len(x))]
    got = tfd.solve_l1_fit_device(x, y, device="cpu")
    slopes = got["slopes"]
    assert int(np.sum(np.diff(slopes) != 0)) == want["slope_breaks"]
    assert abs(got["median_slope"] - want["fit_median_slope"]) < 1e-9
