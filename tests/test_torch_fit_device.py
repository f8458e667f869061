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
computed once on compact levels, d's compact levels reduced and solved
back in place, the strided thread mapping with prefetched factors, d in
shared memory and the other arrays split between shared memory and the
per-problem global scratch, the top levels in one warp from the factor
table) is bit-equal to the plain version.
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
    assert fk.steps_per_solve(4096) == (800 * 15, 800 * 13)
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

PF = 8      # csrc/fit_admm.cu: rows per thread prefetched per CTA level


def _soft32(v, thr):
    m = (np.abs(v) - thr).astype(np.float32)
    m = np.where(m < 0, np.float32(0), m)
    return np.where(v < 0, -m, m).astype(np.float32)


def admm_twin(b, c, k, rho1, rho2, iters, threads, warp_rows=32,
              n_shared=None):
    """csrc/fit_admm.cu emulated in numpy f32: one CTA per problem of
    `threads` threads (thread tid takes j = tid, tid + threads, ... of a
    level; its first PF rows' factors fetched before the barrier that
    ends the step before), the slots split between a shared buffer (the
    first n_shared of fk.SLOTS, d's two first; fk.shared_slots(n) by
    default) and a per-problem global scratch (NaN where unwritten); the
    factors computed once on compact levels ping-ponged through the slots
    of d, p, z, a and e; d's levels compact, reduced level by level and
    solved back over themselves; the levels of at most warp_rows rows,
    the top equation and their back substitution in one warp, from the
    factor table filled at set-up."""
    nb, n = b.shape
    levels = n.bit_length() - 1
    kw = max(0, levels - (warp_rows.bit_length() - 1) - 1)
    if n_shared is None:
        n_shared = len(fk.shared_slots(n))
    f32 = np.float32
    over, under = f32(fk.OVER_RELAX), f32(1 - fk.OVER_RELAX)
    t_out = np.empty((nb, n), np.float32)
    z_out = np.empty((nb, n - 1), np.float32)

    def strided(count, first=0):
        """Items of one barrier step in the threads' order."""
        return [np.arange(m, min(m + threads, count))
                for m in range(first, count, threads)]

    def base_of(lv):
        return n - (n >> lv)

    def dbase(lv):
        return 2 * n - ((2 * n) >> lv)

    for prob in range(nb):
        smem = np.full(n_shared * n, np.nan, np.float32)
        scratch = np.full((fk.N_SLOTS - n_shared) * n, np.nan, np.float32)
        S = {}
        for slot, name in enumerate(fk.SLOTS):
            buf, at = ((smem, slot) if slot < n_shared
                       else (scratch, slot - n_shared))
            if name not in S:
                S[name] = buf[at * n:(at + (2 if name == "D" else 1)) * n]
        D = S["D"]
        if n_shared:
            assert np.shares_memory(D, smem)
        B, CT, KT, R2, P, Z, A, E = (S[x] for x in "B CT KT R2 P Z A E"
                                     .split())
        AL, GA, CA, CC, CB = (S[x] for x in "AL GA CA CC CB".split())
        r1 = f32(rho1[prob])
        bp, cp, kp, rp = b[prob], c[prob], k[prob], rho2[prob]
        xa, xb, xc, ya, yb, yc = D[:n], P, Z, D[n:], A, E
        for i in strided(n):
            B[i] = bp[i]
            CT[i] = cp[i] / r1
            rl = np.where(i > 0, rp[np.maximum(i - 1, 0)], f32(0))
            rr = np.where(i < n - 1, rp[np.minimum(i, n - 2)], f32(0))
            xb[i] = (r1 + rl).astype(f32) + rr
            xa[i] = np.where(i > 0, -rp[np.maximum(i - 1, 0)], f32(0))
            xc[i] = np.where(i < n - 1, -rp[np.minimum(i, n - 2)], f32(0))
            e = i[i < n - 1]
            R2[e] = rp[e]
            KT[e] = kp[e] / rp[e]
        for lv in range(levels):
            m, base = n >> lv, base_of(lv)
            for j in strided(m // 2):
                right = 2 * j + 2 < m
                jr = np.minimum(2 * j + 2, m - 1)
                be = xb[2 * j]
                alpha = xa[2 * j + 1] / be
                gamma = xc[2 * j + 1] / np.where(right, xb[jr], f32(1))
                a_next = np.where(right, xa[jr], f32(0))
                ce_next = np.where(right, xc[jr], f32(0))
                yb[j] = ((xb[2 * j + 1] - alpha * xc[2 * j]).astype(f32)
                         - gamma * a_next)
                ya[j] = -alpha * xa[2 * j]
                yc[j] = -gamma * ce_next
                AL[base + j], GA[base + j] = alpha, gamma
                CA[base + j], CC[base + j], CB[base + j] = (xa[2 * j],
                                                            xc[2 * j], be)
            xa, ya, xb, yb, xc, yc = ya, xa, yb, xb, yc, xc
        # the warp levels' factor table, row base_k - base_kw + j
        tab0 = base_of(kw)
        rows_t = base_of(levels) - tab0
        tab = {x: np.full(2 * warp_rows - 1, np.nan, np.float32)
               for x in ("AL", "GA", "CA", "CC", "CB")}
        for x, arr in (("AL", AL), ("GA", GA), ("CA", CA), ("CC", CC),
                       ("CB", CB)):
            tab[x][:rows_t] = arr[tab0:tab0 + rows_t]
        top = xb[0].copy()
        for i in strided(n):
            P[i] = 0
            A[i] = 0
            e = i[i < n - 1]
            Z[e] = bp[e + 1] - bp[e]
            E[e] = 0

        def forward(lv, j, al, ga):
            m, dk = n >> lv, D[dbase(lv):]
            de_next = np.where(2 * j + 2 < m, dk[np.minimum(2 * j + 2, m - 1)],
                               f32(0))
            D[dbase(lv + 1) + j] = ((dk[2 * j + 1] - al * dk[2 * j])
                                    .astype(f32) - ga * de_next)

        def back(lv, j, ca, cc, cb):
            dk, x = D[dbase(lv):], D[dbase(lv + 1):]
            xr = x[j].copy()
            xl = np.where(j > 0, x[np.maximum(j - 1, 0)], f32(0))
            dk[2 * j] = (((dk[2 * j] - ca * xl).astype(f32) - cc * xr)
                         .astype(f32) / cb)
            dk[2 * j + 1] = xr

        def fetch(lv, names):
            """Each thread's first PF rows' factors of level lv."""
            j = np.arange(min(n >> (lv + 1), PF * threads))
            arrs = (AL, GA) if names == "fwd" else (CA, CC, CB)
            return j, [a[base_of(lv) + j].copy() for a in arrs]

        for _ in range(iters):
            for i in strided(n):
                ii = np.minimum(i, n - 2)
                il = np.maximum(i - 1, 0)
                w_i = np.where(i < n - 1, R2[ii] * (Z[ii] - E[ii]), f32(0))
                w_l = np.where(i > 0, R2[il] * (Z[il] - E[il]), f32(0))
                dtw = np.where(i == 0, -w_i,
                               np.where(i == n - 1, w_l, w_l - w_i))
                D[i] = r1 * ((B[i] + P[i]).astype(f32) - A[i]) + dtw
            regs = fetch(0, "fwd") if kw > 0 else None
            # __syncthreads()
            for lv in range(kw):
                rows, base = n >> (lv + 1), base_of(lv)
                j, (al, ga) = regs
                for part in strided(len(j)):
                    forward(lv, j[part], al[part], ga[part])
                for jj in strided(rows, PF * threads):
                    forward(lv, jj, AL[base + jj], GA[base + jj])
                regs = (fetch(lv + 1, "fwd") if lv + 1 < kw
                        else fetch(kw - 1, "back"))
                # __syncthreads()
            # warp 0: lanes < rows of each warp level, __syncwarp between
            for lv in range(kw, levels):
                rows = n >> (lv + 1)
                assert rows <= warp_rows
                lane = np.arange(rows)
                tb = base_of(lv) - tab0 + lane
                forward(lv, lane, tab["AL"][tb], tab["GA"][tb])
            D[dbase(levels)] = D[dbase(levels)] / top
            for lv in range(levels - 1, kw - 1, -1):
                lane = np.arange(n >> (lv + 1))
                tb = base_of(lv) - tab0 + lane
                back(lv, lane, tab["CA"][tb], tab["CC"][tb], tab["CB"][tb])
            # __syncthreads()
            for lv in range(kw - 1, -1, -1):
                rows, base = n >> (lv + 1), base_of(lv)
                j, (ca, cc, cb) = regs
                for part in strided(len(j)):
                    back(lv, j[part], ca[part], cc[part], cb[part])
                for jj in strided(rows, PF * threads):
                    back(lv, jj, CA[base + jj], CC[base + jj], CB[base + jj])
                if lv > 0:
                    regs = fetch(lv - 1, "back")
                # __syncthreads()
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
        t_out[prob] = D[:n]
        z_out[prob] = Z[:n - 1]
    return t_out, z_out


@pytest.mark.parametrize("n,threads,warp_rows,n_shared", [
    (16, 32, 32, 15), (64, 8, 32, 14), (64, 16, 32, 3), (128, 32, 32, 0),
    (64, 8, 1, 7), (128, 16, 2, 7), (256, 8, 32, 3)])
def test_admm_twin_bit_equal_to_plain(n, threads, warp_rows, n_shared):
    """The kernel's decomposition (factors once on compact levels, d's
    compact levels reduced and solved back in place, strided threads with
    prefetched factors, d in shared memory - or, past 16,384, in the
    scratch - and the rest split with the scratch, the top levels in one
    warp from the factor table) gives the plain version's bits, on two
    real fit problems cut to n and one with 3 live nodes; the warp takes
    1, 2, 4 or 6 levels."""
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
    tt, zt = admm_twin(b, c, k, r1, r2, iters, threads, warp_rows, n_shared)
    np.testing.assert_array_equal(tt, tp.numpy())
    np.testing.assert_array_equal(zt, zp.numpy())
    # signed zeros of z too: the breakpoints read z != 0
    np.testing.assert_array_equal(np.signbit(zt), np.signbit(zp.numpy()))
    assert (zt != 0).any() and (zt == 0).any()


@pytest.mark.parametrize("n_pad,shared,barriers", [
    (4096, 14, 15), (8192, 7, 17), (16384, 3, 19), (32768, 0, 21)])
def test_fit_admm_layout_and_steps(n_pad, shared, barriers):
    """d in shared memory at every n_pad up to 16,384 (the bench pair's
    fit is 8,192, the film's 16,384), the factors next (all of them at
    8,192); 13 warp steps and 2 (log2 n - 6) + 3 CTA barriers per
    iteration."""
    names = fk.shared_slots(n_pad)
    assert len(names) == shared
    assert 4 * n_pad * len(names) + fk.TAB_BYTES <= fk.SMEM_LIMIT
    if n_pad <= 16384:
        assert names[:2] == ("D", "D")
    if n_pad == 8192:
        assert set(names) == {"D", "AL", "GA", "CA", "CC", "CB"}
    assert fk.steps_per_solve(n_pad) == (800 * barriers, 800 * 13)
    assert fk.steps_per_solve(16, iters=1) == (3, 9)


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
