"""L1-minimization piecewise-linear alignment fit (host).

Jax-free twin of describealign_tpu/alignment/fit.py (reference
describealign.py:769-858; see that module for the model). Backends of
solve_l1_fit, with the JAX package's default ('highs'; the alignment
entry points pass their own, 'native'):
- 'highs': the reference's exact LP via scipy.optimize.linprog;
- 'native' (alias 'tv'): the cascaded exact fused-lasso solve of
  fit_tv.py through the native clipped-derivative DP;
- 'device': the ADMM fit of fit_device.py on `device` (the hand-written
  kernel on CUDA), guarded: a result that did not converge falls back to
  'native' with the JAX package's WARNING line.

Outputs: fit_err (N), slopes (N-1), median_slope, smooth_y = y - fit_err.
"""
import ctypes

import numpy as np

from .continuity import get_continuity_err
from .native import native_lib

JUMP_COST_BASE = 10.0
RATE_CHANGE_JUMP_COST = 0.001
RATE_CHANGE_COST = JUMP_COST_BASE * 4000
SHOT_NOISE_COST = 0.01
SHOT_NOISE_JUMP_COST = 3.0
SHOT_NOISE_BOUND = 2.0
JUMP_DETECT_FRAMES = 10.0   # interval position residual that marks a jump

_F64P = ctypes.POINTER(ctypes.c_double)


def compute_jump_costs(x, y):
    """Jump costs discounted where local continuity is already broken
    (reference 776-779)."""
    n = len(x)
    jump_costs = np.full(n - 1, JUMP_COST_BASE)
    if n <= 2 * 29 + 1:     # too short for the continuity window
        return jump_costs
    cerr = get_continuity_err(x, y, deriv=True)
    return jump_costs / np.maximum(1, np.sqrt(cerr / 3.0))


def l1_refine_segment_slopes(x, y, seg_id, slopes, iters=25):
    """Re-estimate each fused slope-segment by a POSITION-anchored L1 fit
    (native dp.cpp refine_segment_slopes; the algorithm is documented on
    the JAX package's _l1_refine_segment_slopes_py)."""
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    seg = np.ascontiguousarray(seg_id, np.int64)
    out = np.ascontiguousarray(slopes, np.float64).copy()
    rc = native_lib().refine_segment_slopes(
        x.ctypes.data_as(_F64P), y.ctypes.data_as(_F64P),
        ctypes.c_longlong(len(x)),
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        out.ctypes.data_as(_F64P), ctypes.c_longlong(iters),
        ctypes.c_double(JUMP_DETECT_FRAMES))
    if rc != 0:
        raise RuntimeError("native refine_segment_slopes failed")
    return out


def solve_l1_fit(x, y, backend='highs', device='cuda'):
    """Fit the piecewise-linear model. x, y: compressed, deduped match
    nodes (float64, len >= 3). device: where the 'device' backend's ADMM
    runs. Returns dict(fit_err, slopes, median_slope, smooth_y)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if backend == 'highs':
        return _solve_linprog(x, y)
    elif backend in ('native', 'tv'):
        from .fit_tv import solve_l1_fit_tv
        return solve_l1_fit_tv(x, y)
    elif backend == 'device':
        # ADMM is iterative: guard the result and fall back to the exact
        # host cascade on non-convergence (mirrors the reference LP's
        # dual-simplex -> interior-point fallback, describealign.py:841-844)
        from .fit_device import solve_l1_fit_device
        result = solve_l1_fit_device(x, y, device=device)
        ok = (np.isfinite(result['smooth_y']).all()
              and np.isfinite(result['slopes']).all()
              and np.median(np.abs(result['fit_err'])) < 50.0)
        if ok:
            return result
        print("  WARNING: device fit did not converge, using native...")
        from .fit_tv import solve_l1_fit_tv
        return solve_l1_fit_tv(x, y)
    raise ValueError(f"unknown fit backend: {backend}")


def _solve_linprog(x, y):
    import scipy.optimize
    import scipy.sparse as sp

    n = len(x)
    xd = np.diff(x)
    yd = np.diff(y)
    jump_costs = compute_jump_costs(x, y)

    c = np.hstack([
        np.ones(2 * n),                        # fit errors +/-
        jump_costs, jump_costs,                # jumps +/-
        np.full(2 * n, SHOT_NOISE_COST),       # shot noise +/-
        np.full(2 * (n - 1), SHOT_NOISE_JUMP_COST),
        np.full(2 * (n - 1), RATE_CHANGE_JUMP_COST),  # slope jumps +/-
        np.full(2 * (n - 2), RATE_CHANGE_COST),       # rate changes +/-
        [0.0],                                 # median slope (free)
    ])

    fit_err_coeffs = sp.diags([-1. / xd, 1. / xd], offsets=[0, 1],
                              shape=(n - 1, n)).tocsc()
    jump_coeffs = sp.diags([1. / xd], offsets=[0],
                           shape=(n - 1, n - 1)).tocsc()

    def zeros(r, cols):
        return sp.csc_matrix((r, cols))

    a_eq1 = sp.hstack([fit_err_coeffs, -fit_err_coeffs,
                       jump_coeffs, -jump_coeffs,
                       zeros(n - 1, 2 * n),
                       jump_coeffs, -jump_coeffs,
                       jump_coeffs, -jump_coeffs,
                       zeros(n - 1, 2 * n - 4),
                       np.ones((n - 1, 1))])
    a_eq2 = sp.hstack([zeros(n - 1, 4 * n - 2),
                       sp.diags([-1., 1.], offsets=[0, 1],
                                shape=(n - 1, n)).tocsc(),
                       sp.diags([1., -1.], offsets=[0, 1],
                                shape=(n - 1, n)).tocsc(),
                       -sp.eye(n - 1), sp.eye(n - 1),
                       zeros(n - 1, 4 * n - 6), zeros(n - 1, 1)])
    slope_change = sp.diags([-1. / xd[:-1], 1. / xd[1:]], offsets=[0, 1],
                            shape=(n - 2, n - 1)).tocsc()
    a_eq3 = sp.hstack([zeros(n - 2, 8 * n - 4),
                       slope_change, -slope_change,
                       -sp.eye(n - 2), sp.eye(n - 2),
                       zeros(n - 2, 1)])
    a_eq = sp.vstack([a_eq1, a_eq2, a_eq3])
    b_eq = np.hstack([yd / xd, np.zeros(2 * n - 3)])
    bounds = ([[0, None]] * (4 * n - 2)
              + [[0, SHOT_NOISE_BOUND]] * (2 * n)
              + [[0, None]] * (6 * n - 8)
              + [[None, None]])

    fit = scipy.optimize.linprog(c, A_eq=a_eq, b_eq=b_eq, bounds=bounds,
                                 method='highs-ds')
    if not fit.success and fit.status == 4:
        # dual simplex hit numerical trouble; retry with interior point
        fit = scipy.optimize.linprog(c, A_eq=a_eq, b_eq=b_eq, bounds=bounds,
                                     method='highs-ipm')
    if not fit.success:
        print(fit)
        raise RuntimeError("Smooth Alignment L1-Min Optimization Failed!")

    fit_err = fit.x[:n] - fit.x[n:2 * n]
    slope_jumps = fit.x[8 * n - 4:9 * n - 5] - fit.x[9 * n - 5:10 * n - 6]
    median_slope = fit.x[-1]
    slopes = median_slope + slope_jumps / xd
    return dict(fit_err=fit_err, slopes=slopes, median_slope=median_slope,
                smooth_y=y - fit_err)
