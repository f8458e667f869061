"""L1 piecewise-linear fit via cascaded exact fused-lassos (native solver).

Jax-free twin of describealign_tpu/alignment/fit_tv.py (see it for the
derivation): stage 1 fits piecewise-constant slopes with a fused-lasso of
weight RATE_CHANGE_COST, stage 2 piecewise-constant offsets with sparse
jumps; each L1 fused-lasso runs IRLS around the exact weighted-L2 TV prox
of csrc/dp.cpp. Native only: the pure-Python prox fallback is not
ported.
"""
import ctypes

import numpy as np

from .fit import RATE_CHANGE_COST, compute_jump_costs, l1_refine_segment_slopes
from .native import native_lib

IRLS_ITERS = 12
SLOPE_IRLS_DELTA = 2e-4     # slope units
OFFSET_IRLS_DELTA = 0.05    # frames
SLOPE_SNAP_TOL = 1e-6

_F64P = ctypes.POINTER(ctypes.c_double)


def tv_weighted_l2(r, w, kappa):
    """Exact min .5*sum w_i(t-r_i)^2 + sum kappa_k|Dt| (native DP)."""
    r = np.ascontiguousarray(r, np.float64)
    w = np.ascontiguousarray(w, np.float64)
    kappa = np.ascontiguousarray(kappa, np.float64)
    out = np.empty_like(r)
    rc = native_lib().tv1d_weighted(
        r.ctypes.data_as(_F64P), w.ctypes.data_as(_F64P),
        kappa.ctypes.data_as(_F64P), ctypes.c_longlong(len(r)),
        out.ctypes.data_as(_F64P))
    if rc != 0:
        raise RuntimeError("tv1d_weighted failed")
    return out


def fused_lasso_l1(b, data_cost, kappa, delta):
    """argmin sum data_cost_i|b_i - t_i| + sum kappa_k|Dt| via IRLS around
    the exact weighted-L2 TV prox (delta-smoothed L1)."""
    b = np.asarray(b, np.float64)
    theta = tv_weighted_l2(b, np.asarray(data_cost, float) / delta, kappa)
    for _ in range(IRLS_ITERS):
        w = data_cost / np.maximum(np.abs(b - theta), delta)
        prev = theta
        theta = tv_weighted_l2(b, w, kappa)
        # exact fixed point: every later iterate would repeat bit for bit
        if np.array_equal(theta, prev):
            break
    return theta


def solve_l1_fit_tv(x, y):
    """Same return dict as fit._solve_linprog."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    xd = np.diff(x)
    r = np.diff(y) / xd
    jc = compute_jump_costs(x, y)

    # stage 1: piecewise-constant slopes
    slope_cost = np.minimum(2.0, jc) * xd
    kappa1 = np.full(max(n - 2, 1), float(RATE_CHANGE_COST))
    theta = fused_lasso_l1(r, slope_cost, kappa1, SLOPE_IRLS_DELTA)

    # snap to exact runs (LP vertex solutions are exactly sparse in du)
    breaks = np.flatnonzero(np.abs(np.diff(theta)) > SLOPE_SNAP_TOL) + 1
    seg_id = np.zeros(n - 1, int)
    seg_id[breaks] = 1
    seg_id = np.cumsum(seg_id)
    slopes = theta.copy()
    for k in range(seg_id.max() + 1):
        sel = seg_id == k
        slopes[sel] = np.average(theta[sel], weights=xd[sel])
    slopes = l1_refine_segment_slopes(x, y, seg_id, slopes)

    # stage 2: piecewise-constant offsets with sparse jumps
    node_slope = np.concatenate([slopes, slopes[-1:]])
    b = y - node_slope * x
    kappa2 = jc.copy()
    kappa2[np.flatnonzero(np.diff(slopes) != 0)] = 0.0  # free across segments
    beta = fused_lasso_l1(b, np.ones(n), kappa2, OFFSET_IRLS_DELTA)

    smooth_y = node_slope * x + beta
    fit_err = y - smooth_y

    # median slope: dx-weighted median (LP optimality for the free median)
    order = np.argsort(slopes)
    csum = np.cumsum(xd[order])
    median_slope = float(slopes[order][np.searchsorted(csum, csum[-1] / 2.0)])

    return dict(fit_err=fit_err, slopes=slopes, median_slope=median_slope,
                smooth_y=smooth_y)
