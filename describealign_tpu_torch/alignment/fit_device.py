"""On-device L1 piecewise-linear fit: ADMM + cyclic reduction on the card.

The port of describealign_tpu/alignment/fit_device.py (see it for the
derivation). Same two-stage decomposition as fit_tv.py's host cascade - a
slope fused-lasso, then an offset fused-lasso - but each 1-D problem

    min_t  sum_i c_i |t_i - b_i|  +  sum_k kappa_k |t_{k+1} - t_k|

is solved directly by ADMM with two splittings (p = t - b, z = Dt); the
t-update's constant tridiagonal system is solved by cyclic reduction.
Rate-change breakpoints come from the ADMM z variable, which is exactly
sparse by soft-thresholding.

Problems are padded to power-of-two buckets (zero data cost and zero TV
coupling across the padding). The ADMM runs on `device`: CUDA tensors go
to the hand-written kernel (ops/fit_kernel.py, csrc/fit_admm.cu), CPU
tensors to its plain torch version. As in the JAX package (x64 off), the
ADMM is f32 with rho1 an f32 scalar; padding and penalty scales are
computed in numpy f64 and the solve's results read back as f64.
"""
import numpy as np
import torch

from ..ops.fit_kernel import (  # noqa: F401 (_cr_solve: the JAX name)
    ADMM_ITERS, _cr_solve, fused_lasso_admm)
from ..ops.fit_kernel import (  # noqa: F401 (the JAX name)
    fused_lasso_admm_plain as _fused_lasso_admm)
from .fit import (RATE_CHANGE_COST, compute_jump_costs,
                  l1_refine_segment_slopes)


def _pad_pow2(arr, n_pad, fill=0.0):
    return np.pad(np.asarray(arr, np.float64), (0, n_pad - len(arr)),
                  constant_values=fill)


def _prep_problem(b, data_cost, kappa, n_pad):
    """Shared padding + penalty-scale setup (see fused_lasso_l1_device):
    returns (b_p, c_p, k_p, rho1, rho2) numpy arrays for one problem."""
    b = np.asarray(b, np.float64)
    data_cost = np.asarray(data_cost, np.float64)
    kappa = np.asarray(kappa, np.float64)
    n = len(b)
    b_p = _pad_pow2(b, n_pad, fill=float(b[-1]))
    c_p = _pad_pow2(data_cost, n_pad, fill=0.0)
    k_p = np.zeros(n_pad - 1)
    k_p[:min(len(kappa), n_pad - 1)] = kappa[:n_pad - 1]
    k_p[n - 1:] = 0.0                       # padding floats freely

    # data scale: a robust spread of b sets every soft-threshold's size
    scale = float(np.median(np.abs(b - np.median(b))))
    scale = max(scale, 1e-6 * max(1.0, float(np.abs(b).max())), 1e-12)
    rho1 = float(max(np.median(data_cost[data_cost > 0]), 1e-3)) / scale \
        if np.any(data_cost > 0) else 1.0
    # per-edge rho2: thresholds kappa/rho2 all land at ~2*scale
    r2 = np.maximum(k_p, 1e-3) / (2.0 * scale)
    return b_p, c_p, k_p, rho1, r2


def bucket(n):
    """The power-of-two bucket of an n-node problem (at least 16)."""
    return 1 << max(4, int(np.ceil(np.log2(max(n, 2)))))


def _solve_padded(bs, cs, ks, r1s, r2s, iters, device):
    """The ADMM on a (B, n_pad) batch of prepped problems on `device`;
    returns (t, z) as f64 numpy arrays."""
    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)
    t, z = fused_lasso_admm(f32(bs), f32(cs), f32(ks), f32(r1s), f32(r2s),
                            iters=iters)
    return (t.cpu().numpy().astype(np.float64),
            z.cpu().numpy().astype(np.float64))


def fused_lasso_l1_device(b, data_cost, kappa, iters=ADMM_ITERS,
                          device='cuda'):
    """Host-facing wrapper: pads to a power-of-two bucket, runs the ADMM on
    `device`, returns (t, break_mask) for the REAL region."""
    n = len(b)
    b_p, c_p, k_p, rho1, r2 = _prep_problem(b, data_cost, kappa, bucket(n))
    t, z = _solve_padded(b_p[None], c_p[None], k_p[None], np.array([rho1]),
                         r2[None], iters, device)
    return t[0, :n], z[0, :max(n - 1, 1)] != 0.0


def fused_lasso_l1_device_batched(problems, iters=ADMM_ITERS, device='cuda'):
    """One ADMM launch for a batch of (b, data_cost, kappa) problems padded
    to a common power-of-two bucket. Returns a list of (t, break_mask) per
    problem."""
    n_pad = bucket(max(len(b) for b, _, _ in problems))
    nb = len(problems)
    bs = np.empty((nb, n_pad))
    cs = np.empty((nb, n_pad))
    ks = np.empty((nb, n_pad - 1))
    r1s = np.empty((nb,))
    r2s = np.empty((nb, n_pad - 1))
    for i, (b, c, k) in enumerate(problems):
        bs[i], cs[i], ks[i], r1s[i], r2s[i] = _prep_problem(b, c, k, n_pad)
    t, z = _solve_padded(bs, cs, ks, r1s, r2s, iters, device)
    return [(t[i, :len(b)], z[i, :max(len(b) - 1, 1)] != 0.0)
            for i, (b, _, _) in enumerate(problems)]


def _weighted_median(values, weights):
    order = np.argsort(values)
    csum = np.cumsum(weights[order])
    return float(values[order][np.searchsorted(csum, csum[-1] / 2.0)])


def _stage1(x, y):
    """(xd, r, jc, slope_cost, kappa1) of the slope fused-lasso."""
    xd = np.diff(x)
    r = np.diff(y) / xd
    jc = compute_jump_costs(x, y)
    slope_cost = np.minimum(2.0, jc) * xd
    kappa1 = np.full(max(len(x) - 2, 1), float(RATE_CHANGE_COST))
    return xd, r, jc, slope_cost, kappa1


def _stage2(x, y, r, jc, slope_cost, theta, z_breaks):
    """Snap stage 1's slopes to exact runs and build the offset problem:
    (slopes, node_slope, (b, data_cost, kappa2))."""
    n = len(x)
    # snap to exact runs using the ADMM's sparse TV copy; within a fused
    # segment the LP's interior optimum is the cost-weighted MEDIAN of the
    # raw slopes, so snap to that (sharper than averaging the shrunk theta)
    seg_id = np.zeros(n - 1, int)
    seg_id[1:] = np.cumsum(z_breaks[:n - 2].astype(int))
    slopes = theta.copy()
    for k in range(seg_id.max() + 1):
        sel = seg_id == k
        slopes[sel] = _weighted_median(r[sel], slope_cost[sel])
    # de-bias long segments (see fit.l1_refine_segment_slopes)
    slopes = l1_refine_segment_slopes(x, y, seg_id, slopes)
    node_slope = np.concatenate([slopes, slopes[-1:]])
    b = y - node_slope * x
    kappa2 = jc.copy()
    kappa2[np.flatnonzero(np.diff(slopes) != 0)] = 0.0
    return slopes, node_slope, (b, np.ones(n), kappa2)


def _result(x, y, xd, slopes, node_slope, beta):
    smooth_y = node_slope * x + beta
    fit_err = y - smooth_y
    order = np.argsort(slopes)
    csum = np.cumsum(xd[order])
    median_slope = float(slopes[order][np.searchsorted(csum, csum[-1] / 2.0)])
    return dict(fit_err=fit_err, slopes=slopes, median_slope=median_slope,
                smooth_y=smooth_y)


def solve_l1_fit_device(x, y, device='cuda'):
    """Drop-in replacement for fit._solve_linprog / fit_tv.solve_l1_fit_tv
    (same return dict), with both fused-lassos solved on `device`."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xd, r, jc, slope_cost, kappa1 = _stage1(x, y)
    # ---- stage 1: piecewise-constant slopes -------------------------------
    theta, z_breaks = fused_lasso_l1_device(r, slope_cost, kappa1,
                                            device=device)
    # ---- stage 2: piecewise-constant offsets with sparse jumps ------------
    slopes, node_slope, problem = _stage2(x, y, r, jc, slope_cost, theta,
                                          z_breaks)
    beta, _ = fused_lasso_l1_device(*problem, device=device)
    return _result(x, y, xd, slopes, node_slope, beta)


def solve_l1_fit_device_batched(node_sets, device='cuda'):
    """solve_l1_fit_device for a batch of (x, y) node sets, each stage one
    ADMM launch for all of them. Identical per-problem math to the
    sequential entry; returns a list of result dicts."""
    prepped = []
    for x, y in node_sets:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        prepped.append((x, y) + _stage1(x, y))
    # ---- stage 1 (batched): piecewise-constant slopes ----------------------
    stage1 = fused_lasso_l1_device_batched(
        [(r, sc, k1) for (_, _, _, r, _, sc, k1) in prepped], device=device)
    mids = []
    for (x, y, xd, r, jc, slope_cost, _), (theta, z_breaks) in zip(prepped,
                                                                   stage1):
        mids.append((x, y, xd) + _stage2(x, y, r, jc, slope_cost, theta,
                                         z_breaks))
    # ---- stage 2 (batched): piecewise-constant offsets ---------------------
    stage2 = fused_lasso_l1_device_batched([m[5] for m in mids],
                                           device=device)
    return [_result(x, y, xd, slopes, node_slope, beta)
            for (x, y, xd, slopes, node_slope, _), (beta, _) in zip(mids,
                                                                   stage2)]
