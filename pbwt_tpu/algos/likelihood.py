"""Likelihood models: PBWT compression-model fitting and the Li-Stephens
leave-one-out copy model (pbwtLikelihood.c)."""

from __future__ import annotations

import math
import sys

import numpy as np

from ..core import engine
from ..core.pbwt import PBWT
from ..utils import log


def line_search_positive(x_init: float, tol: float, fn) -> float:
    """Quadratic-fit line search to maximise fn (lineSearchPositive,
    pbwtLikelihood.c:28-75)."""
    if tol <= 1.0:
        raise ValueError(f"tolerance {tol} in lineSearchPositive() must be > 1.0")
    x0, y0 = 0.9 * x_init, fn(0.9 * x_init)
    x1, y1 = 1.1 * x_init, fn(1.1 * x_init)
    x2 = y2 = None
    while y0 < y1:
        x2 = 3 * x1 - 2 * x0
        if x2 > 2.0 * x1:
            x2 = 2.0 * x1
        y2 = fn(x2)
        if y1 > y2:
            break
        x0, y0, x1, y1 = x1, y1, x2, y2
    while y0 > y1:
        x2, y2 = x1, y1
        x1, y1 = x0, y0
        x0 = 3 * x1 - 2 * x2
        if x0 < 0.5 * x1:
            x0 = 0.5 * x1
        y0 = fn(x0)
    if x2 is None:
        return x1
    while x2 / x0 > tol:
        if (x1 - x0) > 2 * (x2 - x1):
            x = 0.5 * (x0 + x1)
        elif (x2 - x1) > 2 * (x1 - x0):
            x = 0.5 * (x1 + x2)
        else:
            a = (((y2 - y1) * (x1 - x0) - (y1 - y0) * (x2 - x1))
                 / ((x2 * x2 - x1 * x1) * (x1 - x0)
                    - (x1 * x1 - x0 * x0) * (x2 - x1)))
            b = 0.5 * (a * (x2 * x2 - x1 * x1) - (y2 - y1)) / (x2 - x1)
            x = b / a
        y = fn(x)
        if x > x1:
            if y > y1:
                x0, y0, x1, y1 = x1, y1, x, y
            else:
                x2, y2 = x, y
        else:
            if y > y1:
                x2, y2, x1, y1 = x1, y1, x, y
            else:
                x0, y0 = x, y
    return x1


def _iter_columns_ad(p: PBWT):
    """Yield (k, y, d) walking the pbwt forwards with divergence."""
    Y = p.decoded(True)
    a = p.aFstart.copy()
    d = np.zeros(p.M + 1, dtype=np.int32)
    d[0] = d[p.M] = 1
    for k in range(p.N):
        yield k, Y[k], d
        a, d = engine.forwards_ad(a, d, Y[k], k)


def simple_entropy(p: PBWT) -> None:
    """simpleEntropy (pbwtLikelihood.c:79-105)."""
    out = sys.stdout
    LL = 0.0
    d_stick = n_stick = d_switch = n_switch = 0
    for k, y, d in _iter_columns_ad(p):
        dd = (k + 1) - d[1:p.M]
        stick = y[1:] == y[:-1]
        d_stick += int(dd[stick].sum())
        n_stick += int(stick.sum())
        d_switch += int(dd[~stick].sum())
        n_switch += int((~stick).sum())
        c = int(np.count_nonzero(y == 0))
        f = c / p.M
        if 0 < f < 1:
            LL += f * math.log(f) + (1 - f) * math.log(1 - f)
    out.write(f"Fraction switch {n_switch / (n_stick + n_switch):.4f}  "
              f"av dStick {d_stick / n_stick:.1f} "
              f"av dSwitch {d_switch / n_switch:.1f}\n")
    out.write(f"Simple entropy per cell {LL / p.N:f}\n")


def _build_row_info_drop_one(p: PBWT, MAX: int):
    """buildRowInfoDropOne (pbwtLikelihood.c:185-229): triple counts keyed by
    the d-pair code dd."""
    counts: dict[int, np.ndarray] = {}
    for k, y, d in _iter_columns_ad(p):
        M = p.M
        yl = y.astype(np.int64)
        for j in range(M):
            if not d[j] or not d[j + 1]:
                continue
            if j == 0:
                kk = (yl[j] << 1) + yl[j + 1]
                d1, d2 = 0, k + 1 - int(d[j + 1])
            elif j < M - 1:
                kk = (yl[j - 1] << 2) + (yl[j] << 1) + yl[j + 1]
                d1, d2 = k + 1 - int(d[j]), k + 1 - int(d[j + 1])
            else:
                kk = (yl[j - 1] << 2) + (yl[j] << 1)
                d1, d2 = k + 1 - int(d[j]), 0
            d1 //= 10
            d2 //= 10
            d1 = min(d1, MAX)
            d2 = min(d2, MAX)
            dd = d2 * d2 + d1 if d1 < d2 else d1 * d1 + d1 + d2
            row = counts.get(dd)
            if row is None:
                row = counts[dd] = np.zeros(8, dtype=np.int64)
            row[kk] += 1
    return counts


def _ll_drop_one(info: dict[int, np.ndarray], alpha: float, beta: float) -> float:
    dmax = int(math.sqrt(max(info) + 1)) + 1 if info else 1
    p_switch = np.array([-alpha * d1 - beta for d1 in range(dmax + 1)])
    p_stick = np.log(1.0 - np.exp(p_switch))
    like = 0.0
    for dd, nn in info.items():
        # invert dd -> (d1, d2)
        r = int(math.isqrt(dd))
        if dd - r * r < r:
            d2, d1 = r, dd - r * r
        else:
            d1, d2 = r, dd - r * r - r
        dmin, dmx = min(d1, d2), max(d1, d2)
        like += (nn[0] + nn[7]) * p_stick[dmx]
        like += (nn[1] + nn[6]) * (p_stick[d1] + p_switch[d2] - p_switch[dmin])
        like += (nn[2] + nn[5]) * (p_switch[d1] + p_switch[d2] - p_stick[dmin])
        like += (nn[3] + nn[4]) * (p_switch[d1] + p_stick[d2] - p_switch[dmin])
    return float(like)


def _build_row_info_freq(p: PBWT):
    """buildRowInfoFreqDropOne (pbwtLikelihood.c:279-308)."""
    counts = np.zeros((p.M + 1, 8), dtype=np.int64)
    for k, y, d in _iter_columns_ad(p):
        M = p.M
        yl = y.astype(np.int64)
        n1 = int((y != 0).sum())
        valid = (d[:M] != 0) & (d[1:M + 1] != 0)
        prev = np.concatenate(([0], yl[:-1]))
        nxt = np.concatenate((yl[1:], [0]))
        kk = (prev << 2) + (yl << 1) + nxt
        if M > 0:
            kk[0] = (yl[0] << 1) + (yl[1] if M > 1 else 0)
            kk[M - 1] = ((yl[M - 2] << 2) + (yl[M - 1] << 1)) if M > 1 else (yl[0] << 1)
        np.add.at(counts[n1], kk[valid], 1)
    return counts


def _ll_freq(counts: np.ndarray, alpha: float, beta: float, M: int) -> float:
    like = 0.0
    for n1 in range(counts.shape[0]):
        nn = counts[n1]
        if not nn.sum():
            continue
        f = (0.5 + n1) / (1 + M)
        p01 = -beta + alpha * math.log(f)
        p00 = math.log(1.0 - math.exp(p01))
        p10 = -beta
        p11 = math.log(1.0 - math.exp(p10))
        like += (nn[0] + nn[1] + nn[4]) * p00
        like += nn[2] * (p01 + p10 - p00)
        like += (nn[3] + nn[6] + nn[7]) * p11
        like += nn[5] * (p10 + p01 - p11)
    return like


def fit_alpha_beta(p: PBWT, model: int) -> None:
    """pbwtFitAlphaBeta (pbwtLikelihood.c:342-375)."""
    out = sys.stdout
    if model == 1:
        info = _build_row_info_drop_one(p, 1000)
        state = {"alpha": 0.0}
        beta = line_search_positive(1.0, 1.001,
                                    lambda b: _ll_drop_one(info, state["alpha"], b))
        LL = _ll_drop_one(info, state["alpha"], beta) / p.N
        out.write(f"Fit beta {beta:f}  LL per site {LL:f}  per cell {LL / p.M:f}\n")

        def alpha_fn(a):
            state["alpha"] = a
            state["beta"] = line_search_positive(
                state.get("beta", beta), 1.001,
                lambda b: _ll_drop_one(info, a, b))
            return _ll_drop_one(info, a, state["beta"])

        state["beta"] = beta
        alpha = line_search_positive(0.01, 1.001, alpha_fn)
        LL = _ll_drop_one(info, alpha, state["beta"]) / p.N
        out.write(f"Fit alpha {alpha:f}  beta {state['beta']:f}  "
                  f"LL per site {LL:f}  per cell {LL / p.M:f}\n")
    elif model == 2:
        counts = _build_row_info_freq(p)
        state = {"alpha": 1.0}
        beta = line_search_positive(1.0, 1.001,
                                    lambda b: _ll_freq(counts, state["alpha"], b, p.M))
        LL = _ll_freq(counts, state["alpha"], beta, p.M) / p.N
        out.write(f"Fit beta {beta:f}  LL per site {LL:f}  per cell {LL / p.M:f}\n")

        def alpha_fn(a):
            state["alpha"] = a
            state["beta"] = line_search_positive(
                state.get("beta", beta), 1.001,
                lambda b: _ll_freq(counts, a, b, p.M))
            return _ll_freq(counts, a, state["beta"], p.M)

        state["beta"] = beta
        alpha = line_search_positive(1.0, 1.001, alpha_fn)
        LL = _ll_freq(counts, alpha, state["beta"], p.M) / p.N
        out.write(f"Fit alpha {alpha:f}  beta {state['beta']:f}  "
                  f"LL per site {LL:f}  per cell {LL / p.M:f}\n")
    LL = -math.log(256.0) * len(p.yz) / p.N
    out.write(f"PBWT entropy per site {LL:f}  per cell {LL / p.M:f}\n")
    simple_entropy(p)


def copy_log_likelihood_drop_one(p: PBWT, theta: float, rho: float) -> float:
    """Li-Stephens leave-one-out likelihood, O(NM^2)
    (copyLogLikelihoodDropOne, pbwtLikelihood.c:380-420), vectorised over the
    (i, j) copy matrix.

    With PBWT_TPU_DEVICE=1 ops/likelihood_jax carries the copy matrix on
    the device (f32, so only close to this f64 path: exact=False)."""
    from ..ops import device_requested
    if device_requested(exact=False):
        from ..ops.likelihood_jax import copy_ll_device
        return copy_ll_device(p.haplotypes(), theta, rho)
    M = p.M
    X = p.haplotypes()
    left = np.full((M, M), 1.0 / (M - 1.0))
    np.fill_diagonal(left, 0.0)
    log_left_sum = np.zeros(M)
    rho1, rho_m, theta1 = 1.0 - rho, rho / (M - 1.0), 1.0 - theta
    for k in range(p.N):
        x = X[:, k].astype(np.int64)
        eq = x[:, None] == x[None, :]
        left *= rho1
        left += rho_m
        left *= np.where(eq, theta1, theta)
        np.fill_diagonal(left, 0.0)
        ssum = left.sum(axis=1)
        log_left_sum += np.log(ssum)
        left /= ssum[:, None]
        np.fill_diagonal(left, 0.0)
    return float(log_left_sum.sum())


def log_likelihood_copy_model(p: PBWT, theta: float, rho: float) -> None:
    """pbwtLogLikelihoodCopyModel (pbwtLikelihood.c:434-445)."""
    out = sys.stdout
    LL = copy_log_likelihood_drop_one(p, theta, rho)
    out.write(f"theta {theta:f} rho {rho:f} LL {LL:f}  per site {LL / p.N:f}  "
              f"per cell {LL / (p.M * p.N):f}\n")
    state = {"theta": theta, "rho": rho}

    def rho_fn(r):
        return copy_log_likelihood_drop_one(p, state["theta"], r)

    def theta_fn(t):
        state["theta"] = t
        state["rho"] = line_search_positive(state["rho"], 1.001, rho_fn)
        return copy_log_likelihood_drop_one(p, t, state["rho"])

    state["rho"] = line_search_positive(rho, 1.01, rho_fn)
    state["theta"] = line_search_positive(theta, 1.01, theta_fn)
    LL = copy_log_likelihood_drop_one(p, state["theta"], state["rho"]) / p.N
    out.write(f"Fit theta {state['theta']:f}  rho {state['rho']:f}  "
              f"LL per site {LL:f}  per cell {LL / p.M:f}\n")
