"""HDP math utilities (port of impl/hdp_math_utils.c).

The OpenMP vector primitives (parallel_cdf/max/add/exp) become plain numpy;
the spline, interpolation, and normal-inverse-gamma estimators are faithful
ports.
"""

import math

import numpy as np
from scipy.special import digamma, gammaln
from scipy.special import polygamma


def trigamma(x):
    return float(polygamma(1, x))

MACHEP = 1.11022302462515654042e-16


def add_logs(log_x, log_y):
    """add_logs (impl/hdp_math_utils.c)."""
    if log_x < log_y:
        log_x, log_y = log_y, log_x
    if log_y == -np.inf or log_y <= -0.25 * np.finfo(np.float64).max:
        return log_x
    return log_x + math.log1p(math.exp(log_y - log_x))


def spline_knot_slopes(x, y):
    """Natural cubic spline knot slopes (spline_knot_slopes,
    impl/hdp_math_utils.c:402-447): tridiagonal solve by forward elimination
    + back substitution (the C does it recursively)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    k = np.zeros(n)
    # forward sweep
    center = np.zeros(n)
    right = np.zeros(n)
    rhs = np.zeros(n)
    right[0] = 1.0 / (x[1] - x[0])
    center[0] = 2.0 * right[0]
    rhs[0] = 3.0 * (y[1] - y[0]) * right[0] ** 2
    for i in range(1, n - 1):
        left = 1.0 / (x[i] - x[i - 1])
        right[i] = 1.0 / (x[i + 1] - x[i])
        center[i] = 2.0 * (left + right[i])
        rhs[i] = 3.0 * ((y[i] - y[i - 1]) * left ** 2
                        + (y[i + 1] - y[i]) * right[i] ** 2)
        center[i] -= left * right[i - 1] / center[i - 1]
        rhs[i] -= left * rhs[i - 1] / center[i - 1]
    # final point by Cramer's rule
    left = 1.0 / (x[n - 1] - x[n - 2])
    c_last = 2.0 * left
    rhs_last = 3.0 * (y[n - 1] - y[n - 2]) * left ** 2
    k[n - 1] = ((rhs_last * center[n - 2] - rhs[n - 2] * left)
                / (c_last * center[n - 2] - right[n - 2] * left))
    for i in range(n - 2, 0, -1):
        k[i] = (rhs[i] - right[i] * k[i + 1]) / center[i]
    k[0] = (rhs[0] - right[0] * k[1]) / center[0]
    return k


def grid_spline_interp(query_x, x, y, slope):
    """grid_spline_interp (impl/hdp_math_utils.c:471-498): cubic Hermite
    interpolation on an evenly spaced grid, linear extrapolation outside."""
    n = len(x) - 1
    if query_x <= x[0]:
        return y[0] - slope[0] * (x[0] - query_x)
    if query_x >= x[n]:
        return y[n] + slope[n] * (query_x - x[n])
    dx = x[1] - x[0]
    i = int((query_x - x[0]) / dx)
    dy = y[i + 1] - y[i]
    a = slope[i] * dx - dy
    b = dy - slope[i + 1] * dx
    t = (query_x - x[i]) / dx
    u = 1.0 - t
    return u * y[i] + t * y[i + 1] + t * u * (a * u + b * t)


def grid_spline_interp_vec(query_x, x, y, slope):
    """Vectorized grid_spline_interp over an array of query points."""
    query_x = np.asarray(query_x, dtype=np.float64)
    n = len(x) - 1
    dx = x[1] - x[0]
    i = np.clip(((query_x - x[0]) / dx).astype(np.int64), 0, n - 1)
    dy = y[i + 1] - y[i]
    a = slope[i] * dx - dy
    b = dy - slope[i + 1] * dx
    t = (query_x - x[i]) / dx
    u = 1.0 - t
    mid = u * y[i] + t * y[i + 1] + t * u * (a * u + b * t)
    lo = y[0] - slope[0] * (x[0] - query_x)
    hi = y[n] + slope[n] * (query_x - x[n])
    return np.where(query_x <= x[0], lo, np.where(query_x >= x[n], hi, mid))


def linspace(start, stop, length):
    return np.linspace(start, stop, length)


def log_posterior_conditional_term(nu_post, two_alpha_post, beta_post):
    """impl/hdp_math_utils.c:532-538."""
    return (math.lgamma(0.5 * two_alpha_post)
            - 0.5 * (math.log(nu_post) + two_alpha_post * math.log(beta_post)))


def log_posterior_conditional_term_vec(nu_post, two_alpha_post, beta_post):
    from numpy import log
    return (gammaln(0.5 * np.asarray(two_alpha_post))
            - 0.5 * (log(nu_post) + two_alpha_post * log(beta_post)))


def normal_inverse_gamma_params(x):
    """impl/hdp_math_utils.c:540-560."""
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean()
    ssd = ((x - mean) ** 2).sum()
    return mean, float(len(x)), (len(x) - 1.0) / 2.0, 0.5 * ssd


def newton_approx_alpha(length, sum_log_tau, sum_tau):
    """impl/hdp_math_utils.c:751-774."""
    constant = sum_log_tau / length - math.log(sum_tau / length)
    alpha = 1.0
    while True:
        f = math.log(alpha) - digamma(alpha) + constant
        df = 1.0 / alpha - trigamma(alpha)
        if df == 0.0 or df != df:
            raise FloatingPointError("MLE alpha estimation unstable")
        alpha_prime = alpha - f / df
        if abs(alpha - alpha_prime) < MACHEP:
            return alpha_prime
        alpha = alpha_prime


def mle_normal_inverse_gamma_params(mus, taus):
    """impl/hdp_math_utils.c:777-810."""
    mus = np.asarray(mus, dtype=np.float64)
    taus = np.asarray(taus, dtype=np.float64)
    n = len(mus)
    sum_tau = taus.sum()
    sum_log_tau = np.log(taus).sum()
    mu_0 = float((mus * taus).sum() / sum_tau)
    sum_wsd = float((taus * (mus - mu_0) ** 2).sum())
    nu = n / sum_wsd
    alpha = newton_approx_alpha(n, sum_log_tau, sum_tau)
    beta = n * alpha / sum_tau
    return mu_0, nu, alpha, beta
