"""Hierarchical Dirichlet Process with Gibbs sampling (port of impl/hdp.c;
a copy of ``cpecan_tpu/hdp/hdp.py``).

The HDP is inherently sequential pointer-chasing host work (SURVEY §7); it
runs in Python/numpy with the per-candidate likelihood scans vectorized —
the same place the reference applies OpenMP (impl/hdp.c:1805-1816).  Only
its *output* (per-DP posterior densities on the sampling grid) goes to the
card, as tables for the HDP state machine's emission stream.

Representation: Chinese-restaurant-franchise factor trees.  Each DP holds a
set of factors; middle/base factors have children; base factors cache the
posterior normal-inverse-gamma parameters
(add/remove_update_base_factor_params, impl/hdp.c:419-463).
"""

import json
import math

import numpy as np

from .math_utils import (add_logs, grid_spline_interp, grid_spline_interp_vec,
                         log_posterior_conditional_term, spline_knot_slopes)

MINUS_INF = -0.5 * np.finfo(np.float64).max
BASE, MIDDLE, DATA_PT = 0, 1, 2
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def k_means(k, data, max_iters, num_restarts, rng):
    """1-D k-means with random restarts (impl/hdp.c:1154-1251): absolute
    distance, empty clusters re-seeded from random data points, best
    restart by summed distance.  Returns (assignments, centroids)."""
    data = np.asarray(data, dtype=np.float64)
    n = len(data)
    if k > n:
        raise ValueError("must have at least as many data points as "
                         "clusters")
    if k <= 0:
        raise ValueError("must have at least one cluster")
    best_assign = best_centroids = None
    best_sum = np.inf
    for _ in range(num_restarts):
        centroids = data[rng.integers(0, n, size=k)]
        assign = np.full(n, -1, dtype=np.int64)
        for _ in range(max_iters):
            d = np.abs(data[:, None] - centroids[None, :])
            new_assign = np.argmin(d, axis=1)
            if np.array_equal(new_assign, assign):
                break
            assign = new_assign
            sums = np.bincount(assign, weights=data, minlength=k)
            counts = np.bincount(assign, minlength=k)
            nonzero = counts > 0
            centroids = np.where(
                nonzero, sums / np.maximum(counts, 1),
                data[rng.integers(0, n, size=k)])
        total = float(np.abs(data - centroids[assign]).sum())
        if total < best_sum:
            best_sum = total
            best_assign = assign
            best_centroids = centroids
    return best_assign, best_centroids


class Factor:
    __slots__ = ("factor_type", "parent", "children", "params", "data_pt_idx",
                 "dp")

    def __init__(self, factor_type, dp=None):
        self.factor_type = factor_type
        self.parent = None
        self.children = set() if factor_type != DATA_PT else None
        self.params = None       # base factors: [mu, nu, 2a, beta, log_term]
        self.data_pt_idx = None  # data factors
        self.dp = dp
        if dp is not None:
            dp.factors.add(self)


class DirichletProcess:
    __slots__ = ("id", "hdp", "depth", "parent", "children", "factors",
                 "num_factor_children", "base_factor_wt",
                 "posterior_predictive", "spline_slopes",
                 "cached_factor_mean", "cached_factor_ssd",
                 "cached_factor_size", "observed")

    def __init__(self, dp_id, hdp):
        self.id = dp_id
        self.hdp = hdp
        self.depth = 0
        self.parent = None
        self.children = []
        self.factors = set()
        self.num_factor_children = 0
        self.base_factor_wt = 0.0
        self.posterior_predictive = None
        self.spline_slopes = None
        self.cached_factor_mean = 0.0
        self.cached_factor_ssd = 0.0
        self.cached_factor_size = 0
        self.observed = False

    @property
    def gamma(self):
        return self.hdp.gamma[self.depth]


class HierarchicalDirichletProcess:
    """new_hier_dir_proc(_2) (impl/hdp.c:876-1000)."""

    def __init__(self, num_dps, depth, *, gamma=None, gamma_alpha=None,
                 gamma_beta=None, grid_start=None, grid_stop=None,
                 grid_length=None, mu=0.0, nu=1.0, alpha=2.0, beta=1.0,
                 seed=0):
        if nu <= 0.0 or beta <= 0.0:
            raise ValueError("nu and beta must be positive")
        # NOTE: the reference's half-integer check on alpha is a no-op due to
        # a cast-precedence bug (impl/hdp.c:905: "(int64_t) 2 * alpha"
        # multiplies by the casted 2); only alpha > 1 is actually enforced.
        if alpha <= 1.0:
            raise ValueError("alpha must be > 1.0")
        self.rng = np.random.default_rng(seed)
        self.sampler = None   # the last Gibbs run's: "native" or "python"
        self.num_dps = num_dps
        self.depth = depth
        self.mu = mu
        self.nu = nu
        self.two_alpha = 2.0 * alpha
        self.beta = beta
        self.sampling_grid = np.linspace(grid_start, grid_stop, grid_length)
        self.grid_length = grid_length
        self.sample_gamma = gamma is None
        if self.sample_gamma:
            self.gamma_alpha = np.asarray(gamma_alpha, dtype=np.float64)
            self.gamma_beta = np.asarray(gamma_beta, dtype=np.float64)
            self.gamma = self.gamma_alpha / self.gamma_beta
            self.w_aux = np.ones(num_dps)
            self.s_aux = np.zeros(num_dps, dtype=bool)
        else:
            self.gamma = np.asarray(gamma, dtype=np.float64)
            self.gamma_alpha = self.gamma_beta = None
            self.w_aux = self.s_aux = None
        self.dps = [DirichletProcess(i, self) for i in range(num_dps)]
        self.base_dp = None
        self.data = None
        self.data_pt_dp_id = None
        self.finalized = False
        self.splines_finalized = False
        self.samples_taken = 0
        self.metric_memos = []

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------

    def set_dir_proc_parent(self, child_id, parent_id):
        child = self.dps[child_id]
        parent = self.dps[parent_id]
        if child.parent is not None:
            raise ValueError("DP already has a parent")
        child.parent = parent
        parent.children.append(child)

    def finalize_structure(self):
        """finalize_hdp_structure (impl/hdp.c:1582-1594)."""
        roots = [dp for dp in self.dps if dp.parent is None]
        if len(roots) != 1:
            raise ValueError("HDP tree must have exactly one root")
        self.base_dp = roots[0]

        def set_depth(dp, depth):
            dp.depth = depth
            for c in dp.children:
                set_depth(c, depth + 1)

        set_depth(self.base_dp, 0)
        for dp in self.dps:
            if not dp.children and dp.depth != self.depth - 1:
                raise ValueError("all leaf DPs must be at the deepest level")
        self.finalized = True
        if self.data is not None:
            self._finalize_data()

    def pass_data(self, data, dp_ids):
        """pass_data_to_hdp (impl/hdp.c:1566-1580)."""
        if self.data is not None:
            raise ValueError("reset before passing new data")
        self.data = np.asarray(data, dtype=np.float64)
        self.data_pt_dp_id = np.asarray(dp_ids, dtype=np.int64)
        if self.finalized:
            self._finalize_data()

    def reset_data(self):
        """reset_hdp_data (impl/hdp.c:1603-1660)."""
        self.data = None
        self.data_pt_dp_id = None
        for dp in self.dps:
            dp.factors = set()
            dp.num_factor_children = 0
            dp.posterior_predictive = None
            dp.spline_slopes = None
            dp.observed = False
        self.splines_finalized = False
        self.samples_taken = 0
        if self.sample_gamma:
            self.gamma = self.gamma_alpha / self.gamma_beta
            self.w_aux[:] = 1.0
            self.s_aux[:] = False

    def _finalize_data(self):
        for i in self.data_pt_dp_id:
            if self.dps[i].children:
                raise ValueError("data points may only be assigned to leaves")
        observed_ids = set(self.data_pt_dp_id.tolist())
        for dp_id in observed_ids:
            dp = self.dps[dp_id]
            while dp is not None and not dp.observed:
                dp.observed = True
                dp = dp.parent
        for dp in self.dps:
            if dp.observed and dp.posterior_predictive is None:
                dp.posterior_predictive = np.zeros(self.grid_length)
        self._init_factors()

    def _init_factors(self):
        """init_factors (impl/hdp.c:1467-1535): every observed DP starts
        with one factor; all data in a leaf under the single factor chain."""
        data_pt_fctrs = {}
        for idx, dp_id in enumerate(self.data_pt_dp_id):
            f = Factor(DATA_PT)
            f.data_pt_idx = idx
            data_pt_fctrs.setdefault(int(dp_id), []).append(f)

        root_factor = self._new_base_factor()

        def init_internal(dp, parent_fctr):
            if not dp.observed:
                return
            fctr = Factor(MIDDLE, dp)
            fctr.parent = parent_fctr
            parent_fctr.children.add(fctr)
            if not dp.children:
                for dpf in data_pt_fctrs.get(dp.id, []):
                    dpf.parent = fctr
                    fctr.children.add(dpf)
            else:
                for child in dp.children:
                    init_internal(child, fctr)

        for child in self.base_dp.children:
            init_internal(child, root_factor)

        mean, ssd, n = self._factor_stats(root_factor)
        self._add_update_base_params(root_factor, mean, ssd, float(n))

        for dp in self.dps:
            dp.num_factor_children = sum(len(f.children)
                                         for f in dp.factors)

    def k_means_init_factors(self, max_iters=100, num_restarts=3):
        """k_means_init_factors (impl/hdp.c:1287-1435): replace the simple
        single-chain factor initialisation with per-depth factor banks
        derived from hierarchical 1-D k-means over the data (cluster the
        data points, then cluster the centroids, level by level).  Public
        API in the reference (its default call site is commented out,
        impl/hdp.c:1540); call after data is passed, before sampling."""
        if self.data is None or not self.finalized:
            raise ValueError("pass data before k-means initialisation")
        # drop the factors built by the default init, keep observed flags
        for dp in self.dps:
            dp.factors = set()
            dp.num_factor_children = 0

        tree_depth = self.depth
        num_data = len(self.data)
        depth_dp_counts = np.zeros(tree_depth, dtype=np.int64)
        for dp in self.dps:
            depth_dp_counts[dp.depth] += 1

        # expected factor counts per level (Antoniak's E[#tables] =
        # gamma log(1 + n/gamma)), split over the DPs of that level
        expected = np.zeros(tree_depth, dtype=np.int64)
        stat = self.gamma[0] * math.log(1.0 + num_data / self.gamma[0])
        expected[0] = int(stat) // depth_dp_counts[tree_depth - 1] + 1
        for i in range(1, tree_depth):
            lower = expected[i - 1]
            stat = self.gamma[i] * math.log(1.0 + lower / self.gamma[i])
            expected[i] = min(int(stat) // depth_dp_counts[tree_depth - i - 1]
                              + 1, lower)

        assignments = [None] * tree_depth
        centers = [None] * tree_depth
        assignments[0], centers[0] = k_means(
            int(expected[0]), self.data, max_iters, num_restarts, self.rng)
        for i in range(1, tree_depth):
            assignments[i], centers[i] = k_means(
                int(expected[i]), centers[i - 1], max_iters, num_restarts,
                self.rng)

        # per-DP factor banks, filled lazily
        bank = {dp.id: [None] * int(expected[tree_depth - dp.depth - 1])
                for dp in self.dps}

        for i, dp_id in enumerate(self.data_pt_dp_id):
            dp = self.dps[int(dp_id)]
            f = Factor(DATA_PT)
            f.data_pt_idx = i
            slot = int(assignments[0][i])
            parent = bank[dp.id][slot]
            if parent is None:
                parent = Factor(MIDDLE, dp)
                bank[dp.id][slot] = parent
            f.parent = parent
            parent.children.add(f)
            dp.num_factor_children += 1

        for depth in range(tree_depth - 1, 0, -1):
            level_assign = assignments[tree_depth - depth]
            for dp in self.dps:
                if dp.depth != depth:
                    continue
                parent_dp = dp.parent
                for j, fctr in enumerate(bank[dp.id]):
                    if fctr is None:
                        continue
                    slot = int(level_assign[j])
                    parent = bank[parent_dp.id][slot]
                    if parent is None:
                        parent = (Factor(MIDDLE, parent_dp) if depth > 1
                                  else self._new_base_factor())
                        bank[parent_dp.id][slot] = parent
                    fctr.parent = parent
                    parent.children.add(fctr)
                    parent_dp.num_factor_children += 1

        for base_fctr in list(self.base_dp.factors):
            mean, ssd, n = self._factor_stats(base_fctr)
            self._add_update_base_params(base_fctr, mean, ssd, float(n))

    # ------------------------------------------------------------------
    # factor math
    # ------------------------------------------------------------------

    def _new_base_factor(self):
        f = Factor(BASE, self.base_dp)
        mu, nu, two_alpha, beta = self.mu, self.nu, self.two_alpha, self.beta
        f.params = [mu, nu, two_alpha, beta,
                    log_posterior_conditional_term(nu, two_alpha, beta)]
        return f

    def _factor_stats(self, fctr):
        vals = []
        stack = [fctr]
        while stack:
            f = stack.pop()
            if f.factor_type == DATA_PT:
                vals.append(self.data[f.data_pt_idx])
            else:
                stack.extend(f.children)
        vals = np.array(vals)
        mean = vals.mean() if len(vals) else 0.0
        ssd = float(((vals - mean) ** 2).sum()) if len(vals) else 0.0
        return float(mean), ssd, len(vals)

    @staticmethod
    def _posterior_update(params, mean, ssd, n):
        mu_prev, nu_prev, ta_prev, beta_prev = params[:4]
        nu_post = nu_prev + n
        mu_post = (mu_prev * nu_prev + mean * n) / nu_post
        ta_post = ta_prev + n
        mean_dev = mean - mu_prev
        sq_mean_dev = nu_prev * n * mean_dev * mean_dev / nu_post
        beta_post = beta_prev + 0.5 * (ssd + sq_mean_dev)
        return mu_post, nu_post, ta_post, beta_post

    def _add_update_base_params(self, fctr, mean, ssd, n):
        mu, nu, ta, beta = self._posterior_update(fctr.params, mean, ssd, n)
        fctr.params = [mu, nu, ta, beta,
                       log_posterior_conditional_term(nu, ta, beta)]

    def _remove_update_base_params(self, fctr, mean, ssd, n):
        mu_post, nu_post, ta_post, beta_post = fctr.params[:4]
        nu_prev = nu_post - n
        mu_prev = (mu_post * nu_post - mean * n) / nu_prev
        ta_prev = ta_post - n
        mean_dev = mean - mu_prev
        sq_mean_dev = nu_prev * n * mean_dev * mean_dev / nu_post
        beta_prev = beta_post - 0.5 * (ssd + sq_mean_dev)
        fctr.params = [mu_prev, nu_prev, ta_prev, beta_prev,
                       log_posterior_conditional_term(nu_prev, ta_prev,
                                                      beta_prev)]

    @staticmethod
    def _get_base_factor(fctr):
        while fctr.factor_type != BASE:
            fctr = fctr.parent
            if fctr is None:
                return None
        return fctr

    def _data_pt_parent_likelihood(self, data_pt, parent):
        """data_pt_factor_parent_likelihood (impl/hdp.c:500-530)."""
        pa = self._get_base_factor(parent).params
        mu_d, nu_d, ta_d, beta_d, log_denom = pa
        nu_n = nu_d + 1.0
        sq = nu_d * (data_pt - mu_d) ** 2 / nu_n
        log_numer = log_posterior_conditional_term(nu_n, ta_d + 1.0,
                                                   beta_d + 0.5 * sq)
        return INV_SQRT_2PI * math.exp(log_numer - log_denom)

    def _factor_parent_joint_log_likelihood(self, fctr, parent):
        """factor_parent_joint_log_likelihood (impl/hdp.c:465-498)."""
        base = self._get_base_factor(parent)
        dp = fctr.dp
        n = float(dp.cached_factor_size)
        mean = dp.cached_factor_mean
        ssd = dp.cached_factor_ssd
        pa = base.params
        mu_d, nu_d, ta_d, beta_d, log_denom = pa
        nu_n = nu_d + n
        ta_n = ta_d + n
        sq = nu_d * n * (mean - mu_d) ** 2 / nu_n
        beta_n = beta_d + 0.5 * (ssd + sq)
        log_numer = log_posterior_conditional_term(nu_n, ta_n, beta_n)
        return -n * HALF_LOG_2PI + log_numer - log_denom

    def _prior_likelihood(self, data_pt):
        """prior_likelihood (impl/hdp.c:586-609)."""
        mu, nu, ta, beta = self.mu, self.nu, self.two_alpha, self.beta
        dev = data_pt - mu
        alpha_term = math.exp(math.lgamma(0.5 * (ta + 1.0))
                              - math.lgamma(0.5 * ta))
        nu_term = nu / (2.0 * (nu + 1.0) * beta)
        beta_term = (1.0 + nu_term * dev * dev) ** (-0.5 * (ta + 1.0))
        return alpha_term * math.sqrt(nu_term / math.pi) * beta_term

    def _prior_joint_log_likelihood(self, fctr):
        """prior_joint_log_likelihood (impl/hdp.c:611-643)."""
        mu, nu, ta, beta = self.mu, self.nu, self.two_alpha, self.beta
        dp = fctr.dp
        n = float(dp.cached_factor_size)
        mean = dp.cached_factor_mean
        ssd = dp.cached_factor_ssd
        sq = nu * n * (mean - mu) ** 2 / (nu + n)
        log_alpha = math.lgamma(0.5 * (ta + n)) - math.lgamma(0.5 * ta)
        log_nu = 0.5 * (math.log(nu) - math.log(nu + n))
        log_pi = n * HALF_LOG_2PI
        log_b1 = ta * math.log(beta)
        log_b2 = (ta + n) * math.log(beta + 0.5 * (ssd + sq))
        return log_alpha + log_nu - log_pi + 0.5 * (log_b1 - log_b2)

    def _unobserved_factor_likelihood(self, fctr, dp):
        """unobserved_factor_likelihood (impl/hdp.c:645-690)."""
        parent_dp = dp.parent
        if parent_dp is None:
            return self._prior_likelihood(self.data[fctr.data_pt_idx])
        pg = parent_dp.gamma
        lik = 0.0
        data_pt = self.data[fctr.data_pt_idx]
        for pf in parent_dp.factors:
            lik += len(pf.children) * self._data_pt_parent_likelihood(data_pt,
                                                                      pf)
        lik += pg * self._unobserved_factor_likelihood(fctr, parent_dp)
        return lik / (pg + parent_dp.num_factor_children)

    def _unobserved_factor_joint_log_likelihood(self, fctr, dp):
        """unobserved_factor_joint_log_likelihood (impl/hdp.c:717-770)."""
        parent_dp = dp.parent
        if parent_dp is None:
            return self._prior_joint_log_likelihood(fctr)
        pg = parent_dp.gamma
        ll = MINUS_INF
        for pf in parent_dp.factors:
            ll = add_logs(ll, math.log(len(pf.children))
                          + self._factor_parent_joint_log_likelihood(fctr, pf))
        ll = add_logs(ll, math.log(pg)
                      + self._unobserved_factor_joint_log_likelihood(fctr,
                                                                     parent_dp))
        return ll - math.log(pg + parent_dp.num_factor_children)

    # ------------------------------------------------------------------
    # Gibbs iteration
    # ------------------------------------------------------------------

    def _destroy_factor(self, fctr):
        if fctr.children is not None and fctr.children:
            raise RuntimeError("destroying factor with children")
        parent = fctr.parent
        if parent is not None:
            parent.children.discard(fctr)
            parent.dp.num_factor_children -= 1
            if not parent.children:
                self._destroy_factor(parent)
        if fctr.dp is not None:
            fctr.dp.factors.discard(fctr)

    def _unassign_from_parent(self, fctr):
        """unassign_from_parent (impl/hdp.c:1663-1697)."""
        parent = fctr.parent
        base = self._get_base_factor(parent)
        base_dp = base.dp
        parent.children.discard(fctr)
        fctr.parent = None
        parent.dp.num_factor_children -= 1
        if not parent.children:
            self._destroy_factor(parent)
        mean, ssd, n = self._factor_stats(fctr)
        if base in base_dp.factors:
            self._remove_update_base_params(base, mean, ssd, float(n))
        if fctr.dp is not None:
            fctr.dp.cached_factor_mean = mean
            fctr.dp.cached_factor_ssd = ssd
            fctr.dp.cached_factor_size = n

    def _assign_to_parent(self, fctr, parent, update_params):
        """assign_to_parent (impl/hdp.c:1699-1728)."""
        fctr.parent = parent
        parent.children.add(fctr)
        parent.dp.num_factor_children += 1
        if not update_params:
            return
        base = self._get_base_factor(parent)
        if fctr.factor_type == DATA_PT:
            self._add_update_base_params(base, self.data[fctr.data_pt_idx],
                                         0.0, 1.0)
        else:
            dp = fctr.dp
            self._add_update_base_params(base, dp.cached_factor_mean,
                                         dp.cached_factor_ssd,
                                         float(dp.cached_factor_size))

    def _sample_from_data_pt_factor(self, fctr, dp):
        """sample_from_data_pt_factor (impl/hdp.c:1784-1844), with the
        candidate scan vectorized over the factor pool."""
        pool = list(dp.factors)
        data_pt = self.data[fctr.data_pt_idx]
        if pool:
            # vectorized data_pt_factor_parent_likelihood over candidates
            params = np.array([self._get_base_factor(f).params for f in pool])
            sizes = np.array([len(f.children) for f in pool], dtype=np.float64)
            mu_d, nu_d, ta_d, beta_d, log_denom = params.T
            nu_n = nu_d + 1.0
            sq = nu_d * (data_pt - mu_d) ** 2 / nu_n
            from .math_utils import log_posterior_conditional_term_vec
            log_numer = log_posterior_conditional_term_vec(
                nu_n, ta_d + 1.0, beta_d + 0.5 * sq)
            probs = sizes * INV_SQRT_2PI * np.exp(log_numer - log_denom)
        else:
            probs = np.zeros(0)
        new_prob = dp.gamma * self._unobserved_factor_likelihood(fctr, dp)
        cdf = np.concatenate([np.cumsum(probs),
                              [probs.sum() + new_prob]])
        r = self.rng.uniform(0.0, cdf[-1])
        choice = int(np.searchsorted(cdf, r, side="left"))
        if choice >= len(pool):
            parent_dp = dp.parent
            if parent_dp is None:
                return self._new_base_factor()
            new_fctr = Factor(MIDDLE, dp)
            new_parent = self._sample_from_data_pt_factor(fctr, parent_dp)
            self._assign_to_parent(new_fctr, new_parent, False)
            return new_fctr
        return pool[choice]

    def _sample_from_middle_factor(self, fctr, dp):
        """sample_from_middle_factor (impl/hdp.c:1905-1971)."""
        pool = list(dp.factors)
        log_probs = np.empty(len(pool) + 1)
        for i, f in enumerate(pool):
            log_probs[i] = (math.log(len(f.children))
                            + self._factor_parent_joint_log_likelihood(fctr, f))
        log_probs[-1] = (math.log(dp.gamma)
                         + self._unobserved_factor_joint_log_likelihood(fctr,
                                                                        dp))
        m = log_probs.max()
        probs = np.exp(log_probs - m)
        cdf = np.cumsum(probs)
        r = self.rng.uniform(0.0, cdf[-1])
        choice = int(np.searchsorted(cdf, r, side="left"))
        if choice >= len(pool):
            parent_dp = dp.parent
            if parent_dp is None:
                return self._new_base_factor()
            new_fctr = Factor(MIDDLE, dp)
            new_parent = self._sample_from_middle_factor(fctr, parent_dp)
            self._assign_to_parent(new_fctr, new_parent, False)
            return new_fctr
        return pool[choice]

    def _gibbs_factor_iteration(self, fctr):
        parent_dp = fctr.parent.dp
        self._unassign_from_parent(fctr)
        if fctr.factor_type == DATA_PT:
            new_parent = self._sample_from_data_pt_factor(fctr, parent_dp)
        else:
            new_parent = self._sample_from_middle_factor(fctr, parent_dp)
        self._assign_to_parent(fctr, new_parent, True)

    # ------------------------------------------------------------------
    # distribution sampling
    # ------------------------------------------------------------------

    def _evaluate_posterior_predictive(self, base_fctr, x):
        """evaluate_posterior_predictive (impl/hdp.c:532-559)."""
        mu_d, nu_d, ta_d, beta_d, log_denom = base_fctr.params
        nu_n = nu_d + 1.0
        ta_n = ta_d + 1.0
        nu_ratio = nu_d / nu_n
        sq = nu_ratio * (x - mu_d) ** 2
        beta_n = beta_d + 0.5 * sq
        from .math_utils import log_posterior_conditional_term_vec
        log_numer = log_posterior_conditional_term_vec(nu_n, ta_n, beta_n)
        return INV_SQRT_2PI * np.exp(log_numer - log_denom)

    def _evaluate_prior_predictive(self, x):
        """evaluate_prior_predictive (impl/hdp.c:562-585)."""
        mu, nu, ta, beta = self.mu, self.nu, self.two_alpha, self.beta
        nu_factor = nu / (2.0 * (nu + 1.0) * beta)
        alpha_term = math.exp(math.lgamma(0.5 * (ta + 1.0))
                              - math.lgamma(0.5 * ta))
        const = alpha_term * math.sqrt(nu_factor / math.pi)
        return const * (1.0 + nu_factor * (x - mu) ** 2) ** (-0.5 * (ta + 1.0))

    def _cache_prior_contribution(self, dp, parent_prior_prod):
        if not dp.observed:
            return
        g = dp.gamma
        prod = (g / (g + dp.num_factor_children)) * parent_prior_prod
        dp.base_factor_wt += prod
        for c in dp.children:
            self._cache_prior_contribution(c, prod)

    def _cache_base_factor_weight(self, fctr):
        dp = fctr.dp
        g = dp.gamma
        wt = len(fctr.children) / (g + dp.num_factor_children)
        dp.base_factor_wt += wt
        if dp.children:
            for child_fctr in fctr.children:
                self._cache_base_factor_weight(child_fctr)
            for child_dp in dp.children:
                self._cache_prior_contribution(child_dp, wt)

    def _push_factor_distr(self, dp, distr):
        dp.posterior_predictive += dp.base_factor_wt * distr
        dp.base_factor_wt = 0.0
        for c in dp.children:
            if c.observed:
                self._push_factor_distr(c, distr)

    def _take_distr_sample(self):
        """take_distr_sample (impl/hdp.c:2059-2086)."""
        grid = self.sampling_grid
        for base_fctr in list(self.base_dp.factors):
            self._cache_base_factor_weight(base_fctr)
            pdf = self._evaluate_posterior_predictive(base_fctr, grid)
            self._push_factor_distr(self.base_dp, pdf)
        self._cache_prior_contribution(self.base_dp, 1.0)
        pdf = self._evaluate_prior_predictive(grid)
        self._push_factor_distr(self.base_dp, pdf)
        self.samples_taken += 1

    # ------------------------------------------------------------------
    # concentration parameter resampling (Escobar & West)
    # ------------------------------------------------------------------

    def _sample_gamma_params(self):
        """sample_gamma_params (impl/hdp.c:2157-2283)."""
        for dp in self.dps:
            if not dp.observed:
                continue
            self.w_aux[dp.id] = self.rng.beta(dp.gamma + 1.0,
                                              max(dp.num_factor_children, 1e-12))
            n = float(dp.num_factor_children)
            self.s_aux[dp.id] = self.rng.random() < n / (n + dp.gamma)

        num_fctrs = np.zeros(self.depth)
        sum_log_w = np.zeros(self.depth)
        sum_s = np.zeros(self.depth)
        for dp in self.dps:
            if not dp.observed:
                continue
            num_fctrs[dp.depth] += len(dp.factors)
            sum_log_w[dp.depth] += math.log(self.w_aux[dp.id])
            sum_s[dp.depth] += 1.0 if self.s_aux[dp.id] else 0.0

        # base (depth 0), Escobar & West 1995
        ga = self.gamma_alpha[0]
        gb = self.gamma_beta[0]
        n_children = float(self.base_dp.num_factor_children)
        gb_post = gb - sum_log_w[0]
        ga_post = ga + num_fctrs[0]
        frac = (ga_post - 1.0) / (n_children * gb_post)
        wt = frac / (1.0 + frac)
        g1 = self.rng.gamma(ga_post, 1.0 / gb_post)
        g2 = self.rng.gamma(max(ga_post - 1.0, 1e-12), 1.0 / gb_post)
        self.gamma[0] = wt * g1 + (1.0 - wt) * g2

        for d in range(1, self.depth):
            ga_post = self.gamma_alpha[d] + (num_fctrs[d] - sum_s[d])
            gb_post = self.gamma_beta[d] - sum_log_w[d]
            self.gamma[d] = self.rng.gamma(max(ga_post, 1e-12), 1.0 / gb_post)

    # ------------------------------------------------------------------
    # the Gibbs sampling loop
    # ------------------------------------------------------------------

    def execute_gibbs_sampling(self, num_samples, burn_in, thinning,
                               verbose=False, snapshot_func=None,
                               backend="auto"):
        """execute_gibbs_sampling(_with_snapshots) (impl/hdp.c:2480-2538).

        backend: 'native' runs the C++/OpenMP sampler
        (native/hdp_gibbs.cc) — the analogue of the reference's OpenMP hot
        path; 'python' runs this in-process sampler; 'auto' prefers native
        when the library builds and no snapshot hook is requested.  The
        sampler that ran is left in ``self.sampler``.
        """
        if self.data is None or not self.finalized:
            raise ValueError("need data and finalized structure")
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "native" and snapshot_func is not None:
            raise ValueError("snapshot_func requires backend='python' "
                             "(or 'auto'): the native sampler cannot call "
                             "back per sweep")
        if backend != "python" and snapshot_func is None:
            from .native import native_available, run_native_gibbs
            if native_available():
                run_native_gibbs(self, num_samples, burn_in, thinning)
                self.sampler = "native"
                return
            if backend == "native":
                raise RuntimeError("native hdp_gibbs library unavailable")
        self.sampler = "python"
        iter_counter = 0
        sample_counter = 0
        sweep = 0
        while sample_counter < num_samples:
            if verbose:
                print(f"HDP sweep {sweep}: {iter_counter} iterations, "
                      f"{sample_counter}/{num_samples} samples")
            if snapshot_func is not None:
                snapshot_func(self)
            sweep += 1
            order = list(range(self.num_dps))
            self.rng.shuffle(order)
            for dp_idx in order:
                dp = self.dps[dp_idx]
                if not dp.observed:
                    continue
                sampling_fctrs = [cf for f in list(dp.factors)
                                  for cf in list(f.children)]
                for fctr in sampling_fctrs:
                    self._gibbs_factor_iteration(fctr)
                    iter_counter += 1
                    if iter_counter % thinning == 0 and iter_counter > burn_in:
                        self._take_distr_sample()
                        sample_counter += 1
                        if sample_counter >= num_samples:
                            break
                if sample_counter >= num_samples:
                    break
            if self.sample_gamma and sample_counter < num_samples:
                self._sample_gamma_params()

    def finalize_distributions(self):
        """finalize_distributions (impl/hdp.c:2540-2575)."""
        if self.samples_taken <= 0:
            raise ValueError("must sample before finalizing")
        if self.splines_finalized:
            raise ValueError("already finalized")
        inv = 1.0 / self.samples_taken
        for dp in self.dps:
            if not dp.observed:
                continue
            dp.posterior_predictive *= inv
            dp.spline_slopes = spline_knot_slopes(self.sampling_grid,
                                                  dp.posterior_predictive)
        self.splines_finalized = True

    def _observed_ancestor(self, dp_id):
        dp = self.dps[dp_id]
        while not dp.observed:
            dp = dp.parent
        return dp

    def dir_proc_density(self, x, dp_id):
        """dir_proc_density (impl/hdp.c:2577-2601)."""
        if not self.splines_finalized:
            raise ValueError("finalize distributions first")
        dp = self._observed_ancestor(dp_id)
        v = grid_spline_interp(x, self.sampling_grid, dp.posterior_predictive,
                               dp.spline_slopes)
        return v if v > 0.0 else 0.0

    def dir_proc_density_vec(self, x, dp_id):
        dp = self._observed_ancestor(dp_id)
        v = grid_spline_interp_vec(x, self.sampling_grid,
                                   dp.posterior_predictive, dp.spline_slopes)
        return np.maximum(v, 0.0)

    def density_tables(self):
        """Per-DP density + slope tables for the card's emission stream."""
        tables = np.zeros((self.num_dps, self.grid_length))
        slopes = np.zeros((self.num_dps, self.grid_length))
        for dp_id in range(self.num_dps):
            dp = self._observed_ancestor(dp_id)
            tables[dp_id] = dp.posterior_predictive
            slopes[dp_id] = dp.spline_slopes
        return tables, slopes

    # ------------------------------------------------------------------
    # distribution metrics (impl/hdp.c:2603-2822)
    # ------------------------------------------------------------------

    def _distr_pair(self, id1, id2):
        return (self._observed_ancestor(id1).posterior_predictive,
                self._observed_ancestor(id2).posterior_predictive)

    def _trapz(self, vals):
        x = self.sampling_grid
        return float(np.trapezoid(vals, x))

    def kl_divergence(self, id1, id2):
        p, q = self._distr_pair(id1, id2)
        return kl_divergence(self.sampling_grid, p, q)

    def hellinger_distance(self, id1, id2):
        p, q = self._distr_pair(id1, id2)
        return hellinger_distance(self.sampling_grid, p, q)

    def l2_distance(self, id1, id2):
        p, q = self._distr_pair(id1, id2)
        return l2_distance(self.sampling_grid, p, q)

    def shannon_jensen_distance(self, id1, id2):
        p, q = self._distr_pair(id1, id2)
        return shannon_jensen_distance(self.sampling_grid, p, q)

    def compare_kl_divergence(self, dp_id, other, other_dp_id):
        return compare_hdp_distrs(self, dp_id, other, other_dp_id,
                                  kl_divergence)

    def compare_l2_distance(self, dp_id, other, other_dp_id):
        return compare_hdp_distrs(self, dp_id, other, other_dp_id,
                                  l2_distance)

    def compare_shannon_jensen_distance(self, dp_id, other, other_dp_id):
        return compare_hdp_distrs(self, dp_id, other, other_dp_id,
                                  shannon_jensen_distance)

    def compare_hellinger_distance(self, dp_id, other, other_dp_id):
        return compare_hdp_distrs(self, dp_id, other, other_dp_id,
                                  hellinger_distance)

    def metric_memo(self, metric_name):
        """new_*_memo (impl/hdp.c:2678-2762): memoized pairwise distances."""
        fn = getattr(self, metric_name)
        memo = {}

        def get(i, j):
            if i == j:
                return 0.0
            key = (min(i, j), max(i, j))
            if key not in memo:
                memo[key] = fn(*key)
            return memo[key]

        return get

    # ------------------------------------------------------------------
    # serialization (sampler-state round-trip; JSON-based rather than the
    # reference's bespoke text layout, impl/hdp.c:2825-3278)
    # ------------------------------------------------------------------

    def serialize(self, path):
        factors = []
        factor_ids = {}

        def visit(fctr, parent_id):
            fid = len(factors)
            factor_ids[id(fctr)] = fid
            factors.append({
                "type": fctr.factor_type,
                "parent": parent_id,
                "dp": fctr.dp.id if fctr.dp is not None else -1,
                "params": list(fctr.params) if fctr.params else None,
                "data_idx": fctr.data_pt_idx,
            })
            if fctr.children:
                for c in fctr.children:
                    visit(c, fid)

        if self.base_dp is not None:
            for f in list(self.base_dp.factors):
                visit(f, -1)

        doc = {
            "num_dps": self.num_dps,
            "depth": self.depth,
            "mu": self.mu, "nu": self.nu, "two_alpha": self.two_alpha,
            "beta": self.beta,
            "grid": [float(self.sampling_grid[0]),
                     float(self.sampling_grid[-1]), self.grid_length],
            "sample_gamma": self.sample_gamma,
            "gamma": self.gamma.tolist(),
            "gamma_alpha": (self.gamma_alpha.tolist()
                            if self.gamma_alpha is not None else None),
            "gamma_beta": (self.gamma_beta.tolist()
                           if self.gamma_beta is not None else None),
            "parents": [dp.parent.id if dp.parent else -1 for dp in self.dps],
            "data": self.data.tolist() if self.data is not None else None,
            "dp_ids": (self.data_pt_dp_id.tolist()
                       if self.data_pt_dp_id is not None else None),
            "samples_taken": self.samples_taken,
            "splines_finalized": self.splines_finalized,
            "posterior": {str(dp.id): dp.posterior_predictive.tolist()
                          for dp in self.dps
                          if dp.posterior_predictive is not None},
            "factors": factors,
        }
        with open(path, "w") as fh:
            json.dump(doc, fh)

    @classmethod
    def deserialize(cls, path):
        with open(path) as fh:
            doc = json.load(fh)
        kwargs = dict(grid_start=doc["grid"][0], grid_stop=doc["grid"][1],
                      grid_length=doc["grid"][2], mu=doc["mu"], nu=doc["nu"],
                      alpha=doc["two_alpha"] / 2.0, beta=doc["beta"])
        if doc["sample_gamma"]:
            hdp = cls(doc["num_dps"], doc["depth"],
                      gamma_alpha=doc["gamma_alpha"],
                      gamma_beta=doc["gamma_beta"], **kwargs)
        else:
            hdp = cls(doc["num_dps"], doc["depth"], gamma=doc["gamma"],
                      **kwargs)
        hdp.gamma = np.asarray(doc["gamma"])
        for child, parent in enumerate(doc["parents"]):
            if parent >= 0:
                hdp.set_dir_proc_parent(child, parent)
        hdp.finalize_structure()
        if doc["data"] is not None:
            # restore data without re-initializing factors
            hdp.data = np.asarray(doc["data"])
            hdp.data_pt_dp_id = np.asarray(doc["dp_ids"], dtype=np.int64)
            for i in set(hdp.data_pt_dp_id.tolist()):
                dp = hdp.dps[i]
                while dp is not None and not dp.observed:
                    dp.observed = True
                    dp = dp.parent
            for dp in hdp.dps:
                if dp.observed and dp.posterior_predictive is None:
                    dp.posterior_predictive = np.zeros(hdp.grid_length)
            # rebuild factor trees
            restored = []
            for spec in doc["factors"]:
                dp = hdp.dps[spec["dp"]] if spec["dp"] >= 0 else None
                f = Factor(spec["type"], dp)
                f.params = spec["params"]
                f.data_pt_idx = spec["data_idx"]
                restored.append(f)
            for f, spec in zip(restored, doc["factors"]):
                if spec["parent"] >= 0:
                    parent = restored[spec["parent"]]
                    f.parent = parent
                    parent.children.add(f)
            for dp in hdp.dps:
                dp.num_factor_children = sum(len(f.children)
                                             for f in dp.factors)
        hdp.samples_taken = doc["samples_taken"]
        for dp_id_str, post in doc["posterior"].items():
            hdp.dps[int(dp_id_str)].posterior_predictive = np.asarray(post)
        if doc["splines_finalized"]:
            hdp.splines_finalized = False
            if hdp.samples_taken > 0:
                # recompute slopes from stored (already averaged) posteriors
                for dp in hdp.dps:
                    if dp.observed:
                        dp.spline_slopes = spline_knot_slopes(
                            hdp.sampling_grid, dp.posterior_predictive)
                hdp.splines_finalized = True
        return hdp


# ----------------------------------------------------------------------
# distribution metrics on a shared grid + cross-HDP comparisons
# (impl/hdp.c:2603-2676, 2766-2822)
# ----------------------------------------------------------------------

def _trapz(grid, vals):
    return float(np.trapezoid(vals, grid))


def kl_divergence(grid, p, q):
    """Symmetrized KL (kl_divergence, impl/hdp.c:2603-2620)."""
    return _trapz(grid, p * np.log(p / q) + q * np.log(q / p))


def hellinger_distance(grid, p, q):
    return math.sqrt(max(1.0 - _trapz(grid, np.sqrt(p * q)), 0.0))


def l2_distance(grid, p, q):
    return math.sqrt(_trapz(grid, (p - q) ** 2))


def shannon_jensen_distance(grid, p, q):
    m = 0.5 * (p + q)
    return math.sqrt(max(_trapz(
        grid, 0.5 * (p * np.log(p / m) + q * np.log(q / m))), 0.0))


def compare_hdp_distrs(hdp_1, dp_id_1, hdp_2, dp_id_2, dist_func):
    """compare_hdp_distrs (impl/hdp.c:2766-2799): compare DP dp_id_1 of one
    HDP with DP dp_id_2 of an independently-trained second HDP.  hdp_1 is
    the master: its sampling grid carries the comparison; hdp_2's density
    is spline-evaluated at those grid points."""
    if not (hdp_1.splines_finalized and hdp_2.splines_finalized):
        raise ValueError("finalize distributions of both HDPs before "
                         "comparing")
    grid = hdp_1.sampling_grid
    p = hdp_1._observed_ancestor(dp_id_1).posterior_predictive
    q = hdp_2.dir_proc_density_vec(grid, dp_id_2)
    return dist_func(grid, p, q)


def compare_hdp_distrs_kl_divergence(hdp_1, dp_id_1, hdp_2, dp_id_2):
    return compare_hdp_distrs(hdp_1, dp_id_1, hdp_2, dp_id_2, kl_divergence)


def compare_hdp_distrs_l2_distance(hdp_1, dp_id_1, hdp_2, dp_id_2):
    return compare_hdp_distrs(hdp_1, dp_id_1, hdp_2, dp_id_2, l2_distance)


def compare_hdp_distrs_shannon_jensen_distance(hdp_1, dp_id_1, hdp_2,
                                               dp_id_2):
    return compare_hdp_distrs(hdp_1, dp_id_1, hdp_2, dp_id_2,
                              shannon_jensen_distance)


def compare_hdp_distrs_hellinger_distance(hdp_1, dp_id_1, hdp_2, dp_id_2):
    return compare_hdp_distrs(hdp_1, dp_id_1, hdp_2, dp_id_2,
                              hellinger_distance)
