// Native HDP Gibbs-sampling core.
//
// C++/OpenMP implementation of the Chinese-restaurant-franchise Gibbs
// sampler, mirroring the Python reference implementation in
// cpecan_tpu/hdp/hdp.py (itself a re-design of the reference C code,
// impl/hdp.c).  The candidate-parent likelihood scans — the loops the
// reference parallelizes with OpenMP (impl/hdp.c:1805-1816,1925-1936) —
// are OpenMP `parallel for` here as well.  Factors live in an index-based
// arena (no pointer chasing, free-list recycling), which is also what
// makes the ctypes C API possible.
//
// Exposed as a flat C API (see extern "C" block at the bottom); the
// Python wrapper is cpecan_tpu/hdp/native.py.
//
// Numerical contract: identical formulas to hdp.py (posterior
// normal-inverse-gamma updates, joint log-likelihoods, Escobar-West
// gamma resampling).  RNG streams differ, so parity with the Python
// backend is distributional, not bitwise.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_set>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int BASE = 0;
constexpr int MIDDLE = 1;
constexpr int DATA_PT = 2;
constexpr double MINUS_INF = -0.5 * 1.7976931348623157e308;
const double HALF_LOG_2PI = 0.5 * std::log(2.0 * M_PI);
const double INV_SQRT_2PI = 1.0 / std::sqrt(2.0 * M_PI);

double log_post_term(double nu, double two_alpha, double beta) {
  return std::lgamma(0.5 * two_alpha) -
         0.5 * (std::log(nu) + two_alpha * std::log(beta));
}

double add_logs(double a, double b) {
  if (a > b) std::swap(a, b);
  if (a <= MINUS_INF) return b;
  return b + std::log1p(std::exp(a - b));
}

struct Factor {
  int type = BASE;
  int parent = -1;
  int dp = -1;
  int data_idx = -1;
  bool alive = false;
  double params[5] = {0, 0, 0, 0, 0};  // base: mu, nu, 2a, beta, log_term
  std::unordered_set<int> children;
};

struct DP {
  int parent = -1;
  int depth = 0;
  bool observed = false;
  long num_factor_children = 0;
  double base_factor_wt = 0.0;
  double cached_mean = 0.0, cached_ssd = 0.0;
  long cached_size = 0;
  std::vector<int> children;
  std::unordered_set<int> factors;
  std::vector<double> posterior;
};

struct Hdp {
  int num_dps = 0, depth = 0;
  double mu = 0, nu = 1, two_alpha = 4, beta = 1;
  std::vector<double> grid;
  bool sample_gamma = false;
  std::vector<double> gamma, gamma_alpha, gamma_beta, w_aux;
  std::vector<uint8_t> s_aux;
  std::vector<DP> dps;
  int base_dp = -1;
  std::vector<double> data;
  std::vector<int64_t> data_dp;
  bool finalized = false;
  long samples_taken = 0;
  std::vector<Factor> factors;
  std::vector<int> free_list;
  std::mt19937_64 rng;

  // ---------------- factor arena ----------------
  int alloc_factor(int type, int dp_id) {
    int fid;
    if (!free_list.empty()) {
      fid = free_list.back();
      free_list.pop_back();
      factors[fid] = Factor();
    } else {
      fid = (int)factors.size();
      factors.emplace_back();
    }
    Factor &f = factors[fid];
    f.type = type;
    f.dp = dp_id;
    f.alive = true;
    if (dp_id >= 0) dps[dp_id].factors.insert(fid);
    return fid;
  }

  int new_base_factor() {
    int fid = alloc_factor(BASE, base_dp);
    Factor &f = factors[fid];
    f.params[0] = mu;
    f.params[1] = nu;
    f.params[2] = two_alpha;
    f.params[3] = beta;
    f.params[4] = log_post_term(nu, two_alpha, beta);
    return fid;
  }

  void release_factor(int fid) {
    factors[fid].alive = false;
    factors[fid].children.clear();
    free_list.push_back(fid);
  }

  // ---------------- factor math ----------------
  void factor_stats(int fid, double *mean, double *ssd, long *n) const {
    // two-pass over the data points under fid (matches hdp.py _factor_stats)
    std::vector<int> stack = {fid};
    std::vector<double> vals;
    while (!stack.empty()) {
      int cur = stack.back();
      stack.pop_back();
      const Factor &f = factors[cur];
      if (f.type == DATA_PT) {
        vals.push_back(data[f.data_idx]);
      } else {
        for (int c : f.children) stack.push_back(c);
      }
    }
    *n = (long)vals.size();
    if (vals.empty()) {
      *mean = 0.0;
      *ssd = 0.0;
      return;
    }
    double m = 0.0;
    for (double v : vals) m += v;
    m /= (double)vals.size();
    double s = 0.0;
    for (double v : vals) s += (v - m) * (v - m);
    *mean = m;
    *ssd = s;
  }

  void add_update_base_params(int fid, double mean, double ssd, double n) {
    double *p = factors[fid].params;
    double nu_post = p[1] + n;
    double mu_post = (p[0] * p[1] + mean * n) / nu_post;
    double ta_post = p[2] + n;
    double dev = mean - p[0];
    double sq = p[1] * n * dev * dev / nu_post;
    double beta_post = p[3] + 0.5 * (ssd + sq);
    p[0] = mu_post;
    p[1] = nu_post;
    p[2] = ta_post;
    p[3] = beta_post;
    p[4] = log_post_term(nu_post, ta_post, beta_post);
  }

  void remove_update_base_params(int fid, double mean, double ssd, double n) {
    double *p = factors[fid].params;
    double nu_prev = p[1] - n;
    double mu_prev = (p[0] * p[1] - mean * n) / nu_prev;
    double ta_prev = p[2] - n;
    double dev = mean - mu_prev;
    double sq = nu_prev * n * dev * dev / p[1];
    double beta_prev = p[3] - 0.5 * (ssd + sq);
    p[0] = mu_prev;
    p[1] = nu_prev;
    p[2] = ta_prev;
    p[3] = beta_prev;
    p[4] = log_post_term(nu_prev, ta_prev, beta_prev);
  }

  int get_base_factor(int fid) const {
    while (fid >= 0 && factors[fid].type != BASE) fid = factors[fid].parent;
    return fid;
  }

  double data_pt_parent_likelihood(double data_pt, int parent) const {
    const double *p = factors[get_base_factor(parent)].params;
    double nu_n = p[1] + 1.0;
    double sq = p[1] * (data_pt - p[0]) * (data_pt - p[0]) / nu_n;
    double log_numer = log_post_term(nu_n, p[2] + 1.0, p[3] + 0.5 * sq);
    return INV_SQRT_2PI * std::exp(log_numer - p[4]);
  }

  double factor_parent_joint_ll(int fid, int parent) const {
    const DP &dp = dps[factors[fid].dp];
    double n = (double)dp.cached_size;
    double mean = dp.cached_mean, ssd = dp.cached_ssd;
    const double *p = factors[get_base_factor(parent)].params;
    double nu_n = p[1] + n;
    double ta_n = p[2] + n;
    double sq = p[1] * n * (mean - p[0]) * (mean - p[0]) / nu_n;
    double beta_n = p[3] + 0.5 * (ssd + sq);
    return -n * HALF_LOG_2PI + log_post_term(nu_n, ta_n, beta_n) - p[4];
  }

  double prior_likelihood(double data_pt) const {
    double dev = data_pt - mu;
    double alpha_term =
        std::exp(std::lgamma(0.5 * (two_alpha + 1.0)) -
                 std::lgamma(0.5 * two_alpha));
    double nu_term = nu / (2.0 * (nu + 1.0) * beta);
    double beta_term =
        std::pow(1.0 + nu_term * dev * dev, -0.5 * (two_alpha + 1.0));
    return alpha_term * std::sqrt(nu_term / M_PI) * beta_term;
  }

  double prior_joint_ll(int fid) const {
    const DP &dp = dps[factors[fid].dp];
    double n = (double)dp.cached_size;
    double mean = dp.cached_mean, ssd = dp.cached_ssd;
    double sq = nu * n * (mean - mu) * (mean - mu) / (nu + n);
    double log_alpha = std::lgamma(0.5 * (two_alpha + n)) -
                       std::lgamma(0.5 * two_alpha);
    double log_nu = 0.5 * (std::log(nu) - std::log(nu + n));
    double log_pi = n * HALF_LOG_2PI;
    double log_b1 = two_alpha * std::log(beta);
    double log_b2 = (two_alpha + n) * std::log(beta + 0.5 * (ssd + sq));
    return log_alpha + log_nu - log_pi + 0.5 * (log_b1 - log_b2);
  }

  double unobserved_factor_likelihood(int fid, int dp_id) const {
    int parent_dp = dps[dp_id].parent;
    if (parent_dp < 0) return prior_likelihood(data[factors[fid].data_idx]);
    const DP &pd = dps[parent_dp];
    double pg = gamma[pd.depth];
    double lik = 0.0;
    double data_pt = data[factors[fid].data_idx];
    for (int pf : pd.factors)
      lik += (double)factors[pf].children.size() *
             data_pt_parent_likelihood(data_pt, pf);
    lik += pg * unobserved_factor_likelihood(fid, parent_dp);
    return lik / (pg + (double)pd.num_factor_children);
  }

  double unobserved_factor_joint_ll(int fid, int dp_id) const {
    int parent_dp = dps[dp_id].parent;
    if (parent_dp < 0) return prior_joint_ll(fid);
    const DP &pd = dps[parent_dp];
    double pg = gamma[pd.depth];
    double ll = MINUS_INF;
    for (int pf : pd.factors)
      ll = add_logs(ll, std::log((double)factors[pf].children.size()) +
                            factor_parent_joint_ll(fid, pf));
    ll = add_logs(ll,
                  std::log(pg) + unobserved_factor_joint_ll(fid, parent_dp));
    return ll - std::log(pg + (double)pd.num_factor_children);
  }

  // ---------------- Gibbs moves ----------------
  void destroy_factor(int fid) {
    int parent = factors[fid].parent;
    if (parent >= 0) {
      factors[parent].children.erase(fid);
      dps[factors[parent].dp].num_factor_children -= 1;
      if (factors[parent].children.empty()) destroy_factor(parent);
    }
    if (factors[fid].dp >= 0) dps[factors[fid].dp].factors.erase(fid);
    release_factor(fid);
  }

  void unassign_from_parent(int fid) {
    int parent = factors[fid].parent;
    int base = get_base_factor(parent);
    int base_dp_id = factors[base].dp;
    factors[parent].children.erase(fid);
    factors[fid].parent = -1;
    dps[factors[parent].dp].num_factor_children -= 1;
    bool base_destroyed = false;
    if (factors[parent].children.empty()) {
      // record whether the base factor survives the cascade
      destroy_factor(parent);
      base_destroyed = !factors[base].alive;
    }
    double mean, ssd;
    long n;
    factor_stats(fid, &mean, &ssd, &n);
    if (!base_destroyed && dps[base_dp_id].factors.count(base))
      remove_update_base_params(base, mean, ssd, (double)n);
    if (factors[fid].dp >= 0) {
      DP &dp = dps[factors[fid].dp];
      dp.cached_mean = mean;
      dp.cached_ssd = ssd;
      dp.cached_size = n;
    }
  }

  void assign_to_parent(int fid, int parent, bool update_params) {
    factors[fid].parent = parent;
    factors[parent].children.insert(fid);
    dps[factors[parent].dp].num_factor_children += 1;
    if (!update_params) return;
    int base = get_base_factor(parent);
    if (factors[fid].type == DATA_PT) {
      add_update_base_params(base, data[factors[fid].data_idx], 0.0, 1.0);
    } else {
      const DP &dp = dps[factors[fid].dp];
      add_update_base_params(base, dp.cached_mean, dp.cached_ssd,
                             (double)dp.cached_size);
    }
  }

  double uniform(double lo, double hi) {
    std::uniform_real_distribution<double> d(lo, hi);
    return d(rng);
  }

  int sample_from_data_pt_factor(int fid, int dp_id) {
    DP &dp = dps[dp_id];
    std::vector<int> pool(dp.factors.begin(), dp.factors.end());
    double data_pt = data[factors[fid].data_idx];
    std::vector<double> probs(pool.size());
    // the reference's OpenMP-parallel candidate scan (impl/hdp.c:1805-1816)
#pragma omp parallel for if (pool.size() > 256) schedule(static)
    for (long i = 0; i < (long)pool.size(); ++i) {
      probs[i] = (double)factors[pool[i]].children.size() *
                 data_pt_parent_likelihood(data_pt, pool[i]);
    }
    double total = 0.0;
    for (double p : probs) total += p;
    double new_prob =
        gamma[dp.depth] * unobserved_factor_likelihood(fid, dp_id);
    double r = uniform(0.0, total + new_prob);
    double acc = 0.0;
    long choice = (long)pool.size();
    for (long i = 0; i < (long)pool.size(); ++i) {
      acc += probs[i];
      if (r <= acc) {
        choice = i;
        break;
      }
    }
    if (choice >= (long)pool.size()) {
      int parent_dp = dp.parent;
      if (parent_dp < 0) return new_base_factor();
      int new_fctr = alloc_factor(MIDDLE, dp_id);
      int new_parent = sample_from_data_pt_factor(fid, parent_dp);
      assign_to_parent(new_fctr, new_parent, false);
      return new_fctr;
    }
    return pool[choice];
  }

  int sample_from_middle_factor(int fid, int dp_id) {
    DP &dp = dps[dp_id];
    std::vector<int> pool(dp.factors.begin(), dp.factors.end());
    std::vector<double> log_probs(pool.size() + 1);
#pragma omp parallel for if (pool.size() > 256) schedule(static)
    for (long i = 0; i < (long)pool.size(); ++i) {
      log_probs[i] = std::log((double)factors[pool[i]].children.size()) +
                     factor_parent_joint_ll(fid, pool[i]);
    }
    log_probs[pool.size()] =
        std::log(gamma[dp.depth]) + unobserved_factor_joint_ll(fid, dp_id);
    double m = MINUS_INF;
    for (double v : log_probs) m = std::max(m, v);
    double total = 0.0;
    for (double &v : log_probs) {
      v = std::exp(v - m);
      total += v;
    }
    double r = uniform(0.0, total);
    double acc = 0.0;
    long choice = (long)pool.size();
    for (long i = 0; i < (long)log_probs.size(); ++i) {
      acc += log_probs[i];
      if (r <= acc) {
        choice = i;
        break;
      }
    }
    if (choice >= (long)pool.size()) {
      int parent_dp = dp.parent;
      if (parent_dp < 0) return new_base_factor();
      int new_fctr = alloc_factor(MIDDLE, dp_id);
      int new_parent = sample_from_middle_factor(fid, parent_dp);
      assign_to_parent(new_fctr, new_parent, false);
      return new_fctr;
    }
    return pool[choice];
  }

  void gibbs_factor_iteration(int fid) {
    int parent_dp = factors[factors[fid].parent].dp;
    unassign_from_parent(fid);
    int new_parent = (factors[fid].type == DATA_PT)
                         ? sample_from_data_pt_factor(fid, parent_dp)
                         : sample_from_middle_factor(fid, parent_dp);
    assign_to_parent(fid, new_parent, true);
  }

  // ---------------- distribution sampling ----------------
  void cache_prior_contribution(int dp_id, double parent_prod) {
    DP &dp = dps[dp_id];
    if (!dp.observed) return;
    double g = gamma[dp.depth];
    double prod = (g / (g + (double)dp.num_factor_children)) * parent_prod;
    dp.base_factor_wt += prod;
    for (int c : dp.children) cache_prior_contribution(c, prod);
  }

  void cache_base_factor_weight(int fid) {
    DP &dp = dps[factors[fid].dp];
    double g = gamma[dp.depth];
    double wt = (double)factors[fid].children.size() /
                (g + (double)dp.num_factor_children);
    dp.base_factor_wt += wt;
    if (!dp.children.empty()) {
      for (int cf : factors[fid].children) cache_base_factor_weight(cf);
      for (int cd : dp.children) cache_prior_contribution(cd, wt);
    }
  }

  void push_factor_distr(int dp_id, const std::vector<double> &distr) {
    DP &dp = dps[dp_id];
    double w = dp.base_factor_wt;
    for (size_t i = 0; i < grid.size(); ++i)
      dp.posterior[i] += w * distr[i];
    dp.base_factor_wt = 0.0;
    for (int c : dp.children)
      if (dps[c].observed) push_factor_distr(c, distr);
  }

  void evaluate_posterior_predictive(int fid, std::vector<double> &out) const {
    const double *p = factors[fid].params;
    double nu_n = p[1] + 1.0;
    double ta_n = p[2] + 1.0;
    double nu_ratio = p[1] / nu_n;
#pragma omp parallel for if (grid.size() > 512) schedule(static)
    for (long i = 0; i < (long)grid.size(); ++i) {
      double sq = nu_ratio * (grid[i] - p[0]) * (grid[i] - p[0]);
      double log_numer = log_post_term(nu_n, ta_n, p[3] + 0.5 * sq);
      out[i] = INV_SQRT_2PI * std::exp(log_numer - p[4]);
    }
  }

  void evaluate_prior_predictive(std::vector<double> &out) const {
    double nu_factor = nu / (2.0 * (nu + 1.0) * beta);
    double alpha_term =
        std::exp(std::lgamma(0.5 * (two_alpha + 1.0)) -
                 std::lgamma(0.5 * two_alpha));
    double c = alpha_term * std::sqrt(nu_factor / M_PI);
    for (size_t i = 0; i < grid.size(); ++i) {
      double dev = grid[i] - mu;
      out[i] = c * std::pow(1.0 + nu_factor * dev * dev,
                            -0.5 * (two_alpha + 1.0));
    }
  }

  void take_distr_sample() {
    std::vector<double> pdf(grid.size());
    std::vector<int> base_factors(dps[base_dp].factors.begin(),
                                  dps[base_dp].factors.end());
    for (int bf : base_factors) {
      cache_base_factor_weight(bf);
      evaluate_posterior_predictive(bf, pdf);
      push_factor_distr(base_dp, pdf);
    }
    cache_prior_contribution(base_dp, 1.0);
    evaluate_prior_predictive(pdf);
    push_factor_distr(base_dp, pdf);
    samples_taken += 1;
  }

  // ---------------- gamma resampling (Escobar & West) ----------------
  double gamma_deviate(double shape, double scale) {
    std::gamma_distribution<double> d(std::max(shape, 1e-12), scale);
    return d(rng);
  }

  double beta_deviate(double a, double b) {
    double x = gamma_deviate(a, 1.0);
    double y = gamma_deviate(b, 1.0);
    return x / (x + y);
  }

  void sample_gamma_params() {
    for (int i = 0; i < num_dps; ++i) {
      DP &dp = dps[i];
      if (!dp.observed) continue;
      double g = gamma[dp.depth];
      w_aux[i] = beta_deviate(g + 1.0,
                              std::max((double)dp.num_factor_children, 1e-12));
      double n = (double)dp.num_factor_children;
      s_aux[i] = uniform(0.0, 1.0) < n / (n + g) ? 1 : 0;
    }
    std::vector<double> num_fctrs(depth, 0.0), sum_log_w(depth, 0.0),
        sum_s(depth, 0.0);
    for (int i = 0; i < num_dps; ++i) {
      DP &dp = dps[i];
      if (!dp.observed) continue;
      num_fctrs[dp.depth] += (double)dp.factors.size();
      sum_log_w[dp.depth] += std::log(w_aux[i]);
      sum_s[dp.depth] += s_aux[i] ? 1.0 : 0.0;
    }
    double n_children = (double)dps[base_dp].num_factor_children;
    double gb_post = gamma_beta[0] - sum_log_w[0];
    double ga_post = gamma_alpha[0] + num_fctrs[0];
    double frac = (ga_post - 1.0) / (n_children * gb_post);
    double wt = frac / (1.0 + frac);
    double g1 = gamma_deviate(ga_post, 1.0 / gb_post);
    double g2 = gamma_deviate(ga_post - 1.0, 1.0 / gb_post);
    gamma[0] = wt * g1 + (1.0 - wt) * g2;
    for (int d = 1; d < depth; ++d) {
      double ga = gamma_alpha[d] + (num_fctrs[d] - sum_s[d]);
      double gb = gamma_beta[d] - sum_log_w[d];
      gamma[d] = gamma_deviate(ga, 1.0 / gb);
    }
  }

  // ---------------- setup ----------------
  void finalize_structure() {
    for (int i = 0; i < num_dps; ++i)
      if (dps[i].parent < 0) base_dp = i;
    // depths by BFS from root
    std::vector<int> stack = {base_dp};
    dps[base_dp].depth = 0;
    while (!stack.empty()) {
      int cur = stack.back();
      stack.pop_back();
      for (int c : dps[cur].children) {
        dps[c].depth = dps[cur].depth + 1;
        stack.push_back(c);
      }
    }
    finalized = true;
  }

  void init_factors() {
    // mark observed chains
    for (int64_t dp_id : data_dp) {
      int cur = (int)dp_id;
      while (cur >= 0 && !dps[cur].observed) {
        dps[cur].observed = true;
        cur = dps[cur].parent;
      }
    }
    for (auto &dp : dps)
      if (dp.observed) dp.posterior.assign(grid.size(), 0.0);

    // one starter factor per observed DP, all data under the single chain
    std::vector<std::vector<int>> data_fctrs(num_dps);
    for (size_t i = 0; i < data.size(); ++i) {
      int fid = alloc_factor(DATA_PT, -1);
      factors[fid].data_idx = (int)i;
      data_fctrs[data_dp[i]].push_back(fid);
    }
    int root_factor = new_base_factor();

    // iterative DFS mirroring hdp.py _init_factors
    std::vector<std::pair<int, int>> work;  // (dp, parent factor)
    for (int c : dps[base_dp].children) work.push_back({c, root_factor});
    while (!work.empty()) {
      auto [dp_id, parent_fctr] = work.back();
      work.pop_back();
      if (!dps[dp_id].observed) continue;
      int fid = alloc_factor(MIDDLE, dp_id);
      factors[fid].parent = parent_fctr;
      factors[parent_fctr].children.insert(fid);
      if (dps[dp_id].children.empty()) {
        for (int dpf : data_fctrs[dp_id]) {
          factors[dpf].parent = fid;
          factors[fid].children.insert(dpf);
        }
      } else {
        for (int c : dps[dp_id].children) work.push_back({c, fid});
      }
    }
    double mean, ssd;
    long n;
    factor_stats(root_factor, &mean, &ssd, &n);
    add_update_base_params(root_factor, mean, ssd, (double)n);
    for (int i = 0; i < num_dps; ++i) {
      long nfc = 0;
      for (int fid : dps[i].factors) nfc += (long)factors[fid].children.size();
      dps[i].num_factor_children = nfc;
    }
  }

  void execute(long num_samples, long burn_in, long thinning) {
    long iter_counter = 0, sample_counter = 0;
    std::vector<int> order(num_dps);
    for (int i = 0; i < num_dps; ++i) order[i] = i;
    while (sample_counter < num_samples) {
      std::shuffle(order.begin(), order.end(), rng);
      for (int dp_idx : order) {
        DP &dp = dps[dp_idx];
        if (!dp.observed) continue;
        std::vector<int> sampling;
        for (int fid : dp.factors)
          for (int cf : factors[fid].children) sampling.push_back(cf);
        for (int fctr : sampling) {
          gibbs_factor_iteration(fctr);
          iter_counter += 1;
          if (iter_counter % thinning == 0 && iter_counter > burn_in) {
            take_distr_sample();
            sample_counter += 1;
            if (sample_counter >= num_samples) break;
          }
        }
        if (sample_counter >= num_samples) break;
      }
      if (sample_gamma && sample_counter < num_samples) sample_gamma_params();
    }
  }
};

}  // namespace

extern "C" {

void *hdp_new(int num_dps, int depth, double mu, double nu, double two_alpha,
              double beta, double grid_start, double grid_stop,
              int grid_length, uint64_t seed) {
  Hdp *h = new Hdp();
  h->num_dps = num_dps;
  h->depth = depth;
  h->mu = mu;
  h->nu = nu;
  h->two_alpha = two_alpha;
  h->beta = beta;
  h->grid.resize(grid_length);
  for (int i = 0; i < grid_length; ++i)
    h->grid[i] = grid_start +
                 (grid_stop - grid_start) * (double)i / (double)(grid_length - 1);
  h->dps.resize(num_dps);
  h->gamma.assign(depth, 1.0);
  h->rng.seed(seed);
  return h;
}

void hdp_free(void *hp) { delete (Hdp *)hp; }

void hdp_set_gamma(void *hp, const double *g) {
  Hdp *h = (Hdp *)hp;
  h->sample_gamma = false;
  for (int i = 0; i < h->depth; ++i) h->gamma[i] = g[i];
}

void hdp_set_gamma_prior(void *hp, const double *alpha, const double *beta) {
  Hdp *h = (Hdp *)hp;
  h->sample_gamma = true;
  h->gamma_alpha.assign(alpha, alpha + h->depth);
  h->gamma_beta.assign(beta, beta + h->depth);
  for (int i = 0; i < h->depth; ++i) h->gamma[i] = alpha[i] / beta[i];
  h->w_aux.assign(h->num_dps, 1.0);
  h->s_aux.assign(h->num_dps, 0);
}

void hdp_set_parent(void *hp, int child, int parent) {
  Hdp *h = (Hdp *)hp;
  h->dps[child].parent = parent;
  h->dps[parent].children.push_back(child);
}

void hdp_finalize(void *hp) { ((Hdp *)hp)->finalize_structure(); }

void hdp_pass_data(void *hp, const double *data, const int64_t *dp_ids,
                   long n) {
  Hdp *h = (Hdp *)hp;
  h->data.assign(data, data + n);
  h->data_dp.assign(dp_ids, dp_ids + n);
  h->init_factors();
}

void hdp_gibbs(void *hp, long num_samples, long burn_in, long thinning) {
  ((Hdp *)hp)->execute(num_samples, burn_in, thinning);
}

long hdp_samples_taken(void *hp) { return ((Hdp *)hp)->samples_taken; }

int hdp_observed(void *hp, int dp_id) {
  return ((Hdp *)hp)->dps[dp_id].observed ? 1 : 0;
}

void hdp_get_posterior(void *hp, int dp_id, double *out) {
  Hdp *h = (Hdp *)hp;
  const auto &p = h->dps[dp_id].posterior;
  if (p.empty())
    std::memset(out, 0, sizeof(double) * h->grid.size());
  else
    std::memcpy(out, p.data(), sizeof(double) * h->grid.size());
}

void hdp_get_gamma(void *hp, double *out) {
  Hdp *h = (Hdp *)hp;
  std::memcpy(out, h->gamma.data(), sizeof(double) * h->depth);
}

long hdp_num_factors(void *hp, int dp_id) {
  return (long)((Hdp *)hp)->dps[dp_id].factors.size();
}

}  // extern "C"
