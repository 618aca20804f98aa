"""Kmer-aware HDP wrapper (port of impl/nanopore_hdp.c).

Provides the reference's four pre-built DP-tree topologies (flat, multiset,
middle-2-nts, purine-composition), each with fixed-gamma and Gamma-prior
variants, kmer <-> DP-id indexing, training from alignment tsvs, and the
NIG prior fit from an ONT pore-model file.
"""

import itertools
import math

import numpy as np

from .hdp import HierarchicalDirichletProcess
from .math_utils import mle_normal_inverse_gamma_params

# alignment tsv columns (impl/nanopore_hdp.c:9-13; matches the signal-align
# CLI's 15-column output)
ALIGNMENT_KMER_COL = 9
ALIGNMENT_STRAND_COL = 4
ALIGNMENT_SIGNAL_COL = 13


def power(n, k):
    return n ** k


def multiset_number(n, k):
    """((n k)) multichoose (impl/nanopore_hdp.c:274-283)."""
    return math.comb(n + k - 1, k)


def get_word(word_id, alphabet_size, word_length):
    word = [0] * word_length
    rem = word_id
    for i in range(word_length):
        word[word_length - i - 1] = rem % alphabet_size
        rem //= alphabet_size
    return word


def word_id(word, alphabet_size):
    out = 0
    for w in word:
        out = out * alphabet_size + w
    return out


def multiset_id(multiset, alphabet_size):
    """multiset_id (impl/nanopore_hdp.c:317-336): lexicographic rank of the
    sorted multiset."""
    def internal(tail, alphabet_min):
        head = tail[0]
        if len(tail) == 1:
            return head - alphabet_min
        step = 0
        for i in range(alphabet_min, alphabet_size):
            if head > i:
                step += multiset_number(alphabet_size - i, len(tail) - 1)
            else:
                return step + internal(tail[1:], i)
        raise ValueError("character outside alphabet in multiset")

    return internal(multiset, 0)


def word_id_to_multiset_id(wid, alphabet_size, word_length):
    return multiset_id(sorted(get_word(wid, alphabet_size, word_length)),
                       alphabet_size)


def kmer_id(kmer, alphabet, kmer_length):
    word = [alphabet.index(c) for c in kmer[:kmer_length]]
    return word_id(word, len(alphabet))


def standard_kmer_id(kmer, kmer_length=6):
    return kmer_id(kmer, "ACGT", kmer_length)


class NanoporeHDP:
    """package_nanopore_hdp (impl/nanopore_hdp.c:30-74)."""

    def __init__(self, hdp: HierarchicalDirichletProcess, alphabet,
                 kmer_length):
        self.hdp = hdp
        self.alphabet = "".join(sorted(alphabet))
        self.alphabet_size = len(self.alphabet)
        self.kmer_length = kmer_length

    def kmer_id(self, kmer):
        return kmer_id(kmer, self.alphabet, self.kmer_length)

    def kmer_density(self, x, kmer):
        """get_nanopore_kmer_density (impl/nanopore_hdp.c:386-388)."""
        return self.hdp.dir_proc_density(x, self.kmer_id(kmer))

    def execute_gibbs_sampling(self, num_samples, burn_in, thinning,
                               verbose=False, backend="auto"):
        self.hdp.execute_gibbs_sampling(num_samples, burn_in, thinning,
                                        verbose, backend=backend)

    def finalize_distributions(self):
        self.hdp.finalize_distributions()

    def update_from_alignment(self, alignment_path, has_header=False,
                              strand_filter=None):
        """update_nhdp_from_alignment_with_filter
        (impl/nanopore_hdp.c:181-258): read (kmer, signal) rows, reset, and
        pass to the HDP."""
        signals = []
        dp_ids = []
        with open(alignment_path) as fh:
            if has_header:
                fh.readline()
            for line in fh:
                tokens = line.split()
                if not tokens:
                    continue
                if (strand_filter is not None
                        and tokens[ALIGNMENT_STRAND_COL] != strand_filter):
                    continue
                signals.append(float(tokens[ALIGNMENT_SIGNAL_COL]))
                dp_ids.append(self.kmer_id(tokens[ALIGNMENT_KMER_COL]))
        self.hdp.reset_data()
        self.hdp.pass_data(signals, dp_ids)

    def update_from_assignments(self, kmers, signals):
        """HdpHmm assignment intake (hdpHmm_loadFromFile passes assignments
        into the NHDP, impl/continuousHmm.c:833-872)."""
        dp_ids = [self.kmer_id(k) for k in kmers]
        self.hdp.reset_data()
        self.hdp.pass_data(signals, dp_ids)

    def density_tables(self):
        """[num_kmers, grid] density + slope tables for device emission
        lookup (only the kmer-leaf DPs)."""
        tables, slopes = self.hdp.density_tables()
        n_kmers = self.alphabet_size ** self.kmer_length
        return (self.hdp.sampling_grid, tables[:n_kmers], slopes[:n_kmers])

    def serialize(self, path):
        """serialize_nhdp (impl/nanopore_hdp.c:828-848)."""
        import json
        self.hdp.serialize(path + ".hdp")
        with open(path, "w") as fh:
            json.dump({"alphabet": self.alphabet,
                       "kmer_length": self.kmer_length,
                       "hdp_file": path + ".hdp"}, fh)

    @classmethod
    def deserialize(cls, path):
        import json
        with open(path) as fh:
            doc = json.load(fh)
        hdp = HierarchicalDirichletProcess.deserialize(doc["hdp_file"])
        return cls(hdp, doc["alphabet"], doc["kmer_length"])


def normal_inverse_gamma_params_from_minion(model_path):
    """normal_inverse_gamma_params_from_minION (impl/nanopore_hdp.c:120-155).

    NOTE: the reference re-scans the *mean* string into the noise variable
    (impl/nanopore_hdp.c:141 uses mean_str), so precisions are computed from
    the level means; we reproduce that behaviour for parity.
    """
    with open(model_path) as fh:
        tokens = fh.readline().split()
    vals = np.array(tokens[1:], dtype=np.float64).reshape(-1, 5)
    means = vals[:, 0]
    noise = means  # reference bug preserved (reads mean_str into noise)
    precisions = 1.0 / (noise * noise)
    return mle_normal_inverse_gamma_params(means, precisions)


def _minion_hdp(num_dps, depth, model_path, grid_start, grid_stop,
                grid_length, gamma=None, gamma_alpha=None, gamma_beta=None):
    mu, nu, alpha, beta = normal_inverse_gamma_params_from_minion(model_path)
    return HierarchicalDirichletProcess(
        num_dps, depth, gamma=gamma, gamma_alpha=gamma_alpha,
        gamma_beta=gamma_beta, grid_start=grid_start, grid_stop=grid_stop,
        grid_length=grid_length, mu=mu, nu=nu, alpha=alpha, beta=beta)


def _package(hdp, alphabet, kmer_length):
    return NanoporeHDP(hdp, alphabet, kmer_length)


def flat_hdp_model(alphabet, kmer_length, base_gamma, leaf_gamma,
                   grid_start, grid_stop, grid_length, model_path):
    """flat_hdp_model (impl/nanopore_hdp.c:444-470): every kmer DP is a
    child of one base DP."""
    a = len(alphabet)
    num_leaves = power(a, kmer_length)
    hdp = _minion_hdp(num_leaves + 1, 2, model_path, grid_start, grid_stop,
                      grid_length, gamma=[base_gamma, leaf_gamma])
    for i in range(num_leaves):
        hdp.set_dir_proc_parent(i, num_leaves)
    hdp.finalize_structure()
    return _package(hdp, alphabet, kmer_length)


def flat_hdp_model_2(alphabet, kmer_length, base_gamma_alpha, base_gamma_beta,
                     leaf_gamma_alpha, leaf_gamma_beta, grid_start, grid_stop,
                     grid_length, model_path):
    a = len(alphabet)
    num_leaves = power(a, kmer_length)
    hdp = _minion_hdp(num_leaves + 1, 2, model_path, grid_start, grid_stop,
                      grid_length,
                      gamma_alpha=[base_gamma_alpha, leaf_gamma_alpha],
                      gamma_beta=[base_gamma_beta, leaf_gamma_beta])
    for i in range(num_leaves):
        hdp.set_dir_proc_parent(i, num_leaves)
    hdp.finalize_structure()
    return _package(hdp, alphabet, kmer_length)


def _multiset_structure(hdp, alphabet_size, kmer_length):
    num_leaves = power(alphabet_size, kmer_length)
    num_middle = multiset_number(alphabet_size, kmer_length)
    for kid in range(num_leaves):
        mid = word_id_to_multiset_id(kid, alphabet_size, kmer_length)
        hdp.set_dir_proc_parent(kid, num_leaves + mid)
    last = num_leaves + num_middle
    for mid in range(num_leaves, last):
        hdp.set_dir_proc_parent(mid, last)


def multiset_hdp_model(alphabet, kmer_length, base_gamma, middle_gamma,
                       leaf_gamma, grid_start, grid_stop, grid_length,
                       model_path):
    """multiset_hdp_model (impl/nanopore_hdp.c:514-545): kmers grouped by
    their base multiset."""
    a = len(alphabet)
    n = power(a, kmer_length) + multiset_number(a, kmer_length) + 1
    hdp = _minion_hdp(n, 3, model_path, grid_start, grid_stop, grid_length,
                      gamma=[base_gamma, middle_gamma, leaf_gamma])
    _multiset_structure(hdp, a, kmer_length)
    hdp.finalize_structure()
    return _package(hdp, alphabet, kmer_length)


def multiset_hdp_model_2(alphabet, kmer_length, base_ga, base_gb, mid_ga,
                         mid_gb, leaf_ga, leaf_gb, grid_start, grid_stop,
                         grid_length, model_path):
    a = len(alphabet)
    n = power(a, kmer_length) + multiset_number(a, kmer_length) + 1
    hdp = _minion_hdp(n, 3, model_path, grid_start, grid_stop, grid_length,
                      gamma_alpha=[base_ga, mid_ga, leaf_ga],
                      gamma_beta=[base_gb, mid_gb, leaf_gb])
    _multiset_structure(hdp, a, kmer_length)
    hdp.finalize_structure()
    return _package(hdp, alphabet, kmer_length)


def kmer_id_to_middle_nts_id(kid, alphabet_size, kmer_length):
    word = get_word(kid, alphabet_size, kmer_length)
    return alphabet_size * word[kmer_length // 2 - 1] + word[kmer_length // 2]


def _middle_2_structure(hdp, alphabet_size, kmer_length):
    num_leaves = power(alphabet_size, kmer_length)
    num_middle = power(alphabet_size, 2)
    for kid in range(num_leaves):
        mid = kmer_id_to_middle_nts_id(kid, alphabet_size, kmer_length)
        hdp.set_dir_proc_parent(kid, num_leaves + mid)
    last = num_leaves + num_middle
    for mid in range(num_leaves, last):
        hdp.set_dir_proc_parent(mid, last)


def middle_2_nts_hdp_model(alphabet, kmer_length, base_gamma, middle_gamma,
                           leaf_gamma, grid_start, grid_stop, grid_length,
                           model_path):
    """middle_2_nts_hdp_model (impl/nanopore_hdp.c:607-637)."""
    a = len(alphabet)
    n = power(a, kmer_length) + power(a, 2) + 1
    hdp = _minion_hdp(n, 3, model_path, grid_start, grid_stop, grid_length,
                      gamma=[base_gamma, middle_gamma, leaf_gamma])
    _middle_2_structure(hdp, a, kmer_length)
    hdp.finalize_structure()
    return _package(hdp, alphabet, kmer_length)


def middle_2_nts_hdp_model_2(alphabet, kmer_length, base_ga, base_gb, mid_ga,
                             mid_gb, leaf_ga, leaf_gb, grid_start, grid_stop,
                             grid_length, model_path):
    a = len(alphabet)
    n = power(a, kmer_length) + power(a, 2) + 1
    hdp = _minion_hdp(n, 3, model_path, grid_start, grid_stop, grid_length,
                      gamma_alpha=[base_ga, mid_ga, leaf_ga],
                      gamma_beta=[base_gb, mid_gb, leaf_gb])
    _middle_2_structure(hdp, a, kmer_length)
    hdp.finalize_structure()
    return _package(hdp, alphabet, kmer_length)


def _purine_structure(hdp, purines, alphabet, kmer_length):
    alphabet_size = len(alphabet)
    num_leaves = power(alphabet_size, kmer_length)
    num_middle = kmer_length + 1
    purine_set = {alphabet.index(p) for p in purines}
    for kid in range(num_leaves):
        word = get_word(kid, alphabet_size, kmer_length)
        n_purines = sum(1 for w in word if w in purine_set)
        hdp.set_dir_proc_parent(kid, num_leaves + n_purines)
    last = num_leaves + num_middle
    for mid in range(num_leaves, last):
        hdp.set_dir_proc_parent(mid, last)


def purine_composition_hdp_model(alphabet, purines, kmer_length, base_gamma,
                                 middle_gamma, leaf_gamma, grid_start,
                                 grid_stop, grid_length, model_path):
    """purine_composition_hdp_model (impl/nanopore_hdp.c:656-...): kmers
    grouped by purine count."""
    a = len(alphabet)
    n = power(a, kmer_length) + (kmer_length + 1) + 1
    hdp = _minion_hdp(n, 3, model_path, grid_start, grid_stop, grid_length,
                      gamma=[base_gamma, middle_gamma, leaf_gamma])
    _purine_structure(hdp, purines, "".join(sorted(alphabet)), kmer_length)
    hdp.finalize_structure()
    return _package(hdp, alphabet, kmer_length)


def purine_composition_hdp_model_2(alphabet, purines, kmer_length, base_ga,
                                   base_gb, mid_ga, mid_gb, leaf_ga, leaf_gb,
                                   grid_start, grid_stop, grid_length,
                                   model_path):
    a = len(alphabet)
    n = power(a, kmer_length) + (kmer_length + 1) + 1
    hdp = _minion_hdp(n, 3, model_path, grid_start, grid_stop, grid_length,
                      gamma_alpha=[base_ga, mid_ga, leaf_ga],
                      gamma_beta=[base_gb, mid_gb, leaf_gb])
    _purine_structure(hdp, purines, "".join(sorted(alphabet)), kmer_length)
    hdp.finalize_structure()
    return _package(hdp, alphabet, kmer_length)


# ----------------------------------------------------------------------
# kmer-keyed cross-NHDP distribution comparisons
# (compare_nhdp_distrs_*, impl/nanopore_hdp.c:418-443)
# ----------------------------------------------------------------------

def compare_nhdp_distrs_kl_divergence(nhdp_1, kmer_1, nhdp_2, kmer_2):
    from .hdp import compare_hdp_distrs_kl_divergence
    return compare_hdp_distrs_kl_divergence(
        nhdp_1.hdp, nhdp_1.kmer_id(kmer_1),
        nhdp_2.hdp, nhdp_2.kmer_id(kmer_2))


def compare_nhdp_distrs_l2_distance(nhdp_1, kmer_1, nhdp_2, kmer_2):
    from .hdp import compare_hdp_distrs_l2_distance
    return compare_hdp_distrs_l2_distance(
        nhdp_1.hdp, nhdp_1.kmer_id(kmer_1),
        nhdp_2.hdp, nhdp_2.kmer_id(kmer_2))


def compare_nhdp_distrs_shannon_jensen_distance(nhdp_1, kmer_1, nhdp_2,
                                                kmer_2):
    from .hdp import compare_hdp_distrs_shannon_jensen_distance
    return compare_hdp_distrs_shannon_jensen_distance(
        nhdp_1.hdp, nhdp_1.kmer_id(kmer_1),
        nhdp_2.hdp, nhdp_2.kmer_id(kmer_2))


def compare_nhdp_distrs_hellinger_distance(nhdp_1, kmer_1, nhdp_2, kmer_2):
    from .hdp import compare_hdp_distrs_hellinger_distance
    return compare_hdp_distrs_hellinger_distance(
        nhdp_1.hdp, nhdp_1.kmer_id(kmer_1),
        nhdp_2.hdp, nhdp_2.kmer_id(kmer_2))
