"""AMAP-style gap reweighting (impl/pairwiseAligner.c:1667-1711; a copy
of ``cpecan_tpu/ops/reweight.py``)."""

import numpy as np

from ..constants import PAIR_ALIGNMENT_PROB_1


def get_indel_probabilities(aligned_pairs, seq_length, x_if_true_else_y):
    """getIndelProbabilities (impl/pairwiseAligner.c:1667-1682)."""
    indel = np.full(seq_length, PAIR_ALIGNMENT_PROB_1, dtype=np.int64)
    for score, x, y in aligned_pairs:
        indel[x if x_if_true_else_y else y] -= score
    return np.maximum(indel, 0)


def reweight_aligned_pairs_2(aligned_pairs, l_x, l_y, gap_gamma):
    """reweightAlignedPairs2 (impl/pairwiseAligner.c:1699-1711): subtract
    gapGamma * (indelProbX + indelProbY) from each pair's weight."""
    if gap_gamma <= 0.0:
        return aligned_pairs
    indel_x = get_indel_probabilities(aligned_pairs, l_x, True)
    indel_y = get_indel_probabilities(aligned_pairs, l_y, False)
    return [(int(score - gap_gamma * (indel_x[x] + indel_y[y])), x, y)
            for score, x, y in aligned_pairs]
