"""Base / kmer indexing on the host (the part of
``cpecan_tpu/models/kmers.py`` that the port uses).

Parity with emissions_discrete_getBaseIndex / getKmerIndex
(impl/stateMachine.c:104-153): A,C,G,T -> 0..3 lexicographic; any other
character (N/n) maps to the sentinel NUM_OF_KMERS+1 = 4097, which the signal
emission tables treat as "no model".
"""

import numpy as np

from ..constants import KMER_LENGTH, N_SENTINEL

_BASE_LUT = np.full(256, -1, dtype=np.int64)
for _i, _c in enumerate("ACGT"):
    _BASE_LUT[ord(_c)] = _i


def seq_to_base_indices(seq):
    """Vectorized base indices for a DNA string; N -> N_SENTINEL."""
    arr = _BASE_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    return np.where(arr >= 0, arr, N_SENTINEL)


def seq_to_kmer_indices(seq, length=None):
    """Kmer index of the 6-mer starting at each position p of ``seq``.

    ``length`` defaults to the len(seq) - (KMER_LENGTH-1) positions whose
    window fits (sequence_correctSeqLength, impl/pairwiseAligner.c:355-370);
    a caller may ask for more positions, whose clamped windows get
    N_SENTINEL, as does a window that holds a non-ACGT char."""
    base = seq_to_base_indices(seq)
    if length is None:
        length = max(len(seq) - (KMER_LENGTH - 1), 0)
    out = np.full(length, N_SENTINEL, dtype=np.int64)
    valid_len = min(length, max(len(seq) - (KMER_LENGTH - 1), 0))
    if valid_len > 0:
        windows = np.lib.stride_tricks.sliding_window_view(
            base[:valid_len + KMER_LENGTH - 1], KMER_LENGTH)
        ok = np.all(windows < 4, axis=1)
        # reference weighting: 4^5,4^4,4^3,4^2,4^1,4^0 (last char weight 1)
        weights = 4 ** np.arange(KMER_LENGTH - 1, -1, -1, dtype=np.int64)
        out[:valid_len] = np.where(ok, windows @ weights, N_SENTINEL)
    return out
