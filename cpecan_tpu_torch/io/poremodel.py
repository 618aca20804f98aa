"""Pore-model file I/O, read-specific scaling and k-mer skip bins (the part
of ``cpecan_tpu/io/poremodel.py`` that the port uses).

Parity with emissions_signal_loadPoreModel (impl/stateMachine.c:243-321):
3-line text format
  1: [correlation] then MODEL_PARAMS values per kmer  (match model)
  2: 30 kmer-skip bin probabilities
  3: [correlation] then MODEL_PARAMS values per kmer  (scaled "extra event"
     model, used for gap-Y emissions)
"""

from dataclasses import dataclass, replace

import numpy as np

from ..constants import MODEL_PARAMS, NUM_OF_KMERS

# Column order within a model row (inc/stateMachine.h:16).
LEVEL_MEAN, LEVEL_SD, NOISE_MEAN, NOISE_SD, NOISE_LAMBDA = range(MODEL_PARAMS)


@dataclass
class PoreModel:
    match_correlation: float
    match_model: np.ndarray       # [NUM_OF_KMERS, MODEL_PARAMS] float64
    skip_bins: np.ndarray         # [30] float64 (NOT log space)
    gap_y_correlation: float
    gap_y_model: np.ndarray       # [NUM_OF_KMERS, MODEL_PARAMS]


def load_pore_model(path, n_kmers=NUM_OF_KMERS):
    with open(path) as fh:
        l1 = np.array(fh.readline().split(), dtype=np.float64)
        l2 = np.array(fh.readline().split(), dtype=np.float64)
        l3 = np.array(fh.readline().split(), dtype=np.float64)
    if (len(l1) != 1 + n_kmers * MODEL_PARAMS
            or len(l3) != 1 + n_kmers * MODEL_PARAMS):
        raise ValueError("pore model does not match the expected kmer count")
    if len(l2) != 30:
        raise ValueError(f"expected 30 kmer skip bins, got {len(l2)}")
    return PoreModel(
        match_correlation=float(l1[0]),
        match_model=l1[1:].reshape(n_kmers, MODEL_PARAMS),
        skip_bins=l2,
        gap_y_correlation=float(l3[0]),
        gap_y_model=l3[1:].reshape(n_kmers, MODEL_PARAMS),
    )


def scale_model(model: PoreModel, scale, shift, var, scale_sd, var_sd):
    """emissions_signal_scaleModel (impl/stateMachine.c:632-674).

    Only the *match* model is adjusted by the read-specific parameters; the
    gap-Y ("extra event") model is left untouched by the reference.
    """
    m = model.match_model.copy()
    m[:, LEVEL_MEAN] = m[:, LEVEL_MEAN] * scale + shift
    m[:, LEVEL_SD] = m[:, LEVEL_SD] * var
    m[:, NOISE_MEAN] = m[:, NOISE_MEAN] * scale_sd
    m[:, NOISE_LAMBDA] = m[:, NOISE_LAMBDA] * var_sd
    m[:, NOISE_SD] = np.sqrt(m[:, NOISE_MEAN] ** 3 / m[:, NOISE_LAMBDA])
    return replace(model, match_model=m)


def kmer_skip_bin_table(match_model, kmer_idx_prev, kmer_idx_next,
                        scale=None, shift=None):
    """emissions_signal_getKmerSkipBin (impl/stateMachine.c:389-420): bin of
    |level_mean(k_i) - level_mean(k_{i-1})| in 0.5 pA steps, clamped to 29.

    Indices > NUM_OF_KMERS-1 contribute a 0.0 model mean (the reference's
    out-of-range guard, impl/stateMachine.c:222-225).

    ``scale``/``shift`` apply emissions_signal_scaleModel's level_mean
    transform per lookup (broadcast against the index arrays, e.g. [B, 1]
    per-read columns against [B, X] indices): the bins the reference
    computes from a per-read *scaled* model, without materializing one
    scaled table per read.  The shift cancels between two valid kmers but
    not against the out-of-range 0.0 guard, so it is applied before the
    difference, exactly as the reference does.
    """
    def mean(idx):
        idx = np.asarray(idx)
        safe = np.clip(idx, 0, NUM_OF_KMERS - 1)
        m = match_model[safe, LEVEL_MEAN]
        if scale is not None:
            m = m * scale + shift
        return np.where(idx > NUM_OF_KMERS, 0.0, m)

    d = np.abs(mean(kmer_idx_next) - mean(kmer_idx_prev))
    return np.minimum((d / 0.5).astype(np.int64), 29)
