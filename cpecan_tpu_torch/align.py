"""High-level alignment parameters (counterpart of ``cpecan_tpu/align.py``;
only the dataclass is ported so far)."""

from dataclasses import dataclass


@dataclass
class AlignmentParams:
    """pairwiseAlignmentBandingParameters_construct defaults
    (impl/pairwiseAligner.c:1477-1490)."""

    threshold: float = 0.01
    min_diags_between_traceback: int = 1000
    traceback_diagonals: int = 40
    diagonal_expansion: int = 20
    constraint_diagonal_trim: int = 14
    anchor_matrix_bigger_than_this: int = 500 * 500
    repeat_mask_matrix_bigger_than_this: int = 500 * 500
    split_matrix_bigger_than_this: int = 3000 * 3000
    align_ambiguity_characters: bool = False
    gap_gamma: float = 0.5
