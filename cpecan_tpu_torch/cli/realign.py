"""Helpers of the cPecanRealign-equivalent CLI that the port's pipelines
need (a subset of ``cpecan_tpu/cli/realign.py``, which imports JAX through
``ops.engine`` and so cannot be imported here).  The CLI itself is not
ported yet (ROADMAP Queue 1 item 8)."""

from ..io.cigar import PairwiseAlignment


def convert_alignment_to_anchor_pairs(aln: PairwiseAlignment, trim):
    """convertPairwiseForwardStrandAlignmentToAnchorPairs
    (impl/pairwiseAligner.c:1088-1112)."""
    pairs = []
    j, k = aln.start1, aln.start2
    assert aln.strand1 and aln.strand2
    for op, length in aln.operations:
        if op == "M":
            for l in range(trim, length - trim):
                pairs.append((j + l, k + l))
        if op != "I":
            j += length
        if op != "D":
            k += length
    return pairs


def rebase_coordinates(aln, which, shift, flip):
    """rebasePairwiseAlignmentCoordinates (cPecanRealign.c:210-220)."""
    if which == 1:
        aln.start1 += shift
        aln.end1 += shift
        if flip:
            aln.strand1 = not aln.strand1
            aln.start1, aln.end1 = aln.end1, aln.start1
    else:
        aln.start2 += shift
        aln.end2 += shift
        if flip:
            aln.strand2 = not aln.strand2
            aln.start2, aln.end2 = aln.end2, aln.start2
