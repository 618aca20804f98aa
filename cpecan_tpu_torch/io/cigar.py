"""Exonerate cigar parsing (sonLib pairwiseAlignment convention; the part
of ``cpecan_tpu/io/cigar.py`` that the port uses).

The text line names the *query* first:

    cigar: <contig2> <start2> <end2> <strand2> <contig1> <start1> <end1>
           <strand1> <score> [op length]...

but sonLib's PairwiseAlignment maps the second-named sequence to
``contig1`` (the target / X sequence), as getBlastPairs asserts
(impl/pairwiseAligner.c:1164).

Op semantics (convertPairwiseForwardStrandAlignmentToAnchorPairs,
impl/pairwiseAligner.c:1094-1106): M — both advance; I — query (Y/contig2)
only; D — target (X/contig1) only.
"""

from dataclasses import dataclass, field


@dataclass
class PairwiseAlignment:
    contig1: str          # target / X
    start1: int
    end1: int
    strand1: bool         # True == '+'
    contig2: str          # query / Y
    start2: int
    end2: int
    strand2: bool
    score: float
    operations: list = field(default_factory=list)  # [(op, length)] op in MID


def parse_cigar_line(line):
    toks = line.split()
    if toks[0] != "cigar:":
        raise ValueError(f"not a cigar line: {line[:80]}")
    c2, s2, e2, st2, c1, s1, e1, st1, score = toks[1:10]
    ops = []
    rest = toks[10:]
    if len(rest) % 2 != 0:
        raise ValueError("odd number of cigar op tokens")
    for i in range(0, len(rest), 2):
        op = rest[i]
        if op not in "MID":
            raise ValueError(f"bad cigar op {op}")
        ops.append((op, int(rest[i + 1])))
    return PairwiseAlignment(
        contig1=c1, start1=int(s1), end1=int(e1), strand1=st1 == "+",
        contig2=c2, start2=int(s2), end2=int(e2), strand2=st2 == "+",
        score=float(score), operations=ops)
