"""Exonerate cigar I/O (sonLib pairwiseAlignment convention; a copy of
``cpecan_tpu/io/cigar.py``).

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


def cigar_read_stream(fh):
    for line in fh:
        line = line.strip()
        if line.startswith("cigar:"):
            yield parse_cigar_line(line)


def cigar_write(aln: PairwiseAlignment):
    parts = ["cigar:", aln.contig2, str(aln.start2), str(aln.end2),
             "+" if aln.strand2 else "-",
             aln.contig1, str(aln.start1), str(aln.end1),
             "+" if aln.strand1 else "-",
             ("%g" % aln.score)]
    for op, length in aln.operations:
        parts.append(op)
        parts.append(str(length))
    return " ".join(parts)


def check_pairwise_alignment(aln):
    """checkPairwiseAlignment invariants (sonLib): coordinates consistent
    with the operation lengths."""
    d1 = sum(l for op, l in aln.operations if op != "I")
    d2 = sum(l for op, l in aln.operations if op != "D")
    span1 = aln.end1 - aln.start1 if aln.strand1 else aln.start1 - aln.end1
    span2 = aln.end2 - aln.start2 if aln.strand2 else aln.start2 - aln.end2
    if span1 != d1 or span2 != d2:
        raise ValueError("cigar operation lengths do not match coordinates")
