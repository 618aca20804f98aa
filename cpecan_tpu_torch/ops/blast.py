"""lastz ("blast") anchor generation on the host (a copy of
``cpecan_tpu/ops/blast.py``).

Parity with getBlastPairs / getBlastPairsForPairwiseAlignmentParameters
(impl/pairwiseAligner.c:1114-1330).  The reference shells out to its vendored
``cPecanLastz`` binary with fixed flags and parses exonerate cigars; so does
this module.  Anchoring is host-side preprocessing: the card only sees the
resulting integer anchor arrays.
"""

import os
import shutil
import subprocess
import tempfile

from ..io.cigar import parse_cigar_line
from .anchors import filter_to_remove_overlap

LASTZ_ARGS = ["--hspthresh=1800", "--chain", "--strand=plus", "--gapped",
              "--format=cigar", "--gap=100,100", "--ambiguous=iupac,100,100"]


def find_lastz():
    for cand in (os.path.join(os.path.dirname(__file__), "..", "..", "bin", "cPecanLastz"),
                 "./cPecanLastz"):
        cand = os.path.abspath(cand)
        if os.path.exists(cand) and os.access(cand, os.X_OK):
            return cand
    return shutil.which("cPecanLastz") or shutil.which("lastz")


def _cigar_to_anchor_pairs(aln, trim):
    """convertPairwiseForwardStrandAlignmentToAnchorPairs
    (impl/pairwiseAligner.c:1088-1112)."""
    pairs = []
    j, k = aln.start1, aln.start2
    assert aln.strand1 and aln.strand2
    for op, length in aln.operations:
        if op == "M":
            for l in range(trim, length - trim):
                pairs.append((j + l, k + l))
        if op != "I":   # X (contig1/target) advances unless insert-in-query
            j += length
        if op != "D":   # Y (contig2/query) advances unless delete-from-query
            k += length
    return pairs


def get_blast_pairs(seq_x, seq_y, trim, repeat_mask, lastz_path=None):
    """impl/pairwiseAligner.c:1114-1194.  Returns (x, y) pairs sorted by x+y."""
    if len(seq_x) == 0 or len(seq_y) == 0:
        return []
    if not repeat_mask:
        seq_x = seq_x.upper()
        seq_y = seq_y.upper()
    lastz = lastz_path or find_lastz()
    if lastz is None:
        raise RuntimeError("cPecanLastz binary not found (expected in bin/)")

    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "a.fa")
        fb = os.path.join(td, "b.fa")
        with open(fa, "w") as fh:
            fh.write(">a\n" + seq_x + "\n")
        with open(fb, "w") as fh:
            fh.write(">b\n" + seq_y + "\n")
        res = subprocess.run([lastz] + LASTZ_ARGS + [fa, fb],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"lastz failed: {res.stderr[:500]}")
        pairs = []
        for line in res.stdout.splitlines():
            if not line.startswith("cigar:"):
                continue
            aln = parse_cigar_line(line)
            assert aln.contig1 == "a" and aln.contig2 == "b"
            pairs.extend(_cigar_to_anchor_pairs(aln, trim))
    pairs.sort(key=lambda p: (p[0] + p[1]))
    return pairs


def get_blast_pairs_for_pairwise_alignment_parameters(seq_x, seq_y, params,
                                                      lastz_path=None):
    """impl/pairwiseAligner.c:1279-1330: two-level anchoring with
    un-repeat-masked recursion into big inter-anchor gaps."""
    l_x, l_y = len(seq_x), len(seq_y)
    if l_x * l_y <= params.anchor_matrix_bigger_than_this:
        return []
    unfiltered = sorted(get_blast_pairs(seq_x, seq_y,
                                        params.constraint_diagonal_trim, True,
                                        lastz_path))
    top = filter_to_remove_overlap(unfiltered)

    def recurse(p_x, p_y, x, y, combined):
        l_x2, l_y2 = x - p_x, y - p_y
        if l_x2 * l_y2 > params.repeat_mask_matrix_bigger_than_this:
            sub = sorted(get_blast_pairs(seq_x[p_x:x], seq_y[p_y:y],
                                         params.constraint_diagonal_trim,
                                         False, lastz_path))
            sub = filter_to_remove_overlap(sub)
            combined.extend((a + p_x, b + p_y) for a, b in sub)

    combined = []
    p_x = p_y = 0
    for x, y in top:
        assert 0 <= x < l_x and 0 <= y < l_y and x >= p_x and y >= p_y
        recurse(p_x, p_y, x, y, combined)
        combined.append((x, y))
        p_x, p_y = x + 1, y + 1
    recurse(p_x, p_y, l_x, l_y, combined)
    return combined
