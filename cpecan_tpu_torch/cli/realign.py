"""cPecanRealign-equivalent CLI (counterpart of ``cpecan_tpu/cli/realign.py``).

Reads exonerate cigars on stdin and fasta files as arguments; realigns
each with the banded posterior wavefront of the 5-state DNA machine and
writes cigars to stdout.  Flags mirror cPecanRealign.c:382-675, including
the realign-specific parameter overrides (trim 0, split 10, expansion 4,
matchGamma 0.85).

The port's only engine is the wavefront one (the JAX CLI's ``--engine
pallas``): every cigar's split regions become jobs of one
``Dna5Aligner.run`` ragged at both ends, on the CUDA device unless
``--device`` says otherwise.  The JAX CLI's default ``--engine scan`` and
its ``-v/--outputExpectations`` run the f64 scan engine, which is not
ported (ROADMAP Queue 1 item 7): both raise ``NotImplementedError``.

    python -m cpecan_tpu_torch.cli.realign seqs.fa < in.cigar > out.cigar
"""

import argparse
import logging
import sys

from ..align import AlignmentParams
from ..constants import PAIR_ALIGNMENT_PROB_1
from ..io.cigar import (PairwiseAlignment, check_pairwise_alignment,
                        cigar_read_stream, cigar_write)
from ..io.fasta import reverse_complement, sequences_from_fastas
from ..models.hmm import HmmDiscrete, sm5_from_hmm
from ..models.state_machines import StateMachine5
from ..msa.multiple_aligner import \
    filter_pairwise_alignment_to_make_pairs_ordered
from ..ops.anchors import get_split_points
from ..ops.compact import extract_pairs_auto
from ..ops.fb import Dna5Aligner
from ..ops.reweight import reweight_aligned_pairs_2

SCAN_ENGINE = ("the scan engine is not ported (ROADMAP Queue 1 item 7); the "
               "port's engine is the wavefront one, --engine pallas")

# st_setLogLevelFromString levels (cPecanRealign.c:507)
_LOG_LEVELS = {"OFF": logging.CRITICAL + 10, "CRITICAL": logging.CRITICAL,
               "INFO": logging.INFO, "DEBUG": logging.DEBUG}


def set_log_level(level):
    """Set the port's log level from OFF/CRITICAL/INFO/DEBUG (any case)."""
    name = (level or "OFF").upper()
    if name not in _LOG_LEVELS:
        raise ValueError(f"unknown log level {level!r}; "
                         f"expected one of {sorted(_LOG_LEVELS)}")
    logging.getLogger("cpecan_tpu_torch").setLevel(_LOG_LEVELS[name])


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


def convert_aligned_pairs_to_pairwise_alignment(name1, name2, score, l1, l2,
                                                pairs):
    """convertAlignedPairsToPairwiseAlignment (cPecanRealign.c:59-101)."""
    ops = []
    p_x = p_y = -1
    m_l = 0
    for x, y in list(pairs) + [(l1, l2)]:
        if x - p_x > 0 and y - p_y > 0:
            if x - p_x > 1:
                if m_l > 0:
                    ops.append(("M", m_l))
                    m_l = 0
                ops.append(("D", x - p_x - 1))
            if y - p_y > 1:
                if m_l > 0:
                    ops.append(("M", m_l))
                    m_l = 0
                ops.append(("I", y - p_y - 1))
            m_l += 1
            p_x, p_y = x, y
    if m_l > 1:
        ops.append(("M", m_l - 1))
    return PairwiseAlignment(name1, 0, l1, True, name2, 0, l2, True, score,
                             ops)


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


def get_sub_sequence(seq, start, end, strand):
    """getSubSequence (cPecanRealign.c:222-230)."""
    if strand:
        return seq[start:end]
    return reverse_complement(seq[end:start])


def split_pairwise_alignment(aln, max_indel):
    """splitPairwiseAlignment (cPecanRealign.c:126-209): split at indel runs
    longer than max_indel, never ending an alignment with indels."""
    out = []
    cur_pos1, cur_pos2 = aln.start1, aln.start2
    run = 0
    cur_start1, cur_start2 = aln.start1, aln.start2
    cur_end1 = cur_end2 = 0
    cur_ops = []
    indel_ops = []
    sgn1 = 1 if aln.strand1 else -1
    sgn2 = 1 if aln.strand2 else -1
    for op, length in aln.operations:
        if op == "M":
            if run > max_indel and cur_ops:
                out.append(PairwiseAlignment(
                    aln.contig1, cur_start1, cur_end1, aln.strand1,
                    aln.contig2, cur_start2, cur_end2, aln.strand2,
                    aln.score, cur_ops))
                cur_ops = []
                indel_ops = []
                cur_start1, cur_start2 = cur_pos1, cur_pos2
                cur_end1, cur_end2 = cur_start1, cur_start2
            elif not cur_ops:
                indel_ops = []
                cur_start1, cur_start2 = cur_pos1, cur_pos2
                cur_end1, cur_end2 = cur_start1, cur_start2
            run = 0
            cur_ops.extend(indel_ops)
            indel_ops = []
            cur_pos1 += sgn1 * length
            cur_pos2 += sgn2 * length
            cur_end1, cur_end2 = cur_pos1, cur_pos2
            cur_ops.append((op, length))
        elif op == "D":  # indel in X (target advances)
            run += length
            cur_pos1 += sgn1 * length
            indel_ops.append((op, length))
        else:            # "I": indel in Y
            run += length
            cur_pos2 += sgn2 * length
            indel_ops.append((op, length))
    if cur_ops:
        out.append(PairwiseAlignment(
            aln.contig1, cur_start1, cur_end1, aln.strand1,
            aln.contig2, cur_start2, cur_end2, aln.strand2, aln.score,
            cur_ops))
    return out


def _matching(sub_x, sub_y, pairs):
    return sum(1 for _s, x, y in pairs
               if sub_x[x].upper() == sub_y[y].upper()
               and sub_x[x].upper() != "N")


def score_by_identity(sub_x, sub_y, pairs):
    m = _matching(sub_x, sub_y, pairs)
    l = len(sub_x) + len(sub_y)
    return 100.0 * (0 if l == 0 else 2.0 * m / l)


def score_by_identity_ignoring_gaps(sub_x, sub_y, pairs):
    return 100.0 * _matching(sub_x, sub_y, pairs) / max(len(pairs), 1)


def score_by_posterior_probability(l_x, l_y, pairs):
    total = sum(s for s, _, _ in pairs)
    l = l_x + l_y
    return 100.0 * (0 if l == 0 else 2.0 * total / (l * PAIR_ALIGNMENT_PROB_1))


def score_by_posterior_probability_ignoring_gaps(pairs):
    total = sum(s for s, _, _ in pairs)
    return 100.0 * total / (max(len(pairs), 1) * PAIR_ALIGNMENT_PROB_1)


def score_anchor_pairs(anchor_pairs, aligned_pairs):
    """scoreAnchorPairs (cPecanRealign.c:350-380)."""
    remaining = set(anchor_pairs)
    out = []
    for s, x, y in aligned_pairs:
        if (x, y) in remaining:
            out.append((s, x, y))
            remaining.discard((x, y))
    out.extend((0, x, y) for x, y in sorted(remaining))
    return out


def make_parser():
    p = argparse.ArgumentParser(prog="cpecan-torch-realign", add_help=False)
    p.add_argument("fastas", nargs="+")
    p.add_argument("-a", "--logLevel", default=None)
    p.add_argument("-l", "--gapGamma", type=float, default=0.5)
    p.add_argument("-L", "--matchGamma", type=float, default=0.85)
    # default is the raw area 10; an explicit flag value j is squared
    # (cPecanRealign.c:388,453)
    p.add_argument("-o", "--splitMatrixBiggerThanThis", type=int,
                   default=None)
    p.add_argument("-r", "--diagonalExpansion", type=int, default=4)
    p.add_argument("-t", "--constraintDiagonalTrim", type=int, default=0)
    p.add_argument("-w", "--alignAmbiguityCharacters", action="store_true")
    p.add_argument("-x", "--rescoreOriginalAlignment", action="store_true")
    p.add_argument("-i", "--rescoreByIdentity", action="store_true")
    p.add_argument("-j", "--rescoreByPosteriorProb", action="store_true")
    p.add_argument("-k", "--rescoreByIdentityIgnoringGaps", action="store_true")
    p.add_argument("-m", "--rescoreByPosteriorProbIgnoringGaps",
                   action="store_true")
    p.add_argument("-s", "--splitIndelsLongerThanThis", type=int, default=-1)
    p.add_argument("-u", "--outputPosteriorProbs", default=None)
    p.add_argument("-z", "--outputAllPosteriorProbs", default=None)
    p.add_argument("-v", "--outputExpectations", default=None)
    p.add_argument("-y", "--loadHmm", default=None)
    p.add_argument("--engine", default="pallas", choices=["scan", "pallas"],
                   help="pallas: the batched wavefront kernels (the only "
                        "engine of the port); scan is not ported")
    p.add_argument("--device", default="cuda",
                   help="where the wavefront passes run: cuda (default, "
                        "the CUDA kernels) or cpu (their plain versions)")
    p.add_argument("-h", "--help", action="help")
    return p


def write_posterior_probs(path, pairs):
    with open(path, "a") as fh:
        for s, x, y in pairs:
            fh.write(f"{x}\t{y}\t{s / PAIR_ALIGNMENT_PROB_1:f}\n")


def read_alignments(stream, sequences, params):
    """The cigars of ``stream``, each rebased onto its forward-strand
    sub-sequences: [(aln, sub_x, sub_y, anchors, filtered anchors, shift1,
    flip1, shift2, flip2), ...] (cPecanRealign.c's read loop)."""
    deferred = []
    for aln in cigar_read_stream(stream):
        seq_x = sequences[aln.contig1]
        seq_y = sequences[aln.contig2]
        flip1, flip2 = not aln.strand1, not aln.strand2
        shift1 = aln.start1 if aln.strand1 else aln.end1
        shift2 = aln.start2 if aln.strand2 else aln.end2
        sub_x = get_sub_sequence(seq_x, aln.start1, aln.end1, aln.strand1)
        sub_y = get_sub_sequence(seq_y, aln.start2, aln.end2, aln.strand2)
        rebase_coordinates(aln, 1, -shift1, flip1)
        rebase_coordinates(aln, 2, -shift2, flip2)
        check_pairwise_alignment(aln)
        anchors = convert_alignment_to_anchor_pairs(
            aln, params.constraint_diagonal_trim)
        filtered_anchors = [
            (x, y) for x, y in anchors
            if sub_x[x].upper() == sub_y[y].upper()
            and sub_x[x].upper() != "N"]
        deferred.append((aln, sub_x, sub_y, anchors, filtered_anchors,
                         shift1, flip1, shift2, flip2))
    return deferred


def make_jobs(deferred, params):
    """Split each alignment at its large anchor gaps, as the scan engine
    does (getPosteriorProbsWithBandingSplittingAlignmentsByLargeGaps):
    (jobs [(sub_x, sub_y, l_x, l_y, anchors)], owners [(deferred index,
    x offset, y offset)])."""
    jobs = []
    job_owner = []
    for di, (_aln, sub_x, sub_y, _a, fa, *_rest) in enumerate(deferred):
        split_points = get_split_points(
            fa, len(sub_x), len(sub_y),
            params.split_matrix_bigger_than_this, True, True)
        j = 0
        for (x1, y1, x2, y2) in split_points:
            sub_anchors = []
            while j < len(fa):
                ax, ay = fa[j]
                if ax + ay >= x2 + y2:
                    break
                sub_anchors.append((ax - x1, ay - y1))
                j += 1
            if x2 - x1 <= 0 or y2 - y1 <= 0:
                continue  # degenerate region: no match cells exist
            jobs.append((sub_x[x1:x2], sub_y[y1:y2], x2 - x1, y2 - y1,
                         sub_anchors))
            job_owner.append((di, x1, y1))
    return jobs, job_owner


def job_pairs(out, job_owner, n_alignments, threshold):
    """Each alignment's (score, x, y) pairs from one run over its jobs,
    shifted back to the alignment's sub-sequence coordinates."""
    per_aln = [[] for _ in range(n_alignments)]
    for i, (di, x1, y1) in enumerate(job_owner):
        sub_pairs = extract_pairs_auto(
            out, i, out["prep"]["bands"][i].n_diag, threshold)
        per_aln[di].extend((s, x + x1, y + y1) for s, x, y in sub_pairs)
    return per_aln


def aligner_for(params, device):
    """The CLI's aligner: groups of 32 on the card, 8 on the CPU (the JAX
    CLI's compiled and interpret-mode groups)."""
    return Dna5Aligner(params, device=device,
                       group=8 if str(device) == "cpu" else 32)


def main(argv=None, stdin=None, stdout=None, stage=None):
    """The CLI on ``argv``, ``stdin`` and ``stdout`` (the process's unless
    given).  ``stage(name, fn)``, when given, runs each step and returns
    ``fn()``: "read" (the fastas, then the cigars), "jobs", the steps of
    the aligner's run (``WavefrontAligner.run``: "prepare", "inputs",
    "fwd", "bwd", "compact"), "extract" and "finish" (reweight, filter,
    rescore, cigars out), so that a caller can time them."""
    args = make_parser().parse_args(argv)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    stage = stage or (lambda _name, fn: fn())
    if args.engine == "scan":
        raise NotImplementedError(SCAN_ENGINE)
    if args.outputExpectations:
        raise NotImplementedError(
            "-v/--outputExpectations sums the scan engine's expectations: "
            + SCAN_ENGINE)

    if args.logLevel:
        set_log_level(args.logLevel)

    params = AlignmentParams(
        gap_gamma=args.gapGamma,
        split_matrix_bigger_than_this=(
            10 if args.splitMatrixBiggerThanThis is None
            else args.splitMatrixBiggerThanThis ** 2),
        diagonal_expansion=args.diagonalExpansion,
        constraint_diagonal_trim=args.constraintDiagonalTrim)

    if args.loadHmm:
        hmm = HmmDiscrete.load(args.loadHmm)
        hmm.normalize()
        # getStateMachine5 dispatches on the hmm type (symmetric vs
        # asymmetric load, impl/stateMachine.c:1748-1773)
        sm = sm5_from_hmm(hmm)
    else:
        sm = StateMachine5()

    sequences = stage("read", lambda: sequences_from_fastas(args.fastas))

    # clear posterior prob files (we append per cigar)
    for path in (args.outputPosteriorProbs, args.outputAllPosteriorProbs):
        if path:
            open(path, "w").close()

    deferred = stage("read", lambda: read_alignments(stdin, sequences,
                                                     params))
    jobs, job_owner = stage("jobs", lambda: make_jobs(deferred, params))
    per_aln = [[] for _ in deferred]
    if jobs:
        out = aligner_for(params, args.device).run(
            sm, jobs, ragged_left=True, ragged_right=True, stage=stage)
        per_aln = stage("extract", lambda: job_pairs(
            out, job_owner, len(deferred), params.threshold))

    def finish():
        for di, (aln, sub_x, sub_y, anchors, _fa, shift1, flip1, shift2,
                 flip2) in enumerate(deferred):
            _finish_alignment(args, params, stdout, aln, sub_x, sub_y,
                              anchors, per_aln[di], shift1, flip1, shift2,
                              flip2)

    stage("finish", finish)


def _finish_alignment(args, params, stdout, aln, sub_x, sub_y, anchors,
                      aligned_pairs, shift1, flip1, shift2, flip2):
    """Post-alignment pipeline: reweight -> expected-accuracy filter ->
    rescore -> cigar out (cPecanRealign.c:591-666)."""
    aligned_pairs.sort(key=lambda t: (t[1], t[2]))

    if args.outputAllPosteriorProbs:
        write_posterior_probs(args.outputAllPosteriorProbs, aligned_pairs)

    if args.rescoreOriginalAlignment:
        aligned_pairs = score_anchor_pairs(anchors, aligned_pairs)
    else:
        aligned_pairs = reweight_aligned_pairs_2(
            aligned_pairs, len(sub_x), len(sub_y), params.gap_gamma)
        aligned_pairs = filter_pairwise_alignment_to_make_pairs_ordered(
            aligned_pairs, sub_x, sub_y, args.matchGamma)

    if args.rescoreByPosteriorProb:
        aln.score = score_by_posterior_probability(
            len(sub_x), len(sub_y), aligned_pairs)
    elif args.rescoreByPosteriorProbIgnoringGaps:
        aln.score = score_by_posterior_probability_ignoring_gaps(aligned_pairs)
    elif args.rescoreByIdentity:
        aln.score = score_by_identity(sub_x, sub_y, aligned_pairs)
    elif args.rescoreByIdentityIgnoringGaps:
        aln.score = score_by_identity_ignoring_gaps(sub_x, sub_y,
                                                    aligned_pairs)

    if args.outputPosteriorProbs:
        write_posterior_probs(args.outputPosteriorProbs, aligned_pairs)

    coord_pairs = sorted((x, y) for _s, x, y in aligned_pairs)
    r_aln = convert_aligned_pairs_to_pairwise_alignment(
        aln.contig1, aln.contig2, aln.score, aln.end1, aln.end2,
        coord_pairs)
    rebase_coordinates(r_aln, 1, shift1, flip1)
    rebase_coordinates(r_aln, 2, shift2, flip2)
    check_pairwise_alignment(r_aln)
    if args.splitIndelsLongerThanThis != -1:
        for piece in split_pairwise_alignment(
                r_aln, args.splitIndelsLongerThanThis):
            stdout.write(cigar_write(piece) + "\n")
    else:
        stdout.write(cigar_write(r_aln) + "\n")


if __name__ == "__main__":
    main()
