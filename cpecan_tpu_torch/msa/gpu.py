"""Batched pairwise alignment for the MSA layer on the card (the
counterpart of ``cpecan_tpu/msa/tpu.py::tpu_batch_align_fn``).

The reference aligns each chosen sequence pair with one full DP
(addMultipleAlignedPairs = getAlignedPairs + reweightAlignedPairs2,
impl/multipleAligner.c:653-671).  Here a whole round of pairwise jobs (all
pairs, the initial spanning chains, or one spanning-tree iteration's
next-best pairs) runs through the 5-state DNA wavefront kernels
(``ops.fb.Dna5Aligner``: K1 and K2 dna5) in a handful of launches, one
``run`` per chunk of jobs that share their ragged ends (the ragged start
and end are batch-wide kernel scalars).  Anchoring and large-gap splitting
follow getAlignedPairs: lastz anchors gated on the matrix size
(``ops.blast``), split regions as independent kernel jobs, as the realign
CLI does.
"""

import torch

from ..align import AlignmentParams
from ..models.state_machines import StateMachine5
from ..ops.anchors import get_split_points
from ..ops.blast import get_blast_pairs_for_pairwise_alignment_parameters
from ..ops.compact import extract_pairs_auto
from ..ops.fb import Dna5Aligner
from ..ops.reweight import reweight_aligned_pairs_2

# jobs per run: while one chunk's kernels and compaction copy are in
# flight, the host anchors the next chunk with lastz
CHUNK = 16


def gpu_batch_align_fn(params=None, sm=None, aligner=None, device="cuda",
                       lastz_path=None, stage=None):
    """Build a ``batch_align_fn`` for ``msa.multiple_aligner.make_alignment``.

    jobs are (seq_x, seq_y, ragged_left, ragged_right); returns one
    reweighted (score, x, y) pair list per job, ordered by (x, y) like
    getAlignedPairs output after reweightAlignedPairs2.  A job with an
    empty sequence gets no pairs.

    ``aligner`` defaults to a ``Dna5Aligner`` on ``device``: the card
    unless the caller asks for ``"cpu"`` (groups of 32 on the card, 8 on
    the CPU, the JAX package's compiled and interpret-mode groups); with no
    GPU and no ``device="cpu"`` it raises.  ``stage(name, fn)``, when
    given, runs each step and returns ``fn()``: "anchor" (lastz and the
    splitting of a chunk's jobs), the steps of the aligner's run
    (``WavefrontAligner.run``), "extract" and "reweight", so that a caller
    can time them.
    """
    params = params or AlignmentParams()
    sm = sm or StateMachine5()
    stage = stage or (lambda _name, fn: fn())
    if aligner is None:
        on_cpu = torch.device(device).type == "cpu"
        aligner = Dna5Aligner(params, device=device, group=8 if on_cpu
                              else 32)

    def _anchor_one(ji, seq_x, seq_y, rl, rr):
        """lastz anchoring + large-gap splitting for one job (the host /
        subprocess side of the pipeline)."""
        anchors = get_blast_pairs_for_pairwise_alignment_parameters(
            seq_x, seq_y, params, lastz_path=lastz_path)
        splits = get_split_points(
            anchors, len(seq_x), len(seq_y),
            params.split_matrix_bigger_than_this, rl, rr)
        kjobs, owners = [], []
        k = 0
        for (x1, y1, x2, y2) in splits:
            sub = []
            while k < len(anchors):
                ax, ay = anchors[k]
                if ax + ay >= x2 + y2:
                    break
                sub.append((ax - x1, ay - y1))
                k += 1
            if x2 - x1 <= 0 or y2 - y1 <= 0:
                continue
            kjobs.append((seq_x[x1:x2], seq_y[y1:y2],
                          x2 - x1, y2 - y1, sub))
            owners.append((ji, x1, y1))
        return kjobs, owners

    def _anchor_chunk(jobs, chunk, rl, rr):
        kjobs, owners = [], []
        for ji in chunk:
            kj, ow = _anchor_one(ji, jobs[ji][0], jobs[ji][1], rl, rr)
            kjobs.extend(kj)
            owners.extend(ow)
        return kjobs, owners

    def _extract(out, owners, results):
        for i, (ji, x1, y1) in enumerate(owners):
            sub_pairs = extract_pairs_auto(
                out, i, out["prep"]["bands"][i].n_diag, params.threshold)
            results[ji].extend((s, x + x1, y + y1) for s, x, y in sub_pairs)

    def _reweight(jobs, results):
        for ji, (seq_x, seq_y, _rl, _rr) in enumerate(jobs):
            pairs = sorted(results[ji], key=lambda t: (t[1], t[2]))
            results[ji] = reweight_aligned_pairs_2(
                pairs, len(seq_x), len(seq_y), params.gap_gamma)

    def batch_align(jobs):
        results = [[] for _ in jobs]
        # one run per ragged-end combination (batch-wide scalars), each in
        # chunks so that the round pipelines: the run returns with its
        # kernels and the compaction's copy to the host in flight
        # (compact.HostCopy, which the extraction waits for), and the host
        # anchors the next chunk meanwhile.  A shared shape_hint gives
        # every chunk one plane geometry.
        by_ragged = {}
        for ji, (seq_x, seq_y, rl, rr) in enumerate(jobs):
            if seq_x and seq_y:
                by_ragged.setdefault((bool(rl), bool(rr)), []).append(ji)
        max_x = max((len(jobs[ji][0])
                     for m in by_ragged.values() for ji in m), default=0)
        max_y = max((len(jobs[ji][1])
                     for m in by_ragged.values() for ji in m), default=0)
        hint = (min(max_x, params.split_matrix_bigger_than_this),
                min(max_x + max_y + 1,
                    2 * params.split_matrix_bigger_than_this + 1))
        pending = []  # (out, owners) in dispatch order
        for (rl, rr), members in by_ragged.items():
            for c0 in range(0, len(members), CHUNK):
                kjobs, owners = stage("anchor", lambda: _anchor_chunk(
                    jobs, members[c0:c0 + CHUNK], rl, rr))
                if not kjobs:
                    continue
                out = aligner.run(sm, kjobs, ragged_left=rl,
                                  ragged_right=rr, shape_hint=hint,
                                  stage=stage)
                pending.append((out, owners))
        for out, owners in pending:
            stage("extract", lambda: _extract(out, owners, results))
        stage("reweight", lambda: _reweight(jobs, results))
        return results

    return batch_align
