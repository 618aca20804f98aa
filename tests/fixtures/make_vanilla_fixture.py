"""Build ``vanilla_zymo.npz``: what the port's vanilla signal machine is
held to on the card, where there is no JAX.

From the Zymo MinION read and the lastz guide cigar that
``zymo_train.npz`` holds, with the JAX package on the CPU (interpret-mode
Pallas kernels, float64 enabled as in the test suite):

- ``pairs`` int64 [N, 3] (score, x, y): ``VanillaPallasAligner.run`` on the
  read's template job as trainModels builds it (the guide's region of the
  reference, the events of its query span, anchored by its matches),
  scaled per read (``scale_params``), ``extract_pairs_from_pallas`` at the
  default threshold;
- ``sp`` f64 [5]: that job's scale parameters (scale, shift, var,
  scale_sd, var_sd);
- ``t_skip``/``c_skip`` f64 [60] and ``trajectory`` f64 [ITERATIONS, 2]:
  the template and complement skip bins after ``ITERATIONS`` iterations of
  ``cpecan_tpu.pipeline.train_models.train(sm_type="vanilla",
  engine="pallas")`` and the (template, complement) likelihoods;
- ``t1_skip``/``c1_skip``: the same after the first iteration, as the
  M-step left them in memory, before the six-decimal HMM file the second
  iteration starts from.

The trained template skip bins also give the card's kernel checks a
trained vanilla machine.  The first iteration runs alone with a
checkpoint and the rest resume from it, the same computation as one
uninterrupted run.

Run from the repository root (needs JAX; about a minute):
    python tests/fixtures/make_vanilla_fixture.py
"""

import copy
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "vanilla_zymo.npz")
ITERATIONS = 2


def template_job(guide):
    """(job (ref, events, l_x, l_y, anchors), scale params [5]) of the
    read's template strand, as the JAX trainer builds it
    (cpecan_tpu/pipeline/train_models.py:204-243)."""
    from cpecan_tpu.cli.realign import (convert_alignment_to_anchor_pairs,
                                        rebase_coordinates)
    from cpecan_tpu.cli.signal_align import (get_remapped_anchor_pairs,
                                             make_event_slice)
    from cpecan_tpu.align import AlignmentParams
    from cpecan_tpu.constants import KMER_LENGTH
    from cpecan_tpu.fixtures import fixture_path
    from cpecan_tpu.io.fasta import reverse_complement
    from cpecan_tpu.io.npread import load_npread
    from cpecan_tpu.ops.anchors import filter_to_remove_overlap

    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    npr = load_npread(fixture_path("ZymoC_ch_1_file1.npRead"))
    aln = copy.deepcopy(guide)
    if aln.strand1:
        target = ref[aln.start1:aln.end1]
    else:
        target = reverse_complement(ref[aln.end1:aln.start1])
    events, _ = make_event_slice(npr.template_events, aln.start2, aln.end2,
                                 npr.template_event_map)
    map_offset = aln.start2
    rebase_coordinates(aln, 1, -(aln.start1 if aln.strand1 else aln.end1),
                       not aln.strand1)
    anchors = filter_to_remove_overlap(sorted(
        convert_alignment_to_anchor_pairs(
            aln, AlignmentParams().constraint_diagonal_trim)))
    remapped = get_remapped_anchor_pairs(anchors, npr.template_event_map,
                                         map_offset)
    tp = npr.template_params
    job = (target, events, max(len(target) - (KMER_LENGTH - 1), 0),
           len(events), remapped)
    return job, np.array([tp.scale, tp.shift, tp.var, tp.scale_sd,
                          tp.var_sd], np.float64)


def build_fixture():
    """The fixture's arrays (a dict); needs JAX on the CPU."""
    from cpecan_tpu.align import AlignmentParams
    from cpecan_tpu.fixtures import fixture_path
    from cpecan_tpu.io.cigar import parse_cigar_line
    from cpecan_tpu.io.poremodel import load_pore_model
    from cpecan_tpu.models.state_machines import StateMachine3Vanilla
    from cpecan_tpu.ops.pallas_fb import (VanillaPallasAligner,
                                          extract_pairs_from_pallas)
    from cpecan_tpu.pipeline.train_models import TrainOptions, train

    guide = str(np.load(os.path.join(HERE, "zymo_train.npz"))["guide"])
    job, sp = template_job(parse_cigar_line(guide))
    params = AlignmentParams()
    sm = StateMachine3Vanilla(
        load_pore_model(fixture_path("template_median68pA.model")))
    out = VanillaPallasAligner(params, interpret=True).run(
        sm, [job], scale_params=sp[None])
    pairs = np.asarray(extract_pairs_from_pallas(out, 0, params.threshold),
                       np.int64).reshape(-1, 3)
    res = dict(pairs=pairs, sp=sp)
    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        ref_file = os.path.join(tmp, "ref.seq")
        with open(ref_file, "w") as fh:
            fh.write(ref + "\n")
        for iterations, tag in ((1, "1"), (ITERATIONS, "")):
            t_hmm, c_hmm, traj = train(
                ref_file,
                [(fixture_path("ZymoC_ch_1_file1.npRead"),
                  parse_cigar_line(guide))],
                fixture_path("template_median68pA.model"),
                fixture_path("complement_median68pA_pop2.model"),
                os.path.join(tmp, "t.hmm"), os.path.join(tmp, "c.hmm"),
                TrainOptions(sm_type="vanilla", iterations=iterations,
                             engine="pallas"),
                log=lambda m: None, checkpoint_dir=os.path.join(tmp, "ckpt"),
                resume=iterations > 1)
            res[f"t{tag}_skip"] = t_hmm.kmer_skip_bins
            res[f"c{tag}_skip"] = c_hmm.kmer_skip_bins
    return dict(res, trajectory=np.asarray(traj, np.float64))


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(OUT, **build_fixture())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
