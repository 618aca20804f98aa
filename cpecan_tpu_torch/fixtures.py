"""Vendored data the port checks itself against.

``load_zymo_slice`` gives the Zymo MinION read (``ZymoC_ch_1_file1.npRead``,
template strand) with its stored lastz anchors and the f64 scan engine's
aligned pairs from ``tests/fixtures/zymo_template_slice.npz`` (built by
``tests/fixtures/make_zymo_template_slice.py``), so a check needs neither
lastz nor JAX.

``load_long_read`` gives the long-alignment path's check: a 10 kb x
17,000-event strawman read (``synthetic.long_signal_read``, seed 11) with
the f64 scan engine's pairs and the JAX package's tiled-path pairs from
``tests/fixtures/long_read.npz`` (built by
``tests/fixtures/make_long_read_fixture.py``).

``load_dna5_realign`` gives the 5-state DNA (realign) path's checks from
``tests/fixtures/dna5_realign.npz`` (built by
``tests/fixtures/make_dna5_realign_fixture.py``): the first 8 pairs of
bench.py's realign workload as a fasta text and gapless cigars with the JAX
CLI's ``--engine pallas`` output for them, and a 10 kb pair
(``synthetic.synth_dna_pair``, seed 7, ~20,000 diagonals) with the f64
scan engine's pairs and the JAX package's tiled-path pairs.

``load_dna5_em`` gives the cPecanEm path's check from
``tests/fixtures/dna5_em.npz`` (built by
``tests/fixtures/make_dna5_em_fixture.py``): three small alignments
(``synthetic.dna_em_batch``) with the JAX package's ``engine="pallas"``
EM result for the fiveState and fiveStateAsymmetric models.

``load_zymo_train`` gives what a training check of the same read needs:
the lastz guide cigar and the JAX package's two-iteration trainModels
result from ``tests/fixtures/zymo_train.npz`` (built by
``tests/fixtures/make_zymo_train_fixture.py``); ``zymo_trained_params``
the strawman machine parameters of its trained template HMM.

``load_vanilla_zymo`` gives the vanilla machine's checks on the same read
from ``tests/fixtures/vanilla_zymo.npz`` (built by
``tests/fixtures/make_vanilla_fixture.py``): the read's template job as
the trainer builds it from the guide, with the JAX package's vanilla pairs
for it and its two-iteration vanilla trainModels result, whose template
skip bins also give a trained vanilla machine.

``load_batch_zymo`` gives the signalAlign batch pipeline's check on the
same read from ``tests/fixtures/batch_zymo.npz`` (built by
``tests/fixtures/make_batch_fixture.py``): the JAX package's
``run_batch_fast`` posterior tsv of the read for the threeState, vanilla
and fourState machines, with the guide it was made from;
``load_echelon_zymo`` the same for the echelon machine at threshold 0.15
from ``tests/fixtures/echelon_zymo.npz`` (built by
``tests/fixtures/make_echelon_fixture.py``).
"""

import os

import numpy as np

from .constants import KMER_LENGTH
from .io.cigar import parse_cigar_line
from .io.npread import load_npread
from .io.poremodel import load_pore_model, scale_model
from .models.hmm import ContinuousPairHmm

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURES = os.path.join(_REPO, "tests", "fixtures")
ZYMO_SLICE = os.path.join(_FIXTURES, "zymo_template_slice.npz")
ZYMO_TRAIN = os.path.join(_FIXTURES, "zymo_train.npz")
LONG_READ = os.path.join(_FIXTURES, "long_read.npz")
DNA5_REALIGN = os.path.join(_FIXTURES, "dna5_realign.npz")
DNA5_EM = os.path.join(_FIXTURES, "dna5_em.npz")
VANILLA_ZYMO = os.path.join(_FIXTURES, "vanilla_zymo.npz")
BATCH_ZYMO = os.path.join(_FIXTURES, "batch_zymo.npz")
ECHELON_ZYMO = os.path.join(_FIXTURES, "echelon_zymo.npz")

# name -> repository-relative path of the vendored data files the port
# reads (the JAX package's ``fixtures.fixture_path`` names)
_FILES = {
    "template_median68pA.model": "models/template_median68pA.model",
    "complement_median68pA_pop2.model":
        "models/complement_median68pA_pop2.model",
    "ZymoRef.txt": "tests/fixtures/ZymoRef.txt",
    "ZymoC_ch_1_file1.npRead": "tests/fixtures/ZymoC_ch_1_file1.npRead",
}


def fixture_path(name):
    """Absolute path of a vendored data file of the repository."""
    path = os.path.join(_REPO, _FILES[name])
    if not os.path.exists(path):
        raise FileNotFoundError(f"vendored data file missing: {path}")
    return path


def load_zymo_slice():
    """(scaled template PoreModel, read (ref, events, l_x, l_y, anchors),
    engine pairs [N, 3] int64 (score, x, y))."""
    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    npr = load_npread(fixture_path("ZymoC_ch_1_file1.npRead"))
    stored = np.load(ZYMO_SLICE)
    tp = npr.template_params
    model = scale_model(load_pore_model(
        fixture_path("template_median68pA.model")), tp.scale, tp.shift,
        tp.var, tp.scale_sd, tp.var_sd)
    anchors = [tuple(int(v) for v in a) for a in stored["anchors"]]
    read = (ref, npr.template_events, len(ref) - (KMER_LENGTH - 1),
            npr.n_template_events, anchors)
    return model, read, stored["pairs"]


def load_long_read():
    """(template PoreModel, read (ref, events, l_x, l_y, anchors), stored
    arrays: ``engine_pairs`` and ``tiled_pairs`` [N, 3] (score, x, y),
    ``l_x``, ``l_y``, ``seed``, ``tile_diag``)."""
    from .synthetic import long_signal_read

    with np.load(LONG_READ) as z:
        stored = {k: z[k] for k in z.files}
    model, read = long_signal_read(int(stored["l_x"]), int(stored["l_y"]),
                                   int(stored["seed"]))
    return model, read, stored


def load_dna5_realign():
    """(fasta text, input cigar lines, the 10 kb pair (seq_x, seq_y, l_x,
    l_y, anchors), stored arrays: ``cigars_out`` (the JAX CLI's output
    lines), ``engine_pairs`` and ``tiled_pairs`` [N, 3] (score, x, y),
    ``seed``, ``l_ref``, ``tile_diag``)."""
    from .synthetic import dna_realign_batch, realign_inputs, synth_dna_pair

    with np.load(DNA5_REALIGN) as z:
        stored = {k: z[k] for k in z.files}
    n = len(stored["cigars_in"])
    fasta, cigars = realign_inputs(dna_realign_batch()[:n])
    pair = synth_dna_pair(np.random.default_rng(int(stored["seed"])),
                          int(stored["l_ref"]))
    return fasta, cigars, pair, stored


def load_dna5_em():
    """(sequences, alignments, stored arrays): the inputs regenerated by
    ``synthetic.dna_em_batch`` from the stored ``n_pairs``, ``length``,
    ``seed`` and ``redraw``; the stored ``iterations`` and, for each model
    type ``m`` in ``model_types``, the JAX EM result ``{m}_transitions``,
    ``{m}_emissions``, ``{m}_running`` (running likelihoods) and
    ``{m}_likelihood``."""
    from .synthetic import dna_em_batch

    with np.load(DNA5_EM) as z:
        stored = {k: z[k] for k in z.files}
    seqs, alns, _ = dna_em_batch(
        int(stored["n_pairs"]), int(stored["length"]), int(stored["seed"]),
        float(stored["redraw"]))
    return seqs, alns, stored


def load_zymo_train():
    """(train arguments, stored JAX result).  The arguments are a dict of
    ``reference_path``, ``read_guide_pairs`` [(npRead path, guide
    PairwiseAlignment)], ``template_model`` and ``complement_model`` for
    ``pipeline.train_models.train``; the result holds ``t_trans``/
    ``c_trans`` [3, 3], ``t_kmer_gap``/``c_kmer_gap`` [4096] and
    ``trajectory`` [iterations, 2], the same HMMs after the first
    iteration as ``t1_*``/``c1_*``, and ``guide``, the cigar line."""
    with np.load(ZYMO_TRAIN) as z:
        stored = {k: z[k] for k in z.files}
    args = dict(
        reference_path=fixture_path("ZymoRef.txt"),
        read_guide_pairs=[(fixture_path("ZymoC_ch_1_file1.npRead"),
                           parse_cigar_line(str(stored["guide"])))],
        template_model=fixture_path("template_median68pA.model"),
        complement_model=fixture_path("complement_median68pA_pop2.model"))
    return args, stored


def zymo_trained_params():
    """(params, gap_x_log_probs) for ``StateMachine3SignalStrawman``: the
    template HMM of the stored JAX training run, through
    ``ContinuousPairHmm.to_sm3_params`` as the trainer loads it.  Unlike
    the untrained machine's LOG_ZERO, its ``gap_switch_to_x`` (Y -> X) is
    finite, and its gap-X table is per k-mer."""
    _, stored = load_zymo_train()
    hmm = ContinuousPairHmm()
    hmm.transitions = stored["t_trans"].copy()
    hmm.kmer_gap_probs = stored["t_kmer_gap"].copy()
    params, gap_x = hmm.to_sm3_params()
    if not np.isfinite(params["gap_switch_to_x"]):
        raise AssertionError("the trained machine has no Y -> X transition")
    return params, gap_x


def load_vanilla_zymo():
    """(template job (ref, events, l_x, l_y, anchors), its scale params
    [5], stored arrays).  The job is the trainer's
    (``pipeline.train_models.strand_jobs``) for the guide of
    ``load_zymo_train``; the stored arrays hold the JAX vanilla ``pairs``
    [N, 3] (score, x, y) for it and the ``sp`` they were made with,
    ``t_skip``/``c_skip`` [60] and ``trajectory`` [iterations, 2] of the JAX
    vanilla trainer, and its first iteration's ``t1_skip``/``c1_skip``."""
    from .align import AlignmentParams
    from .pipeline.train_models import strand_jobs

    args, _ = load_zymo_train()
    with np.load(VANILLA_ZYMO) as z:
        stored = {k: z[k] for k in z.files}
    with open(args["reference_path"]) as fh:
        ref = fh.readline().strip()
    (job, sp), _ = strand_jobs(ref, *args["read_guide_pairs"][0],
                               AlignmentParams())
    return job, np.asarray(sp, np.float64), stored


def load_batch_zymo(path=BATCH_ZYMO):
    """(run arguments, {sm_type: the JAX tsv's bytes}).  The arguments are
    a dict of ``reference_path``, ``npread_guide_pairs`` [(npRead path,
    guide cigar line)], ``template_model_file``, ``complement_model_file``,
    ``threshold`` and ``group`` for
    ``pipeline.signal_align_batch.run_batch_fast``; the read's tsv is
    ``<label>.tsv``, the label given as ``label``."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    args = dict(
        reference_path=fixture_path("ZymoRef.txt"),
        npread_guide_pairs=[(fixture_path("ZymoC_ch_1_file1.npRead"),
                             str(stored["guide"]))],
        template_model_file=fixture_path("template_median68pA.model"),
        complement_model_file=fixture_path(
            "complement_median68pA_pop2.model"),
        threshold=float(stored["threshold"]), group=int(stored["group"]))
    tsvs = {k[:-4]: stored[k].tobytes() for k in stored
            if k.endswith("_tsv")}
    return dict(args, label=str(stored["label"])), tsvs


def load_echelon_zymo():
    """``load_batch_zymo`` of ``echelon_zymo.npz``: the run arguments
    (threshold 0.15) and {"echelon": the JAX tsv's bytes}."""
    return load_batch_zymo(ECHELON_ZYMO)
