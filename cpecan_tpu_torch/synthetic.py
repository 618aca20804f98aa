"""Synthetic reads at realistic scale, made from a seed.

Signal: ``synthetic_batch`` is the counterpart of
``__graft_entry__._synthetic_batch`` and ``long_signal_read`` of
``tools/exp_long_events.py::synth_read``: the same numpy rng call
sequences, so both packages get byte-identical reads for the same seed.
``echelon_batch`` is the 64-read batch of bench.py's
``echelon_alignments_per_sec`` (``bench_echelon``) on the vendored
template pore model, and ``hdp_model`` the HDP machine of bench.py's
``hdp_alignments_per_sec`` (``bench_hdp``), sampled by the port's own copy
of the HDP.

DNA: ``synth_dna_pair`` is ``tools/exp_long_read.py::synth_dna_pair`` (the
100 kb pair of bench.py's ``long_read_bases_per_sec``), and
``dna_realign_batch`` the 64 x 2 kb pairs of bench.py's
``dna_realign_alignments_per_sec`` (``bench_dna_realign``), with their
cigars for the realign CLI, and ``dna_em_batch`` the 128 x 1 kb
alignments of bench.py's ``dna_em_estep_alignments_per_sec``
(``bench_dna_em``); ``msa_frags`` the 32 x 1 kb fragments of bench.py's
``msa_pairwise_alignments_per_sec`` (``bench_msa``)."""

import random

import numpy as np

from .constants import KMER_LENGTH, MODEL_PARAMS, NUM_OF_KMERS
from .fixtures import fixture_path
from .io.cigar import parse_cigar_line
from .io.poremodel import PoreModel, load_pore_model
from .models.kmers import seq_to_kmer_indices
from .models.state_machines import (StateMachine3Hdp,
                                    StateMachine3SignalStrawman,
                                    StateMachineEchelon)


def synthetic_batch(n_reads=4, n_ref=160, n_events=150, seed=0,
                    shape_jitter=0.0):
    """(machine, reads): a random pore model and ``n_reads`` reads
    (ref, events [n, 3], l_x, l_y, anchors) whose events follow the model
    means along the diagonal.

    ``shape_jitter`` > 0 draws each read's (n_ref, n_events) uniformly from
    [(1-jitter), 1.0] x the nominal sizes."""
    rng = np.random.default_rng(seed)
    model_rows = np.zeros((NUM_OF_KMERS, MODEL_PARAMS))
    model_rows[:, 0] = rng.uniform(50.0, 80.0, NUM_OF_KMERS)  # level mean
    model_rows[:, 1] = rng.uniform(0.5, 1.5, NUM_OF_KMERS)    # level sd
    model_rows[:, 2] = rng.uniform(0.5, 1.5, NUM_OF_KMERS)    # noise mean
    model_rows[:, 3] = rng.uniform(0.05, 0.2, NUM_OF_KMERS)   # noise sd
    model_rows[:, 4] = rng.uniform(0.5, 2.0, NUM_OF_KMERS)    # noise lambda
    model = PoreModel(0.0, model_rows, np.full(30, 0.3), 0.0,
                      model_rows.copy())
    sm = StateMachine3SignalStrawman(model)

    reads = []
    for _ in range(n_reads):
        r_ref, r_events = n_ref, n_events
        if shape_jitter:
            r_ref = int(rng.integers(int(n_ref * (1 - shape_jitter)),
                                     n_ref + 1))
            r_events = int(rng.integers(int(n_events * (1 - shape_jitter)),
                                        n_events + 1))
        ref = "".join(rng.choice(list("ACGT"), r_ref))
        l_x = r_ref - (KMER_LENGTH - 1)
        kidx = seq_to_kmer_indices(ref)
        ev = np.zeros((r_events, 3))
        for i in range(r_events):
            k = kidx[min(int(i * l_x / r_events), l_x - 1)]
            ev[i, 0] = model_rows[k, 0] + rng.normal(0, 1.0)
            ev[i, 1] = max(model_rows[k, 2] + rng.normal(0, 0.1), 0.05)
            ev[i, 2] = 0.05
        anchors = []
        px = py = -1
        for j in range(1, 10):
            x = int(j * (l_x - 2) / 10) + 1
            y = int(j * (r_events - 2) / 10) + 1
            if x > px and y > py:
                anchors.append((x, y))
                px, py = x, y
        reads.append((ref, ev, l_x, r_events, anchors))
    return sm, reads


# anchors every ANCHOR_STEP reference positions along the event staircase
ANCHOR_STEP = 25


def echelon_batch(n_reads=64, n_ref=905, n_events=800, seed=6):
    """(machine, reads): bench.py's echelon cell (``bench_echelon``, the
    same rng call sequence): the untrained ``StateMachineEchelon`` of the
    vendored template model and ``n_reads`` random references of
    ``n_ref`` bases with ``n_events`` events (mean at the model's level
    mean of the diagonal's k-mer + N(0, 0.5), noise the model's noise
    mean (at least 0.1), duration 0.01) and nine anchors each."""
    model = load_pore_model(fixture_path("template_median68pA.model"))
    rng = np.random.default_rng(seed)
    mm = model.match_model
    reads = []
    for _ in range(n_reads):
        ref = "".join(rng.choice(list("ACGT"), n_ref))
        l_x = n_ref - (KMER_LENGTH - 1)
        kidx = seq_to_kmer_indices(ref)
        ev = np.zeros((n_events, 3))
        for i in range(n_events):
            k = kidx[min(int(i * l_x / n_events), l_x - 1)]
            ev[i, 0] = mm[k, 0] + rng.normal(0, 0.5)
            ev[i, 1] = max(mm[k, 2], 0.1)
            ev[i, 2] = 0.01
        anchors = []
        px = py = -1
        for j in range(1, 10):
            x = int(j * (l_x - 2) / 10) + 1
            y = int(j * (n_events - 2) / 10) + 1
            if x > px and y > py:
                anchors.append((x, y))
                px, py = x, y
        reads.append((ref, ev, l_x, n_events, anchors))
    return StateMachineEchelon(model), reads


def hdp_model():
    """The HDP machine of bench.py's ``hdp_alignments_per_sec``
    (``bench_hdp``, the same rng call sequence): a 200-base reference from
    ``default_rng(1)``, two signals per k-mer (the vendored template
    model's level mean + N(0, 1)), ``flat_hdp_model_2("ACGT", 6, 1, 1, 1,
    1, 30, 110, 120, template_median68pA.model)``, Gibbs sampling with 6
    samples, burn-in 100, thinning 20 (the HDP's own seed, 0), finalized;
    log densities.  The native sampler runs where it builds, else the
    Python one (``HierarchicalDirichletProcess.execute_gibbs_sampling``);
    the one that ran is ``sm.nhdp.hdp.sampler``."""
    from .hdp.nanopore_hdp import flat_hdp_model_2

    model_path = fixture_path("template_median68pA.model")
    mm = load_pore_model(model_path).match_model
    rng = np.random.default_rng(1)
    ref = "".join(rng.choice(list("ACGT"), 200))
    kidx = seq_to_kmer_indices(ref)
    kmers = [ref[p:p + 6] for p in range(len(kidx)) for _ in (0, 1)]
    signals = [mm[kidx[p], 0] + rng.normal(0, 1.0)
               for p in range(len(kidx)) for _ in (0, 1)]
    nhdp = flat_hdp_model_2("ACGT", 6, 1.0, 1.0, 1.0, 1.0, 30.0, 110.0, 120,
                            model_path)
    nhdp.update_from_assignments(kmers, signals)
    nhdp.execute_gibbs_sampling(num_samples=6, burn_in=100, thinning=20)
    nhdp.finalize_distributions()
    return StateMachine3Hdp(nhdp)


def long_signal_read(l_x=10000, l_y=17000, seed=11):
    """(template pore model, read (ref, events [l_y, 3], l_x, l_y,
    anchors)): a nanopore-length strawman read whose events follow the
    vendored template model's level means along a staircase of l_y / l_x
    events per base, with a dense monotone anchor chain every ANCHOR_STEP
    positions that keeps the band narrow (at most 46 cells at 10 kb x 17k
    events, ND = l_x + l_y diagonals)."""
    rng = np.random.default_rng(seed)
    model = load_pore_model(fixture_path("template_median68pA.model"))
    ref = "".join(rng.choice(list("ACGT"), l_x + 5))
    kidx = seq_to_kmer_indices(ref)
    k = kidx[np.minimum((np.arange(l_y) * l_x / l_y).astype(np.int64),
                        l_x - 1)]
    # one (level, noise) normal pair per event, drawn in event order
    z = rng.standard_normal((l_y, 2))
    ev = np.zeros((l_y, 3))
    ev[:, 0] = model.match_model[k, 0] + z[:, 0] * 1.0
    ev[:, 1] = np.maximum(model.match_model[k, 2], 0.1) + np.abs(z[:, 1] * .1)
    ev[:, 2] = 0.01
    anchors = [(x, int(x * l_y / l_x))
               for x in range(20, l_x - 20, ANCHOR_STEP)]
    return model, (ref, ev, l_x, l_y, anchors)


BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def synth_dna_pair(rng, l_ref, sub=0.07, indel=0.05, anchor_step=64):
    """A mutated copy of a random reference plus dense exact anchors
    (every ~anchor_step bases, jittered like a lastz chain would be):
    (seq_x, seq_y, l_x, l_y, anchors) from the numpy generator ``rng``."""
    x = rng.integers(0, 4, l_ref)
    keep = rng.random(l_ref) >= indel / 2          # deletions
    y_parts = []
    sub_mask = rng.random(l_ref) < sub
    y_base = np.where(sub_mask, rng.integers(0, 4, l_ref), x)
    # insertions: after ~indel/2 of positions, one random base
    ins_mask = rng.random(l_ref) < indel / 2
    pos_y = np.zeros(l_ref, np.int64)              # y coord of each kept x
    yi = 0
    for i in range(l_ref):
        if keep[i]:
            y_parts.append(y_base[i])
            pos_y[i] = yi
            yi += 1
        else:
            pos_y[i] = yi
        if ins_mask[i]:
            y_parts.append(rng.integers(0, 4))
            yi += 1
    y = np.array(y_parts)
    sx = BASES[x].tobytes().decode()
    sy = BASES[y].tobytes().decode()
    anchors, px = [], -1
    for i in range(anchor_step, l_ref - anchor_step, anchor_step):
        j = int(pos_y[i])
        if i > px and 0 < j < len(y) - 1:
            anchors.append((i, j))
            px = i
    return sx, sy, len(sx), len(sy), anchors


def dna_realign_batch(n_pairs=64, length=2000, seed=11):
    """bench.py's realign workload: ``n_pairs`` pairs of ``length`` random
    bases and a copy with ~9% substitutions (no indels) from
    ``random.Random(seed)``, anchored every 50 bases: reads (seq_x, seq_y,
    l_x, l_y, anchors)."""
    rng = random.Random(seed)
    reads = []
    for _ in range(n_pairs):
        sx = "".join(rng.choice("ACGT") for _ in range(length))
        sy = "".join(c if rng.random() > 0.12 else rng.choice("ACGT")
                     for c in sx)
        anchors = [(j, j) for j in range(40, length - 40, 50)]
        reads.append((sx, sy, length, len(sy), anchors))
    return reads


def realign_inputs(reads):
    """(fasta text, cigar lines) that hand ``reads`` to the realign CLI:
    pair i as sequences x<i> and y<i> and one gapless cigar over both."""
    fasta, cigars = [], []
    for i, (sx, sy, l_x, l_y, _a) in enumerate(reads):
        fasta.append(f">x{i}\n{sx}\n>y{i}\n{sy}\n")
        cigars.append(f"cigar: y{i} 0 {l_y} + x{i} 0 {l_x} + 0 M {l_x}")
    return "".join(fasta), cigars


def dna_em_batch(n_pairs=128, length=1000, seed=3, redraw=0.12):
    """bench.py's cPecanEm E-step workload (``bench_dna_em``), byte for
    byte: ``n_pairs`` pairs x<i> / y<i> of ``length`` random bases and a
    copy with a share ``redraw`` of its bases drawn again (~9%
    substitutions at 0.12) from ``random.Random(seed)``, each with one
    gapless cigar ``M length``.  Returns (sequences {name: bases},
    alignments [PairwiseAlignment], the generator): bench.py shards the
    alignments with that generator next (``_shard_alignments``).  With
    (3, 120, 21, 0.15) it is the case of tests/test_pipelines.py::
    test_em_pallas_engine_matches_scan."""
    rng = random.Random(seed)
    seqs, alns = {}, []
    for i in range(n_pairs):
        sx = "".join(rng.choice("ACGT") for _ in range(length))
        sy = "".join(c if rng.random() > redraw else rng.choice("ACGT")
                     for c in sx)
        seqs[f"x{i}"] = sx
        seqs[f"y{i}"] = sy
        alns.append(parse_cigar_line(
            f"cigar: y{i} 0 {len(sy)} + x{i} 0 {length} + 0 M {length}"))
    return seqs, alns, rng


def msa_frags(n_frags=32, length=1000, seed=17, rate=0.08):
    """bench.py's MSA input (``bench_msa``), byte for byte: a base sequence
    of ``length`` random bases from ``random.Random(seed)`` and ``n_frags``
    copies of it, each base redrawn with probability ``rate`` by the same
    generator, as ``SeqFrag(copy, 2 i, 2 i + 1)``: every fragment has its
    own left and right end, so every pairwise job is ragged at both."""
    from .msa.multiple_aligner import SeqFrag

    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(length))

    def mutate(s):
        return "".join(c if rng.random() > rate else rng.choice("ACGT")
                       for c in s)

    return [SeqFrag(mutate(base), 2 * i, 2 * i + 1) for i in range(n_frags)]
