"""trainModels-equivalent of the port: signal-HMM Baum-Welch over a set of
npReads, the E-step batched through the wavefront kernels (counterpart of
``cpecan_tpu/pipeline/train_models.py`` with ``engine="pallas"``, for both
of its machines: the strawman ``threeState`` and ``vanilla``).

Per iteration and strand: one expectation run (``StrawmanAligner`` or
``VanillaAligner``, ``run(expectations=True)``) over all reads (per-read
model scaling on the device), per-read expectation containers merged and
normalized (the M-step, ``models/hmm.py``: ``ContinuousPairHmm``'s
transitions and k-mer gap probabilities, ``VanillaHmm``'s 60 skip bins),
the HMM written, the likelihoods tracked.  The next iteration's machine is
loaded back from the written HMM, as the reference does
(scripts/trainModels.py:118-236).
"""

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from ..align import AlignmentParams
from ..cli.realign import convert_alignment_to_anchor_pairs, \
    rebase_coordinates
from ..cli.signal_align import get_remapped_anchor_pairs, make_event_slice
from ..constants import KMER_LENGTH
from ..io.fasta import reverse_complement
from ..io.npread import load_npread
from ..io.poremodel import load_pore_model, scale_model
from ..models.hmm import ContinuousPairHmm, VanillaHmm
from ..models.state_machines import (StateMachine3SignalStrawman,
                                     StateMachine3Vanilla)
from ..ops.anchors import filter_to_remove_overlap
from ..ops.fb import StrawmanAligner, VanillaAligner
from ..utils.checkpoint import CheckpointManager

# reads per kernel block group at most (the JAX package's compiled EM
# group); smaller batches use one group of their own size
MAX_GROUP = 32


@dataclass
class TrainOptions:
    sm_type: str = "threeState"     # or "vanilla"
    iterations: int = 10
    params: AlignmentParams = field(default_factory=AlignmentParams)
    # 'pallas' (the JAX package's name for it) batches the whole E-step
    # through the wavefront kernels; the per-read 'scan' engine is not
    # ported yet
    engine: str = "pallas"


def add_and_norm_expectations(hmms):
    """add_and_norm_expectations (scripts/trainModels.py:108-115): merge
    per-read expectation containers (ContinuousPairHmm or VanillaHmm) and
    normalize (the M-step).  Returns (merged HMM, summed likelihood)."""
    merged = hmms[0]
    for h in hmms[1:]:
        if isinstance(merged, VanillaHmm):
            merged.kmer_skip_bins += h.kmer_skip_bins
        else:
            merged.transitions += h.transitions
            merged.kmer_gap_probs += h.kmer_gap_probs
        merged.likelihood += h.likelihood
    likelihood = merged.likelihood
    merged.normalize()
    return merged, likelihood


def strawman_machine(model_file, hmm_file=None):
    """The strawman machine of an E-step: the unscaled pore model (each
    read is scaled on the device) with the transitions and k-mer gap
    probabilities of ``hmm_file`` when given (buildStateMachine +
    loadHmmRoutine, vanillaAlign.c:104-138)."""
    params = gap_x = None
    if hmm_file:
        params, gap_x = ContinuousPairHmm.load(hmm_file).to_sm3_params()
    return StateMachine3SignalStrawman(load_pore_model(model_file),
                                       params=params, gap_x_log_probs=gap_x)


def vanilla_machine(model_file, hmm_file=None, strand=0):
    """The vanilla machine of an E-step on strand 0 (template) or 1
    (complement): the unscaled pore model with the skip bins of
    ``hmm_file`` when given (train_models.py:80-92)."""
    skip_bins = VanillaHmm.load(hmm_file).kmer_skip_bins if hmm_file else None
    return StateMachine3Vanilla(
        load_pore_model(model_file), skip_bin_probs=skip_bins,
        strand="template" if strand == 0 else "complement")


def strand_expectations(sm, jobs, sps, aligner):
    """Batched E-step of one strand (counterpart of
    ``_pallas_strand_expectations``, train_models.py:68-134): one
    expectation run over all ``jobs`` (ref, events, l_x, l_y, anchors)
    with per-read ``sps`` (scale, shift, var, scale_sd, var_sd), ragged at
    both ends.  Returns one container per read: a ContinuousPairHmm for
    the strawman machine, a VanillaHmm (with the read's scaled pore model
    implanted, :122-125) for the vanilla one."""
    out = aligner.run(sm.to(aligner.device), jobs, expectations=True,
                      scale_params=np.asarray(sps, np.float64),
                      ragged_left=True, ragged_right=True)
    exp = out["expectations"]
    accs = []
    for i in range(len(jobs)):
        if isinstance(sm, StateMachine3Vanilla):
            h = VanillaHmm(pseudocount=0.0001)
            h.implant_match_models(scale_model(sm.model, *sps[i]))
            h.add_expectations({"skip_bins": exp["skip_bins"][i],
                                "likelihood": exp["likelihood"][i]})
        else:
            h = ContinuousPairHmm(pseudocount=0.0001)
            h.add_expectations({"trans": exp["trans"][i],
                                "kmer_gap": exp["kmer_gap"][i],
                                "likelihood": exp["likelihood"][i]})
        accs.append(h)
    return accs


def strand_jobs(reference_seq, npread_path, guide, params):
    """The (template, complement) E-step jobs of one read: each a (job,
    scale params) pair, the job sliced to the guide's region and anchored
    by its matches (train_models.py:204-243)."""
    aln = copy.deepcopy(guide)
    np_read = load_npread(npread_path)
    if aln.strand1:
        trimmed = reference_seq[aln.start1:aln.end1]
    else:
        trimmed = reverse_complement(reference_seq[aln.end1:aln.start1])
    map_offset = aln.start2
    ref_shift = aln.start1 if aln.strand1 else aln.end1
    rebase_coordinates(aln, 1, -ref_shift, not aln.strand1)
    anchors = filter_to_remove_overlap(sorted(
        convert_alignment_to_anchor_pairs(aln,
                                          params.constraint_diagonal_trim)))
    out = []
    for target, events, emap, npp in (
            (trimmed, np_read.template_events, np_read.template_event_map,
             np_read.template_params),
            (reverse_complement(trimmed), np_read.complement_events,
             np_read.complement_event_map, np_read.complement_params)):
        events, _ = make_event_slice(events, guide.start2, guide.end2, emap)
        l_x = max(len(target) - (KMER_LENGTH - 1), 0)
        remapped = get_remapped_anchor_pairs(anchors, emap, map_offset)
        out.append(((target, events, l_x, len(events), remapped),
                    [npp.scale, npp.shift, npp.var, npp.scale_sd,
                     npp.var_sd]))
    return out


def train(reference_path, read_guide_pairs, template_model, complement_model,
          out_template_hmm, out_complement_hmm, options: TrainOptions,
          log=print, checkpoint_dir=None, resume=False, mesh=None, *,
          device="cuda"):
    """Main EM loop (scripts/trainModels.py:118-236) on ``device`` (a CUDA
    device runs the CUDA kernels, the CPU their plain versions).

    read_guide_pairs: list of (npread_path, guide PairwiseAlignment).
    Returns (template_hmm, complement_hmm, likelihood trajectory)."""
    if options.engine == "scan":
        raise NotImplementedError(
            "the per-read scan engine is not ported yet (ROADMAP Queue 1 "
            "item 7); use engine='pallas'")
    if options.engine != "pallas":
        raise ValueError(f"unknown engine {options.engine!r}")
    if options.sm_type not in ("threeState", "vanilla"):
        raise ValueError(f"unknown sm_type {options.sm_type!r}")
    vanilla = options.sm_type == "vanilla"
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel E-steps are not ported yet (ROADMAP Queue 1 "
            "item 9)")
    with open(reference_path) as fh:
        reference_seq = fh.readline().strip()

    t_hmm_file = c_hmm_file = None
    trajectory = []
    start_iteration = 0
    manager = None
    if checkpoint_dir is not None:
        manager = CheckpointManager(checkpoint_dir)
        restored = manager.restore() if resume else None
        if restored is not None:
            step, _, meta = restored
            start_iteration = step + 1
            trajectory = [tuple(t) for t in meta["trajectory"]]
            with open(out_template_hmm, "w") as fh:
                fh.write(meta["template_hmm"])
            with open(out_complement_hmm, "w") as fh:
                fh.write(meta["complement_hmm"])
            t_hmm_file, c_hmm_file = out_template_hmm, out_complement_hmm
            log(f"resumed from checkpoint at iteration {step}")
    aligner = (VanillaAligner if vanilla else StrawmanAligner)(
        options.params, device=torch.device(device),
        group=max(1, min(MAX_GROUP, len(read_guide_pairs))))
    # the jobs do not change between iterations; the machines do
    jobs = [strand_jobs(reference_seq, path, guide, options.params)
            for path, guide in read_guide_pairs]
    t_merged = c_merged = None
    for iteration in range(start_iteration, options.iterations):
        merged = []
        for strand, model_file, hmm_file in (
                (0, template_model, t_hmm_file),
                (1, complement_model, c_hmm_file)):
            sm = (vanilla_machine(model_file, hmm_file, strand) if vanilla
                  else strawman_machine(model_file, hmm_file))
            accs = strand_expectations(
                sm, [j[strand][0] for j in jobs],
                [j[strand][1] for j in jobs], aligner)
            merged.append(add_and_norm_expectations(accs))
        (t_merged, t_lik), (c_merged, c_lik) = merged
        with open(out_template_hmm, "w") as fh:
            t_merged.write(fh)
        with open(out_complement_hmm, "w") as fh:
            c_merged.write(fh)
        t_hmm_file, c_hmm_file = out_template_hmm, out_complement_hmm
        trajectory.append((t_lik, c_lik))
        log(f"iteration {iteration}: template likelihood {t_lik:.2f}, "
            f"complement likelihood {c_lik:.2f}")
        if manager is not None:
            with open(out_template_hmm) as fh:
                t_text = fh.read()
            with open(out_complement_hmm) as fh:
                c_text = fh.read()
            manager.save(iteration, meta={
                "trajectory": [list(t) for t in trajectory],
                "template_hmm": t_text, "complement_hmm": c_text})
    if t_merged is None and t_hmm_file is not None:
        # resumed past the final iteration: reload the written models
        loader = VanillaHmm if vanilla else ContinuousPairHmm
        t_merged = loader.load(t_hmm_file)
        c_merged = loader.load(c_hmm_file)
    return t_merged, c_merged, trajectory
