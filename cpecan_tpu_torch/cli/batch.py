"""Batch CLIs of the port (a subset of ``cpecan_tpu/cli/batch.py``):

  - cpecan-torch-signal-align-batch  <- scripts/signalAlign.py (batch
    signal alignment over a read directory, posterior tsvs per read), on
    the wavefront kernels (the JAX CLI's ``--engine pallas``)
  - cpecan-torch-train-models  <- scripts/trainModels.py (signal-HMM
    Baum-Welch), the E-step on the wavefront kernels
  - cpecan-torch-em  <- cPecanEm.py (DNA pair-HMM Baum-Welch), the E-step
    on the 5-state wavefront kernels (the JAX CLI's E-step runs the scan
    engine, which is not ported)

Guide alignments come from a cigar file (one exonerate cigar per read,
query name == read name), read as the JAX CLI reads them; guiding fast5
reads with bwa is not ported (ROADMAP Queue 1 item 8b).
"""

import argparse
import glob
import os
import sys

from ..fixtures import fixture_path
from ..io.cigar import parse_cigar_line

# flags of the JAX CLI that neither trainer reads (every read with a guide
# trains): accepted at their defaults, refused otherwise
UNREAD_FLAGS = {"train_amount": 1_000_000, "threshold": 0.01}
UNREAD_HELP = "not read by the trainer; only the default is accepted"


def _load_guides(path):
    """cigar file -> {query name: (line, PairwiseAlignment)}
    (``cpecan_tpu/cli/batch.py::_load_guides``)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            aln = parse_cigar_line(line)
            out[aln.contig2] = (line, aln)
    return out


def _collect_read_pairs(files_dir, guides, log):
    """Directory of .npRead files -> [(npread_path, guide line)]
    (``cpecan_tpu/cli/batch.py::_collect_read_pairs``); .fast5 inputs are
    refused (their conversion and bwa guiding are not ported)."""
    npreads = sorted(glob.glob(os.path.join(files_dir, "*.npRead")))
    fast5s = sorted(glob.glob(os.path.join(files_dir, "*.fast5")))
    if fast5s:
        raise NotImplementedError(
            f"{len(fast5s)} .fast5 files in {files_dir}: fast5 conversion "
            "and bwa guiding are not ported yet (ROADMAP Queue 1 item 8b); "
            "convert them to .npRead files and pass --guides")
    if npreads and not guides:
        raise SystemExit(
            f"{len(npreads)} .npRead files in {files_dir} but no --guides "
            "file: npRead inputs need guide cigars")
    pairs = []
    for p in npreads:
        name = os.path.basename(p).replace(".npRead", "")
        if name in guides:
            pairs.append((p, guides[name][0]))
        else:
            log(f"no guide for {name}, skipping")
    return pairs


def signal_align_batch_main(argv=None):
    """signalAlign over a directory of npReads on the port
    (``cpecan_tpu/cli/batch.py::signal_align_batch_main``, flag for flag,
    plus ``--device``); the engine defaults to the wavefront kernels
    (``pallas``), and the per-read ``scan`` engine is not ported."""
    p = argparse.ArgumentParser(
        prog="cpecan-torch-signal-align-batch",
        description="Batch signal alignment (scripts/signalAlign.py "
                    "equivalent) on the PyTorch/CUDA port.")
    p.add_argument("--file_directory", "-d", required=True,
                   help="directory of .npRead files")
    p.add_argument("--ref", "-r", required=True,
                   help="reference fasta (or bare one-line sequence file)")
    p.add_argument("--output_location", "-o", required=True)
    p.add_argument("--stateMachineType", "-smt", default="vanilla",
                   choices=["vanilla", "threeState", "fourState", "echelon"])
    p.add_argument("--threshold", "-t", type=float, default=0.01)
    p.add_argument("--un-banded", "-ub", dest="banded", action="store_false",
                   help="the scan engine's unbanded mode; the wavefront "
                        "path is always banded, so it is refused")
    p.add_argument("--nb_files", "-n", type=int, default=None)
    p.add_argument("--guides", default=None,
                   help="exonerate cigar file keyed by read name")
    p.add_argument("--target_regions", "-q", default=None)
    p.add_argument("--engine", default="pallas", choices=["scan", "pallas"],
                   help="pallas: the batched wavefront kernels (threeState "
                        "and vanilla); scan: the per-read engine (not "
                        "ported yet)")
    p.add_argument("--templateModel", "-T",
                   default=fixture_path("template_median68pA.model"))
    p.add_argument("--complementModel", "-C",
                   default=fixture_path("complement_median68pA_pop2.model"))
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu "
                        "their plain PyTorch versions")
    args = p.parse_args(argv)
    if args.engine == "scan":
        raise NotImplementedError(
            "the per-read scan engine is not ported yet (ROADMAP Queue 1 "
            "item 7); use --engine pallas")
    if not args.banded:
        p.error("-ub/--un-banded has no effect on the wavefront path, "
                "which is always banded (the JAX package's pallas engine "
                "does not read it either); leave it out")

    from ..io.fasta import read_fasta_file
    from ..pipeline.signal_align_batch import run_batch_fast

    log = lambda m: print(m, file=sys.stderr)
    os.makedirs(args.output_location, exist_ok=True)
    # a fasta reference becomes a bare one-line sequence file
    ref_path = args.ref
    with open(args.ref) as fh:
        if fh.read(1) == ">":
            ref_path = os.path.join(args.output_location, "reference.seq")
            for _name, seq in read_fasta_file(args.ref):
                with open(ref_path, "w") as out:
                    print(seq, file=out)
                break
    guides = _load_guides(args.guides) if args.guides else None
    if args.target_regions and guides:
        from ..io.guide import TargetRegions
        tr = TargetRegions(args.target_regions)
        guides = {k: v for k, v in guides.items()
                  if tr.check_aligned_region(min(v[1].start1, v[1].end1),
                                             max(v[1].start1, v[1].end1))}
    pairs = _collect_read_pairs(args.file_directory, guides, log)
    if args.stateMachineType not in ("threeState", "vanilla"):
        p.error("--engine pallas requires -smt threeState or vanilla")
    if args.nb_files is not None:
        # the JAX CLI's seeded shuffle-then-slice
        import random
        random.Random(0).shuffle(pairs)
        pairs = pairs[:args.nb_files]
    results = run_batch_fast(
        ref_path, pairs, args.output_location,
        template_model_file=args.templateModel,
        complement_model_file=args.complementModel,
        threshold=args.threshold, log=log, device=args.device,
        sm_type=args.stateMachineType)
    ok = sum(1 for _, s, _ in results if s)
    print(f"aligned {ok}/{len(results)} reads", file=sys.stderr)
    return 0 if ok else 1


def train_models_main(argv=None):
    p = argparse.ArgumentParser(
        prog="cpecan-torch-train-models",
        description="Signal-HMM Baum-Welch (scripts/trainModels.py "
                    "equivalent) on the PyTorch/CUDA port.")
    p.add_argument("--file_directory", "-d", required=True)
    p.add_argument("--ref", "-r", required=True,
                   help="bare one-line reference sequence file")
    p.add_argument("--output_location", "-o", required=True)
    p.add_argument("--iterations", "-i", type=int, default=10)
    p.add_argument("--train_amount", "-a", type=int,
                   default=UNREAD_FLAGS["train_amount"], help=UNREAD_HELP)
    p.add_argument("--stateMachineType", "-smt", default="threeState",
                   choices=["threeState", "vanilla"])
    p.add_argument("--threshold", "-t", type=float,
                   default=UNREAD_FLAGS["threshold"], help=UNREAD_HELP)
    p.add_argument("--templateModel", "-T", required=True,
                   help="template pore model file")
    p.add_argument("--complementModel", "-C", required=True)
    p.add_argument("--guides", required=True,
                   help="exonerate cigar file keyed by read name")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--engine", default="pallas", choices=["scan", "pallas"],
                   help="E-step engine: the batched wavefront kernels "
                        "(pallas: threeState and vanilla) or the per-read "
                        "scan engine (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the E-step: cuda runs the CUDA "
                        "kernels, cpu their plain PyTorch versions")
    args = p.parse_args(argv)
    for name, default in UNREAD_FLAGS.items():
        if getattr(args, name) != default:
            p.error(f"--{name} has no effect on training (the JAX "
                    f"package's trainer does not read it either); leave it "
                    f"at {default}")

    from ..pipeline.train_models import TrainOptions, train

    log = lambda m: print(m, file=sys.stderr)
    guides = _load_guides(args.guides)
    pairs = []
    for path in sorted(glob.glob(os.path.join(args.file_directory,
                                              "*.npRead"))):
        name = os.path.basename(path).replace(".npRead", "")
        if name in guides:
            pairs.append((path, guides[name][1]))
        else:
            log(f"no guide for {name}, skipping")
    if not pairs:
        p.error("no (npRead, guide) pairs found")
    os.makedirs(args.output_location, exist_ok=True)
    opts = TrainOptions(sm_type=args.stateMachineType,
                        iterations=args.iterations, engine=args.engine)
    _t_hmm, _c_hmm, trajectory = train(
        args.ref, pairs, args.templateModel, args.complementModel,
        os.path.join(args.output_location, "template_trained.hmm"),
        os.path.join(args.output_location, "complement_trained.hmm"),
        opts, log=log, checkpoint_dir=args.checkpoint_dir,
        resume=args.resume, device=args.device)
    for i, (t_lik, c_lik) in enumerate(trajectory):
        print(f"iteration {i}\t{t_lik}\t{c_lik}")
    return 0


def em_main(argv=None):
    """cPecanEm on the port (``cpecan_tpu/cli/batch.py::em_main``, flag for
    flag, plus ``--device``): EM over the cigars of ``--alignments`` on the
    sequences of ``--sequences``, the model written to ``--outputModel``
    and, when asked, a lastz scoring matrix."""
    p = argparse.ArgumentParser(
        prog="cpecan-torch-em",
        description="DNA pair-HMM expectation maximisation (cPecanEm.py "
                    "equivalent) on the PyTorch/CUDA port.")
    p.add_argument("--sequences", required=True, nargs="+",
                   help="fasta files")
    p.add_argument("--alignments", required=True,
                   help="exonerate cigar file")
    p.add_argument("--outputModel", default="hmm.txt")
    p.add_argument("--modelType", default="fiveState",
                   choices=["fiveState", "threeState",
                            "threeStateAsymmetric"])
    p.add_argument("--inputModel", default=None)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--randomStart", action="store_true")
    p.add_argument("--useDefaultModelAsStart", action="store_true")
    p.add_argument("--setJukesCantorStartingEmissions", type=float,
                   default=None)
    p.add_argument("--trainEmissions", action="store_true")
    p.add_argument("--tieEmissions", action="store_true")
    p.add_argument("--maxAlignmentLengthPerJob", type=int,
                   default=1_000_000)
    p.add_argument("--maxAlignmentLengthToSample", type=int,
                   default=50_000_000)
    p.add_argument("--outputLastzScoringMatrix", default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the E-step: cuda runs the CUDA "
                        "kernels, cpu their plain PyTorch versions")
    args = p.parse_args(argv)

    from ..io.fasta import sequences_from_fastas
    from ..pipeline.em import (EmOptions, expectation_maximisation,
                               expectation_maximisation_trials,
                               make_blast_scoring_matrix,
                               write_lastz_scoring_matrix)

    sequences = sequences_from_fastas(args.sequences)
    alignments = []
    with open(args.alignments) as fh:
        for line in fh:
            line = line.strip()
            if line:
                alignments.append(parse_cigar_line(line))
    opts = EmOptions(
        model_type=args.modelType, input_model=args.inputModel,
        iterations=args.iterations, trials=args.trials,
        random_start=args.randomStart,
        use_default_model_as_start=args.useDefaultModelAsStart,
        set_jukes_cantor_starting_emissions=
            args.setJukesCantorStartingEmissions,
        train_emissions=args.trainEmissions,
        tie_emissions=args.tieEmissions,
        max_alignment_length_per_job=args.maxAlignmentLengthPerJob,
        max_alignment_length_to_sample=args.maxAlignmentLengthToSample)
    if args.checkpoint_dir is not None:
        hmm = expectation_maximisation(sequences, alignments, opts,
                                       checkpoint_dir=args.checkpoint_dir,
                                       resume=args.resume,
                                       device=args.device)
    else:
        hmm = expectation_maximisation_trials(sequences, alignments, opts,
                                              device=args.device)
    hmm.write(args.outputModel)
    if args.outputLastzScoringMatrix:
        match_probs, gap_open, gap_extend = make_blast_scoring_matrix(
            hmm, sequences.values())
        with open(args.outputLastzScoringMatrix, "w") as fh:
            write_lastz_scoring_matrix(fh, match_probs, gap_open, gap_extend)
    print(f"final likelihood {hmm.likelihood}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(train_models_main())
