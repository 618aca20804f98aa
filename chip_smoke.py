"""Smoke run of the PyTorch/CUDA port (cpecan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ and drives the strawman signal-alignment
paths, the 5-state DNA realigner, cPecanEm (DNA Baum-Welch), the vanilla
signal machine (signalAlign's default, posteriors and trainModels), the
4-state signal machine, the signalAlign batch pipeline, the echelon
machine and the HDP machine through them:

1. versions, the card's name and power limit;
2. the kernel build (nvcc, ptxas register report); every select instance
   (the kernels redesigned for the card: K6a and K6b dna5, K3 dna5, K6b
   strawman, K6a strawman, K2 dna5, K6b sm4 and vanilla, K6a sm4 and
   vanilla, K1 and K2 echelon, K2 strawman and vanilla, K2 hdp, K1
   vanilla, K1 strawman, K1 dna5, K1 and K2 sm4) and the echelon emission
   pre-pass within 64 registers, no spill;
3. each kernel against its plain PyTorch version on the card, on the first
   64-read chunk of the bench batch (256 reads x 905 bases x 800 events,
   seed 7), with the tolerances of cpecan_tpu_torch/parity.py, and the
   pair sets extracted from both (K1 strawman sm3_fwd_tiled_sel<Strawman,
   0>, K2 strawman sm3_bwd_tiled_sel<Strawman, 0, 0>);
4. the Zymo MinION read against the f64 scan engine's stored pairs;
5. the main path at bench scale: StrawmanAligner(group=64).run over chunks
   of 64 reads, compact_k=1024, then extract_pairs_chunk; end-to-end
   alignments/s and band cells/s (median of 3 after a warm-up), with the
   kernels' launch counts;
6. forward + backward device time of the kernels on the whole batch;
7. the EM expectation backward against its plain version on the first 32
   bench reads (ragged ends, per-read scaling), with the untrained machine
   and with the Zymo fixture's trained one (Y -> X open): posteriors,
   totals and transition sums equal bit for bit, gap-X columns within
   parity.KERNEL_GAPX_ATOL, the finalized expectations of both, and their
   times;
8. two Baum-Welch iterations of trainModels on the Zymo read (both
   strands) against the JAX package's stored result;
9. the trainer at full width: three EM iterations (E-step, merge and
   normalize, a new machine) over the 256-read bench batch, with the
   E-step rate on bench.py's signal_em shape (128 reads, one dispatch)
   and a stage split of one E-step;
10. the tiled long-alignment kernels (K6a forward, K6b backward) against
   their plain versions on the first bench chunk with tile_diag=128 (14
   tiles): fwd plane, shifts, posteriors and totals equal bit for bit,
   equal pair sets;
11. the 10 kb x 17,000-event fixture read (27,000 diagonals) through
   StrawmanAligner(group=8).run with no tile_diag: it must route tiled,
   its pairs meet the JAX tiled path's and the f64 engine's stored pairs
   (parity.check_long_pairs);
12. the long-read path at full width: 64 such reads (seeds 11..74), group
   8, compact_k=4096, through run and extract_pairs_chunk: bases/s and
   alignments/s end to end (median of 3 after a warm-up), a stage split,
   peak device memory, the launch counts and K6a/K6b ms per launch, ns a
   diagonal and bounds on those reads; then
   K6a/K6b against their plain versions at that run's R, W and TD on one
   1,500 x 2,550 read of the same generator (two tiles): fwd plane,
   shifts, posteriors and totals bit for bit, equal pairs, and the
   kernels' and plain versions' ms on it;
13. the dna5 kernels K1 and K2 (sm3_fwd_tiled_sel<Dna5, 0>,
   sm3_bwd_tiled_sel<Dna5, 0, 0>) against their plain versions on the first
   32 pairs of bench.py's realign batch (64 x 2 kb, random.Random(11);
   group 32, ragged at both ends): fwd planes, posteriors and totals equal
   bit for bit, equal pair sets; K6a/K6b dna5 on the same pairs with
   tile_diag=128 (32 tiles), their distance from the untiled run logged
   (it is the untiled f32 drift; phase 16 and the gpu tests hold K6a/K6b
   dna5 to their plain versions); the golden AGCG x AGTTCG pairs at
   threshold 0.2;
14. the realign CLI (cpecan_tpu_torch.cli.realign) on the card on the
   stored cigars of tests/fixtures/dna5_realign.npz: at least 7 of 8
   cigars equal the JAX CLI's --engine pallas output;
15. realign at bench scale: all 64 pairs through Dna5Aligner(group=32).run
   in chunks of 32 (shape_hint, ragged ends, compact_k=4096), as bench.py's
   dna_realign_alignments_per_sec (median of 3 after a warm-up); the CLI
   end to end on the same 64 cigars, and its stage split (realign.main's
   own steps, timed through its stage hook); launch counts and peak device
   memory;
16. long DNA: the stored 10 kb pair routes tiled by itself and meets the
   JAX tiled and f64-engine pairs; then bench.py's long_read_bases_per_sec
   workload (synth_dna_pair(default_rng(7), 100_000), group 8,
   compact_k=2048, tile_diag=2048, extract_pairs_long): bases/s end to end
   (median of 3 after a warm-up), a stage split, peak device memory,
   coverage >= 98% of x, and K6a/K6b dna5 ms per launch and ns a diagonal,
   their bounds for the pair's row and for all 8 rows of its group, and
   their ptxas report (stored beside a cached library); then K6a/K6b dna5
   against their plain versions at that run's geometry (G 1, R 8, W 128,
   TD 2048) on a 2 kb pair of the same generator (two tiles): fwd plane,
   shifts, posteriors and totals equal bit for bit, equal pairs, and the
   kernels' and plain versions' ms on it;
17. the dna5 expectation backward (K3 for the 5-state machine) against its
   plain version on the first 32 alignments of bench.py's cPecanEm E-step
   batch (128 x 1 kb, random.Random(3); group 32, ragged at both ends),
   with the equalised fiveState start that the E-step runs: posteriors,
   totals and the 25 transition lanes equal bit for bit, the 20
   per-column accumulators within parity.KERNEL_GAPX_ATOL, the finalized
   expectations, and their times;
18. cPecanEm at full width: bench.py's dna_em_estep_alignments_per_sec (the
   128 alignments, one shard, chunks of 64; median of 3 after a warm-up),
   the E-step's stage split and one 64-pair chunk's kernel ms (K3 dna5's
   ns a diagonal and bound on it); three
   expectation_maximisation iterations over one default-size shard (1,000
   x 1 kb alignments of the same generator): s per iteration, the
   likelihood rising, peak device memory and the launch counts; the
   fixture case (tests/fixtures/dna5_em.npz) against the JAX package's
   stored engine="pallas" models; cpecan-torch-em end to end on the card
   (the fixture case against the stored model, the 128 alignments timed);
19. the vanilla kernels (K1, K2, K3 for the vanilla machine) against their
   plain versions: K1/K2 on the first 64-read chunk of bench.py's vanilla
   cell (the bench batch on the vendored template model) with the default
   machine and flush ends, K3 on its first 32 reads (group 32) with the
   skip bins of the stored JAX vanilla training, ragged ends and per-read
   scaling: fwd plane, posteriors, totals and the beta/alpha accumulators
   equal bit for bit, and the finalized skip bins;
20. the vanilla main path at full width: bench.py's
   vanilla_alignments_per_sec (VanillaAligner(group=64).run over chunks of
   64, compact_k=1024; median of 3 after a warm-up) with its stage split
   and launch counts; the vanilla E-step rate on bench.py's signal-EM shape
   (128 reads, group 32); the Zymo read's vanilla pairs and two vanilla
   trainModels iterations against tests/fixtures/vanilla_zymo.npz; the
   CLI with -smt vanilla once;
21. K6a/K6b vanilla against their plain versions at phase 12's R, W and
   TD on its 1,500 x 2,550 check read (two tiles), then phase 12's 64
   long reads through VanillaAligner once, kernels only: bases/s;
22. the sm4 kernels K3, K6a and K6b (the 4-state machine's; phase 23 holds
   K1/K2 sm4, the untiled select forms sm3_fwd_tiled_sel<Sm4, 0> and
   sm3_bwd_tiled_sel<Sm4, 0, 0>) against their plain versions: K3 through
   one Sm4Aligner.run(expectations=True) on the first 32 bench reads with
   ragged ends, per-read scaling and a trained-looking machine (every
   transition finite, a non-zero gap-X table); phase 12's 64 long reads
   routed tiled once, then K6a/K6b against plain on its check read: fwd
   planes, shifts, posteriors, totals and transition lanes bit for bit,
   the shortGapX columns within parity.KERNEL_GAPX_ATOL, equal pairs, ms,
   plain ms and bounds;
23. the signalAlign pipeline at full width: bench.py's
   signal_pipeline_reads_per_sec (run_batch_fast on 64 copies of the Zymo
   read, each guided by the stored guide renamed to it, StrawmanAligner
   group 32, chunk 64, compact_k 2048; median of 3 after a warm-up) with
   its stage split, launch counts and peak device memory; the same reads
   with -smt vanilla and fourState (median of 3 after a warm-up each);
   every read aligned, every copy's tsv equal to read 0's, read 0's within
   parity.check_tsv of the JAX package's stored tsv
   (tests/fixtures/batch_zymo.npz) for each machine; each machine's first
   chunk (template strand, as its warm-up run launched it) against the
   plain passes, fwd plane, posteriors and totals bit for bit (the K1/K2
   sm4 ms, plain ms and bound of the kernels line are this chunk's: K1
   sm3_fwd_tiled_sel<Sm4, 0>, K2 sm3_bwd_tiled_sel<Sm4, 0, 0>); the
   one-chunk-behind drain over 256 reads in chunks of 64 against the same
   runs serialized; cpecan-torch-signal-align-batch -smt vanilla on 4 of
   the reads;
24. the echelon kernels (K1, K2 for the 7-state echelon machine, each
   the emission pre-pass and then its recurrence) against their plain
   versions on the first 32-read chunk of bench.py's echelon cell (64
   reads of 905 bases x 800 events with anchors on the vendored template
   model, seed 6; group 32, the cell's shape hint): the pre-pass's planes
   (k = 0 and 1) against echelon_emissions_plain, the fwd plane, the five
   posterior planes and the totals bit for bit, equal expanded pairs, max
   |d| per plane, ms of the pre-pass and of each recurrence, plain ms and
   bounds; one launch of each at W = 1024 against plain;
25. bench.py's echelon_alignments_per_sec: the 64 reads through
   EchelonAligner(group=32).run in chunks of 32 (compact_k 4096, shape
   hint), run and compaction to the host, median of 3 after a warm-up,
   with the band cells/s, the pairs after the echelon expansion, the
   launch counts, a stage split and its staged split (pre-pass, K1, K2,
   prepare, the rest);
26. bench.py's signal_pipeline_echelon_reads_per_sec: 32 copies of the
   Zymo read through run_batch_fast(sm_type="echelon", threshold=0.15)
   (EchelonAligner group 32), median of 3 after a warm-up, with phase 23's
   stage split and launch counts; every read aligned, every copy's tsv
   equal to read 0's, read 0's within parity.check_tsv(multi=True) of the
   JAX package's stored tsv (tests/fixtures/echelon_zymo.npz); the
   pipeline's first chunk (template strand, ragged, scaled: the skip bins
   too) as the warm-up run launched it, its fwd plane, five posterior
   planes and totals equal to the plain passes' bit for bit, as phase 23
   holds the other three machines;
27. the HDP kernels (K1, K2, K3 for the streamed HDP machine): bench.py's
   HDP machine (``synthetic.hdp_model``, sampled by the port's copy of the
   HDP; the sampler that ran and its time logged), the first 64-read chunk
   of bench.py's HDP cell (the bench batch, group 64): the card's emission
   stream against the host's build from the same inputs
   (parity.check_hdp_stream), K1/K2 hdp against their plain versions, the
   fwd plane, posteriors and totals bit for bit and equal pairs from a
   compaction of 2048 (saturated: the exact fallback); K3 hdp on the
   first 32-read group of phase 28's E-step (ragged) as phase 7 holds K3;
   ms, plain ms and bounds, and the stream build's ms;
28. bench.py's hdp_alignments_per_sec: the 256 reads through
   HdpAligner(group=64).run in chunks of 64, compact_k 2048, the
   compaction copied to the host, median of 3 after a warm-up, with the
   launch counts and a stage split (prepare, inputs, stream, fwd, bwd,
   compact, and the extraction of each chunk); the HDP E-step on bench.py's
   signal-EM shape (128 reads, group 32, ragged), median of 3 after a
   warm-up.

The stage splits run the path's own code (``WavefrontAligner.run``,
``cli.realign.main``, ``pipeline.em.calculate_expectations_pallas`` and
``pipeline.signal_align_batch.run_batch_fast`` take a ``stage`` hook),
each step ended by a synchronize.

Each path's launch counts are read from a run that starts with every
count at 0.  Any failed check raises (exit code != 0).  After the phases,
one line each gives a phase's wall seconds (``phase N: s``), then their
sum.  The last three lines are a JSON record of the kernels (times,
launches and the passes of the main path they were counted over, the
least time the card could take and what bounds it), the card's name and
power limit, and {"ok": true, "device": ...}.  Exits with 2 and prints no
result when no CUDA device is present.
"""

import contextlib
import importlib.metadata
import io
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# the port runs without JAX and without the JAX package: any import fails
sys.modules["jax"] = None
sys.modules["cpecan_tpu"] = None

import torch

BATCH = dict(n_reads=256, n_ref=905, n_events=800, seed=7)
GROUP = CHUNK = 64
COMPACT_K = 1024
EM_GROUP = 32        # the JAX package's EM group (bench_signal_em)
EM_ITERATIONS = 3
TILE_CHECK = 128     # phase 10's tile: 14 tiles over the bench chunk
LONG_READS = 64      # phase 12: seeds 11 .. 74
LONG_GROUP = 8
LONG_COMPACT_K = 4096
LONG_CHECK = (1500, 2550)  # phase 12: the read held against plain (2 tiles)
DEVICE = "cuda"
# H100 SXM data-sheet peaks (dense, 700 W): the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per band cell and diagonal, counted from the kernels'
# arithmetic (an exp or log counts one): strawman emissions 34, a
# piecewise-cubic log_add 38, the forward update 205, the backward update
# and posterior 211, the expectation targets 110 more.  Dna5: the match
# emission 14 (five compares, five selects, four adds), eight log_adds and
# 18 adds per update (322), the band mask 3 and the backward's seed
# selects and posterior 10; the dna5 expectation target 135 more (the
# match emission 14, 13 probabilities of 5 each, 5 adds, 13 sums of 2, the
# band mask 3, four y-base compares, the state masses 8, five column adds
# of 2).  Vanilla: the emissions 50 (two Gaussians of 8, two inverse
# Gaussians of 16, two adds), four log_adds and 9 adds per update (161),
# the band mask 3, the backward's seed selects and posterior 10; the
# expectation target 17 more (two probabilities of 5, their masked adds 4,
# the band mask 3).  Sm4: the strawman's emissions 34, seven log_adds and
# 15 adds per update (281), the band mask 3 and the fourth state's select
# 2; the backward's seed selects and posterior 11; the expectation target
# 122 more (the emissions 34, 11 probabilities of 5, four adds, 11 masked
# sums of 2, the shortGapX column add 4, the band mask 3).  Echelon: the
# emissions 212 (per n = 1..5 a Gaussian of 8, an inverse Gaussian of 16,
# their add, an exact log_add of 7 and the validity select, log n, duration
# and clamp 5; the gap-Y term 27), the forward update 15 log_adds and 11
# adds (581), the band mask 3 and seven selects; the backward update seven
# log_adds and 12 adds (278), the band mask 3, the seed selects 10 and five
# posteriors of 5; the emission pre-pass the emissions alone (212).  Hdp: the strawman's counts without its emissions (34,
# twice in the expectation target), one stream read and its window check
# (1)
FLOPS_PER_CELL = dict(fwd=240, bwd=245, bwd_exp=355, dna5_fwd=339,
                      dna5_bwd=349, dna5_bwd_exp=484, vanilla_fwd=214,
                      vanilla_bwd=221, vanilla_bwd_exp=238, sm4_fwd=320,
                      sm4_bwd=326, sm4_bwd_exp=448, echelon_fwd=803,
                      echelon_bwd=528, echelon_emissions=212, hdp_fwd=207,
                      hdp_bwd=212, hdp_bwd_exp=288)
DNA_GROUP = 32       # phases 13-15: bench.py's realign chunk and group
DNA_COMPACT_K = 4096
DNA_LONG = 100_000   # phase 16: bench.py's long_read_bases_per_sec pair
DNA_LONG_COMPACT_K = 2048
DNA_LONG_TILE = 2048
DNA_CHECK = 2_000    # phase 16: the pair held against plain at that geometry
EM_DNA_GROUP = 32    # phases 17-18: bench.py's bench_dna_em group
EM_DNA_SHARD = 1000  # phase 18: one default-size shard of 1 kb alignments
VANILLA_E_READS = 128  # phase 20: bench.py's signal-EM shape (group 32)
PIPE_READS = 64      # phase 23: bench.py's signal_pipeline_reads_per_sec
PIPE_GROUP = 32
PIPE_CHUNK = 64
PIPE_COMPACT_K = 2048
PIPE_CLI_READS = 4   # phase 23: the CLI's run
PIPE_OVERLAP_READS = 256  # phase 23: the drain overlap over four chunks
ECH_READS = 64       # phases 24-25: bench.py's echelon cell
ECH_GROUP = ECH_CHUNK = 32
ECH_COMPACT_K = 4096
ECH_THRESHOLD = 0.01
# phase 26: bench.py's signal_pipeline_echelon_reads_per_sec
ECH_PIPE_READS = 32
ECH_PIPE_THRESHOLD = 0.15
HDP_GROUP = HDP_CHUNK = 64   # phases 27-28: bench.py's HDP cell (bench_hdp)
HDP_COMPACT_K = 2048
GOLDEN = {(0, 0), (1, 1), (2, 4), (3, 5)}
# the kernels redesigned for the H100 (every select instance) whose ptxas
# report phase 2 holds to 64 registers and no spill
REDESIGNED = ("sm3_fwd_tiled_sel<Dna5, 1>",
              "sm3_bwd_tiled_sel<Dna5, 0, 1>",
              "sm3_bwd_tiled_sel<Dna5, 1, 0>",
              "sm3_bwd_tiled_sel<Strawman, 0, 1>",
              "sm3_fwd_tiled_sel<Strawman, 1>",
              "sm3_bwd_tiled_sel<Dna5, 0, 0>",
              "sm3_bwd_tiled_sel<Sm4, 0, 1>",
              "sm3_bwd_tiled_sel<Vanilla, 0, 1>",
              "sm3_fwd_tiled_sel<Sm4, 1>", "sm3_fwd_tiled_sel<Vanilla, 1>",
              "sm3_fwd_tiled_sel<Echelon, 0>",
              "sm3_bwd_tiled_sel<Echelon, 0, 0>",
              "sm3_emissions_kernel<Echelon>",
              "sm3_bwd_tiled_sel<Strawman, 0, 0>",
              "sm3_bwd_tiled_sel<Vanilla, 0, 0>",
              "sm3_bwd_tiled_sel<Hdp, 0, 0>",
              "sm3_fwd_tiled_sel<Vanilla, 0>",
              "sm3_fwd_tiled_sel<Strawman, 0>",
              "sm3_fwd_tiled_sel<Dna5, 0>",
              "sm3_fwd_tiled_sel<Sm4, 0>",
              "sm3_bwd_tiled_sel<Sm4, 0, 0>")


def log(msg):
    print(msg, flush=True)


def smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warm=True):
    """Mean device time of fn() over ``reps`` back-to-back calls (CUDA
    events), after one warm-up call unless ``warm`` is False."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), device ms of that one call from CUDA events): the plain
    versions are timed on the call whose result is checked."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end)


class PhaseClock:
    """Wall seconds of each phase: ``start(n)`` ends the running phase and
    starts phase n, ``stop()`` ends the last one."""

    def __init__(self):
        self.s = {}
        self.n = self.t0 = None

    def start(self, n):
        now = time.perf_counter()
        if self.n is not None:
            self.s[self.n] = now - self.t0
        self.n, self.t0 = n, now

    def stop(self):
        self.start(None)


class Stages:
    """The ``stage`` hook of ``WavefrontAligner.run`` and the realign CLI:
    times each named step, ended by a synchronize (the run overlaps
    nothing across them), and keeps each step's last result."""

    def __init__(self):
        self.s, self.out = {}, {}

    def __call__(self, name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0
        self.out[name] = res
        return res

    def line(self):
        total = sum(self.s.values())
        return ", ".join(f"{k} {v:.4f} ({v / total:.1%})"
                         for k, v in self.s.items())


def bound(tensors, cells, flops_per_cell):
    """(least ms the card could take, "bytes" or "operations"): every
    tensor read or written once at HBM_BYTES_PER_S, against the f32
    operations of ``cells`` band cells at F32_FLOPS_PER_S."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * flops_per_cell / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def posterior_fwd(fwd, seedf, R):
    """The entries of a fwd plane [G, ND+1, S, R, W] that a posterior
    backward of one posterior state (the match, 0) must read, as tensors
    for ``bound``: that state's plane, and the other states' entries of
    each read's lanes at its seed diagonals (its total)."""
    b, d = torch.nonzero(seedf != 0, as_tuple=True)
    return [fwd[:, :, 0], fwd[b // R, d, 1:, b % R, :]]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.cli import realign
    from cpecan_tpu_torch.cli.batch import (em_main,
                                            signal_align_batch_main,
                                            train_models_main)
    from cpecan_tpu_torch.fixtures import (fixture_path, load_batch_zymo,
                                           load_dna5_em, load_echelon_zymo,
                                           load_dna5_realign, load_long_read,
                                           load_vanilla_zymo,
                                           load_zymo_slice, load_zymo_train,
                                           zymo_trained_params)
    from cpecan_tpu_torch.io.cigar import cigar_write
    from cpecan_tpu_torch.io.poremodel import load_pore_model
    from cpecan_tpu_torch.models.hmm import ContinuousPairHmm, VanillaHmm
    from cpecan_tpu_torch.models.state_machines import (
        StateMachine3Hdp, StateMachine3SignalStrawman, StateMachine3Vanilla,
        StateMachine4, StateMachine5)
    from cpecan_tpu_torch.ops import fb_kernels as fk
    from cpecan_tpu_torch.ops.compact import (compact_chunks,
                                              compact_posteriors,
                                              extract_echelon_pairs_chunk,
                                              fetch,
                                              extract_pairs_auto,
                                              extract_pairs_chunk,
                                              extract_pairs_long)
    from cpecan_tpu_torch.ops.cuda_build import build_info, load_library
    from cpecan_tpu_torch.ops.compact import host_array
    from cpecan_tpu_torch.ops.fb import (Dna5Aligner, EchelonAligner,
                                         HdpAligner, Sm4Aligner,
                                         StrawmanAligner, VanillaAligner,
                                         exp_dispatch, exp_finalize)
    from cpecan_tpu_torch.parity import (KERNEL_GAPX_ATOL,
                                         LONG_DNA_ENGINE_SCORE_ATOL,
                                         TOTAL_RTOL, band_mask, check_em,
                                         check_exp_kernel,
                                         check_expectations, check_fwd,
                                         check_hdp_stream,
                                         check_long_pairs, check_pair_sets,
                                         check_pairs, check_posts,
                                         check_tiled, check_tiled_pairs,
                                         check_totals, check_trained,
                                         check_tsv)
    from cpecan_tpu_torch.pipeline import em
    from cpecan_tpu_torch.pipeline.signal_align_batch import run_batch_fast
    from cpecan_tpu_torch.pipeline.train_models import (
        TrainOptions, add_and_norm_expectations, strand_expectations, train)
    from cpecan_tpu_torch.synthetic import (dna_em_batch, dna_realign_batch,
                                            echelon_batch, hdp_model,
                                            long_signal_read, realign_inputs,
                                            synth_dna_pair, synthetic_batch)

    def same(what, got, want):
        """0.0, the largest difference of ``got`` from ``want``, or raise."""
        if not torch.equal(got, want):
            raise AssertionError(f"{what} differs from the plain version by "
                                 f"{float((got - want).abs().max())}")
        return 0.0

    dev = torch.device(DEVICE)
    thr = AlignmentParams().threshold
    clock = PhaseClock()
    clock.start(1)
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    smi = smi_line()
    log(f"capability: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"triton {triton}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"nvidia-smi: {smi}")

    # -- 2. build --------------------------------------------------------
    clock.start(2)
    t0 = time.perf_counter()
    load_library()
    path, build_s, build_log = build_info()
    log(f"build: {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {'%.2f s' % build_s if build_s is not None else 'cached'})")
    # one line per kernel instance: its registers and spill
    kernel, ptxas = None, {}
    for line in build_log.splitlines():
        m = re.search(r"(sm3_\w+?)INS_\d+(\w+?)E((?:Lb[01]E)*)", line)
        if m:
            flags = "".join(", " + f
                            for f in re.findall(r"Lb([01])E", m.group(3)))
            kernel = f"{m.group(1)}<{m.group(2)}{flags}>"
        elif "registers" in line or "spill" in line:
            ptxas.setdefault(kernel, []).append(line.strip())
            log(f"  ptxas: {kernel}: {line.strip()}")
    # the kernels redesigned for this card (every select instance) stay
    # within the 64-register cap without spilling
    for name in REDESIGNED:
        report = " ".join(ptxas.get(name, []))
        regs = re.search(r"Used (\d+) registers", report)
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", report)
        if not regs or len(spills) != 2:
            raise AssertionError(f"no ptxas report for {name}")
        if int(regs.group(1)) > 64 or any(int(s) for s in spills):
            raise AssertionError(f"{name}: {report}")
        log(f"  ptxas: {name} within 64 registers, no spill")

    # -- 3. kernels vs plain on the first bench chunk --------------------
    clock.start(3)
    # K1 strawman (the untiled select forward, sm3_fwd_tiled_sel<Strawman,
    # 0>) and K2 strawman (the untiled select posterior form,
    # sm3_bwd_tiled_sel<Strawman, 0, 0>), bit for bit
    sm, reads = synthetic_batch(**BATCH)
    pa = StrawmanAligner(AlignmentParams(), device=dev, group=GROUP)
    prep = pa.prepare(sm, reads[:CHUNK])
    inp = pa.device_inputs(sm, prep)
    dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"])
    args = [inp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    bargs = args + [inp["seedf"], inp["raggedf"]]
    fwd_k = fk.wavefront_fwd(*args, **dims)
    fwd_p, fwd_plain_ms = timed(lambda: fk.forward_plain(*args, **dims))
    fwd_err = check_fwd(fwd_k, fwd_p, band_mask(prep, inp["basef"],
                                                inp["widthf"]))
    posts_k, tot_k = fk.wavefront_bwd(*bargs, fwd_k, **dims)
    (posts_p, tot_p), bwd_plain_ms = timed(
        lambda: fk.backward_plain(*bargs, fwd_k, **dims))
    if not torch.all(posts_k[:, 0] == 0):
        raise AssertionError("diagonal 0 of the posterior plane is not 0")
    post_err = check_posts(posts_k, posts_p)
    tot_rel = check_totals(tot_k, tot_p)
    for what, got, want in (("K1 fwd plane", fwd_k, fwd_p),
                            ("K2 posteriors", posts_k, posts_p),
                            ("K2 totals", tot_k, tot_p)):
        same(what, got, want)
    cells = sum(int(b.width.sum()) for b in prep["bands"])
    bounds = dict(
        fwd=bound(args + [fwd_k], cells, FLOPS_PER_CELL["fwd"]),
        bwd=bound(bargs + posterior_fwd(fwd_k, bargs[6], dims["R"])
                  + [posts_k, tot_k], cells, FLOPS_PER_CELL["bwd"]))
    nds = [b.n_diag for b in prep["bands"]]
    rels = list(range(len(nds)))
    chunk_outs = [dict(prep=prep, posteriors=posts,
                       compact=compact_posteriors(posts, COMPACT_K))
                  for posts in (posts_k, posts_p)]
    chunk_parts = [extract_pairs_chunk(o, rels, nds, thr)
                   for o in chunk_outs]
    n_fringe = sum(check_pairs(a.tolist(), b.tolist(), *chunk_outs, i, thr)
                   for i, (a, b) in enumerate(zip(*chunk_parts)))
    ms = dict(
        fwd=cuda_ms(lambda: fk.wavefront_fwd(*args, **dims), 5),
        fwd_plain=fwd_plain_ms,
        bwd=cuda_ms(lambda: fk.wavefront_bwd(*bargs, fwd_k, **dims), 5),
        bwd_plain=bwd_plain_ms)
    log(f"kernels vs plain ({CHUNK} reads, ND={dims['ND']}, W={dims['W']}): "
        f"fwd, posts, totals equal bit for bit; "
        f"fwd in-band max|d| {fwd_err:.3g}, posts max|d| {post_err:.3g}, "
        f"totals rel {tot_rel:.3g}, pairs {sum(map(len, chunk_parts[0]))} "
        f"({n_fringe} fringe); ms fwd {ms['fwd']:.3f} vs plain "
        f"{ms['fwd_plain']:.1f}, bwd {ms['bwd']:.3f} vs plain "
        f"{ms['bwd_plain']:.1f}")

    # -- 4. Zymo read vs the f64 engine ----------------------------------
    clock.start(4)
    model, zread, zpairs = load_zymo_slice()
    zout = StrawmanAligner(AlignmentParams(), device=dev, group=1).run(
        StateMachine3SignalStrawman(model), [zread])
    got = {(x, y) for _, x, y in extract_pairs_auto(
        zout, 0, zout["prep"]["bands"][0].n_diag, thr)}
    want = {(int(x), int(y)) for _, x, y in zpairs}
    log(f"zymo: {len(got & want)} pairs agree with the f64 engine "
        f"({len(want)}), {len(got ^ want)} differ")
    if len(got & want) < 980 or len(got ^ want) > 2:
        raise AssertionError("Zymo pairs disagree with the f64 engine")
    torch.cuda.synchronize()

    # -- 5. the main path at bench scale ---------------------------------
    clock.start(5)
    def main_path():
        parts, outs = [], []
        for i in range(0, len(reads), CHUNK):
            out = pa.run(sm, reads[i:i + CHUNK], compact_k=COMPACT_K)
            nds = [b.n_diag for b in out["prep"]["bands"]]
            parts += extract_pairs_chunk(out, list(range(len(nds))), nds,
                                         thr)
            outs.append(out)
        torch.cuda.synchronize()
        return parts, outs

    fk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    parts, outs = main_path()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        main_path()
        times.append(time.perf_counter() - t0)
    launches = dict(wavefront_fwd=fk.wavefront_fwd.launches,
                    wavefront_bwd=fk.wavefront_bwd.launches)
    plain_calls = fk.forward_plain.calls + fk.backward_plain.calls
    peak = torch.cuda.max_memory_allocated()
    if min(launches.values()) <= 0 or plain_calls:
        raise AssertionError(f"main path launches {launches}, plain calls "
                             f"{plain_calls}")
    cells = sum(int(b.width.sum()) for o in outs for b in o["prep"]["bands"])
    for o in outs:
        tot = o["totals"]
        if tuple(tot.shape) != (1, CHUNK) or not torch.isfinite(tot).all():
            raise AssertionError("main path totals not finite")
    if min(map(len, parts)) == 0 or len(parts) != len(reads):
        raise AssertionError("a read of the main path has no pairs")
    for i in rels:   # the main path's first chunk against the plain run
        check_pairs(parts[i].tolist(), chunk_parts[1][i].tolist(), outs[0],
                    chunk_outs[1], i, thr)
    dt = statistics.median(times)
    log(f"main path: {len(reads)} reads in chunks of {CHUNK}, "
        f"{sum(map(len, parts))} pairs, {len(reads) / dt:.1f} alignments/s "
        f"e2e, {cells / dt:.4g} band cells/s e2e (median of "
        f"{[round(t, 4) for t in times]} s), peak device memory "
        f"{peak / 1e9:.3f} GB, launches {launches}, plain calls "
        f"{plain_calls}")

    # where one main-path pass spends its time: its run's steps
    st = Stages()
    for i in range(0, len(reads), CHUNK):
        sout = pa.run(sm, reads[i:i + CHUNK], compact_k=COMPACT_K, stage=st)
        snd = [b.n_diag for b in sout["prep"]["bands"]]
        st("extract", lambda: extract_pairs_chunk(
            sout, list(range(len(snd))), snd, thr))
    log("main path stages (s, share): " + st.line())
    del st, sout

    # -- 6. device-only fwd+bwd, whole batch -----------------------------
    clock.start(6)
    bprep = pa.prepare(sm, reads)
    binp = pa.device_inputs(sm, bprep)
    bdims = dict(R=bprep["R"], W=bprep["W"], ND=bprep["ND"], C=bprep["C"])
    ba = [binp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    bb = ba + [binp["seedf"], binp["raggedf"]]

    def once(fwd_fn, bwd_fn):
        return bwd_fn(*bb, fwd_fn(*ba, **bdims), **bdims)

    dev_ms = cuda_ms(lambda: once(fk.wavefront_fwd, fk.wavefront_bwd), 3)
    bcells = sum(int(b.width.sum()) for b in bprep["bands"])
    log(f"device fwd+bwd ({len(reads)} reads, G={len(bprep['win'])}): "
        f"kernels {dev_ms:.3f} ms ({bcells / dev_ms * 1e3:.4g} band "
        f"cells/s)")
    torch.cuda.synchronize()

    # -- 7. K3 vs plain on the first 32 bench reads, training inputs -----
    clock.start(7)
    # the inputs of phase 9's E-step (ragged ends, per-read scaling), cut
    # to their first group of 32 reads; once with the untrained machine
    # (Y -> X closed: LOG_ZERO) and once with a trained one (Y -> X open)
    em_sp = np.random.default_rng(4).uniform(0.95, 1.05, (len(reads), 5))
    epa = StrawmanAligner(AlignmentParams(), device=dev, group=EM_GROUP)
    full = epa.prepare(sm, reads, ragged_right=True, scale_params=em_sp)
    n = EM_GROUP
    eprep = dict(full, B=n, codes=full["codes"][:n], bands=full["bands"][:n])
    edims = dict(R=n, W=full["W"], ND=full["ND"], C=full["C"])
    tparams, tgap_x = zymo_trained_params()
    machines = dict(untrained=sm, trained=StateMachine3SignalStrawman(
        sm.model, params=tparams, gap_x_log_probs=tgap_x))
    sx = fk.StrawmanSpec.EXP_LANES["sx"]
    exp_err = 0.0
    for name, machine in machines.items():
        finp = epa.device_inputs(machine, full, ragged_left=True)
        mb = [finp["scal"], finp["win"][:1]] + [
            finp[k][:n] for k in ("xf", "yf", "basef", "widthf", "seedf",
                                  "raggedf")]
        efwd = fk.wavefront_fwd(*mb[:6], **edims)
        ek = fk.wavefront_bwd_exp(*mb, efwd, **edims)
        ep, ep_ms = timed(lambda: fk.backward_exp_plain(*mb, efwd, **edims))
        e_gap = check_exp_kernel(ek, ep)
        y_to_x = ek[2][..., sx]
        if not bool(torch.all(y_to_x > 0) if name == "trained"
                    else torch.all(y_to_x == 0)):
            raise AssertionError(f"{name} machine: Y -> X sums {y_to_x}")
        mexp, pexp = (exp_finalize(eprep, host_array(exp_dispatch(
            o[2], o[3], o[1]))) for o in (ek, ep))
        check_expectations(mexp, pexp)
        exp_err = max(exp_err, e_gap)
        if name == "untrained":
            kexp, eb, ebfwd, ek_plain_ms = mexp, mb, efwd, ep_ms
        log(f"expectation kernel vs plain, {name} machine ({n} reads, "
            f"ragged, scaled, ND={edims['ND']}, W={edims['W']}): posts, "
            f"totals, trans equal; gapx max|d| {e_gap:.3g}; Y -> X "
            f"sums {float(y_to_x.min()):.4g}-{float(y_to_x.max()):.4g}")
    ms.update(
        bwd_exp=cuda_ms(lambda: fk.wavefront_bwd_exp(*eb, ebfwd, **edims),
                        5),
        bwd_exp_plain=ek_plain_ms)
    em_cells = sum(int(b.width.sum()) for b in eprep["bands"])
    bounds["bwd_exp"] = bound(eb + [ebfwd, *ek], em_cells,
                              FLOPS_PER_CELL["bwd_exp"])
    log(f"expectation kernel ms ({n} reads, untrained machine): bwd_exp "
        f"{ms['bwd_exp']:.3f} vs plain {ms['bwd_exp_plain']:.1f}")

    # -- 8. Zymo training vs the JAX package's result ---------------------
    clock.start(8)
    zargs, zstored = load_zymo_train()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t_hmm, c_hmm, traj = train(
            **zargs, out_template_hmm=os.path.join(tmp, "t.hmm"),
            out_complement_hmm=os.path.join(tmp, "c.hmm"),
            options=TrainOptions(iterations=len(zstored["trajectory"])),
            log=lambda m: None, device=dev)
    ztrans = check_trained(t_hmm, c_hmm, traj, zstored)
    log(f"zymo training ({len(traj)} iterations, both strands) in "
        f"{time.perf_counter() - t0:.2f} s: trajectory "
        f"{[tuple(round(v, 2) for v in t) for t in traj]}, transitions "
        f"max|d| {ztrans:.3g} vs the JAX package")

    # -- 9. the trainer at full width -------------------------------------
    clock.start(9)
    em_kw = dict(expectations=True, ragged_left=True, ragged_right=True)
    # the full-width E-step against phase 7's on the reads they share
    first = epa.run(sm, reads, scale_params=em_sp, **em_kw)["expectations"]
    first_err = check_expectations({k: v[:n] for k, v in first.items()},
                                   kexp)

    def em_iteration(machine):
        accs = strand_expectations(machine, reads, em_sp, epa)
        merged, lik = add_and_norm_expectations(accs)
        params, gap_x = merged.to_sm3_params()
        return StateMachine3SignalStrawman(
            machine.model, params=params, gap_x_log_probs=gap_x), lik

    fk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    em_held = torch.cuda.memory_allocated()   # by the earlier phases
    machine, liks, iter_s = sm, [], []
    for _ in range(EM_ITERATIONS):
        t0 = time.perf_counter()
        machine, lik = em_iteration(machine)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
        liks.append(lik)
    em_launches = dict(wavefront_fwd=fk.wavefront_fwd.launches,
                       wavefront_bwd_exp=fk.wavefront_bwd_exp.launches)
    em_plain = (fk.forward_plain.calls + fk.backward_plain.calls
                + fk.backward_exp_plain.calls)
    em_peak = torch.cuda.max_memory_allocated()
    if min(em_launches.values()) <= 0 or em_plain:
        raise AssertionError(f"EM path launches {em_launches}, plain calls "
                             f"{em_plain}")
    if not all(np.isfinite(liks)):
        raise AssertionError(f"EM likelihoods not finite: {liks}")
    if not np.isfinite(machine.gap_x_log_probs).all():
        raise AssertionError("trained gap-X table not finite")

    # bench.py bench_signal_em: 128 reads, one dispatch, median of 3
    em_sub = reads[:128]

    def estep():
        return epa.run(sm, em_sub, **em_kw)["expectations"]

    estep()
    em_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        estep()
        em_times.append(time.perf_counter() - t0)
    em_rate = len(em_sub) / statistics.median(em_times)
    log(f"EM at full width: {len(reads)} reads x {EM_ITERATIONS} "
        f"iterations (first E-step vs phase 7's kernel run on its first "
        f"{n} reads: trans max|d| {first_err:.3g}), likelihoods {liks}, s "
        f"per iteration {[round(t, 4) for t in iter_s]}, peak device "
        f"memory {em_peak / 1e9:.3f} GB ({em_held / 1e9:.3f} GB of it held "
        f"before the EM run), launches {em_launches}, plain calls "
        f"{em_plain}")
    log(f"signal_em_estep_reads_per_sec {em_rate:.1f} ({len(em_sub)} reads, "
        f"group {EM_GROUP}, one dispatch; median of "
        f"{[round(t, 4) for t in em_times]} s)")

    # where one E-step spends its time: its run's steps
    est = Stages()
    epa.run(sm, em_sub, stage=est, **em_kw)
    log("E-step stages (s, share): " + est.line())
    del est
    torch.cuda.synchronize()

    # -- 10. K6a/K6b vs plain on the first bench chunk, 14 tiles ----------
    clock.start(10)
    tprep = pa.prepare(sm, reads[:CHUNK], tile_diag=TILE_CHECK)
    tinp = pa.device_inputs(sm, tprep)
    tl = tprep["tiled"]
    tdims = dict(R=tprep["R"], W=tprep["W"], ND=tl["NDT"], C=tprep["C"],
                 TD=tl["TD"])
    ta = [tinp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    tb = ta + [tinp["seedf"], tinp["raggedf"]]
    tfwd_k, tsh_k = fk.wavefront_fwd_tiled(*ta, **tdims)
    (tfwd_p, tsh_p), ms["fwd_tiled_plain"] = timed(
        lambda: fk.forward_tiled_plain(*ta, **tdims))
    tposts_k, ttot_k = fk.wavefront_bwd_tiled(*tb, tfwd_k, tsh_k, **tdims)
    (tposts_p, ttot_p), ms["bwd_tiled_plain"] = timed(
        lambda: fk.backward_tiled_plain(*tb, tfwd_k, tsh_k, **tdims))
    for what, got, want in (("K6a fwd plane", tfwd_k, tfwd_p),
                            ("K6a shifts", tsh_k, tsh_p),
                            ("K6b posteriors", tposts_k, tposts_p),
                            ("K6b totals", ttot_k, ttot_p)):
        same(what, got, want)
    if not (torch.all(tposts_k[:, 0] == 0)
            and torch.all(tfwd_k[:, dims["ND"] + 1:] == fk.NEG)):
        raise AssertionError("tiled planes: diagonal 0 or the fwd rows past "
                             "ND are not 0 / NEG")
    if not bool((tsh_k[..., 1:] != 0).all()):
        raise AssertionError("a tile boundary did not re-center")
    # the tiled planes against the untiled ones: the shifts repaid
    tpost_err, ttot_err = check_tiled(tposts_k, ttot_k, posts_k, tot_k)
    tparts = []
    for tposts in (tposts_k, tposts_p):
        tout = dict(prep=tprep, posteriors=tposts, tiled=tl,
                    compact_chunks=compact_chunks(
                        tposts, tl["DC"], min(COMPACT_K, tl["DC"] * dims["W"])))
        tparts.append(extract_pairs_chunk(tout, rels, nds, thr))
    for i, (a, b) in enumerate(zip(*tparts)):
        if not np.array_equal(a, b):
            raise AssertionError(f"tiled pairs of read {i}: kernel and plain "
                                 "planes give different pairs")
        check_tiled_pairs(a, chunk_parts[0][i], thr)
    ms.update(
        fwd_tiled=cuda_ms(lambda: fk.wavefront_fwd_tiled(*ta, **tdims), 5),
        bwd_tiled=cuda_ms(lambda: fk.wavefront_bwd_tiled(
            *tb, tfwd_k, tsh_k, **tdims), 5))
    log(f"tiled kernels vs plain ({CHUNK} reads, ND={dims['ND']}, "
        f"TD={tl['TD']}, NT={tl['NT']}, NDT={tl['NDT']}): fwd plane, shifts, "
        f"posts, totals equal bit for bit, pairs equal; against the untiled "
        f"run posts max|d| {tpost_err:.3g}, totals max|d| {ttot_err:.3g}; ms "
        f"fwd_tiled {ms['fwd_tiled']:.3f} vs plain "
        f"{ms['fwd_tiled_plain']:.1f}, bwd_tiled {ms['bwd_tiled']:.3f} vs "
        f"plain {ms['bwd_tiled_plain']:.1f}")
    del tfwd_k, tfwd_p, tposts_k, tposts_p
    torch.cuda.synchronize()

    # -- 11. the fixture long read routes tiled by itself -----------------
    clock.start(11)
    lmodel, lread, lstored = load_long_read()
    lsm = StateMachine3SignalStrawman(lmodel)
    la = StrawmanAligner(AlignmentParams(), device=dev, group=LONG_GROUP)
    fk.reset_counts()
    lout = la.run(lsm, [lread])
    torch.cuda.synchronize()
    lcounts = dict(wavefront_fwd_tiled=fk.wavefront_fwd_tiled.launches,
                   wavefront_bwd_tiled=fk.wavefront_bwd_tiled.launches,
                   wavefront_fwd=fk.wavefront_fwd.launches,
                   wavefront_bwd=fk.wavefront_bwd.launches)
    if (lcounts["wavefront_fwd_tiled"], lcounts["wavefront_bwd_tiled"],
            lcounts["wavefront_fwd"], lcounts["wavefront_bwd"]) != (1, 1, 0, 0):
        raise AssertionError(f"the long read did not route tiled: {lcounts}")
    lnd = lout["prep"]["bands"][0].n_diag
    lpairs = extract_pairs_auto(lout, 0, lnd, thr, as_array=True)
    vs_jax = check_long_pairs(lpairs, lstored["tiled_pairs"], thr)
    vs_eng = check_long_pairs(lpairs, lstored["engine_pairs"], thr)
    if not torch.isfinite(lout["totals"]).all():
        raise AssertionError("long read total not finite")
    log(f"long read (l_x {lread[2]}, l_y {lread[3]}, ND={lnd}, "
        f"{lout['tiled']}, W={lout['prep']['W']}): routed tiled "
        f"{lcounts}; {len(lpairs)} pairs; vs the JAX tiled path "
        f"({len(lstored['tiled_pairs'])}): {vs_jax[0]} in one set only "
        f"(max {vs_jax[1]:.3g} from the threshold), common scores max|d| "
        f"{vs_jax[2]:.3g}; vs the f64 engine "
        f"({len(lstored['engine_pairs'])}): {vs_eng[0]} in one set only "
        f"(max {vs_eng[1]:.3g}), common max|d| {vs_eng[2]:.3g}")
    del lout
    torch.cuda.synchronize()

    # -- 12. the long-read path at full width -----------------------------
    clock.start(12)
    lreads = [long_signal_read(lread[2], lread[3], seed)[1]
              for seed in range(11, 11 + LONG_READS)]
    bases = sum(r[2] + r[3] for r in lreads)

    def long_path():
        out = la.run(lsm, lreads, compact_k=LONG_COMPACT_K)
        nds = [b.n_diag for b in out["prep"]["bands"]]
        parts = extract_pairs_chunk(out, list(range(len(nds))), nds, thr)
        torch.cuda.synchronize()
        return parts, out

    fk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    long_held = torch.cuda.memory_allocated()
    lparts, lbig = long_path()
    ltimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        long_path()
        ltimes.append(time.perf_counter() - t0)
    long_launches = dict(
        wavefront_fwd_tiled=fk.wavefront_fwd_tiled.launches,
        wavefront_bwd_tiled=fk.wavefront_bwd_tiled.launches)
    long_plain = fk.forward_tiled_plain.calls + fk.backward_tiled_plain.calls
    long_peak = torch.cuda.max_memory_allocated()
    if (min(long_launches.values()) <= 0 or long_plain
            or fk.wavefront_fwd.launches or fk.wavefront_bwd.launches):
        raise AssertionError(f"long path launches {long_launches}, plain "
                             f"calls {long_plain}")
    if not torch.isfinite(lbig["totals"]).all():
        raise AssertionError("long path totals not finite")
    if len(lparts) != LONG_READS or min(map(len, lparts)) < lread[2]:
        raise AssertionError("a long read has fewer pairs than bases")
    # its first read is the fixture read, in a batch of its own quantization
    big_vs_jax = check_long_pairs(lparts[0], lstored["tiled_pairs"], thr)
    lt = statistics.median(ltimes)
    log(f"long path: {LONG_READS} reads of {lread[2]} bases x {lread[3]} "
        f"events (group {LONG_GROUP}, compact_k {LONG_COMPACT_K}, "
        f"{lbig['tiled']}), {sum(map(len, lparts))} pairs, "
        f"{bases / lt:.6g} bases/s e2e, {LONG_READS / lt:.4g} alignments/s "
        f"e2e (median of {[round(t, 4) for t in ltimes]} s); first read vs "
        f"the JAX tiled path: {big_vs_jax[0]} in one set only, common max|d| "
        f"{big_vs_jax[2]:.3g}; peak device memory {long_peak / 1e9:.3f} GB "
        f"({long_held / 1e9:.3f} GB of it held before), launches "
        f"{long_launches}, plain calls {long_plain}")
    del lbig
    torch.cuda.synchronize()

    lst = Stages()
    sout = la.run(lsm, lreads, compact_k=LONG_COMPACT_K, stage=lst)
    snd = [b.n_diag for b in sout["prep"]["bands"]]
    lst("extract", lambda: extract_pairs_chunk(
        sout, list(range(len(snd))), snd, thr))
    log("long path stages (s, share): " + lst.line())

    def tiled_args(st, spec=fk.StrawmanSpec):
        """(fwd args, bwd args, dims, prep) of a staged tiled run."""
        prep, inp = st.out["prepare"], st.out["inputs"]
        tl = prep["tiled"]
        dims = dict(R=prep["R"], W=prep["W"], ND=tl["NDT"], C=prep["C"],
                    TD=tl["TD"], spec=spec)
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
        return fa, fa + [inp["seedf"], inp["raggedf"]], dims, prep

    def long_main(st, spec, fwd_key, bwd_key, flops):
        """K6a/K6b of ``spec`` timed on the inputs of a staged run ``st``
        of the 64 long reads (ms[fwd_key], ms[bwd_key]), and their bounds;
        every row of the run's groups is a read (64 = 8 x 8), so the bound
        of its real rows is that of all rows.  Returns (a log line, the
        run's dims)."""
        fa, ba, dims, prep = tiled_args(st, spec)
        (fwd, sh), (posts, tot) = st.out["fwd_tiled"], st.out["bwd_tiled"]
        if len(prep["bands"]) != len(prep["win"]) * dims["R"]:
            raise AssertionError("the long path's groups hold padding rows")
        ms[fwd_key] = cuda_ms(lambda: fk.wavefront_fwd_tiled(*fa, **dims), 3)
        ms[bwd_key] = cuda_ms(lambda: fk.wavefront_bwd_tiled(
            *ba, fwd, sh, **dims), 3)
        cells = sum(int(b.width.sum()) for b in prep["bands"])
        bounds[fwd_key] = bound(fa + [fwd, sh], cells,
                                FLOPS_PER_CELL[flops + "fwd"])
        bounds[bwd_key] = bound(ba + posterior_fwd(fwd, ba[6], dims["R"])
                                + [sh, posts, tot], cells,
                                FLOPS_PER_CELL[flops + "bwd"])
        for key in (fwd_key, bwd_key):
            bounds[key + "_padded"] = bounds[key]
        nd = dims["ND"]
        return (f"G={len(prep['win'])}, NDT={nd}, W={dims['W']}, {cells} "
                f"band cells): K6a {ms[fwd_key]:.3f} ms, K6b "
                f"{ms[bwd_key]:.3f} ms per launch "
                f"({ms[fwd_key] * 1e6 / nd:.1f} / "
                f"{ms[bwd_key] * 1e6 / nd:.1f} ns a diagonal); bounds "
                f"{bounds[fwd_key][0]:.4f} / {bounds[bwd_key][0]:.4f} ms "
                f"({bounds[bwd_key][1]})"), dims

    lline, sd = long_main(lst, fk.StrawmanSpec, "fwd_long_main",
                          "bwd_long_main", "")
    lgeom = (sd["R"], sd["W"], sd["TD"])
    del lst, sout
    log(f"long path kernels ({LONG_READS} reads, {lline}")
    torch.cuda.synchronize()
    # K6a/K6b against their plain versions at the main path's R, W and TD
    # on one shorter read of the same generator (two tiles; the main
    # path's 64 reads would take ~6 minutes of plain passes).  The kernels
    # line takes these kernels' ms, plain ms, bound and error from this
    # check, all on its inputs
    cread = long_signal_read(LONG_CHECK[0], LONG_CHECK[1], 11)[1]
    cst = Stages()
    cout = la.run(lsm, [cread], compact_k=LONG_COMPACT_K,
                  tile_diag=sd["TD"], stage=cst)
    ca, cb, cd, cprep = tiled_args(cst)
    (cfwd, csh), (cposts, ctot) = cst.out["fwd_tiled"], cst.out["bwd_tiled"]
    del cst
    if (cd["R"], cd["W"], cd["TD"]) != lgeom:
        raise AssertionError(f"the check read's R, W, TD differ from the "
                             f"long path's {lgeom}")
    (pfwd, psh), ms["fwd_long_plain"] = timed(
        lambda: fk.forward_tiled_plain(*ca, **cd))
    (pposts, ptot), ms["bwd_long_plain"] = timed(
        lambda: fk.backward_tiled_plain(*cb, cfwd, csh, **cd))
    for what, got, want in (("K6a fwd plane (check read)", cfwd, pfwd),
                            ("K6a shifts (check read)", csh, psh),
                            ("K6b posteriors (check read)", cposts, pposts),
                            ("K6b totals (check read)", ctot, ptot)):
        same(what, got, want)
    cnd = cprep["bands"][0].n_diag
    cpairs = [extract_pairs_long(dict(cout, posteriors=p, compact_chunks=(
        compact_chunks(p, cout["tiled"]["DC"], min(
            LONG_COMPACT_K, cout["tiled"]["DC"] * cd["W"])))), 0, cnd, thr,
        as_array=True) for p in (cposts, pposts)]
    if not np.array_equal(*cpairs) or len(cpairs[0]) < cread[2]:
        raise AssertionError("the long check read: kernel and plain planes "
                             "give different pairs")
    ms.update(
        fwd_long=cuda_ms(lambda: fk.wavefront_fwd_tiled(*ca, **cd), 3),
        bwd_long=cuda_ms(lambda: fk.wavefront_bwd_tiled(
            *cb, cfwd, csh, **cd), 3))
    ccells = sum(int(b.width.sum()) for b in cprep["bands"])
    bounds.update(
        fwd_long=bound(ca + [cfwd, csh], ccells, FLOPS_PER_CELL["fwd"]),
        bwd_long=bound(cb + posterior_fwd(cfwd, cb[6], cd["R"])
                       + [csh, cposts, ctot], ccells,
                       FLOPS_PER_CELL["bwd"]))
    log(f"long path kernels vs plain (a {cread[2]} x {cread[3]} read, "
        f"{cout['tiled']}, R={cd['R']}, W={cd['W']}): fwd plane, shifts, "
        f"posts, totals equal bit for bit, {len(cpairs[0])} pairs equal; "
        f"K6a {ms['fwd_long']:.3f} ms vs plain {ms['fwd_long_plain']:.1f}, "
        f"K6b {ms['bwd_long']:.3f} ms vs plain {ms['bwd_long_plain']:.1f}; "
        f"bounds {bounds['fwd_long'][0]:.4f} / {bounds['bwd_long'][0]:.4f} "
        f"ms ({bounds['fwd_long'][1]})")
    del cout, cfwd, pfwd, cposts, pposts
    torch.cuda.synchronize()

    # -- 13. the dna5 kernels vs plain on the first 32 realign pairs ------
    clock.start(13)
    # K1 dna5 (the untiled select forward, sm3_fwd_tiled_sel<Dna5, 0>) and
    # K2 dna5 (the untiled select posterior form, sm3_bwd_tiled_sel<Dna5,
    # 0, 0>), bit for bit
    dreads = dna_realign_batch()
    dsm = StateMachine5()
    da = Dna5Aligner(AlignmentParams(), device=dev, group=DNA_GROUP)
    dprep = da.prepare(dsm, dreads[:DNA_GROUP], ragged_right=True)
    dinp = da.device_inputs(dsm, dprep, ragged_left=True)
    ddims = dict(R=dprep["R"], W=dprep["W"], ND=dprep["ND"], C=dprep["C"],
                 spec=fk.Dna5Spec)
    dfa = [dinp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    dba = dfa + [dinp["seedf"], dinp["raggedf"]]
    dfwd_k = fk.wavefront_fwd(*dfa, **ddims)
    dfwd_p, ms["dna5_fwd_plain"] = timed(
        lambda: fk.forward_plain(*dfa, **ddims))
    dposts_k, dtot_k = fk.wavefront_bwd(*dba, dfwd_k, **ddims)
    (dposts_p, dtot_p), ms["dna5_bwd_plain"] = timed(
        lambda: fk.backward_plain(*dba, dfwd_k, **ddims))
    for what, got, want in (("K1 dna5 fwd plane", dfwd_k, dfwd_p),
                            ("K2 dna5 posteriors", dposts_k, dposts_p),
                            ("K2 dna5 totals", dtot_k, dtot_p)):
        same(what, got, want)
    del dfwd_p
    dnds = [b.n_diag for b in dprep["bands"]]
    drels = list(range(len(dnds)))
    dparts = [extract_pairs_chunk(
        dict(prep=dprep, posteriors=p, compact=compact_posteriors(
            p, min(DNA_COMPACT_K, ddims["ND"] * ddims["W"]))), drels, dnds,
        thr) for p in (dposts_k, dposts_p)]
    for i, (a, b) in enumerate(zip(*dparts)):
        if not np.array_equal(a, b) or len(a) < dreads[i][2]:
            raise AssertionError(f"dna5 pairs of pair {i}: kernel and plain "
                                 "planes give different pairs")
    ms.update(
        dna5_fwd=cuda_ms(lambda: fk.wavefront_fwd(*dfa, **ddims), 5),
        dna5_bwd=cuda_ms(lambda: fk.wavefront_bwd(*dba, dfwd_k, **ddims),
                         5))
    dcells = sum(int(b.width.sum()) for b in dprep["bands"])
    bounds.update(
        dna5_fwd=bound(dfa + [dfwd_k], dcells, FLOPS_PER_CELL["dna5_fwd"]),
        dna5_bwd=bound(dba + posterior_fwd(dfwd_k, dba[6], ddims["R"])
                       + [dposts_k, dtot_k], dcells,
                       FLOPS_PER_CELL["dna5_bwd"]))
    # the tiled pair on the same pairs, 128 diagonals per tile (phase 16
    # holds K6a/K6b dna5 to their plain versions at the long path's
    # geometry)
    dtprep = da.prepare(dsm, dreads[:DNA_GROUP], ragged_right=True,
                        tile_diag=TILE_CHECK)
    dtinp = da.device_inputs(dsm, dtprep, ragged_left=True)
    dtl = dtprep["tiled"]
    dtdims = dict(R=dtprep["R"], W=dtprep["W"], ND=dtl["NDT"],
                  C=dtprep["C"], TD=dtl["TD"], spec=fk.Dna5Spec)
    dta = [dtinp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    dtb = dta + [dtinp["seedf"], dtinp["raggedf"]]
    dtfwd_k, dtsh_k = fk.wavefront_fwd_tiled(*dta, **dtdims)
    dtposts_k, dttot_k = fk.wavefront_bwd_tiled(*dtb, dtfwd_k, dtsh_k,
                                                **dtdims)
    if not bool((dtsh_k[..., 1:] != 0).all()):
        raise AssertionError("a dna5 tile boundary did not re-center")
    # the tiled planes against the untiled ones, logged and not held: at
    # ~4,000 diagonals the untiled f32 posteriors drift from the f64 engine
    # by up to 6e-2 (pair 18 of this batch; the JAX package's untiled
    # kernels give the same plane to 1e-8), the re-centered tiled ones stay
    # within 1e-3 of it, so the two runs differ by the untiled drift
    dtraw = float((dtposts_k[:, :ddims["ND"] + 1] - dposts_k).abs().max())
    dtclip = float((dtposts_k[:, :ddims["ND"] + 1].clamp(max=1.0)
                    - dposts_k.clamp(max=1.0)).abs().max())
    dttot_err = float((dttot_k - dtot_k).abs().max())
    del dtfwd_k
    gold = Dna5Aligner(AlignmentParams(threshold=0.2), device=dev,
                       group=1).run(dsm, [("AGCG", "AGTTCG", 4, 6, [])])
    gpairs = {(x, y) for _, x, y in extract_pairs_auto(
        gold, 0, gold["prep"]["bands"][0].n_diag, 0.2)}
    if gpairs != GOLDEN:
        raise AssertionError(f"golden AGCG x AGTTCG pairs {gpairs}")
    log(f"dna5 kernels vs plain ({DNA_GROUP} realign pairs, ragged, "
        f"ND={ddims['ND']}, W={ddims['W']}): K1/K2 fwd plane, posts, "
        f"totals equal bit for bit, {sum(map(len, dparts[0]))} pairs equal; "
        f"ms fwd {ms['dna5_fwd']:.3f} vs plain {ms['dna5_fwd_plain']:.1f}, "
        f"bwd {ms['dna5_bwd']:.3f} vs plain {ms['dna5_bwd_plain']:.1f} "
        f"({ms['dna5_fwd'] * 1e6 / ddims['ND']:.1f} / "
        f"{ms['dna5_bwd'] * 1e6 / ddims['ND']:.1f} ns a diagonal; bounds "
        f"{bounds['dna5_fwd'][0]:.4f} / {bounds['dna5_bwd'][0]:.4f} ms); "
        f"tiled (TD={dtl['TD']}, NT={dtl['NT']}) against the untiled run "
        f"(the untiled drift): posts max|d| {dtclip:.3g} clipped at 1, "
        f"{dtraw:.3g} raw (largest posterior untiled "
        f"{float(dposts_k.max()):.4g}, tiled {float(dtposts_k.max()):.4g}), "
        f"totals max|d| {dttot_err:.3g}; golden AGCG x AGTTCG {gpairs}")
    torch.cuda.synchronize()

    # -- 14. the realign CLI on the card vs the JAX CLI's stored output ---
    clock.start(14)
    def cli(fasta_text, cigars, stage=None):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "realign.fa")
            with open(path, "w") as fh:
                fh.write(fasta_text)
            out = io.StringIO()
            realign.main([path, "--device", DEVICE],
                         stdin=io.StringIO("\n".join(cigars) + "\n"),
                         stdout=out, stage=stage)
        torch.cuda.synchronize()
        return out.getvalue().splitlines()

    rfasta, rcigars, lpair, dstored = load_dna5_realign()
    fk.reset_counts()
    rst = Stages()
    rgot = cli(rfasta, rcigars, stage=rst)
    cli_counts = dict(fk.KERNEL_LAUNCHES)
    rwant = [str(c) for c in dstored["cigars_out"]]
    n_same = sum(a == b for a, b in zip(rgot, rwant))
    if len(rgot) != len(rwant) or n_same < len(rwant) - 1:
        raise AssertionError(f"realign CLI: {n_same} of {len(rwant)} cigars "
                             "equal the JAX CLI's")
    if (cli_counts.get("wavefront_fwd_dna5", 0) < 1
            or cli_counts.get("wavefront_bwd_dna5", 0) < 1
            or fk.forward_plain.calls or fk.backward_plain.calls):
        raise AssertionError(f"realign CLI launches {cli_counts}")
    rprep = rst.out["prepare"]
    log(f"realign CLI on the card ({len(rcigars)} stored pairs, "
        f"{len(rst.out['jobs'][0])} jobs, ND={rprep['ND']}, W={rprep['W']}): "
        f"{n_same} of {len(rwant)} cigars equal the JAX CLI's --engine "
        f"pallas output; launches {cli_counts}")
    del rst, rprep

    # -- 15. realign at bench scale ----------------------------------------
    clock.start(15)
    hint = (max(r[2] for r in dreads), da.prepare(dsm, dreads)["ND"])

    def realign_bench():
        outs = [da.run(dsm, dreads[i:i + DNA_GROUP], ragged_left=True,
                       ragged_right=True, compact_k=DNA_COMPACT_K,
                       shape_hint=hint)
                for i in range(0, len(dreads), DNA_GROUP)]
        torch.cuda.synchronize()
        return outs

    fk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    dheld = torch.cuda.memory_allocated()
    douts = realign_bench()
    dtimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        realign_bench()
        dtimes.append(time.perf_counter() - t0)
    dna_counts = dict(fk.KERNEL_LAUNCHES)
    dpeak = torch.cuda.max_memory_allocated()
    if (dna_counts.get("wavefront_fwd_dna5", 0) <= 0
            or dna_counts.get("wavefront_bwd_dna5", 0) <= 0
            or fk.forward_plain.calls or fk.backward_plain.calls):
        raise AssertionError(f"realign path launches {dna_counts}")
    for o in douts:
        if not torch.isfinite(o["totals"]).all():
            raise AssertionError("realign totals not finite")
    drate = len(dreads) / statistics.median(dtimes)
    log(f"dna_realign_alignments_per_sec {drate:.1f} ({len(dreads)} x "
        f"{dreads[0][2]} bases, chunks of {DNA_GROUP}, group {DNA_GROUP}, "
        f"ND={douts[0]['prep']['ND']}, W={douts[0]['prep']['W']}; median of "
        f"{[round(t, 4) for t in dtimes]} s); peak device memory "
        f"{dpeak / 1e9:.3f} GB ({dheld / 1e9:.3f} GB held before), launches "
        f"{dna_counts}")
    del douts
    # the CLI end to end on the same 64 pairs, then its stages
    bfasta, bcigars = realign_inputs(dreads)
    bout = cli(bfasta, bcigars)
    ctimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        cli(bfasta, bcigars)
        ctimes.append(time.perf_counter() - t0)
    if len(bout) != len(dreads):
        raise AssertionError("the realign CLI lost a cigar")
    cst = Stages()
    cli(bfasta, bcigars, stage=cst)
    crate = len(dreads) / statistics.median(ctimes)
    log(f"realign CLI end to end: {crate:.1f} alignments/s "
        f"({len(dreads)} cigars, {len(cst.out['jobs'][0])} jobs; median of "
        f"{[round(t, 4) for t in ctimes]} s); stages (s, share): "
        + cst.line())
    del cst
    torch.cuda.synchronize()

    # -- 16. long DNA --------------------------------------------------------
    clock.start(16)
    l5 = Dna5Aligner(AlignmentParams(), device=dev, group=LONG_GROUP)
    fk.reset_counts()
    l10 = l5.run(dsm, [lpair])
    torch.cuda.synchronize()
    l10_counts = dict(fk.KERNEL_LAUNCHES)
    if l10_counts != {"wavefront_fwd_tiled_dna5": 1,
                      "wavefront_bwd_tiled_dna5": 1}:
        raise AssertionError(f"the 10 kb pair did not route tiled: "
                             f"{l10_counts}")
    l10nd = l10["prep"]["bands"][0].n_diag
    l10pairs = extract_pairs_auto(l10, 0, l10nd, thr, as_array=True)
    d_vs_jax = check_long_pairs(l10pairs, dstored["tiled_pairs"], thr)
    d_vs_eng = check_long_pairs(l10pairs, dstored["engine_pairs"], thr,
                                score_atol=LONG_DNA_ENGINE_SCORE_ATOL)
    log(f"10 kb DNA pair (l_x {lpair[2]}, l_y {lpair[3]}, ND={l10nd}, "
        f"{l10['tiled']}, W={l10['prep']['W']}): routed tiled {l10_counts}; "
        f"{len(l10pairs)} pairs; vs the JAX tiled path "
        f"({len(dstored['tiled_pairs'])}): {d_vs_jax[0]} in one set only "
        f"(max {d_vs_jax[1]:.3g} from the threshold), common max|d| "
        f"{d_vs_jax[2]:.3g}; vs the f64 engine "
        f"({len(dstored['engine_pairs'])}): {d_vs_eng[0]} in one set only "
        f"(max {d_vs_eng[1]:.3g}), common max|d| {d_vs_eng[2]:.3g}")
    del l10
    big = synth_dna_pair(np.random.default_rng(7), DNA_LONG)

    def long_dna():
        out = l5.run(dsm, [big], compact_k=DNA_LONG_COMPACT_K,
                     tile_diag=DNA_LONG_TILE)
        pairs = extract_pairs_long(out, 0, out["prep"]["bands"][0].n_diag,
                                   thr, as_array=True)
        torch.cuda.synchronize()
        return pairs, out

    fk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    bheld = torch.cuda.memory_allocated()
    bpairs, bout_ = long_dna()
    btimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        long_dna()
        btimes.append(time.perf_counter() - t0)
    big_counts = dict(fk.KERNEL_LAUNCHES)
    bpeak = torch.cuda.max_memory_allocated()
    if (big_counts.get("wavefront_fwd_tiled_dna5", 0) <= 0
            or big_counts.get("wavefront_bwd_tiled_dna5", 0) <= 0
            or fk.forward_tiled_plain.calls or fk.backward_tiled_plain.calls):
        raise AssertionError(f"long DNA launches {big_counts}")
    n_x = len(np.unique(bpairs[:, 1]))
    if n_x < 0.98 * big[2] or not torch.isfinite(bout_["totals"]).all():
        raise AssertionError(f"long DNA pair covers {n_x} of {big[2]} x")
    btl = bout_["tiled"]
    brate = (big[2] + big[3]) / statistics.median(btimes)
    log(f"long_read_bases_per_sec {brate:.6g} (one {big[2]} x {big[3]} "
        f"DNA pair, group {LONG_GROUP}, "
        f"compact_k {DNA_LONG_COMPACT_K}, {btl}, W={bout_['prep']['W']}; "
        f"median of {[round(t, 4) for t in btimes]} s); {len(bpairs)} pairs "
        f"covering {n_x} of {big[2]} x; peak device memory "
        f"{bpeak / 1e9:.3f} GB ({bheld / 1e9:.3f} GB held before), launches "
        f"{big_counts}")
    del bout_
    torch.cuda.synchronize()
    bst = Stages()
    bout_ = l5.run(dsm, [big], compact_k=DNA_LONG_COMPACT_K,
                   tile_diag=DNA_LONG_TILE, stage=bst)
    bst("extract", lambda: extract_pairs_long(
        bout_, 0, bout_["prep"]["bands"][0].n_diag, thr, as_array=True))
    log("long DNA stages (s, share): " + bst.line())
    del bout_

    bfa, bba, bd, bprep = tiled_args(bst, fk.Dna5Spec)
    (bfwd, bsh), (bposts, btot) = bst.out["fwd_tiled"], bst.out["bwd_tiled"]
    del bst
    ms.update(
        dna5_fwd_long=cuda_ms(lambda: fk.wavefront_fwd_tiled(*bfa, **bd), 3),
        dna5_bwd_long=cuda_ms(lambda: fk.wavefront_bwd_tiled(
            *bba, bfwd, bsh, **bd), 3))
    bcells = sum(int(b.width.sum()) for b in bprep["bands"])
    bounds.update(
        dna5_fwd_long_padded=bound(bfa + [bfwd, bsh], bcells,
                                   FLOPS_PER_CELL["dna5_fwd"]),
        dna5_bwd_long_padded=bound(bba + posterior_fwd(bfwd, bba[6],
                                                       bd["R"])
                                   + [bsh, bposts, btot], bcells,
                                   FLOPS_PER_CELL["dna5_bwd"]))
    bgeom = (len(bprep["win"]), bd["R"], bd["W"], bd["TD"])
    # the bound of the real work: the pair's row of its group (G 1; the
    # other R - 1 rows are padding) of the per-row inputs (axis 0), the
    # planes (R axis -2), the shifts and the totals (axis 1)
    nr = len(bprep["bands"])
    if bgeom[0] != 1:
        raise AssertionError(f"the 100 kb pair runs in {bgeom[0]} groups")
    rfa = bfa[:2] + [t[:nr] for t in bfa[2:]]
    rba = rfa + [t[:nr] for t in bba[len(bfa):]]
    rfwd, rsh = bfwd[..., :nr, :], bsh[:, :nr]
    bounds.update(
        dna5_fwd_long=bound(rfa + [rfwd, rsh], bcells,
                            FLOPS_PER_CELL["dna5_fwd"]),
        dna5_bwd_long=bound(rba + posterior_fwd(rfwd, rba[6], bd["R"])
                            + [rsh, bposts[..., :nr, :], btot[:, :nr]],
                            bcells, FLOPS_PER_CELL["dna5_bwd"]))
    log(f"long DNA kernels (G={bgeom[0]}, R={bd['R']}, NDT={bd['ND']}, "
        f"W={bd['W']}, {bcells} band cells): K6a dna5 "
        f"{ms['dna5_fwd_long']:.3f} ms, K6b dna5 {ms['dna5_bwd_long']:.3f} "
        f"ms per launch ({ms['dna5_fwd_long'] * 1e6 / bd['ND']:.1f} / "
        f"{ms['dna5_bwd_long'] * 1e6 / bd['ND']:.1f} ns a diagonal); "
        f"bounds {bounds['dna5_fwd_long'][0]:.4f} ms "
        f"({bounds['dna5_fwd_long'][1]}) / {bounds['dna5_bwd_long'][0]:.4f}"
        f" ms ({bounds['dna5_bwd_long'][1]}) for the pair's {nr} row, "
        f"{bounds['dna5_fwd_long_padded'][0]:.4f} / "
        f"{bounds['dna5_bwd_long_padded'][0]:.4f} ms counting all "
        f"{bd['R']} rows' planes")
    # the dna5 tiled kernels' registers and spill
    for name in ("sm3_fwd_tiled_sel<Dna5, 1>", "sm3_bwd_tiled_sel<Dna5, 0, 1>"):
        if name not in ptxas:
            raise AssertionError(f"no ptxas report for {name}")
        for line in ptxas[name]:
            log(f"  ptxas: {name}: {line}")
    del bfwd, bposts, bfa, bba, rfa, rba, rfwd, rsh
    torch.cuda.synchronize()

    # K6a/K6b dna5 against their plain versions at the main path's geometry
    # (its G, R, W and TD) on a shorter pair of the same generator: two
    # tiles, where a plain pass over the 100 kb pair's 200k diagonals would
    # take most of an hour.  The kernels line takes these kernels' ms,
    # plain ms, bound and error from this check, all on its inputs
    pair = synth_dna_pair(np.random.default_rng(7), DNA_CHECK)
    kst = Stages()
    kout = l5.run(dsm, [pair], compact_k=DNA_LONG_COMPACT_K,
                  tile_diag=DNA_LONG_TILE, stage=kst)
    kfa, kba, kd, kprep = tiled_args(kst, fk.Dna5Spec)
    (kfwd, ksh), (kposts, ktot) = kst.out["fwd_tiled"], kst.out["bwd_tiled"]
    del kst
    if (len(kprep["win"]), kd["R"], kd["W"], kd["TD"]) != bgeom:
        raise AssertionError(f"the check pair's geometry differs from the "
                             f"100 kb pair's {bgeom}")
    (pfwd, psh), ms["dna5_fwd_tiled_plain"] = timed(
        lambda: fk.forward_tiled_plain(*kfa, **kd))
    (pposts, ptot), ms["dna5_bwd_tiled_plain"] = timed(
        lambda: fk.backward_tiled_plain(*kba, kfwd, ksh, **kd))
    derr = max(same(what, got, want) for what, got, want in (
        ("K6a dna5 fwd plane (2 tiles of 2048)", kfwd, pfwd),
        ("K6a dna5 shifts (2 tiles of 2048)", ksh, psh),
        ("K6b dna5 posteriors (2 tiles of 2048)", kposts, pposts),
        ("K6b dna5 totals (2 tiles of 2048)", ktot, ptot)))
    knd = kprep["bands"][0].n_diag
    kpairs = [extract_pairs_long(dict(kout, posteriors=p, compact_chunks=(
        compact_chunks(p, kout["tiled"]["DC"], min(
            DNA_LONG_COMPACT_K, kout["tiled"]["DC"] * kd["W"])))), 0, knd,
        thr, as_array=True) for p in (kposts, pposts)]
    if not np.array_equal(*kpairs) or len(kpairs[0]) < pair[2]:
        raise AssertionError("the check pair: kernel and plain planes give "
                             "different pairs")
    ms.update(
        dna5_fwd_tiled=cuda_ms(lambda: fk.wavefront_fwd_tiled(*kfa, **kd),
                               3),
        dna5_bwd_tiled=cuda_ms(lambda: fk.wavefront_bwd_tiled(
            *kba, kfwd, ksh, **kd), 3))
    kcells = sum(int(b.width.sum()) for b in kprep["bands"])
    bounds.update(
        dna5_fwd_tiled=bound(kfa + [kfwd, ksh], kcells,
                             FLOPS_PER_CELL["dna5_fwd"]),
        dna5_bwd_tiled=bound(kba + posterior_fwd(kfwd, kba[6], kd["R"])
                             + [ksh, kposts, ktot], kcells,
                             FLOPS_PER_CELL["dna5_bwd"]))
    log(f"long DNA kernels vs plain (a {pair[2]} x {pair[3]} pair, "
        f"{kout['tiled']}, G={bgeom[0]}, R={kd['R']}, W={kd['W']}): fwd "
        f"plane, shifts, posts, totals equal bit for bit, "
        f"{len(kpairs[0])} pairs equal; K6a dna5 "
        f"{ms['dna5_fwd_tiled']:.3f} ms vs plain "
        f"{ms['dna5_fwd_tiled_plain']:.1f}, K6b dna5 "
        f"{ms['dna5_bwd_tiled']:.3f} ms vs plain "
        f"{ms['dna5_bwd_tiled_plain']:.1f}; bounds "
        f"{bounds['dna5_fwd_tiled'][0]:.4f} / "
        f"{bounds['dna5_bwd_tiled'][0]:.4f} ms")
    del kout, kfwd, pfwd, kposts, pposts
    torch.cuda.synchronize()

    # -- 17. K3 dna5 vs plain on the first 32 cPecanEm E-step pairs --------
    clock.start(17)
    # bench.py's E-step inputs (ragged at both ends), cut to their first
    # group of 32, with the equalised fiveState start that bench.py's
    # E-step runs (the gpu tests hold the default machine too)
    eseqs, ealns, erng = dna_em_batch()
    eopts = em.EmOptions(train_emissions=True)
    eparams = eopts.realign_params
    ehmm = em.PipelineHmm("fiveState")
    ehmm.equalise()
    esm = ehmm.to_state_machine()
    ea = Dna5Aligner(eparams, device=dev, group=EM_DNA_GROUP)
    ejobs = em._alignment_jobs(ealns[:EM_DNA_GROUP], eseqs, eparams)
    xprep = ea.prepare(esm, ejobs, ragged_right=True)
    xinp = ea.device_inputs(esm, xprep, ragged_left=True)
    xdims = dict(R=xprep["R"], W=xprep["W"], ND=xprep["ND"],
                 C=xprep["C"], spec=fk.Dna5Spec)
    xfa = [xinp[k] for k in ("scal", "win", "xf", "yf", "basef",
                             "widthf")]
    xba = xfa + [xinp["seedf"], xinp["raggedf"]]
    xfwd = fk.wavefront_fwd(*xfa, **xdims)
    xk = fk.wavefront_bwd_exp(*xba, xfwd, **xdims)
    xp, xp_ms = timed(lambda: fk.backward_exp_plain(*xba, xfwd, **xdims))
    d5exp_err = check_exp_kernel(xk, xp)
    lanes = list(fk.Dna5Spec.EXP_LANES.values())
    if not (bool(torch.all(xk[2][..., lanes] > 0))
            and int((xk[2] != 0).sum(-1).max()) == len(lanes)):
        raise AssertionError("equalised machine: dna5 transition lanes "
                             f"{xk[2][0, 0].tolist()}")
    kfin, pfin = (ea.exp_finalize(xprep, host_array(ea.exp_dispatch(
        xprep, xinp, o[2], o[3], o[1]))) for o in (xk, xp))
    for k in ("trans", "likelihood"):
        if not np.array_equal(kfin[k], pfin[k]):
            raise AssertionError(f"equalised machine: finalized {k} differ")
    if not np.abs(kfin["emis"] - pfin["emis"]).max() <= KERNEL_GAPX_ATOL:
        raise AssertionError("equalised machine: finalized emis differ")
    # the line's ms, plain ms and bound
    ms.update(dna5_bwd_exp=cuda_ms(lambda: fk.wavefront_bwd_exp(
        *xba, xfwd, **xdims), 5), dna5_bwd_exp_plain=xp_ms)
    xcells = sum(int(b.width.sum()) for b in xprep["bands"])
    bounds["dna5_bwd_exp"] = bound(xba + [xfwd, *xk], xcells,
                                   FLOPS_PER_CELL["dna5_bwd_exp"])
    log(f"dna5 expectation kernel vs plain, equalised machine "
        f"({len(ejobs)} E-step pairs, ragged, ND={xdims['ND']}, "
        f"W={xdims['W']}): posts, totals, 25 trans lanes equal bit "
        f"for bit, accumulators max|d| {d5exp_err:.3g}; finalized trans and "
        f"likelihoods equal, emis within {KERNEL_GAPX_ATOL}; plain "
        f"{xp_ms:.1f} ms")
    log(f"dna5 expectation kernel ms ({len(ejobs)} pairs, equalised "
        f"machine): bwd_exp_dna5 {ms['dna5_bwd_exp']:.3f} vs plain "
        f"{ms['dna5_bwd_exp_plain']:.1f}; bound "
        f"{bounds['dna5_bwd_exp'][0]:.4f} ms ({bounds['dna5_bwd_exp'][1]})")
    del xk, xp, xfwd, xinp
    torch.cuda.synchronize()

    # -- 18. cPecanEm at full width ----------------------------------------
    clock.start(18)
    # bench.py bench_dna_em: 128 x 1 kb alignments, the equalised fiveState
    # start, shards drawn with the generator that made them, group 32,
    # chunks of 64; median of 3 after a warm-up
    eshards = em._shard_alignments(ealns, eopts, erng)

    def estep_dna(stage=None):
        out = em.calculate_expectations_pallas(eshards, eseqs, esm, eparams,
                                               ea, stage=stage)
        torch.cuda.synchronize()
        return out

    estep_dna()
    etimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        estep_dna()
        etimes.append(time.perf_counter() - t0)
    erate = len(ealns) / statistics.median(etimes)
    log(f"dna_em_estep_alignments_per_sec {erate:.1f} ({len(ealns)} x "
        f"{len(eseqs['x0'])} bases, {len(eshards)} shard, chunks of "
        f"{em.CHUNK}, group {EM_DNA_GROUP}; median of "
        f"{[round(t, 4) for t in etimes]} s)")
    est = Stages()
    estep_dna(stage=est)
    log("dna5 E-step stages (s, share): " + est.line())
    cprep, cinp = est.out["prepare"], est.out["inputs"]
    del est
    # one 64-pair chunk's kernels, the main path's launch shape (its last
    # chunk's inputs)
    cdims = dict(R=cprep["R"], W=cprep["W"], ND=cprep["ND"], C=cprep["C"],
                 spec=fk.Dna5Spec)
    cfa = [cinp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    cba = cfa + [cinp["seedf"], cinp["raggedf"]]
    cfwd = fk.wavefront_fwd(*cfa, **cdims)
    cexp = fk.wavefront_bwd_exp(*cba, cfwd, **cdims)
    ms["dna5_bwd_exp_main"] = cuda_ms(lambda: fk.wavefront_bwd_exp(
        *cba, cfwd, **cdims), 3)
    cfwd_ms = cuda_ms(lambda: fk.wavefront_fwd(*cfa, **cdims), 3)
    # every row of the chunk's groups is a pair (64 = 2 x 32), so the
    # bound of its real rows is that of all rows
    if cprep["B"] != len(cprep["win"]) * cdims["R"]:
        raise AssertionError("the E-step chunk's groups hold padding rows")
    bounds["dna5_bwd_exp_main"] = bounds["dna5_bwd_exp_main_padded"] = bound(
        cba + [cfwd, *cexp], sum(int(b.width.sum()) for b in cprep["bands"]),
        FLOPS_PER_CELL["dna5_bwd_exp"])
    log(f"dna5 E-step chunk kernels ({cprep['B']} pairs, "
        f"G={len(cprep['win'])}, ND={cdims['ND']}, W={cdims['W']}): K1 dna5 "
        f"{cfwd_ms:.3f} ms, K3 dna5 {ms['dna5_bwd_exp_main']:.3f} ms per "
        f"launch ({ms['dna5_bwd_exp_main'] * 1e6 / cdims['ND']:.1f} ns a "
        f"diagonal; bound {bounds['dna5_bwd_exp_main'][0]:.4f} ms, "
        f"{bounds['dna5_bwd_exp_main'][1]})")
    del cfwd, cexp, cinp, cfa, cba
    # a real cPecanEm run: one default-size shard (1 Mbp: 1,000 x 1 kb
    # alignments of the same generator), three iterations
    bseqs, balns, brng = dna_em_batch(EM_DNA_SHARD)
    bopts = em.EmOptions(iterations=EM_ITERATIONS, train_emissions=True)
    starts = []

    def mark(name, fn):
        # each iteration's E-step starts with its jobs
        if name == "jobs":
            starts.append(time.perf_counter())
        return fn()

    fk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    em_dna_held = torch.cuda.memory_allocated()
    bhmm = em.expectation_maximisation(bseqs, balns, bopts, brng, aligner=ea,
                                       stage=mark)
    torch.cuda.synchronize()
    starts.append(time.perf_counter())
    em_dna_counts = dict(fk.KERNEL_LAUNCHES)
    em_dna_peak = torch.cuda.max_memory_allocated()
    if (em_dna_counts.get("wavefront_fwd_dna5", 0) <= 0
            or em_dna_counts.get("wavefront_bwd_exp_dna5", 0) <= 0
            or fk.forward_plain.calls or fk.backward_exp_plain.calls):
        raise AssertionError(f"cPecanEm launches {em_dna_counts}")
    bliks = bhmm.running_likelihoods
    if len(bliks) != EM_ITERATIONS or not all(
            b > a for a, b in zip(bliks, bliks[1:])):
        raise AssertionError(f"cPecanEm likelihoods do not rise: {bliks}")
    if not (np.isfinite(bhmm.transitions).all()
            and np.isfinite(bhmm.emissions).all()):
        raise AssertionError("cPecanEm model not finite")
    biter = [b - a for a, b in zip(starts, starts[1:])]
    log(f"cPecanEm at full width: {len(balns)} x {len(bseqs['x0'])} bases "
        f"(one shard), {EM_ITERATIONS} iterations, likelihoods {bliks}, s "
        f"per iteration {[round(t, 4) for t in biter]}, peak device memory "
        f"{em_dna_peak / 1e9:.3f} GB ({em_dna_held / 1e9:.3f} GB held "
        f"before), launches {em_dna_counts}")
    # the fixture case against the JAX package's stored result
    fseqs, falns, fstored = load_dna5_em()
    fit = int(fstored["iterations"])
    femax = 0.0
    for mt in (str(m) for m in fstored["model_types"]):
        fh = em.expectation_maximisation(
            fseqs, falns, em.EmOptions(model_type=mt, iterations=fit,
                                       train_emissions=True),
            random.Random(int(fstored["rng_seed"])), device=dev)
        femax = max(femax, check_em(
            fh.transitions, fh.emissions, fh.running_likelihoods,
            fstored[f"{mt}_transitions"], fstored[f"{mt}_emissions"],
            fstored[f"{mt}_running"]))
    # cpecan-torch-em end to end: the fixture case (its model against the
    # stored one) and bench.py's 128 alignments (timed)
    with tempfile.TemporaryDirectory() as tmp:
        def em_cli(seqs, alns, name, iterations):
            fa = os.path.join(tmp, f"{name}.fa")
            cig = os.path.join(tmp, f"{name}.cigar")
            with open(fa, "w") as fh:
                fh.write("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
            with open(cig, "w") as fh:
                fh.write("\n".join(cigar_write(a) for a in alns) + "\n")
            model = os.path.join(tmp, f"{name}.hmm")
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                rc = em_main(["--sequences", fa, "--alignments", cig,
                              "--outputModel", model, "--iterations",
                              str(iterations), "--trainEmissions",
                              "--outputLastzScoringMatrix", model + ".lz",
                              "--device", DEVICE])
            torch.cuda.synchronize()
            if rc != 0:
                raise AssertionError(f"cpecan-torch-em exited {rc}")
            with open(model + ".lz") as fh:
                lz = fh.read()
            return em.PipelineHmm.load(model), lz, time.perf_counter() - t0

        ch, clz, _ = em_cli(fseqs, falns, "fixture", fit)
        check_em(ch.transitions, ch.emissions, [ch.likelihood],
                 fstored["fiveState_transitions"],
                 fstored["fiveState_emissions"],
                 fstored["fiveState_running"][-1:])
        bh, blz, bcli_s = em_cli(eseqs, ealns, "bench", EM_ITERATIONS)
    if not (np.isfinite(bh.transitions).all() and len(clz.splitlines()) == 7
            and len(blz.splitlines()) == 7):
        raise AssertionError("cpecan-torch-em wrote a bad model or matrix")
    log(f"cPecanEm fixture case ({len(falns)} alignments, {fit} iterations, "
        f"fiveState and fiveStateAsymmetric) vs the JAX package's stored "
        f"engine=pallas result: model max|d| {femax:.3g}; cpecan-torch-em on "
        f"the card: the fixture case's model within parity.EM_* of the "
        f"stored one; {len(ealns)} alignments x {EM_ITERATIONS} iterations "
        f"end to end in {bcli_s:.3f} s, final likelihood {bh.likelihood}")
    torch.cuda.synchronize()

    # -- 19. the vanilla kernels vs plain on bench.py's vanilla cell --------
    clock.start(19)
    # K1 vanilla (the untiled select forward, sm3_fwd_tiled_sel<Vanilla,
    # 0>), K2 vanilla (the untiled select posterior form,
    # sm3_bwd_tiled_sel<Vanilla, 0, 0>) and K3 vanilla
    # (sm3_bwd_kernel<Vanilla, 1>), bit for bit
    # bench.py's vanilla cell: the bench batch on the vendored template
    # model.  K1/K2 on the default machine with flush ends (the main
    # path's), K3 on the skip bins of the stored JAX vanilla training with
    # ragged ends and per-read scaling (the E-step's configuration); phase
    # 23 holds K1/K2 vanilla to plain on ragged, scaled reads too
    tmodel = load_pore_model(fixture_path("template_median68pA.model"))
    vjob, vsp, vstored = load_vanilla_zymo()
    vmachines = {
        "default": StateMachine3Vanilla(tmodel),
        "trained": StateMachine3Vanilla(tmodel,
                                        skip_bin_probs=vstored["t_skip"])}

    def vanilla_inputs(machine, rs, group, ragged, sp):
        """(aligner, prep, inputs, fwd args, bwd args, dims)."""
        a = VanillaAligner(AlignmentParams(), device=dev, group=group)
        prep = a.prepare(machine, rs, ragged_right=ragged,
                         scale_params=None if sp is None else sp[:len(rs)])
        inp = a.device_inputs(machine, prep, ragged_left=ragged)
        vd = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"],
                  spec=fk.VanillaSpec)
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        return a, prep, inp, fa, fa + [inp["seedf"], inp["raggedf"]], vd

    _, kprep, _, kfa, kba, kd = vanilla_inputs(
        vmachines["default"], reads[:CHUNK], GROUP, False, None)
    vfwd = fk.wavefront_fwd(*kfa, **kd)
    vfwd_p, vfwd_ms = timed(lambda: fk.forward_plain(*kfa, **kd))
    vposts, vtot = fk.wavefront_bwd(*kba, vfwd, **kd)
    (vposts_p, vtot_p), vbwd_ms = timed(
        lambda: fk.backward_plain(*kba, vfwd, **kd))
    for what, got, want in (("K1 vanilla fwd plane", vfwd, vfwd_p),
                            ("K2 vanilla posteriors", vposts, vposts_p),
                            ("K2 vanilla totals", vtot, vtot_p)):
        same(f"{what} (default machine)", got, want)
    vnds = [b.n_diag for b in kprep["bands"]]
    vparts = [extract_pairs_chunk(dict(
        prep=kprep, posteriors=p, compact=compact_posteriors(
            p, min(COMPACT_K, kd["ND"] * kd["W"]))), rels, vnds, thr)
        for p in (vposts, vposts_p)]
    for i, (a, b) in enumerate(zip(*vparts)):
        if not np.array_equal(a, b) or len(a) == 0:
            raise AssertionError(f"vanilla pairs of read {i}: kernel and "
                                 "plain differ")
    del vfwd_p, vposts_p
    # the main path's machine and chunk: the line's ms and bound
    vchunk_parts = vparts[0]
    ms.update(
        vanilla_fwd=cuda_ms(lambda: fk.wavefront_fwd(*kfa, **kd), 5),
        vanilla_fwd_plain=vfwd_ms,
        vanilla_bwd=cuda_ms(lambda: fk.wavefront_bwd(*kba, vfwd, **kd), 5),
        vanilla_bwd_plain=vbwd_ms)
    vcells = sum(int(b.width.sum()) for b in kprep["bands"])
    bounds.update(
        vanilla_fwd=bound(kfa + [vfwd], vcells,
                          FLOPS_PER_CELL["vanilla_fwd"]),
        vanilla_bwd=bound(kba + posterior_fwd(vfwd, kba[6], kd["R"])
                          + [vposts, vtot], vcells,
                          FLOPS_PER_CELL["vanilla_bwd"]))
    del vfwd, vposts
    log(f"vanilla kernels vs plain, default machine ({CHUNK} reads, "
        f"ND={kd['ND']}, W={kd['W']}): K1/K2 (sm3_fwd_tiled_sel<Vanilla, "
        f"0>, sm3_bwd_tiled_sel<Vanilla, 0, 0>) fwd plane, posts, totals "
        f"equal bit for bit, {sum(map(len, vparts[0]))} pairs equal; plain "
        f"ms fwd {vfwd_ms:.1f}, bwd {vbwd_ms:.1f}")
    # K3 vanilla on the first group of 32 (the E-step's group)
    ea_, eprep_, einp_, efa, eba, ed = vanilla_inputs(
        vmachines["trained"], reads[:EM_GROUP], EM_GROUP, True, em_sp)
    efwd = fk.wavefront_fwd(*efa, **ed)
    vk = fk.wavefront_bwd_exp(*eba, efwd, **ed)
    vp, vp_ms = timed(lambda: fk.backward_exp_plain(*eba, efwd, **ed))
    check_exp_kernel(vk, vp)
    same("K3 vanilla beta/alpha accumulators (trained machine)", vk[3],
         vp[3])
    if vk[2].any() or not bool(vk[3].sum() > 0):
        raise AssertionError("trained machine: vanilla K3 lanes or "
                             "accumulators")
    kfin, pfin = (ea_.exp_finalize(eprep_, host_array(ea_.exp_dispatch(
        eprep_, einp_, o[2], o[3], o[1]))) for o in (vk, vp))
    if not all(np.array_equal(kfin[k], pfin[k]) for k in kfin):
        raise AssertionError("trained machine: finalized vanilla "
                             "expectations differ")
    ms.update(vanilla_bwd_exp=cuda_ms(lambda: fk.wavefront_bwd_exp(
        *eba, efwd, **ed), 5), vanilla_bwd_exp_plain=vp_ms)
    ecells = sum(int(b.width.sum()) for b in eprep_["bands"])
    bounds["vanilla_bwd_exp"] = bound(
        eba + [efwd, *vk], ecells, FLOPS_PER_CELL["vanilla_bwd_exp"])
    log(f"vanilla K3 vs plain, trained machine ({EM_GROUP} reads, "
        f"ND={ed['ND']}, W={ed['W']}, ragged, scaled): posts, totals, "
        f"lanes, beta/alpha accumulators equal bit for bit, finalized skip "
        f"bins and likelihoods equal; plain ms bwd_exp {vp_ms:.1f}")
    del vk, vp, efwd
    log(f"vanilla kernel ms: fwd (sm3_fwd_tiled_sel<Vanilla, 0>) "
        f"{ms['vanilla_fwd']:.3f}, bwd "
        f"{ms['vanilla_bwd']:.3f} ({CHUNK} reads, default machine), bwd_exp "
        f"{ms['vanilla_bwd_exp']:.3f} ({EM_GROUP} reads, trained machine); "
        f"bounds {bounds['vanilla_fwd'][0]:.4f} / "
        f"{bounds['vanilla_bwd'][0]:.4f} / "
        f"{bounds['vanilla_bwd_exp'][0]:.4f} ms ({bounds['vanilla_fwd'][1]})")
    torch.cuda.synchronize()

    # -- 20. the vanilla main path at full width ---------------------------
    clock.start(20)
    vsm = vmachines["default"]
    vpa = VanillaAligner(AlignmentParams(), device=dev, group=GROUP)

    def vanilla_path(stage=None):
        outs = [vpa.run(vsm, reads[i:i + CHUNK], compact_k=COMPACT_K,
                        stage=stage)
                for i in range(0, len(reads), CHUNK)]
        torch.cuda.synchronize()
        return outs

    fk.reset_counts()
    vouts = vanilla_path()
    vtimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        vanilla_path()
        vtimes.append(time.perf_counter() - t0)
    van_counts = dict(fk.KERNEL_LAUNCHES)
    if (set(van_counts) != {"wavefront_fwd_vanilla", "wavefront_bwd_vanilla"}
            or min(van_counts.values()) <= 0 or fk.forward_plain.calls
            or fk.backward_plain.calls):
        raise AssertionError(f"vanilla main path launches {van_counts}")
    vall = []
    for o in vouts:
        if not torch.isfinite(o["totals"]).all():
            raise AssertionError("vanilla main path totals not finite")
        vnds = [b.n_diag for b in o["prep"]["bands"]]
        vall += extract_pairs_chunk(o, list(range(len(vnds))), vnds, thr)
    if len(vall) != len(reads) or min(map(len, vall)) == 0:
        raise AssertionError("a read of the vanilla main path has no pairs")
    for i, (a, b) in enumerate(zip(vall, vchunk_parts)):
        if not np.array_equal(a, b):
            raise AssertionError(f"vanilla main path read {i}: pairs differ "
                                 "from phase 19's kernel run")
    vrate = len(reads) / statistics.median(vtimes)
    log(f"vanilla_alignments_per_sec {vrate:.1f} ({len(reads)} reads in "
        f"chunks of {CHUNK}, group {GROUP}, compact_k {COMPACT_K}, "
        f"{sum(map(len, vall))} pairs; median of "
        f"{[round(t, 4) for t in vtimes]} s); launches {van_counts}")
    del vouts
    vst = Stages()
    vanilla_path(stage=vst)
    log("vanilla main path stages (s, share): " + vst.line())
    del vst
    # the vanilla E-step on bench.py's signal-EM shape
    vea = VanillaAligner(AlignmentParams(), device=dev, group=EM_GROUP)
    vsub = reads[:VANILLA_E_READS]

    def vestep():
        return vea.run(vsm, vsub, **em_kw)["expectations"]

    fk.reset_counts()
    vexp = vestep()
    vetimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        vestep()
        vetimes.append(time.perf_counter() - t0)
    vexp_counts = dict(fk.KERNEL_LAUNCHES)
    if (set(vexp_counts) != {"wavefront_fwd_vanilla",
                             "wavefront_bwd_exp_vanilla"}
            or fk.forward_plain.calls or fk.backward_exp_plain.calls):
        raise AssertionError(f"vanilla E-step launches {vexp_counts}")
    if not (vexp["skip_bins"].shape == (len(vsub), 60)
            and np.isfinite(vexp["likelihood"]).all()
            and (vexp["skip_bins"].sum(-1) > 0).all()):
        raise AssertionError("vanilla E-step expectations")
    log(f"vanilla E-step: {len(vsub) / statistics.median(vetimes):.1f} "
        f"reads/s ({len(vsub)} reads, group {EM_GROUP}, ragged, one "
        f"dispatch; median of {[round(t, 4) for t in vetimes]} s); "
        f"launches {vexp_counts}")
    est = Stages()
    vea.run(vsm, vsub, stage=est, **em_kw)
    log("vanilla E-step stages (s, share): " + est.line())
    del est
    # the Zymo read: pairs and two trainModels iterations against the JAX
    # package's stored results, then the CLI once
    zv = VanillaAligner(AlignmentParams(), device=dev, group=1).run(
        vsm, [vjob], scale_params=vsp[None])
    zvgot = {(x, y) for _, x, y in extract_pairs_auto(
        zv, 0, zv["prep"]["bands"][0].n_diag, thr)}
    zshared, zone = check_pair_sets(
        zvgot, {(int(x), int(y)) for _, x, y in vstored["pairs"]})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        vt_hmm, vc_hmm, vtraj = train(
            **zargs, out_template_hmm=os.path.join(tmp, "t.hmm"),
            out_complement_hmm=os.path.join(tmp, "c.hmm"),
            options=TrainOptions(sm_type="vanilla",
                                 iterations=len(vstored["trajectory"])),
            log=lambda m: None, device=dev)
        vtrain_s = time.perf_counter() - t0
        vtrain_err = check_trained(vt_hmm, vc_hmm, vtraj, vstored)
        # cpecan-torch-train-models -smt vanilla, one iteration
        guide = str(zstored["guide"])
        rdir = os.path.join(tmp, "reads")
        os.makedirs(rdir)
        os.symlink(zargs["read_guide_pairs"][0][0],
                   os.path.join(rdir, f"{guide.split()[1]}.npRead"))
        with open(os.path.join(tmp, "guides.cig"), "w") as fh:
            fh.write(guide + "\n")
        cout_ = io.StringIO()
        with contextlib.redirect_stdout(cout_), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = train_models_main([
                "-d", rdir, "-r", zargs["reference_path"], "-o",
                os.path.join(tmp, "out"), "-T", zargs["template_model"],
                "-C", zargs["complement_model"], "--guides",
                os.path.join(tmp, "guides.cig"), "-smt", "vanilla", "-i",
                "1", "--device", DEVICE])
        cli_hmm = VanillaHmm.load(os.path.join(tmp, "out",
                                               "template_trained.hmm"))
    cli_traj = [float(v) for v in cout_.getvalue().split()[-2:]]
    if (rc != 0 or abs(cli_hmm.kmer_skip_bins.sum() - 1.0) > 1e-4
            or not np.allclose(cli_traj, vstored["trajectory"][0],
                               rtol=TOTAL_RTOL, atol=0.0)):
        raise AssertionError(f"cpecan-torch-train-models -smt vanilla: rc "
                             f"{rc}, trajectory {cli_traj}")
    log(f"vanilla Zymo: {zshared} of {len(vstored['pairs'])} pairs shared "
        f"with the JAX package's, {zone} in one set only; training "
        f"({len(vtraj)} iterations, both strands) in {vtrain_s:.2f} s, "
        f"trajectory {[tuple(round(v, 2) for v in t) for t in vtraj]}, "
        f"skip bins max|d| {vtrain_err:.3g} vs the JAX package; "
        f"cpecan-torch-train-models -smt vanilla on the card: rc 0, "
        f"iteration 0 likelihoods {cli_traj}")
    torch.cuda.synchronize()

    # -- 21. K6a/K6b vanilla vs plain at the long path's geometry ----------
    clock.start(21)
    vla = VanillaAligner(AlignmentParams(), device=dev, group=LONG_GROUP)
    vlsm = StateMachine3Vanilla(lmodel)
    vcst = Stages()
    vcout = vla.run(vlsm, [cread], compact_k=LONG_COMPACT_K,
                    tile_diag=lgeom[2], stage=vcst)
    tva, tvb, tvd, tvprep = tiled_args(vcst, fk.VanillaSpec)
    (tvfwd, tvsh), (tvposts, tvtot) = (vcst.out["fwd_tiled"],
                                       vcst.out["bwd_tiled"])
    del vcst
    if (tvd["R"], tvd["W"], tvd["TD"]) != lgeom:
        raise AssertionError(f"the vanilla check read's R, W, TD differ from "
                             f"the long path's {lgeom}")
    (pfwd, psh), ms["vanilla_fwd_tiled_plain"] = timed(
        lambda: fk.forward_tiled_plain(*tva, **tvd))
    (pposts, ptot), ms["vanilla_bwd_tiled_plain"] = timed(
        lambda: fk.backward_tiled_plain(*tvb, tvfwd, tvsh, **tvd))
    for what, got, want in (
            ("K6a vanilla fwd plane (check read)", tvfwd, pfwd),
            ("K6a vanilla shifts (check read)", tvsh, psh),
            ("K6b vanilla posteriors (check read)", tvposts, pposts),
            ("K6b vanilla totals (check read)", tvtot, ptot)):
        same(what, got, want)
    tvnd = tvprep["bands"][0].n_diag
    tvpairs = [extract_pairs_long(dict(vcout, posteriors=p, compact_chunks=(
        compact_chunks(p, vcout["tiled"]["DC"], min(
            LONG_COMPACT_K, vcout["tiled"]["DC"] * tvd["W"])))), 0, tvnd,
        thr, as_array=True) for p in (tvposts, pposts)]
    if not np.array_equal(*tvpairs) or len(tvpairs[0]) == 0:
        raise AssertionError("the vanilla long check read: kernel and plain "
                             "planes give different pairs")
    ms.update(
        vanilla_fwd_tiled=cuda_ms(lambda: fk.wavefront_fwd_tiled(
            *tva, **tvd), 3),
        vanilla_bwd_tiled=cuda_ms(lambda: fk.wavefront_bwd_tiled(
            *tvb, tvfwd, tvsh, **tvd), 3))
    tvcells = sum(int(b.width.sum()) for b in tvprep["bands"])
    bounds.update(
        vanilla_fwd_tiled=bound(tva + [tvfwd, tvsh], tvcells,
                                FLOPS_PER_CELL["vanilla_fwd"]),
        vanilla_bwd_tiled=bound(tvb + posterior_fwd(tvfwd, tvb[6],
                                                    tvd["R"])
                                + [tvsh, tvposts, tvtot], tvcells,
                                FLOPS_PER_CELL["vanilla_bwd"]))
    log(f"vanilla long kernels vs plain (a {cread[2]} x {cread[3]} read, "
        f"{vcout['tiled']}, R={tvd['R']}, W={tvd['W']}): fwd plane, shifts, "
        f"posts, totals equal bit for bit, {len(tvpairs[0])} pairs equal; "
        f"K6a vanilla {ms['vanilla_fwd_tiled']:.3f} ms vs plain "
        f"{ms['vanilla_fwd_tiled_plain']:.1f}, K6b vanilla "
        f"{ms['vanilla_bwd_tiled']:.3f} ms vs plain "
        f"{ms['vanilla_bwd_tiled_plain']:.1f}; bounds "
        f"{bounds['vanilla_fwd_tiled'][0]:.4f} / "
        f"{bounds['vanilla_bwd_tiled'][0]:.4f} ms")
    del vcout, tvfwd, pfwd, tvposts, pposts, tva, tvb
    torch.cuda.synchronize()
    # phase 12's 64 long reads through the vanilla machine once
    fk.reset_counts()
    t0 = time.perf_counter()
    vlong = vla.run(vlsm, lreads, compact_k=LONG_COMPACT_K)
    vlnds = [b.n_diag for b in vlong["prep"]["bands"]]
    vlparts = extract_pairs_chunk(vlong, list(range(len(vlnds))), vlnds, thr)
    torch.cuda.synchronize()
    vlong_s = time.perf_counter() - t0
    vlong_counts = dict(fk.KERNEL_LAUNCHES)
    if (vlong_counts != {"wavefront_fwd_tiled_vanilla": 1,
                         "wavefront_bwd_tiled_vanilla": 1}
            or fk.forward_tiled_plain.calls or fk.backward_tiled_plain.calls):
        raise AssertionError(f"vanilla long path launches {vlong_counts}")
    if (not torch.isfinite(vlong["totals"]).all()
            or len(vlparts) != LONG_READS
            or min(map(len, vlparts)) < lread[2]):
        raise AssertionError("vanilla long path: totals not finite or a "
                             "read with fewer pairs than bases")
    log(f"vanilla long path: {LONG_READS} reads of {lread[2]} bases x "
        f"{lread[3]} events (group {LONG_GROUP}, {vlong['tiled']}), one run "
        f"after the check read, kernels only: {bases / vlong_s:.6g} bases/s "
        f"e2e ({vlong_s:.4f} s), {sum(map(len, vlparts))} pairs, launches "
        f"{vlong_counts}")
    del vlong
    torch.cuda.synchronize()
    # K6a/K6b vanilla on the inputs of a staged run of the same reads
    vst = Stages()
    vla.run(vlsm, lreads, compact_k=LONG_COMPACT_K, stage=vst)
    vline, _ = long_main(vst, fk.VanillaSpec, "vanilla_fwd_tiled_main",
                         "vanilla_bwd_tiled_main", "vanilla_")
    del vst
    log(f"vanilla long path kernels ({LONG_READS} reads, {vline}")
    torch.cuda.synchronize()

    # -- 22. the sm4 kernels vs plain ---------------------------------------
    clock.start(22)
    # K3 sm4 through Sm4Aligner.run(expectations=True) on the first 32
    # reads with ragged ends, per-read scaling and a trained-looking
    # machine (the M-step of a random 4-state table: every transition
    # finite, a non-zero gap-X table); K6a/K6b sm4 on phase 12's 64 long
    # reads once (routed tiled by themselves), then against their plain
    # versions on its check read.  Phase 23 holds K1/K2 sm4 to plain on
    # the fourState pipeline's first chunk (the main path's)
    rng4 = np.random.default_rng(21)
    h4 = ContinuousPairHmm(state_number=4, pseudocount=1e-4)
    h4.add_expectations({"trans": rng4.uniform(0.05, 1.0, (4, 4)),
                         "kmer_gap": rng4.uniform(0.1, 1.0, 4098),
                         "likelihood": -100.0})
    h4.normalize()
    p4, gx4 = h4.to_sm4_params()
    sm4_trained = StateMachine4(sm.model, params=p4, gap_x_log_probs=gx4)
    # K3 sm4: the E-step entry point, its launches counted from 0
    s4ea = Sm4Aligner(AlignmentParams(), device=dev, group=EM_GROUP)
    s4st = Stages()
    fk.reset_counts()
    s4exp = s4ea.run(sm4_trained, reads[:EM_GROUP], expectations=True,
                     ragged_left=True, ragged_right=True,
                     scale_params=em_sp[:EM_GROUP], stage=s4st)
    sm4_exp_counts = dict(fk.KERNEL_LAUNCHES)
    if (sm4_exp_counts != {"wavefront_fwd_sm4": 1,
                           "wavefront_bwd_exp_sm4": 1}
            or fk.forward_plain.calls or fk.backward_exp_plain.calls):
        raise AssertionError(f"sm4 E-step launches {sm4_exp_counts}")
    e4prep, e4inp = s4st.out["prepare"], s4st.out["inputs"]
    e4d = dict(R=e4prep["R"], W=e4prep["W"], ND=e4prep["ND"],
               C=e4prep["C"], spec=fk.Sm4Spec)
    e4fa = [e4inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
    e4ba = e4fa + [e4inp["seedf"], e4inp["raggedf"]]
    e4fwd, e4k = s4st.out["fwd"], s4st.out["bwd_exp"]
    del s4st
    e4p, ms["sm4_bwd_exp_plain"] = timed(
        lambda: fk.backward_exp_plain(*e4ba, e4fwd, **e4d))
    sm4_exp_err = check_exp_kernel(e4k, e4p)
    if (e4k[2][..., [6, 7, 9, 13, 14]].any()
            or not bool((e4k[2][..., [0, 1, 2, 3, 4, 5, 8, 10, 11, 12, 15]]
                         > 0).all())):
        raise AssertionError("sm4 K3 transition lanes")
    p4fin = s4ea.exp_finalize(e4prep, host_array(s4ea.exp_dispatch(
        e4prep, e4inp, e4p[2], e4p[3], e4p[1])))
    k4fin = s4exp["expectations"]
    check_expectations(k4fin, p4fin)
    if k4fin["trans"].shape != (EM_GROUP, 4, 4):
        raise AssertionError(f"sm4 trans {k4fin['trans'].shape}")
    ms["sm4_bwd_exp"] = cuda_ms(lambda: fk.wavefront_bwd_exp(
        *e4ba, e4fwd, **e4d), 5)
    e4cells = sum(int(b.width.sum()) for b in e4prep["bands"])
    bounds["sm4_bwd_exp"] = bound(e4ba + [e4fwd, *e4k], e4cells,
                                  FLOPS_PER_CELL["sm4_bwd_exp"])
    del e4p, e4k, e4fwd
    log(f"sm4 kernels vs plain: K3 "
        f"({EM_GROUP} reads, trained machine, ragged, scaled, one "
        f"Sm4Aligner.run(expectations=True), launches {sm4_exp_counts}): "
        f"posts, totals, 16 lanes equal bit for bit (lanes 6, 7, 9, 13, 14 "
        f"zero), shortGapX columns max|d| {sm4_exp_err:.3g}, finalized "
        f"expectations within parity; ms bwd_exp {ms['sm4_bwd_exp']:.3f} "
        f"vs plain {ms['sm4_bwd_exp_plain']:.1f}; bound "
        f"{bounds['sm4_bwd_exp'][0]:.4f} ms ({bounds['sm4_bwd_exp'][1]})")
    torch.cuda.synchronize()
    # K6a/K6b sm4: phase 12's 64 long reads route tiled by themselves
    s4la = Sm4Aligner(AlignmentParams(), device=dev, group=LONG_GROUP)
    s4lsm = StateMachine4(lmodel)
    fk.reset_counts()
    t0 = time.perf_counter()
    s4long = s4la.run(s4lsm, lreads, compact_k=LONG_COMPACT_K)
    s4lnds = [b.n_diag for b in s4long["prep"]["bands"]]
    s4lparts = extract_pairs_chunk(s4long, list(range(len(s4lnds))), s4lnds,
                                   thr)
    torch.cuda.synchronize()
    s4long_s = time.perf_counter() - t0
    sm4_long_counts = dict(fk.KERNEL_LAUNCHES)
    if (sm4_long_counts != {"wavefront_fwd_tiled_sm4": 1,
                            "wavefront_bwd_tiled_sm4": 1}
            or fk.forward_tiled_plain.calls or fk.backward_tiled_plain.calls):
        raise AssertionError(f"sm4 long path launches {sm4_long_counts}")
    if (not torch.isfinite(s4long["totals"]).all()
            or len(s4lparts) != LONG_READS
            or min(map(len, s4lparts)) < lread[2]):
        raise AssertionError("sm4 long path: totals not finite or a read "
                             "with fewer pairs than bases")
    del s4long
    torch.cuda.synchronize()
    # K6a/K6b sm4 on the inputs of a staged run of the same reads
    s4st = Stages()
    s4la.run(s4lsm, lreads, compact_k=LONG_COMPACT_K, stage=s4st)
    s4line, _ = long_main(s4st, fk.Sm4Spec, "sm4_fwd_tiled_main",
                          "sm4_bwd_tiled_main", "sm4_")
    del s4st
    log(f"sm4 long path kernels ({LONG_READS} reads, {s4line}")
    torch.cuda.synchronize()
    s4cst = Stages()
    s4cout = s4la.run(s4lsm, [cread], compact_k=LONG_COMPACT_K,
                      tile_diag=lgeom[2], stage=s4cst)
    t4a, t4b, t4d, t4prep = tiled_args(s4cst, fk.Sm4Spec)
    (t4fwd, t4sh), (t4posts, t4tot) = (s4cst.out["fwd_tiled"],
                                       s4cst.out["bwd_tiled"])
    del s4cst
    if (t4d["R"], t4d["W"], t4d["TD"]) != lgeom:
        raise AssertionError(f"the sm4 check read's R, W, TD differ from "
                             f"the long path's {lgeom}")
    (pfwd, psh), ms["sm4_fwd_tiled_plain"] = timed(
        lambda: fk.forward_tiled_plain(*t4a, **t4d))
    (pposts, ptot), ms["sm4_bwd_tiled_plain"] = timed(
        lambda: fk.backward_tiled_plain(*t4b, t4fwd, t4sh, **t4d))
    for what, got, want in (
            ("K6a sm4 fwd plane (check read)", t4fwd, pfwd),
            ("K6a sm4 shifts (check read)", t4sh, psh),
            ("K6b sm4 posteriors (check read)", t4posts, pposts),
            ("K6b sm4 totals (check read)", t4tot, ptot)):
        same(what, got, want)
    t4nd = t4prep["bands"][0].n_diag
    t4pairs = [extract_pairs_long(dict(s4cout, posteriors=p, compact_chunks=(
        compact_chunks(p, s4cout["tiled"]["DC"], min(
            LONG_COMPACT_K, s4cout["tiled"]["DC"] * t4d["W"])))), 0, t4nd,
        thr, as_array=True) for p in (t4posts, pposts)]
    if not np.array_equal(*t4pairs) or len(t4pairs[0]) == 0:
        raise AssertionError("the sm4 long check read: kernel and plain "
                             "planes give different pairs")
    ms.update(
        sm4_fwd_tiled=cuda_ms(lambda: fk.wavefront_fwd_tiled(*t4a, **t4d),
                              3),
        sm4_bwd_tiled=cuda_ms(lambda: fk.wavefront_bwd_tiled(
            *t4b, t4fwd, t4sh, **t4d), 3))
    t4cells = sum(int(b.width.sum()) for b in t4prep["bands"])
    bounds.update(
        sm4_fwd_tiled=bound(t4a + [t4fwd, t4sh], t4cells,
                            FLOPS_PER_CELL["sm4_fwd"]),
        sm4_bwd_tiled=bound(t4b + posterior_fwd(t4fwd, t4b[6], t4d["R"])
                            + [t4sh, t4posts, t4tot], t4cells,
                            FLOPS_PER_CELL["sm4_bwd"]))
    log(f"sm4 long path: {LONG_READS} reads routed tiled by themselves, one "
        f"run, kernels only: {bases / s4long_s:.6g} bases/s e2e "
        f"({s4long_s:.4f} s), {sum(map(len, s4lparts))} pairs, launches "
        f"{sm4_long_counts}; K6a/K6b sm4 vs plain (a {cread[2]} x "
        f"{cread[3]} read, {s4cout['tiled']}, R={t4d['R']}, W={t4d['W']}): "
        f"fwd plane, shifts, posts, totals equal bit for bit, "
        f"{len(t4pairs[0])} pairs equal; K6a sm4 {ms['sm4_fwd_tiled']:.3f} "
        f"ms vs plain {ms['sm4_fwd_tiled_plain']:.1f}, K6b sm4 "
        f"{ms['sm4_bwd_tiled']:.3f} ms vs plain "
        f"{ms['sm4_bwd_tiled_plain']:.1f}; bounds "
        f"{bounds['sm4_fwd_tiled'][0]:.4f} / "
        f"{bounds['sm4_bwd_tiled'][0]:.4f} ms")
    del s4cout, t4fwd, pfwd, t4posts, pposts, t4a, t4b
    torch.cuda.synchronize()

    # -- 23. the signalAlign pipeline at full width ----------------------
    clock.start(23)
    # bench.py's signal_pipeline_reads_per_sec workload: 64 copies of the
    # Zymo npRead, each guided by the stored lastz guide renamed to it,
    # StrawmanAligner(group=32), chunk 64, compact_k 2048
    bargs, btsvs = load_batch_zymo()
    blabel = bargs["label"]
    bguide = bargs["npread_guide_pairs"][0][1].split()
    bkw = dict(template_model_file=bargs["template_model_file"],
               complement_model_file=bargs["complement_model_file"],
               log=lambda m: None, chunk=PIPE_CHUNK,
               compact_k=PIPE_COMPACT_K)
    with tempfile.TemporaryDirectory() as ptmp:
        prdir = os.path.join(ptmp, "reads")
        os.makedirs(prdir)
        ppairs = []
        for i in range(PIPE_READS):
            label = f"read{i:03d}"
            dst = os.path.join(prdir, label + ".npRead")
            shutil.copy(bargs["npread_guide_pairs"][0][0], dst)
            ppairs.append((dst, " ".join([bguide[0], label] + bguide[2:])))
        pout = os.path.join(ptmp, "out")

        def pipeline(sm_type, aligner, out_dir=pout, pairs=ppairs, **kw):
            res = run_batch_fast(bargs["reference_path"], pairs, out_dir,
                                 aligner=aligner, sm_type=sm_type,
                                 **bkw, **kw)
            torch.cuda.synchronize()
            return res

        def check_pipeline(sm_type, res, out_dir=pout):
            """Every read aligned, every copy's tsv read 0's (its label
            aside), read 0's within parity of the JAX package's."""
            if len(res) != PIPE_READS or not all(r[1] for r in res):
                raise AssertionError(f"{sm_type} pipeline: "
                                     f"{[r for r in res if not r[1]]}")
            texts = []
            for i in range(PIPE_READS):
                with open(os.path.join(out_dir, f"read{i:03d}.tsv"),
                          "rb") as fh:
                    texts.append(fh.read().replace(
                        f"\tread{i:03d}\t".encode(), b"\tLABEL\t"))
            if any(t != texts[0] for t in texts):
                raise AssertionError(f"{sm_type} pipeline: the copies' tsvs "
                                     "differ")
            return check_tsv(texts[0].replace(
                b"\tLABEL\t", f"\t{blabel}\t".encode()), btsvs[sm_type],
                bargs["threshold"])

        def recorded(cls, params=AlignmentParams()):
            """An aligner of ``cls`` (group 32) whose first run, the first
            chunk's template strand, goes through a ``Stages`` hook: its
            inputs and kernel outputs are then held against the plain
            passes (``hold_chunk``; phases 23 and 26)."""
            class Recorded(cls):
                rec = None

                def run(self, sm, reads, **kw):
                    if self.rec is not None:
                        return super().run(sm, reads, **kw)
                    self.rec = Stages()
                    return super().run(sm, reads, stage=self.rec, **kw)

            return Recorded(params, device=dev, group=PIPE_GROUP)

        def hold_chunk(sm_type, pa):
            """The kernels' fwd plane, posteriors and totals of the
            pipeline's first chunk (template strand, as the warm-up run
            launched them) equal forward_plain/backward_plain's on the
            same inputs, bit for bit; returns (fwd args, bwd args, dims,
            band cells, fwd, posts, totals, plain fwd ms, plain bwd ms)."""
            st = pa.rec
            pa.rec = Stages()   # an empty record: later runs go unhooked
            prep, inp = st.out["prepare"], st.out["inputs"]
            d = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"],
                     spec=pa.spec)
            fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                                   "widthf")]
            ba = fa + [inp["seedf"], inp["raggedf"]]
            fwd, (posts, tot) = st.out["fwd"], st.out["bwd"]
            fwd_p, fms = timed(lambda: fk.forward_plain(*fa, **d))
            (posts_p, tot_p), bms = timed(
                lambda: fk.backward_plain(*ba, fwd, **d))
            for what, got, want in (("fwd plane", fwd, fwd_p),
                                    ("posteriors", posts, posts_p),
                                    ("totals", tot, tot_p)):
                same(f"{sm_type} pipeline chunk {what}", got, want)
            cells = sum(int(b.width.sum()) for b in prep["bands"])
            log(f"pipeline -smt {sm_type} chunk vs plain ({len(prep['bands'])}"
                f" reads, template strand, G={len(prep['win'])}, R={d['R']}, "
                f"W={d['W']}, ND={d['ND']}, ragged, scaled): fwd plane, "
                f"posts, totals equal bit for bit; plain ms fwd {fms:.1f}, "
                f"bwd {bms:.1f}")
            return fa, ba, d, cells, fwd, posts, tot, fms, bms

        def median_rate(sm_type, pa, n_reads=PIPE_READS, **kw):
            """(reads/s of the median of 3 runs, the runs' seconds, the
            last run's results)."""
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                res = pipeline(sm_type, pa, **kw)
                times.append(time.perf_counter() - t0)
            return n_reads / statistics.median(times), times, res

        ppa = recorded(StrawmanAligner)
        pres = pipeline("threeState", ppa)
        fk.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        prate, ptimes, pres = median_rate("threeState", ppa)
        pipe_counts = dict(fk.KERNEL_LAUNCHES)
        pipe_peak = torch.cuda.max_memory_allocated()
        if (pipe_counts != {"wavefront_fwd": 6, "wavefront_bwd": 6}
                or fk.forward_plain.calls or fk.backward_plain.calls):
            raise AssertionError(f"pipeline launches {pipe_counts}")
        p_one, p_err = check_pipeline("threeState", pres)
        pst = Stages()
        pipeline("threeState", ppa, stage=pst)
        log(f"signal_pipeline_reads_per_sec: {prate:.1f} reads/s e2e "
            f"({PIPE_READS} reads, both strands, group {PIPE_GROUP}, chunk "
            f"{PIPE_CHUNK}, compact_k {PIPE_COMPACT_K}; median of "
            f"{[round(t, 4) for t in ptimes]} s), peak device memory "
            f"{pipe_peak / 1e9:.3f} GB, launches in the 3 runs "
            f"{pipe_counts}; "
            f"read 0 vs the JAX package's tsv: {p_one} rows in one file "
            f"only, posteriors max|d| {p_err:.3g}; every copy's tsv equal")
        log("pipeline stages (s, share): " + pst.line())
        del pst
        hold_chunk("threeState", ppa)
        prates = {"threeState": prate}
        for sm_type, cls in (("vanilla", VanillaAligner),
                             ("fourState", Sm4Aligner)):
            pa = recorded(cls)
            pipeline(sm_type, pa)
            fk.reset_counts()
            prates[sm_type], times, res = median_rate(sm_type, pa)
            counts = dict(fk.KERNEL_LAUNCHES)
            suffix = {"vanilla": "_vanilla", "fourState": "_sm4"}[sm_type]
            if (counts != {f"wavefront_fwd{suffix}": 6,
                           f"wavefront_bwd{suffix}": 6}
                    or fk.forward_plain.calls or fk.backward_plain.calls):
                raise AssertionError(f"{sm_type} pipeline launches {counts}")
            one, err = check_pipeline(sm_type, res)
            log(f"pipeline -smt {sm_type}: {prates[sm_type]:.1f} reads/s "
                f"e2e (median of {[round(t, 4) for t in times]} s after a "
                f"warm-up), launches in the 3 runs {counts}; read 0 vs the "
                f"JAX package's tsv: {one} rows in one file only, "
                f"posteriors max|d| {err:.3g}; every copy's tsv equal")
            held = hold_chunk(sm_type, pa)
            if sm_type == "fourState":
                # the kernels line's K1/K2 sm4 entries: launches from these
                # runs, ms, plain ms and bound on their first chunk
                sm4_pipe_counts = counts
                fa, ba, d, cells, fwd, posts, tot, fms, bms = held
                ms.update(
                    sm4_fwd=cuda_ms(lambda: fk.wavefront_fwd(*fa, **d), 5),
                    sm4_bwd=cuda_ms(lambda: fk.wavefront_bwd(*ba, fwd, **d),
                                    5),
                    sm4_fwd_plain=fms, sm4_bwd_plain=bms)
                bounds.update(
                    sm4_fwd=bound(fa + [fwd], cells,
                                  FLOPS_PER_CELL["sm4_fwd"]),
                    sm4_bwd=bound(ba + posterior_fwd(fwd, ba[6], d["R"])
                                  + [posts, tot], cells,
                                  FLOPS_PER_CELL["sm4_bwd"]))
                log(f"pipeline chunk K1/K2 sm4: ms fwd {ms['sm4_fwd']:.3f}, "
                    f"bwd {ms['sm4_bwd']:.3f}; bounds "
                    f"{bounds['sm4_fwd'][0]:.4f} / "
                    f"{bounds['sm4_bwd'][0]:.4f} ms ({bounds['sm4_fwd'][1]})")
            del held
            torch.cuda.synchronize()
        # the one-chunk-behind drain over several chunks: 256 reads in
        # chunks of 64, against the same runs with each chunk's kernels
        # waited for before the last chunk's drain (a "chunk" stage hook
        # that synchronizes), interleaved
        os.makedirs(os.path.join(ptmp, "more"))
        opairs = list(ppairs)
        for i in range(PIPE_READS, PIPE_OVERLAP_READS):
            label = f"read{i:03d}"
            dst = os.path.join(ptmp, "more", label + ".npRead")
            shutil.copy(bargs["npread_guide_pairs"][0][0], dst)
            opairs.append((dst, " ".join([bguide[0], label] + bguide[2:])))

        def serial(name, fn):
            res = fn()
            if name == "chunk":
                torch.cuda.synchronize()
            return res

        otimes = {"one chunk behind": [], "serialized": []}
        pout2 = os.path.join(ptmp, "out256")
        ores = pipeline("threeState", ppa, out_dir=pout2, pairs=opairs)
        for _ in range(3):
            for mode, hook in (("one chunk behind", None),
                               ("serialized", serial)):
                t0 = time.perf_counter()
                ores = pipeline("threeState", ppa, out_dir=pout2,
                                pairs=opairs, stage=hook)
                otimes[mode].append(time.perf_counter() - t0)
        if len(ores) != PIPE_OVERLAP_READS or not all(r[1] for r in ores):
            raise AssertionError("the 256-read pipeline: "
                                 f"{[r for r in ores if not r[1]]}")
        orates = {m: PIPE_OVERLAP_READS / statistics.median(t)
                  for m, t in otimes.items()}
        log(f"pipeline drain overlap ({PIPE_OVERLAP_READS} reads, chunk "
            f"{PIPE_CHUNK}, threeState): " + "; ".join(
                f"{m} {orates[m]:.1f} reads/s (median of "
                f"{[round(t, 4) for t in otimes[m]]} s)" for m in otimes))
        # the CLI once: -smt vanilla on 4 of the 64 reads (-n)
        with open(os.path.join(ptmp, "guides.cig"), "w") as fh:
            fh.write("\n".join(g for _, g in ppairs) + "\n")
        with open(bargs["reference_path"]) as fh:
            pref = fh.readline().strip()
        with open(os.path.join(ptmp, "ref.fa"), "w") as fh:
            fh.write(">ZymoRef\n" + pref + "\n")
        cerr = io.StringIO()
        with contextlib.redirect_stderr(cerr):
            rc = signal_align_batch_main([
                "-d", prdir, "-r", os.path.join(ptmp, "ref.fa"), "-o",
                os.path.join(ptmp, "cli"), "--guides",
                os.path.join(ptmp, "guides.cig"), "--engine", "pallas",
                "-smt", "vanilla", "-n", str(PIPE_CLI_READS), "--device",
                DEVICE])
        cli_tsvs = [f for f in os.listdir(os.path.join(ptmp, "cli"))
                    if f.endswith(".tsv")]
        formatter = [m for m in cerr.getvalue().splitlines()
                     if m.startswith("tsv formatter:")]
        n_cli = PIPE_CLI_READS
        if (rc != 0 or len(cli_tsvs) != n_cli or len(formatter) != 1
                or f"aligned {n_cli}/{n_cli} reads" not in cerr.getvalue()):
            raise AssertionError(f"cpecan-torch-signal-align-batch: rc {rc}, "
                                 f"{cli_tsvs}, log {cerr.getvalue()[-500:]}")
    rates = ", ".join(f"{k} {v:.1f}" for k, v in prates.items())
    log(f"pipeline reads/s: {rates}; "
        f"cpecan-torch-signal-align-batch --engine pallas -smt vanilla -n "
        f"{n_cli} on the card: rc 0, {n_cli} tsvs, {formatter[0]}")
    torch.cuda.synchronize()

    # -- 24. the echelon kernels vs plain on bench.py's echelon cell -------
    clock.start(24)
    # K1/K2 echelon on the first 32-read chunk of bench.py's echelon cell,
    # prepared with the main path's shape hint (phase 25), so that this is
    # the main path's first chunk
    esm, ereads = echelon_batch(n_reads=ECH_READS)
    esm = esm.to(dev)
    eal = EchelonAligner(AlignmentParams(threshold=ECH_THRESHOLD), device=dev,
                         group=ECH_GROUP)
    ehint = (max(r[2] for r in ereads), eal.prepare(esm, ereads)["ND"])
    eprep = eal.prepare(esm, ereads[:ECH_CHUNK], shape_hint=ehint)
    einp = eal.device_inputs(esm, eprep)
    ed = dict(R=eprep["R"], W=eprep["W"], ND=eprep["ND"], C=eprep["C"],
              spec=fk.EchelonSpec)
    efa = [einp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    eba = efa + [einp["seedf"], einp["raggedf"]]
    egeo = {k: ed[k] for k in ("R", "W", "ND", "C")}

    def prepass(fa, geo, k):
        return fk.echelon_emissions(fa[1], fa[2], fa[3], k=k, **geo)

    # the emission pre-pass at both offsets against its plain twin
    ech_err = {}
    for k in (0, 1):
        got = prepass(efa, egeo, k)
        want, ms[f"echelon_emissions_k{k}_plain"] = timed(
            lambda: fk.echelon_emissions_plain(efa[1], efa[2], efa[3], k=k,
                                               **egeo))
        ech_err[f"pre-pass k={k}"] = float((got - want).abs().max())
        same(f"echelon pre-pass plane k={k}", got, want)
    eplanes = [prepass(efa, egeo, k) for k in (0, 1)]
    efwd = fk.wavefront_fwd(*efa, **ed)
    efwd_p, ms["echelon_fwd_plain"] = timed(
        lambda: fk.forward_plain(*efa, **ed))
    eposts, etot = fk.wavefront_bwd(*eba, efwd, **ed)
    (eposts_p, etot_p), ms["echelon_bwd_plain"] = timed(
        lambda: fk.backward_plain(*eba, efwd, **ed))
    for what, got, want in (("fwd plane", efwd, efwd_p),
                            ("posteriors", eposts, eposts_p),
                            ("totals", etot, etot_p)):
        ech_err[what] = float((got - want).abs().max())
        same(f"K1/K2 echelon {what}", got, want)
    if not torch.all(eposts[:, 0] == 0) or tuple(eposts.shape[2:4]) != (
            5, ECH_CHUNK):
        raise AssertionError(f"echelon posteriors {tuple(eposts.shape)}")
    ends = [b.n_diag for b in eprep["bands"]]
    erels = list(range(len(ends)))
    eparts = [extract_echelon_pairs_chunk(dict(
        prep=eprep, posteriors=p, compact=compact_posteriors(
            p, min(ECH_COMPACT_K, ed["ND"] * ed["W"]))), erels, ends,
        ECH_THRESHOLD) for p in (eposts, eposts_p)]
    for i, (a, b) in enumerate(zip(*eparts)):
        if not np.array_equal(a, b) or len(a) == 0:
            raise AssertionError(f"echelon pairs of read {i}: kernel and "
                                 "plain differ")
    # each wrapper (the pre-pass, then its recurrence), the pre-pass alone
    # at both offsets and each recurrence alone on the pre-pass's plane
    ms.update(
        echelon_fwd=cuda_ms(lambda: fk.wavefront_fwd(*efa, **ed), 5),
        echelon_bwd=cuda_ms(lambda: fk.wavefront_bwd(*eba, efwd, **ed), 5),
        echelon_emissions_k0=cuda_ms(lambda: prepass(efa, egeo, 0), 5),
        echelon_emissions_k1=cuda_ms(lambda: prepass(efa, egeo, 1), 5),
        echelon_fwd_recurrence=cuda_ms(lambda: fk._launch_fwd(
            "wavefront_fwd", *efa, ed["R"], ed["W"], ed["ND"], ed["C"],
            fk.EchelonSpec, plane=eplanes[0]), 5),
        echelon_bwd_recurrence=cuda_ms(lambda: fk._launch_bwd(
            "wavefront_bwd", *eba, efwd, ed["R"], ed["W"], ed["ND"],
            ed["C"], False, fk.EchelonSpec, plane=eplanes[1]), 5))
    # the pre-pass per launch: the mean of its two offsets
    ms["echelon_emissions"] = (ms["echelon_emissions_k0"]
                               + ms["echelon_emissions_k1"]) / 2
    ms["echelon_emissions_plain"] = (ms["echelon_emissions_k0_plain"]
                                     + ms["echelon_emissions_k1_plain"]) / 2
    ecells = sum(int(b.width.sum()) for b in eprep["bands"])
    bounds.update(
        # the whole function of each wrapper (the pre-pass's work included):
        # the same inputs and outputs as before the pre-pass existed
        echelon_fwd=bound(efa + [efwd], ecells, FLOPS_PER_CELL["echelon_fwd"]),
        # the whole fwd plane: echelon's posteriors are those of five of
        # its seven states (match1..match5), so it reads 5/7 of the plane
        # on every diagonal; posterior_fwd counts one posterior state
        echelon_bwd=bound(eba + [efwd, eposts, etot], ecells,
                          FLOPS_PER_CELL["echelon_bwd"]),
        # the pre-pass: its window rows, its plane written once, and the
        # emissions of every cell of the plane (it computes the window,
        # not only the band)
        echelon_emissions=bound(
            [efa[1], efa[2], efa[3], eplanes[0]], eplanes[0][:, :, 0].numel(),
            FLOPS_PER_CELL["echelon_emissions"]))
    del efwd_p, eposts_p, efwd, eposts, eplanes
    # one launch of each at W = 1024, the widest window: one read whose
    # band covers the window for 128 diagonals, seeded at the last (random
    # model rows, skip logs, validity bits, durations and events)
    wrng = np.random.default_rng(6)
    WW, WND = 1024, 128
    WY = WND + 3 + WW + 256
    wxf = wrng.uniform(0.5, 2.0, (1, fk.EchelonSpec.NXF, WW))
    wxf[:, 24:28] = np.log(wrng.uniform(0.05, 0.9, (1, 4, WW)))
    wxf[:, 28:] = wrng.integers(0, 2, (1, 5, WW))
    wyf = np.concatenate([np.log(wrng.uniform(0.05, 0.9, (1, 6, WY))),
                          wrng.uniform(0.5, 2.0, (1, 2, WY))], axis=1)
    wseed = np.zeros((1, 384))
    wseed[0, WND] = 1.0

    def on_card(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    wfa = [on_card(np.log(wrng.uniform(0.05, 0.9, 21))),
           on_card(np.zeros((1, 384)), torch.int32), on_card(wxf),
           on_card(wyf), on_card(np.zeros((1, 384))),
           on_card(np.full((1, 384), float(WW)))]
    wba = wfa + [on_card(wseed), on_card(np.zeros((1, 384)))]
    wd = dict(R=1, W=WW, ND=WND, C=WND + 3, spec=fk.EchelonSpec)
    wgeo = {k: wd[k] for k in ("R", "W", "ND", "C")}
    for k in (0, 1):
        same(f"echelon pre-pass plane k={k} at W = 1024",
             prepass(wfa, wgeo, k),
             fk.echelon_emissions_plain(wfa[1], wfa[2], wfa[3], k=k, **wgeo))
    wfwd = fk.wavefront_fwd(*wfa, **wd)
    same("K1 echelon fwd plane at W = 1024", wfwd,
         fk.forward_plain(*wfa, **wd))
    wout = fk.wavefront_bwd(*wba, wfwd, **wd)
    for what, got, want in zip(("posteriors", "totals"), wout,
                               fk.backward_plain(*wba, wfwd, **wd)):
        same(f"K2 echelon {what} at W = 1024", got, want)
    if not torch.isfinite(wout[1]).all():
        raise AssertionError("K2 echelon total at W = 1024 not finite")
    w_ms = (cuda_ms(lambda: fk.wavefront_fwd(*wfa, **wd), 3),
            cuda_ms(lambda: fk.wavefront_bwd(*wba, wfwd, **wd), 3))
    nd = ed["ND"]
    log(f"echelon kernels vs plain ({ECH_CHUNK} reads of bench.py's echelon "
        f"cell, ND={nd}, W={ed['W']}, R={ed['R']}): pre-pass planes "
        f"[G, ND+3, 6, R, W] at k = 0 and 1, fwd plane, posts "
        f"[G, ND+1, 5, R, W], totals equal bit for bit (max|d| "
        + ", ".join(f"{k} {v:.3g}" for k, v in ech_err.items())
        + f"), {sum(map(len, eparts[0]))} expanded pairs equal; ms: "
        f"pre-pass k=0 {ms['echelon_emissions_k0']:.4f}, k=1 "
        f"{ms['echelon_emissions_k1']:.4f} (plain "
        f"{ms['echelon_emissions_k0_plain']:.1f}, "
        f"{ms['echelon_emissions_k1_plain']:.1f}); wrapper (pre-pass and "
        f"recurrence) fwd {ms['echelon_fwd']:.4f} vs plain "
        f"{ms['echelon_fwd_plain']:.1f}, bwd {ms['echelon_bwd']:.4f} vs "
        f"plain {ms['echelon_bwd_plain']:.1f}; recurrence alone fwd "
        f"{ms['echelon_fwd_recurrence']:.4f} "
        f"({ms['echelon_fwd_recurrence'] * 1e6 / nd:.0f} ns a diagonal), "
        f"bwd {ms['echelon_bwd_recurrence']:.4f} "
        f"({ms['echelon_bwd_recurrence'] * 1e6 / nd:.0f} ns a diagonal); "
        f"bounds (the whole function of each wrapper) "
        f"{bounds['echelon_fwd'][0]:.4f} ({bounds['echelon_fwd'][1]}) / "
        f"{bounds['echelon_bwd'][0]:.4f} ({bounds['echelon_bwd'][1]}) / "
        f"pre-pass {bounds['echelon_emissions'][0]:.4f} ms "
        f"({bounds['echelon_emissions'][1]}); at W = {WW} (ND {WND}) the "
        f"pre-pass planes and both wrappers equal plain, ms fwd "
        f"{w_ms[0]:.3f}, bwd {w_ms[1]:.3f}")
    torch.cuda.synchronize()

    # -- 25. echelon_alignments_per_sec -------------------------------------
    clock.start(25)
    def ech_main(stage=None):
        outs = [eal.run(esm, ereads[i:i + ECH_CHUNK],
                        compact_k=ECH_COMPACT_K, shape_hint=ehint,
                        stage=stage)
                for i in range(0, len(ereads), ECH_CHUNK)]
        for o in outs:
            fetch(o)
        return outs

    ech_main()
    fk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    etimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        eouts = ech_main()
        etimes.append(time.perf_counter() - t0)
    ech_counts = dict(fk.KERNEL_LAUNCHES)
    epeak = torch.cuda.max_memory_allocated()
    n_chunks = -(-ECH_READS // ECH_CHUNK)
    if (ech_counts != {"wavefront_fwd_echelon": 3 * n_chunks,
                       "wavefront_bwd_echelon": 3 * n_chunks,
                       "wavefront_emissions_echelon": 6 * n_chunks}
            or fk.forward_plain.calls or fk.backward_plain.calls
            or fk.echelon_emissions_plain.calls):
        raise AssertionError(f"echelon main path launches {ech_counts}")
    eall = []
    for o in eouts:
        if not torch.isfinite(o["totals"]).all():
            raise AssertionError("echelon main path totals not finite")
        nds = [b.n_diag for b in o["prep"]["bands"]]
        eall += extract_echelon_pairs_chunk(o, list(range(len(nds))), nds,
                                            ECH_THRESHOLD)
    if len(eall) != ECH_READS or min(map(len, eall)) == 0:
        raise AssertionError("an echelon read has no pairs")
    for i, a in enumerate(eparts[0]):   # phase 24's chunk is the first
        if not np.array_equal(eall[i], a):
            raise AssertionError(f"echelon main path read {i} differs from "
                                 "phase 24's kernel pairs")
    ecells_all = sum(int(b.width.sum()) for o in eouts
                     for b in o["prep"]["bands"])
    edt = statistics.median(etimes)
    est = Stages()
    # the staged run times each pre-pass too (ended by a synchronize, as
    # each stage is), so that the fwd and bwd stages split into the
    # pre-pass and the recurrence
    pre_s = {0: 0.0, 1: 0.0}
    wrapped = fk.echelon_emissions

    def timed_prepass(*a, k, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wrapped(*a, k=k, **kw)
        torch.cuda.synchronize()
        pre_s[k] += time.perf_counter() - t0
        return out

    fk.echelon_emissions = timed_prepass
    try:
        ech_main(stage=est)
    finally:
        fk.echelon_emissions = wrapped
    e_total = sum(est.s.values())
    e_split = {"pre-pass": pre_s[0] + pre_s[1],
               "K1": est.s["fwd"] - pre_s[0], "K2": est.s["bwd"] - pre_s[1],
               "prepare": est.s["prepare"]}
    e_split["the rest"] = e_total - sum(e_split.values())
    log(f"echelon_alignments_per_sec: {ECH_READS / edt:.1f} alignments/s "
        f"e2e ({ECH_READS} reads in chunks of {ECH_CHUNK}, group "
        f"{ECH_GROUP}, compact_k {ECH_COMPACT_K}, shape hint {ehint}; run + "
        f"compaction to the host, median of {[round(t, 4) for t in etimes]} "
        f"s), {ecells_all / edt:.4g} band cells/s e2e, "
        f"{sum(map(len, eall))} pairs after the expansion (threshold "
        f"{ECH_THRESHOLD}), peak device memory {epeak / 1e9:.3f} GB, "
        f"launches in the 3 runs {ech_counts}")
    log("echelon main path stages (s, share): " + est.line())
    log("echelon main path staged split (s, share): " + ", ".join(
        f"{k} {v:.4f} ({v / e_total:.1%})" for k, v in e_split.items()))
    del est, eouts, einp
    torch.cuda.synchronize()

    # -- 26. signal_pipeline_echelon_reads_per_sec --------------------------
    clock.start(26)
    eargs, etsvs = load_echelon_zymo()
    eguide = eargs["npread_guide_pairs"][0][1].split()
    with tempfile.TemporaryDirectory() as etmp:
        epairs = []
        for i in range(ECH_PIPE_READS):
            label = f"read{i:03d}"
            dst = os.path.join(etmp, label + ".npRead")
            shutil.copy(eargs["npread_guide_pairs"][0][0], dst)
            epairs.append((dst, " ".join([eguide[0], label] + eguide[2:])))
        eout = os.path.join(etmp, "out")
        # the warm-up run records the first chunk's template strand, held
        # to the plain passes after the timed runs (hold_chunk, phase 23)
        epa = recorded(EchelonAligner,
                       AlignmentParams(threshold=ECH_PIPE_THRESHOLD))

        def epipe(stage=None):
            res = run_batch_fast(
                eargs["reference_path"], epairs, eout,
                template_model_file=eargs["template_model_file"],
                complement_model_file=eargs["complement_model_file"],
                log=lambda m: None, aligner=epa, sm_type="echelon",
                threshold=ECH_PIPE_THRESHOLD, stage=stage)
            torch.cuda.synchronize()
            return res

        epipe()
        fk.reset_counts()
        eptimes = []
        for _ in range(3):
            t0 = time.perf_counter()
            eres = epipe()
            eptimes.append(time.perf_counter() - t0)
        epipe_counts = dict(fk.KERNEL_LAUNCHES)
        if (epipe_counts != {"wavefront_fwd_echelon": 6,
                             "wavefront_bwd_echelon": 6,
                             "wavefront_emissions_echelon": 12}
                or fk.forward_plain.calls or fk.backward_plain.calls
                or fk.echelon_emissions_plain.calls):
            raise AssertionError(f"echelon pipeline launches {epipe_counts}")
        if len(eres) != ECH_PIPE_READS or not all(r[1] for r in eres):
            raise AssertionError("echelon pipeline: "
                                 f"{[r for r in eres if not r[1]]}")
        etexts = []
        for i in range(ECH_PIPE_READS):
            with open(os.path.join(eout, f"read{i:03d}.tsv"), "rb") as fh:
                etexts.append(fh.read().replace(f"\tread{i:03d}\t".encode(),
                                                b"\tLABEL\t"))
        if any(t != etexts[0] for t in etexts):
            raise AssertionError("echelon pipeline: the copies' tsvs differ")
        e_one, e_err = check_tsv(etexts[0].replace(
            b"\tLABEL\t", f"\t{eargs['label']}\t".encode()),
            etsvs["echelon"], ECH_PIPE_THRESHOLD, multi=True)
        epst = Stages()
        epipe(stage=epst)
        erate = ECH_PIPE_READS / statistics.median(eptimes)
        log(f"signal_pipeline_echelon_reads_per_sec: {erate:.1f} reads/s e2e "
            f"({ECH_PIPE_READS} reads, both strands, group {PIPE_GROUP}, "
            f"threshold {ECH_PIPE_THRESHOLD}; median of "
            f"{[round(t, 4) for t in eptimes]} s after a warm-up), launches "
            f"in the 3 runs {epipe_counts}; read 0 vs the JAX package's tsv: "
            f"{e_one} rows in one file only, posteriors max|d| {e_err:.3g}, "
            f"{len(etexts[0].splitlines())} rows; every copy's tsv equal")
        log("echelon pipeline stages (s, share): " + epst.line())
        del epst
        hold_chunk("echelon", epa)
    torch.cuda.synchronize()

    # -- 27. the HDP kernels vs plain on bench.py's HDP chunk -------------
    clock.start(27)
    # K1 hdp (sm3_fwd_kernel<Hdp>), K2 hdp (the untiled select posterior
    # form reading the stream, sm3_bwd_tiled_sel<Hdp, 0, 0>) and K3 hdp
    # (sm3_bwd_kernel<Hdp, 1>)
    # bench.py's HDP machine, sampled here by the port's own HDP copy
    t0 = time.perf_counter()
    hsm = hdp_model()
    hdp_s = time.perf_counter() - t0
    sampler = hsm.nhdp.hdp.sampler
    hpa = HdpAligner(AlignmentParams(), device=dev, group=HDP_GROUP)
    # the first 64-read chunk of bench.py's HDP cell (its reads are the
    # bench batch): the main path's (phase 28) first chunk
    hprep = hpa.prepare(hsm, reads[:HDP_CHUNK])
    hinp = hpa.device_inputs(hsm, hprep)
    hest = hpa.emission_stream(hsm, hprep, hinp)
    # the stream built on the host from the same inputs
    csm = StateMachine3Hdp(hsm.nhdp)
    cpa = HdpAligner(AlignmentParams(), device="cpu", group=HDP_GROUP)
    t0 = time.perf_counter()
    cest = cpa.emission_stream(csm, hprep, cpa.device_inputs(csm, hprep))
    cest_s = time.perf_counter() - t0
    stream_err = check_hdp_stream(hest, cest)
    del cest
    hd = dict(R=hprep["R"], W=hprep["W"], ND=hprep["ND"], C=hprep["C"],
              spec=fk.HdpSpec, est=hest)
    hfa = [hinp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    hba = hfa + [hinp["seedf"], hinp["raggedf"]]
    hfwd = fk.wavefront_fwd(*hfa, **hd)
    hfwd_p, ms["hdp_fwd_plain"] = timed(lambda: fk.forward_plain(*hfa, **hd))
    hposts, htot = fk.wavefront_bwd(*hba, hfwd, **hd)
    (hposts_p, htot_p), ms["hdp_bwd_plain"] = timed(
        lambda: fk.backward_plain(*hba, hfwd, **hd))
    for what, got, want in (("fwd plane", hfwd, hfwd_p),
                            ("posteriors", hposts, hposts_p),
                            ("totals", htot, htot_p)):
        same(f"K1/K2 hdp {what}", got, want)
    if not torch.all(hposts[:, 0] == 0) or not torch.isfinite(htot).all():
        raise AssertionError("hdp posteriors or totals")
    hnds = [b.n_diag for b in hprep["bands"]]
    hrels = list(range(len(hnds)))
    hcomps = [compact_posteriors(p, min(HDP_COMPACT_K, hd["ND"] * hd["W"]))
              for p in (hposts, hposts_p)]
    hparts = [extract_pairs_chunk(dict(prep=hprep, posteriors=p, compact=c),
                                  hrels, hnds, thr)
              for p, c in zip((hposts, hposts_p), hcomps)]
    # reads whose top-k ends above the threshold: the exact fallback
    hsat = int((hcomps[0].wait()[0][0, :, -1] / 65535.0 >= thr).sum())
    for i, (a, b) in enumerate(zip(*hparts)):
        if not np.array_equal(a, b) or len(a) == 0:
            raise AssertionError(f"hdp pairs of read {i}: kernel and plain "
                                 "differ")
    del hfwd_p, hposts_p
    ms.update(hdp_fwd=cuda_ms(lambda: fk.wavefront_fwd(*hfa, **hd), 5),
              hdp_bwd=cuda_ms(lambda: fk.wavefront_bwd(*hba, hfwd, **hd),
                              5))
    hcells = sum(int(b.width.sum()) for b in hprep["bands"])
    # the bytes the hdp kernels read: of xf only the gap-X row 8, no y row
    # (the stream replaces the emission rows)
    hread = [hinp["scal"], hinp["win"], hinp["xf"][:, 8:9], hinp["basef"],
             hinp["widthf"]]
    bounds.update(
        hdp_fwd=bound(hread + [hest, hfwd], hcells,
                      FLOPS_PER_CELL["hdp_fwd"]),
        hdp_bwd=bound(hread + [hinp["seedf"], hinp["raggedf"], hest,
                               hposts, htot]
                      + posterior_fwd(hfwd, hinp["seedf"], hd["R"]), hcells,
                      FLOPS_PER_CELL["hdp_bwd"]))
    hstream_ms = cuda_ms(lambda: hpa.emission_stream(hsm, hprep, hinp), 5)
    del hfwd, hposts, hest, hinp
    # K3 hdp on the first 32-read group of phase 28's E-step (bench.py's
    # signal-EM shape: 128 reads, group 32, ragged at both ends)
    hea = HdpAligner(AlignmentParams(), device=dev, group=EM_GROUP)
    hesub = reads[:VANILLA_E_READS]
    heprep = hea.prepare(hsm, hesub, ragged_right=True)
    heinp = hea.device_inputs(hsm, heprep, ragged_left=True)
    n = EM_GROUP
    hed = dict(R=n, W=heprep["W"], ND=heprep["ND"], C=heprep["C"],
               spec=fk.HdpSpec,
               est=hea.emission_stream(hsm, heprep, heinp)[:1].contiguous())
    heb = [heinp["scal"], heinp["win"][:1]] + [
        heinp[k][:n] for k in ("xf", "yf", "basef", "widthf", "seedf",
                               "raggedf")]
    hefwd = fk.wavefront_fwd(*heb[:6], **hed)
    hek = fk.wavefront_bwd_exp(*heb, hefwd, **hed)
    hep, ms["hdp_bwd_exp_plain"] = timed(
        lambda: fk.backward_exp_plain(*heb, hefwd, **hed))
    hdp_exp_err = check_exp_kernel(hek, hep)
    if not float(hek[2].sum()) > 0:
        raise AssertionError("hdp transition sums are 0")
    ms["hdp_bwd_exp"] = cuda_ms(
        lambda: fk.wavefront_bwd_exp(*heb, hefwd, **hed), 5)
    hecells = sum(int(b.width.sum()) for b in heprep["bands"][:n])
    bounds["hdp_bwd_exp"] = bound(
        heb[:2] + [heb[2][:, 8:9]] + heb[4:] + [hed["est"], hefwd, *hek],
        hecells, FLOPS_PER_CELL["hdp_bwd_exp"])
    del hek, hep, hefwd, heinp
    log(f"hdp model: bench.py's flat_hdp_model_2 (4,097 DPs, grid 120) "
        f"sampled by the {sampler} sampler in {hdp_s:.2f} s")
    log(f"hdp kernels vs plain ({HDP_CHUNK} reads of bench.py's HDP cell, "
        f"G={len(hprep['win'])}, R={hd['R']}, W={hd['W']}, ND={hd['ND']}): "
        f"K1/K2 (sm3_fwd_kernel<Hdp>, sm3_bwd_tiled_sel<Hdp, 0, 0>) fwd "
        f"plane, posts, totals equal bit for bit, "
        f"{sum(map(len, hparts[0]))} pairs equal (compact_k "
        f"{HDP_COMPACT_K}, saturated in {hsat} reads); stream vs the host's build max|d| {stream_err:.3g} "
        f"(host build {cest_s:.2f} s); K3 hdp vs plain ({n} reads, ragged, "
        f"ND={hed['ND']}, W={hed['W']}): posts, totals, trans equal, gapx "
        f"max|d| {hdp_exp_err:.3g}; ms fwd {ms['hdp_fwd']:.3f} vs plain "
        f"{ms['hdp_fwd_plain']:.1f}, bwd {ms['hdp_bwd']:.3f} vs plain "
        f"{ms['hdp_bwd_plain']:.1f}, bwd_exp {ms['hdp_bwd_exp']:.3f} vs "
        f"plain {ms['hdp_bwd_exp_plain']:.1f}, stream build "
        f"{hstream_ms:.3f}; bounds "
        + ", ".join(f"{k} {bounds[k][0]:.4f} ({bounds[k][1]})"
                    for k in ("hdp_fwd", "hdp_bwd", "hdp_bwd_exp")))
    torch.cuda.synchronize()

    # -- 28. hdp_alignments_per_sec -----------------------------------------
    clock.start(28)
    def hdp_main(stage=None):
        outs = [hpa.run(hsm, reads[i:i + HDP_CHUNK],
                        compact_k=HDP_COMPACT_K, stage=stage)
                for i in range(0, len(reads), HDP_CHUNK)]
        for o in outs:
            fetch(o)
        return outs

    hdp_main()
    fk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    htimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        houts = hdp_main()
        htimes.append(time.perf_counter() - t0)
    hdp_counts = dict(fk.KERNEL_LAUNCHES)
    hpeak = torch.cuda.max_memory_allocated()
    n_chunks = -(-len(reads) // HDP_CHUNK)
    if (hdp_counts != {"wavefront_fwd_hdp": 3 * n_chunks,
                       "wavefront_bwd_hdp": 3 * n_chunks}
            or fk.forward_plain.calls or fk.backward_plain.calls):
        raise AssertionError(f"hdp main path launches {hdp_counts}")
    hall = []
    for o in houts:
        if not torch.isfinite(o["totals"]).all():
            raise AssertionError("hdp main path totals not finite")
        nds = [b.n_diag for b in o["prep"]["bands"]]
        hall += extract_pairs_chunk(o, list(range(len(nds))), nds, thr)
    if len(hall) != len(reads) or min(map(len, hall)) == 0:
        raise AssertionError("an hdp read has no pairs")
    for i, a in enumerate(hparts[0]):   # phase 27's chunk is the first
        if not np.array_equal(hall[i], a):
            raise AssertionError(f"hdp main path read {i} differs from "
                                 "phase 27's kernel pairs")
    del houts
    hrate = len(reads) / statistics.median(htimes)
    hst = Stages()
    for o in hdp_main(stage=hst):
        nds = [b.n_diag for b in o["prep"]["bands"]]
        hst("extract", lambda: extract_pairs_chunk(
            o, list(range(len(nds))), nds, thr))
    # the E-step on bench.py's signal-EM shape
    fk.reset_counts()
    hexp = hea.run(hsm, hesub, **em_kw)["expectations"]
    hetimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        hea.run(hsm, hesub, **em_kw)
        hetimes.append(time.perf_counter() - t0)
    hexp_counts = dict(fk.KERNEL_LAUNCHES)
    if (hexp_counts != {"wavefront_fwd_hdp": 4, "wavefront_bwd_exp_hdp": 4}
            or fk.forward_plain.calls or fk.backward_exp_plain.calls):
        raise AssertionError(f"hdp E-step launches {hexp_counts}")
    if not (hexp["trans"].shape == (len(hesub), 3, 3)
            and np.isfinite(hexp["likelihood"]).all()
            and (hexp["trans"].sum((1, 2)) > 0).all()):
        raise AssertionError("hdp E-step expectations")
    log(f"hdp_alignments_per_sec {hrate:.1f} alignments/s e2e "
        f"({len(reads)} reads in chunks of {HDP_CHUNK}, group {HDP_GROUP}, "
        f"compact_k {HDP_COMPACT_K}, run + compaction to the host; median "
        f"of {[round(t, 4) for t in htimes]} s after a warm-up), "
        f"{sum(map(len, hall))} pairs, peak device memory "
        f"{hpeak / 1e9:.3f} GB, launches in the 3 runs {hdp_counts}")
    log("hdp main path stages (s, share): " + hst.line())
    log(f"hdp E-step: {len(hesub) / statistics.median(hetimes):.1f} reads/s "
        f"({len(hesub)} reads, group {EM_GROUP}, ragged; median of "
        f"{[round(t, 4) for t in hetimes]} s after a warm-up), launches in "
        f"4 runs {hexp_counts}")
    del hst
    torch.cuda.synchronize()

    src = "cpecan_tpu_torch/csrc/wavefront.cu"

    def entry(name, replaces, launches, passes, err, key, bkey, main=None):
        # launches counted over ``passes`` passes of the main path
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches,
               "passes": passes, "launches_per_pass": launches / passes,
               "max_abs_err": err, "ms": ms[key],
               "plain_ms": ms[key + "_plain"],
               "bound_ms": bounds[bkey][0], "bound_by": bounds[bkey][1],
               # no single PyTorch call computes a banded pair-HMM
               # wavefront
               "library_ms": None}
        if main:
            # the same kernel on the main path's own inputs: the bound of
            # its real rows, and of all rows of its groups
            row.update(main_ms=ms[main], main_bound_ms=bounds[main][0],
                       main_bound_ms_padded=bounds[main + "_padded"][0])
        return row

    clock.stop()
    for n, sec in clock.s.items():
        log(f"phase {n}: {sec:.1f} s")
    log(f"phases 1-{max(clock.s)}: {sum(clock.s.values()):.1f} s")
    exact = 0.0   # phases 3, 10, 12, 13, 19, 21-24, 27 hold these bit for bit
    # passes: a warm-up and 3 timed runs (4; phases 5, 12, 15, 16, 20 and
    # the E-steps of 20 and 28), the EM iterations (phases 9, 18), 3 timed
    # runs (phases 23, 25, 28) or one run (phases 21, 22)
    # K2 strawman, K2 dna5, K2 vanilla, K2 sm4 and K2 hdp run the untiled
    # select posterior form (sm3_bwd_tiled_sel<Spec, 0, 0>; hdp's reads
    # its stream); K1 strawman, K1 dna5, K1 vanilla and K1 sm4 the untiled
    # select forward (sm3_fwd_tiled_sel<Spec, 0>), K1 hdp
    # sm3_fwd_kernel<Hdp>
    log(json.dumps({"kernels": [
        entry("wavefront_fwd", "cpecan_tpu/ops/pallas_fb.py:635",
              launches["wavefront_fwd"], 4, exact, "fwd", "fwd"),
        entry("wavefront_bwd", "cpecan_tpu/ops/pallas_fb.py:857",
              launches["wavefront_bwd"], 4, exact, "bwd", "bwd"),
        entry("wavefront_bwd_exp",
              "cpecan_tpu/ops/pallas_fb.py:2221 (with_exp=True)",
              em_launches["wavefront_bwd_exp"], EM_ITERATIONS, exp_err,
              "bwd_exp", "bwd_exp"),
        # phase 12 holds K6a/K6b to plain on its check read (ms, plain ms
        # and bound there; main_ms and main_bound_ms on the 64 long reads)
        entry("wavefront_fwd_tiled", "cpecan_tpu/ops/pallas_fb.py:2304",
              long_launches["wavefront_fwd_tiled"], 4, exact, "fwd_long",
              "fwd_long", main="fwd_long_main"),
        entry("wavefront_bwd_tiled", "cpecan_tpu/ops/pallas_fb.py:2332",
              long_launches["wavefront_bwd_tiled"], 4, exact, "bwd_long",
              "bwd_long", main="bwd_long_main"),
        # phase 13 holds K1/K2 dna5 bit for bit, phase 16's check pair
        # K6a/K6b dna5 (their ms, plain ms and bound are on that pair;
        # main_ms, main_bound_ms and main_bound_ms_padded on the 100 kb
        # pair)
        entry("wavefront_fwd_dna5",
              "cpecan_tpu/ops/pallas_fb.py:635 (_Dna5Spec :340)",
              dna_counts["wavefront_fwd_dna5"], 4, exact, "dna5_fwd",
              "dna5_fwd"),
        entry("wavefront_bwd_dna5",
              "cpecan_tpu/ops/pallas_fb.py:857 (_Dna5Spec :340)",
              dna_counts["wavefront_bwd_dna5"], 4, exact, "dna5_bwd",
              "dna5_bwd"),
        entry("wavefront_fwd_tiled_dna5",
              "cpecan_tpu/ops/pallas_fb.py:2304 (_Dna5Spec :340)",
              big_counts["wavefront_fwd_tiled_dna5"], 4, derr,
              "dna5_fwd_tiled", "dna5_fwd_tiled", main="dna5_fwd_long"),
        entry("wavefront_bwd_tiled_dna5",
              "cpecan_tpu/ops/pallas_fb.py:2332 (_Dna5Spec :340)",
              big_counts["wavefront_bwd_tiled_dna5"], 4, derr,
              "dna5_bwd_tiled", "dna5_bwd_tiled", main="dna5_bwd_long"),
        # phase 17 holds K3 dna5 to its plain version (ms, plain ms and
        # bound on its equalised-machine inputs; main_ms and main_bound_ms
        # on phase 18's 64-pair chunk); launches from phase 18's cPecanEm
        # run
        entry("wavefront_bwd_exp_dna5",
              "cpecan_tpu/ops/pallas_fb.py:2221 (with_exp=True, _Dna5Spec "
              ":406)", em_dna_counts["wavefront_bwd_exp_dna5"],
              EM_ITERATIONS, d5exp_err, "dna5_bwd_exp", "dna5_bwd_exp",
              main="dna5_bwd_exp_main"),
        # phase 19 holds K1/K2/K3 vanilla to plain (K1/K2 ms, plain ms and
        # bound on the main path's default-machine chunk, K3 on the trained
        # machine's E-step group), phase 21 K6a/K6b vanilla on its check
        # read (main_ms and main_bound_ms on the 64 long reads); launches
        # from phases 20 (main path, E-step) and 21
        entry("wavefront_fwd_vanilla",
              "cpecan_tpu/ops/pallas_fb.py:635 (_VanillaSpec :456)",
              van_counts["wavefront_fwd_vanilla"], 4, exact, "vanilla_fwd",
              "vanilla_fwd"),
        entry("wavefront_bwd_vanilla",
              "cpecan_tpu/ops/pallas_fb.py:857 (_VanillaSpec :456)",
              van_counts["wavefront_bwd_vanilla"], 4, exact, "vanilla_bwd",
              "vanilla_bwd"),
        entry("wavefront_bwd_exp_vanilla",
              "cpecan_tpu/ops/pallas_fb.py:2221 (with_exp=True, "
              "_VanillaSpec :506)",
              vexp_counts["wavefront_bwd_exp_vanilla"], 4, exact,
              "vanilla_bwd_exp", "vanilla_bwd_exp"),
        entry("wavefront_fwd_tiled_vanilla",
              "cpecan_tpu/ops/pallas_fb.py:2304 (_VanillaSpec :456)",
              vlong_counts["wavefront_fwd_tiled_vanilla"], 1, exact,
              "vanilla_fwd_tiled", "vanilla_fwd_tiled",
              main="vanilla_fwd_tiled_main"),
        entry("wavefront_bwd_tiled_vanilla",
              "cpecan_tpu/ops/pallas_fb.py:2332 (_VanillaSpec :456)",
              vlong_counts["wavefront_bwd_tiled_vanilla"], 1, exact,
              "vanilla_bwd_tiled", "vanilla_bwd_tiled",
              main="vanilla_bwd_tiled_main"),
        # phases 22-23 hold the five sm4 instances to plain (K1/K2, the
        # untiled select forms sm3_fwd_tiled_sel<Sm4, 0> and
        # sm3_bwd_tiled_sel<Sm4, 0, 0>: ms, plain ms and bound on the
        # fourState pipeline's first chunk, K3
        # on the trained machine's E-step group, K6a/K6b on phase 12's
        # check read, their main_ms and main_bound_ms on the 64 long
        # reads); launches from phase 23's fourState pipeline (K1/K2), the
        # E-step run (K3) and the 64 long reads (K6a/K6b)
        entry("wavefront_fwd_sm4",
              "cpecan_tpu/ops/pallas_fb.py:635 (_Sm4Spec :257)",
              sm4_pipe_counts["wavefront_fwd_sm4"], 3, exact, "sm4_fwd",
              "sm4_fwd"),
        entry("wavefront_bwd_sm4",
              "cpecan_tpu/ops/pallas_fb.py:857 (_Sm4Spec :257)",
              sm4_pipe_counts["wavefront_bwd_sm4"], 3, exact, "sm4_bwd",
              "sm4_bwd"),
        entry("wavefront_bwd_exp_sm4",
              "cpecan_tpu/ops/pallas_fb.py:2221 (with_exp=True, _Sm4Spec "
              ":275)", sm4_exp_counts["wavefront_bwd_exp_sm4"], 1, sm4_exp_err,
              "sm4_bwd_exp", "sm4_bwd_exp"),
        entry("wavefront_fwd_tiled_sm4",
              "cpecan_tpu/ops/pallas_fb.py:2304 (_Sm4Spec :257)",
              sm4_long_counts["wavefront_fwd_tiled_sm4"], 1, exact,
              "sm4_fwd_tiled", "sm4_fwd_tiled", main="sm4_fwd_tiled_main"),
        entry("wavefront_bwd_tiled_sm4",
              "cpecan_tpu/ops/pallas_fb.py:2332 (_Sm4Spec :257)",
              sm4_long_counts["wavefront_bwd_tiled_sm4"], 1, exact,
              "sm4_bwd_tiled", "sm4_bwd_tiled", main="sm4_bwd_tiled_main"),
        # phase 24 holds the pre-pass and K1/K2 echelon to plain (ms,
        # plain ms and bound on the first chunk of bench.py's echelon
        # cell: ms, plain ms and the bound each the whole wrapper, its
        # pre-pass included; recurrence_ms the recurrence alone on the
        # pre-pass's plane; the pre-pass's ms the mean of its two
        # offsets); launches from phase 25's main path
        dict(entry("wavefront_fwd_echelon",
                   "cpecan_tpu/ops/pallas_fb.py:635 (_EchelonSpec :528)",
                   ech_counts["wavefront_fwd_echelon"], 3,
                   ech_err["fwd plane"], "echelon_fwd", "echelon_fwd"),
             recurrence_ms=ms["echelon_fwd_recurrence"]),
        dict(entry("wavefront_bwd_echelon",
                   "cpecan_tpu/ops/pallas_fb.py:857 (_EchelonSpec :528)",
                   ech_counts["wavefront_bwd_echelon"], 3,
                   max(ech_err["posteriors"], ech_err["totals"]),
                   "echelon_bwd", "echelon_bwd"),
             recurrence_ms=ms["echelon_bwd_recurrence"]),
        entry("wavefront_emissions_echelon",
              "none: the emission half of K1/K2 echelon's body "
              "(cpecan_tpu/ops/pallas_fb.py:528-620, _EchelonSpec)",
              ech_counts["wavefront_emissions_echelon"], 3,
              max(ech_err["pre-pass k=0"], ech_err["pre-pass k=1"]),
              "echelon_emissions", "echelon_emissions"),
        # phase 27 holds K1/K2 hdp to plain on the first chunk of bench.py's
        # HDP cell (ms, plain ms and bound there), K3 hdp on the first
        # group of the E-step; launches from phase 28's main path and
        # E-step
        entry("wavefront_fwd_hdp",
              "cpecan_tpu/ops/pallas_fb.py:635 (_HdpSpec :2829)",
              hdp_counts["wavefront_fwd_hdp"], 3, exact, "hdp_fwd", "hdp_fwd"),
        entry("wavefront_bwd_hdp",
              "cpecan_tpu/ops/pallas_fb.py:857 (_HdpSpec :2829)",
              hdp_counts["wavefront_bwd_hdp"], 3, exact, "hdp_bwd", "hdp_bwd"),
        entry("wavefront_bwd_exp_hdp",
              "cpecan_tpu/ops/pallas_fb.py:2221 (with_exp=True, _HdpSpec "
              ":2829)", hexp_counts["wavefront_bwd_exp_hdp"], 4, hdp_exp_err,
              "hdp_bwd_exp", "hdp_bwd_exp"),
    ]}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
