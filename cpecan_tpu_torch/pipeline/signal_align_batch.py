"""signalAlign-equivalent batch driver of the port (counterpart of
``cpecan_tpu/pipeline/signal_align_batch.py::run_batch_fast``, :72-442).

Aligns a set of npReads to a reference, both strands of every read, and
writes each read's 15-column posterior tsv (writePosteriorProbs), for the
threeState (strawman), vanilla (signalAlign's default), fourState and
echelon machines, on the wavefront kernels.  The reference runs one
vanillaAlign process per read (scripts/signalAlign.py:101-141); here reads
go through the aligner in chunks, a chunk's two strand runs in a handful
of kernel launches with per-read model scaling on the device.

Not ported: data-parallel runs over a mesh (ROADMAP Queue 1 item 9), fast5
inputs (``prepare_fast5_reads``, item 8b) and ``run_batch``, the per-read
scan-engine batch (item 8b, after the scan engine, item 7).
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..align import AlignmentParams
from ..cli.realign import (convert_alignment_to_anchor_pairs,
                           rebase_coordinates)
from ..cli.signal_align import (_native_tsv, get_remapped_anchor_pairs,
                                make_event_slice, tsv_formatter,
                                write_posterior_probs)
from ..constants import COMPLEMENT, KMER_LENGTH, TEMPLATE
from ..io.cigar import parse_cigar_line
from ..io.fasta import reverse_complement
from ..io.npread import load_npread
from ..io.poremodel import load_pore_model, scale_model
from ..models.hmm import ContinuousPairHmm, VanillaHmm
from ..models.state_machines import (StateMachine3SignalStrawman,
                                     StateMachine3Vanilla, StateMachine4,
                                     StateMachineEchelon)
from ..ops.anchors import filter_to_remove_overlap
from ..ops.band import make_band, make_bands
from ..ops.compact import (extract_echelon_pairs_chunk, extract_pairs_chunk,
                           fetch)
from ..ops.fb import (EchelonAligner, Sm4Aligner, StrawmanAligner,
                      VanillaAligner, _call)
from ..ops.fb_kernels import post_planes

ALIGNERS = {"threeState": StrawmanAligner, "vanilla": VanillaAligner,
            "fourState": Sm4Aligner, "echelon": EchelonAligner}
# reads per kernel group at most (the JAX package's compiled group); a
# smaller batch takes one group of its own size
MAX_GROUP = 32
# tsv writer threads per chunk (file IO and the native formatter release
# the GIL)
WRITERS = 8


def run_batch(*_args, **_kwargs):
    """The per-read scan-engine batch (``run_batch``, JAX :445-475)."""
    raise NotImplementedError(
        "run_batch drives the per-read scan engine, which is not ported "
        "(ROADMAP Queue 1 item 8b, after the scan engine, item 7); use "
        "run_batch_fast")


def run_batch_fast(reference_path, npread_guide_pairs, out_dir, *,
                   template_model_file, complement_model_file,
                   in_template_hmm=None, in_complement_hmm=None,
                   threshold=0.01, params=None, group=None, compact_k=4096,
                   log=print, device="cuda", aligner=None,
                   sm_type="threeState", chunk=64, mesh=None, stage=None):
    """Batched signalAlign on the wavefront kernels: ``npread_guide_pairs``
    [(npRead path, guide cigar line)] against the one-line reference in
    ``reference_path``; writes ``<out_dir>/<label>.tsv`` per read (label:
    the npRead's base name) and returns [(label, ok, message)].

    ``sm_type``: 'threeState', 'vanilla', 'fourState' or 'echelon' (its
    multi-state posteriors expand to pairs through
    ``extract_echelon_pairs_chunk``); ``in_*_hmm`` load trained transitions
    and k-mer gap probabilities (vanilla: skip bins) as vanillaAlign does
    (echelon has no HMM to load and refuses one).
    ``device`` is where the aligner runs (the card's CUDA kernels by
    default, ``"cpu"`` their plain versions); ``aligner`` reuses an aligner
    of the machine's class, ``group`` is its R (None: MAX_GROUP, or the
    number of reads when fewer).

    Same per-read preprocessing as the JAX driver (guide trimming, event
    slicing, anchor rebasing: vanillaAlign.c:463-530) and the same cheap
    anchor checks, so that one bad read is logged and skipped, not fatal;
    bands are built once per strand over the batch (per read where the
    batch fails, to drop the reads at fault).  Reads go in ``chunk``-sized
    slices, drained one chunk behind: chunk k+1's kernels are queued
    before chunk k's compaction is waited for (``run`` starts each copy to
    the host, pinned and non-blocking, behind its kernels and returns), so
    that chunk k's pair extraction and tsv writing overlap chunk k+1's
    kernels.  A shape hint pinned to the whole batch keeps every chunk's
    geometry.  A chunk that fails is re-run one read at a time, and a read
    that fails then is recorded as failed.

    ``stage(name, fn)``, when given, runs each step and returns ``fn()``:
    "load" (per-read preprocessing), "bands", "chunk" (a chunk's two strand
    runs), "fetch" (waiting for the compaction on the host), "extract" and
    "write"; posteriors are normalized by the exact per-read total, as in
    the JAX driver.  The per-read scale parameters scale the match model
    and, for echelon, the k-mer skip bins too (``EchelonAligner``)."""
    if sm_type not in ALIGNERS:
        raise ValueError("run_batch_fast supports sm_type 'threeState', "
                         "'vanilla', 'fourState' or 'echelon'")
    if sm_type == "echelon" and (in_template_hmm or in_complement_hmm):
        # the reference defines no echelon EM (its expectation hook is
        # NULL, impl/stateMachine.c:1831); refused before any work, where
        # the JAX driver refuses it after loading the reads
        raise ValueError("echelon has no trainable HMM to load")
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel runs over a mesh are not ported yet (ROADMAP "
            "Queue 1 item 9)")
    stage = stage or _call
    params = params or AlignmentParams(threshold=threshold)
    os.makedirs(out_dir, exist_ok=True)
    with open(reference_path) as fh:
        reference_seq = fh.readline().strip()

    jobs, sps, meta, hint = stage("load", lambda: _load_reads(
        reference_seq, npread_guide_pairs, params, log))
    if not meta:
        return []
    bands_all = stage("bands", lambda: _batch_bands(jobs, sps, meta, params,
                                                    log))
    if not meta:
        return []

    pa = aligner if aligner is not None else ALIGNERS[sm_type](
        params, device=device,
        group=min(MAX_GROUP, len(meta)) if group is None else group)
    sms, models = {}, {}
    for strand, model_file, hmm_file in (
            (TEMPLATE, template_model_file, in_template_hmm),
            (COMPLEMENT, complement_model_file, in_complement_hmm)):
        sm, models[strand] = _strand_machine(sm_type, model_file, hmm_file,
                                             strand)
        sms[strand] = sm.to(pa.device)
    log(f"tsv formatter: {tsv_formatter()}")

    # per-(strand, read-params) scaled match model, memoized: reads of one
    # pore/run share scalings, and the tsv writer needs only the table
    scaled_memo = {}

    def scaled_match_model(strand, npp):
        key = (strand, npp.scale, npp.shift, npp.var, npp.scale_sd,
               npp.var_sd)
        m = scaled_memo.get(key)
        if m is None:
            m = scale_model(models[strand], npp.scale, npp.shift, npp.var,
                            npp.scale_sd, npp.var_sd).match_model
            scaled_memo[key] = m
        return m

    def chunk_outputs(idxs):
        return {strand: pa.run(
            sms[strand], [jobs[strand][i] for i in idxs],
            compact_k=compact_k,
            scale_params=np.asarray([sps[strand][i] for i in idxs]),
            ragged_left=True, ragged_right=True, shape_hint=hint,
            bands=[bands_all[strand][i] for i in idxs])
            for strand in (TEMPLATE, COMPLEMENT)}

    def drain(idxs, outs):
        """Write the chunk's tsvs; returns its result rows (the caller
        keeps them only on full success, so that the isolation retry can
        re-run a failed chunk without duplicating rows)."""
        stage("fetch", lambda: [fetch(o) for o in outs.values()])
        # one vectorized extraction per strand over the whole chunk, rows
        # in the tsv's stable diagonal order
        extract = (extract_echelon_pairs_chunk if post_planes(pa.spec)
                   else extract_pairs_chunk)
        aps = stage("extract", lambda: {
            strand: extract(
                out, list(range(len(idxs))),
                [out["prep"]["bands"][rel].n_diag
                 for rel in range(len(idxs))], params.threshold)
            for strand, out in outs.items()})

        def write_read(rel, i):
            m = meta[i]
            n_pairs = {}
            with open(os.path.join(out_dir, m["label"] + ".tsv"), "w") as fh:
                for strand in (TEMPLATE, COMPLEMENT):
                    ap = aps[strand][rel]
                    n_pairs[strand] = len(ap)
                    np_read = m["np_read"]
                    npp, full_events, target = (
                        (np_read.template_params, np_read.template_events,
                         m["trimmed"]) if strand == TEMPLATE else
                        (np_read.complement_params,
                         np_read.complement_events, m["rc_trimmed"]))
                    write_posterior_probs(
                        fh, m["label"], scaled_match_model(strand, npp),
                        npp.scale, npp.shift, full_events, target,
                        m["forward"], m["contig"], m["ev_off"][strand],
                        m["r_shift"][strand], ap, strand)
            return (m["label"], True,
                    f"t={n_pairs[TEMPLATE]} c={n_pairs[COMPLEMENT]}")

        def write_all():
            # build the native formatter before any writer thread calls it
            _native_tsv()
            if len(idxs) == 1:
                return [write_read(0, idxs[0])]
            with ThreadPoolExecutor(max_workers=WRITERS) as pool:
                return list(pool.map(write_read, range(len(idxs)), idxs))

        return stage("write", write_all)

    results = []

    def drain_isolated(idxs, outs):
        """Chunk-level failure isolation (the reference's per-read
        try/except, scripts/signalAlign.py:52-58): a failed chunk re-runs
        one read at a time; a read that fails alone is recorded as failed,
        never fatal."""
        try:
            results.extend(drain(idxs, outs))
            return
        except Exception as exc:
            log(f"chunk of {len(idxs)} failed ({exc}); isolating reads")
        for i in idxs:
            try:
                results.extend(drain([i], stage("chunk", lambda: (
                    chunk_outputs([i])))))
            except Exception as exc:
                results.append((meta[i]["label"], False, str(exc)))
                log(f"alignment failed for {meta[i]['label']}: {exc}")

    pending = None
    for i0 in range(0, len(meta), chunk):
        idxs = list(range(i0, min(i0 + chunk, len(meta))))
        outs = stage("chunk", lambda: chunk_outputs(idxs))
        if pending is not None:
            # the host work of the last chunk overlaps this chunk's kernels
            drain_isolated(*pending)
        pending = (idxs, outs)
    if pending is not None:
        drain_isolated(*pending)
    return results


def _load_reads(reference_seq, npread_guide_pairs, params, log):
    """Per-read preprocessing (JAX :148-228): (jobs {strand: [(target,
    events, l_x, l_y, anchors)]}, scale params {strand: [[5]]}, meta [per
    read], the batch-wide shape hint (max l_x, max l_x + l_y)).  A read
    that cannot be loaded or whose anchors fail the cheap checks is logged
    and skipped."""
    jobs = {TEMPLATE: [], COMPLEMENT: []}
    sps = {TEMPLATE: [], COMPLEMENT: []}
    meta = []
    hint_lx = hint_nd = 0
    for npread_path, guide_cigar in npread_guide_pairs:
        label = os.path.basename(npread_path).replace(".npRead", "")
        try:
            np_read = load_npread(npread_path)
            aln = parse_cigar_line(guide_cigar.strip())
        except Exception as exc:
            log(f"could not load {label}: {exc}")
            continue
        if aln.strand1:
            trimmed = reference_seq[aln.start1:aln.end1]
        else:
            trimmed = reverse_complement(reference_seq[aln.end1:aln.start1])
        rc_trimmed = reverse_complement(trimmed)
        t_events, t_off = make_event_slice(
            np_read.template_events, aln.start2, aln.end2,
            np_read.template_event_map)
        c_events, c_off = make_event_slice(
            np_read.complement_events, aln.start2, aln.end2,
            np_read.complement_event_map)
        map_offset = aln.start2
        aln2 = dataclasses.replace(aln, operations=list(aln.operations))
        ref_shift = aln2.start1 if aln2.strand1 else aln2.end1
        rebase_coordinates(aln2, 1, -ref_shift, not aln2.strand1)
        anchors = filter_to_remove_overlap(sorted(
            convert_alignment_to_anchor_pairs(
                aln2, params.constraint_diagonal_trim)))
        try:
            strand_jobs = []
            for strand, target, events, emap, npp in (
                    (TEMPLATE, trimmed, t_events,
                     np_read.template_event_map, np_read.template_params),
                    (COMPLEMENT, rc_trimmed, c_events,
                     np_read.complement_event_map,
                     np_read.complement_params)):
                l_x = max(len(target) - (KMER_LENGTH - 1), 0)
                remapped = get_remapped_anchor_pairs(anchors, emap,
                                                     map_offset)
                # cheap anchor and shape checks, so that one bad read cannot
                # fail the batch's band construction
                a = np.asarray(remapped, np.int64).reshape(-1, 2)
                if len(a) and not (
                        np.all(np.diff(a[:, 0]) > 0)
                        and np.all(np.diff(a[:, 1]) > 0)
                        and a[0, 0] >= 0 and a[0, 1] >= 0
                        and a[-1, 0] < l_x and a[-1, 1] < len(events)):
                    raise ValueError("anchors must be strictly increasing "
                                     "and in range")
                if l_x + 130 >= 2 ** 15:
                    raise ValueError(f"reference length {l_x} exceeds the "
                                     "int16 band-metadata range")
                hint_lx = max(hint_lx, l_x)
                hint_nd = max(hint_nd, l_x + len(events))
                strand_jobs.append((strand, (target, events, l_x,
                                             len(events), remapped),
                                    [npp.scale, npp.shift, npp.var,
                                     npp.scale_sd, npp.var_sd]))
        except Exception as exc:
            log(f"skipping {label}: {exc}")
            continue
        for strand, job, sp in strand_jobs:
            jobs[strand].append(job)
            sps[strand].append(sp)
        meta.append(dict(label=label, np_read=np_read, forward=aln.strand1,
                         contig=aln.contig1, trimmed=trimmed,
                         rc_trimmed=rc_trimmed,
                         r_shift={TEMPLATE: aln.start1,
                                  COMPLEMENT: aln.end1},
                         ev_off={TEMPLATE: t_off, COMPLEMENT: c_off}))
    return jobs, sps, meta, (hint_lx, hint_nd)


def _batch_bands(jobs, sps, meta, params, log):
    """Band geometry once per strand over the whole batch (JAX :230-262);
    where that fails, per read, dropping (from ``jobs``, ``sps`` and
    ``meta``, in place) each read whose band cannot be built.  Returns
    {strand: [BandGeometry]}."""
    def build():
        return {s: make_bands([j[4] for j in jobs[s]],
                              [j[2] for j in jobs[s]],
                              [j[3] for j in jobs[s]],
                              params.diagonal_expansion)
                for s in (TEMPLATE, COMPLEMENT)}

    try:
        return build()
    except ValueError:
        pass
    bad = set()
    for i, m in enumerate(meta):
        for s in (TEMPLATE, COMPLEMENT):
            j = jobs[s][i]
            try:
                make_band(j[4], j[2], j[3], params.diagonal_expansion)
            except ValueError as exc:
                log(f"skipping {m['label']}: {exc}")
                bad.add(i)
                break
    keep = [i for i in range(len(meta)) if i not in bad]
    meta[:] = [meta[i] for i in keep]
    for s in (TEMPLATE, COMPLEMENT):
        jobs[s] = [jobs[s][i] for i in keep]
        sps[s] = [sps[s][i] for i in keep]
    return build() if meta else {}


def _strand_machine(sm_type, model_file, hmm_file, strand):
    """(machine, unscaled pore model) of one strand: buildStateMachine +
    loadHmmRoutine (vanillaAlign.c:104-138), each read scaled on the
    device."""
    model = load_pore_model(model_file)
    if sm_type == "echelon":
        # no HMM to load (run_batch_fast refuses one)
        return StateMachineEchelon(model), model
    if sm_type == "vanilla":
        skip_bins = (VanillaHmm.load(hmm_file).kmer_skip_bins
                     if hmm_file else None)
        return StateMachine3Vanilla(
            model, skip_bin_probs=skip_bins,
            strand="template" if strand == TEMPLATE
            else "complement"), model
    p = gap_x = None
    if hmm_file:
        hmm = ContinuousPairHmm.load(hmm_file)
        p, gap_x = (hmm.to_sm4_params() if sm_type == "fourState"
                    else hmm.to_sm3_params())
    if sm_type == "fourState":
        return StateMachine4(model, params=p, gap_x_log_probs=gap_x), model
    return StateMachine3SignalStrawman(model, params=p,
                                       gap_x_log_probs=gap_x), model
