"""Smoke run of the PyTorch/CUDA port (cpecan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ and drives the strawman signal-alignment
fast path through them:

1. versions, the card's name and power limit;
2. the kernel build (nvcc, ptxas register report);
3. each kernel against its plain PyTorch version on the card, on the first
   64-read chunk of the bench batch (256 reads x 905 bases x 800 events,
   seed 7), with the tolerances of cpecan_tpu_torch/parity.py, and the
   pair sets extracted from both;
4. the Zymo MinION read against the f64 scan engine's stored pairs;
5. the main path at bench scale: StrawmanAligner(group=64).run over chunks
   of 64 reads, compact_k=1024, then extract_pairs_chunk; end-to-end
   alignments/s and band cells/s (median of 3 after a warm-up), with the
   kernels' launch counts;
6. forward + backward device time on the whole batch, kernels vs plain;
7. the EM expectation backward against its plain version on the first 32
   bench reads (ragged ends, per-read scaling), with the untrained machine
   and with the Zymo fixture's trained one (Y -> X open): forward planes,
   posteriors, totals and transition sums equal bit for bit, gap-X
   columns within parity.KERNEL_GAPX_ATOL, the finalized expectations of
   both, and their times;
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
   peak device memory and the launch counts; then K6a/K6b against their
   plain versions on its inputs (bit for bit) and their ms per launch.

Each path's launch counts are read from a run that starts with every
count at 0.  Any failed check raises (exit code != 0).  The last three
lines are a JSON record of the kernels (times, launches, the least time
the card could take and what bounds it), the card's name and power
limit, and {"ok": true, "device": ...}.  Exits with 2 and prints no
result when no CUDA device is present.
"""

import importlib.metadata
import json
import os
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
DEVICE = "cuda"
# H100 SXM data-sheet peaks (dense, 700 W): the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per band cell and diagonal, counted from the kernels'
# arithmetic (an exp or log counts one): emissions 34, a piecewise-cubic
# log_add 38, the forward update 205, the backward update and posterior
# 211, the expectation targets 110 more
FLOPS_PER_CELL = dict(fwd=240, bwd=245, bwd_exp=355)


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


def bound(tensors, cells, flops_per_cell):
    """(least ms the card could take, "bytes" or "operations"): every
    tensor read or written once at HBM_BYTES_PER_S, against the f32
    operations of ``cells`` band cells at F32_FLOPS_PER_S."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cells * flops_per_cell / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.fixtures import (load_long_read, load_zymo_slice,
                                           load_zymo_train,
                                           zymo_trained_params)
    from cpecan_tpu_torch.models.state_machines import \
        StateMachine3SignalStrawman
    from cpecan_tpu_torch.ops import fb_kernels as fk
    from cpecan_tpu_torch.ops.compact import (compact_chunks,
                                              compact_posteriors,
                                              extract_pairs_auto,
                                              extract_pairs_chunk)
    from cpecan_tpu_torch.ops.cuda_build import build_info, load_library
    from cpecan_tpu_torch.ops.compact import host_array
    from cpecan_tpu_torch.ops.fb import (StrawmanAligner, exp_dispatch,
                                         exp_finalize)
    from cpecan_tpu_torch.parity import (band_mask, check_exp_kernel,
                                         check_expectations, check_fwd,
                                         check_long_pairs, check_pairs,
                                         check_posts, check_tiled,
                                         check_tiled_pairs, check_totals,
                                         check_trained)
    from cpecan_tpu_torch.pipeline.train_models import (
        TrainOptions, add_and_norm_expectations, strand_expectations, train)
    from cpecan_tpu_torch.synthetic import long_signal_read, synthetic_batch

    def same(what, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{what} differs from the plain version by "
                                 f"{float((got - want).abs().max())}")

    dev = torch.device(DEVICE)
    thr = AlignmentParams().threshold
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
    t0 = time.perf_counter()
    load_library()
    path, build_s, build_log = build_info()
    log(f"build: {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {'%.2f s' % build_s if build_s is not None else 'cached'})")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 3. kernels vs plain on the first bench chunk --------------------
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
        bwd=bound(bargs + [fwd_k, posts_k, tot_k], cells,
                  FLOPS_PER_CELL["bwd"]))
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

    # where one main-path pass spends its time: the run's stages, each
    # ended by a synchronize (run() itself overlaps nothing across them)
    stages = dict.fromkeys(("prepare", "inputs", "fwd", "bwd", "compact",
                            "extract"), 0.0)

    def stage(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        stages[name] += time.perf_counter() - t0
        return res

    for i in range(0, len(reads), CHUNK):
        sprep = stage("prepare", lambda: pa.prepare(sm, reads[i:i + CHUNK]))
        sinp = stage("inputs", lambda: pa.device_inputs(sm, sprep))
        sd = dict(R=sprep["R"], W=sprep["W"], ND=sprep["ND"], C=sprep["C"])
        sa = [sinp[k] for k in ("scal", "win", "xf", "yf", "basef",
                                "widthf")]
        sfwd = stage("fwd", lambda: fk.wavefront_fwd(*sa, **sd))
        sposts, _ = stage("bwd", lambda: fk.wavefront_bwd(
            *sa, sinp["seedf"], sinp["raggedf"], sfwd, **sd))
        scomp = stage("compact", lambda: compact_posteriors(
            sposts, min(COMPACT_K, sd["ND"] * sd["W"])))
        sout = dict(prep=sprep, posteriors=sposts, compact=scomp)
        snd = [b.n_diag for b in sprep["bands"]]
        stage("extract", lambda: extract_pairs_chunk(
            sout, list(range(len(snd))), snd, thr))
    total_s = sum(stages.values())
    log("main path stages (s, share): " + ", ".join(
        f"{k} {v:.4f} ({v / total_s:.1%})" for k, v in stages.items()))

    # -- 6. device-only fwd+bwd, whole batch -----------------------------
    bprep = pa.prepare(sm, reads)
    binp = pa.device_inputs(sm, bprep)
    bdims = dict(R=bprep["R"], W=bprep["W"], ND=bprep["ND"], C=bprep["C"])
    ba = [binp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    bb = ba + [binp["seedf"], binp["raggedf"]]

    def once(fwd_fn, bwd_fn):
        return bwd_fn(*bb, fwd_fn(*ba, **bdims), **bdims)

    dev_ms = cuda_ms(lambda: once(fk.wavefront_fwd, fk.wavefront_bwd), 3)
    plain_ms = cuda_ms(lambda: once(fk.forward_plain, fk.backward_plain), 1,
                       warm=False)
    bcells = sum(int(b.width.sum()) for b in bprep["bands"])
    log(f"device fwd+bwd ({len(reads)} reads, G={len(bprep['win'])}): "
        f"kernels {dev_ms:.3f} ms ({bcells / dev_ms * 1e3:.4g} band "
        f"cells/s), plain {plain_ms:.1f} ms "
        f"({bcells / plain_ms * 1e3:.4g} band cells/s)")
    torch.cuda.synchronize()

    # -- 7. K3 vs plain on the first 32 bench reads, training inputs -----
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
        pfwd = fk.forward_plain(*mb[:6], **edims)
        if not torch.equal(efwd, pfwd):
            raise AssertionError(
                f"{name} machine: forward kernel differs from its plain "
                f"version by {float((efwd - pfwd).abs().max())}")
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
            f"ragged, scaled, ND={edims['ND']}, W={edims['W']}): fwd, "
            f"posts, totals, trans equal; gapx max|d| {e_gap:.3g}; Y -> X "
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

    # where one E-step spends its time, each stage ended by a synchronize
    est = dict.fromkeys(("prepare", "inputs", "fwd", "bwd_exp",
                         "dispatch+D2H", "finalize"), 0.0)

    def estage(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        est[name] += time.perf_counter() - t0
        return res

    sprep = estage("prepare", lambda: epa.prepare(sm, em_sub,
                                                  ragged_right=True))
    sinp = estage("inputs", lambda: epa.device_inputs(sm, sprep,
                                                      ragged_left=True))
    sd = dict(R=sprep["R"], W=sprep["W"], ND=sprep["ND"], C=sprep["C"])
    sb = [sinp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf",
                            "seedf", "raggedf")]
    sfwd = estage("fwd", lambda: fk.wavefront_fwd(*sb[:6], **sd))
    sout = estage("bwd_exp", lambda: fk.wavefront_bwd_exp(*sb, sfwd, **sd))
    flat = estage("dispatch+D2H", lambda: host_array(exp_dispatch(
        sout[2], sout[3], sout[1])))
    estage("finalize", lambda: exp_finalize(sprep, flat))
    est_total = sum(est.values())
    log("E-step stages (s, share): " + ", ".join(
        f"{k} {v:.4f} ({v / est_total:.1%})" for k, v in est.items()))
    torch.cuda.synchronize()

    # -- 10. K6a/K6b vs plain on the first bench chunk, 14 tiles ----------
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
    lbig_tiled = lbig["tiled"]
    del lbig
    torch.cuda.synchronize()

    lst = dict.fromkeys(("prepare", "inputs", "fwd_tiled", "bwd_tiled",
                         "compact", "extract"), 0.0)

    def lstage(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        lst[name] += time.perf_counter() - t0
        return res

    sprep = lstage("prepare", lambda: la.prepare(
        lsm, lreads, tile_diag=lbig_tiled["TD"]))
    sinp = lstage("inputs", lambda: la.device_inputs(lsm, sprep))
    stl = sprep["tiled"]
    sd = dict(R=sprep["R"], W=sprep["W"], ND=stl["NDT"], C=sprep["C"],
              TD=stl["TD"])
    sa = [sinp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    sb = sa + [sinp["seedf"], sinp["raggedf"]]
    sfwd, ssh = lstage("fwd_tiled", lambda: fk.wavefront_fwd_tiled(*sa,
                                                                     **sd))
    sposts, stot = lstage("bwd_tiled", lambda: fk.wavefront_bwd_tiled(
        *sb, sfwd, ssh, **sd))
    schunks = lstage("compact", lambda: compact_chunks(
        sposts, stl["DC"], min(LONG_COMPACT_K, stl["DC"] * sd["W"])))
    snd = [b.n_diag for b in sprep["bands"]]
    lstage("extract", lambda: extract_pairs_chunk(
        dict(prep=sprep, posteriors=sposts, tiled=stl,
             compact_chunks=schunks), list(range(len(snd))), snd, thr))
    ltotal = sum(lst.values())
    log("long path stages (s, share): " + ", ".join(
        f"{k} {v:.4f} ({v / ltotal:.1%})" for k, v in lst.items()))
    # K6a/K6b against their plain versions on the main path's inputs
    (pfwd, psh), ms["fwd_long_plain"] = timed(
        lambda: fk.forward_tiled_plain(*sa, **sd))
    same("K6a fwd plane (long path)", sfwd, pfwd)
    same("K6a shifts (long path)", ssh, psh)
    del pfwd
    (pposts, ptot), ms["bwd_long_plain"] = timed(
        lambda: fk.backward_tiled_plain(*sb, sfwd, ssh, **sd))
    same("K6b posteriors (long path)", sposts, pposts)
    same("K6b totals (long path)", stot, ptot)
    del pposts
    ms.update(
        fwd_long=cuda_ms(lambda: fk.wavefront_fwd_tiled(*sa, **sd), 3),
        bwd_long=cuda_ms(lambda: fk.wavefront_bwd_tiled(
            *sb, sfwd, ssh, **sd), 3))
    long_cells = sum(int(b.width.sum()) for b in sprep["bands"])
    bounds.update(
        fwd_long=bound(sa + [sfwd, ssh], long_cells, FLOPS_PER_CELL["fwd"]),
        bwd_long=bound(sb + [sfwd, ssh, sposts, stot], long_cells,
                       FLOPS_PER_CELL["bwd"]))
    log(f"long path kernels ({LONG_READS} reads, G={len(sprep['win'])}, "
        f"NDT={stl['NDT']}, W={sd['W']}, {long_cells} band cells): "
        f"K6a {ms['fwd_long']:.3f} ms, K6b {ms['bwd_long']:.3f} ms per "
        f"launch, equal to their plain versions bit for bit (plain "
        f"{ms['fwd_long_plain']:.1f} / {ms['bwd_long_plain']:.1f} ms); "
        f"bounds K6a {bounds['fwd_long'][0]:.4f} ms "
        f"({bounds['fwd_long'][1]}), K6b {bounds['bwd_long'][0]:.4f} ms "
        f"({bounds['bwd_long'][1]})")
    del sfwd, sposts
    torch.cuda.synchronize()

    src = "cpecan_tpu_torch/csrc/wavefront.cu"

    def entry(name, replaces, launches, err, key, bkey):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms[key],
                "plain_ms": ms[key + "_plain"],
                "bound_ms": bounds[bkey][0], "bound_by": bounds[bkey][1],
                # no single PyTorch call computes a banded pair-HMM
                # wavefront
                "library_ms": None}

    exact = 0.0   # phases 3, 10 and 12 hold these kernels bit for bit
    log(json.dumps({"kernels": [
        entry("wavefront_fwd", "cpecan_tpu/ops/pallas_fb.py:635",
              launches["wavefront_fwd"], exact, "fwd", "fwd"),
        entry("wavefront_bwd", "cpecan_tpu/ops/pallas_fb.py:857",
              launches["wavefront_bwd"], exact, "bwd", "bwd"),
        entry("wavefront_bwd_exp",
              "cpecan_tpu/ops/pallas_fb.py:2221 (with_exp=True)",
              em_launches["wavefront_bwd_exp"], exp_err, "bwd_exp",
              "bwd_exp"),
        entry("wavefront_fwd_tiled", "cpecan_tpu/ops/pallas_fb.py:2304",
              long_launches["wavefront_fwd_tiled"], exact, "fwd_long",
              "fwd_long"),
        entry("wavefront_bwd_tiled", "cpecan_tpu/ops/pallas_fb.py:2332",
              long_launches["wavefront_bwd_tiled"], exact, "bwd_long",
              "bwd_long"),
    ]}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
