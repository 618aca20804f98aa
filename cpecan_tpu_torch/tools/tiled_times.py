"""Time kernels as built from several source trees, on the inputs of
``chip_smoke.py``, one path at a time (``--path``):

- ``long`` (the default): the tiled pair (K6a, K6b) of the strawman,
  vanilla and fourState machines on the inputs of phases 12, 21 and 22:
  the 64 long reads (``long_signal_read`` of the fixture long read's
  lengths, seeds 11..74, group 8) and the 1,500 x 2,550 check read (seed
  11, the long reads' tile);
- ``echelon``: the untiled echelon pair (K1 and K2 echelon) on phase 24's
  inputs: the first 32-read chunk of bench.py's echelon cell
  (``echelon_batch``'s 64 reads, group 32, with phase 25's shape hint).
  For a tree with the emission pre-pass (``echelon_emissions``) the
  pre-pass at both offsets and each recurrence alone on its plane are
  timed too;
- ``posterior``: the untiled signal pairs (K1 and K2 strawman, K1 and K2
  vanilla) on the inputs of phases 3/5 and 19/20: each 64-read chunk of
  bench.py's 256 signal reads (``synthetic_batch(256, 905, 800, seed=7)``,
  group 64; ND 1,700, W 128) as the strawman main path runs it, and the
  same chunks on the default vanilla machine of the vendored template
  model.  Chunk 0 is the chunk whose kernel ms ``chip_smoke.py`` reports;
- ``hdp``: the HDP pair (K1 and K2 hdp) on the inputs of phases 27/28:
  each 64-read chunk of bench.py's HDP cell (the same 256 reads, group 64,
  on ``synthetic.hdp_model()``), the model and each chunk's emission
  stream built once and handed to every tree;
- ``realign``: the untiled dna5 pair (K1 and K2 dna5) on the inputs of
  phases 13 and 15: bench.py's realign batch (``dna_realign_batch()``: 64
  x 2 kb pairs, ``random.Random(11)``), group 32, ragged at both ends:
  each 32-pair chunk as phase 15's ``Dna5Aligner.run`` stages it (the
  shape hint of all 64 pairs).  Chunk 0 equals phase 13's chunk (staged
  without the hint), whose kernel ms ``chip_smoke.py`` reports;
- ``fourstate``: the untiled sm4 pair (K1 and K2 sm4) on phase 23's
  fourState pipeline chunks: ``run_batch_fast(sm_type="fourState")`` on
  64 copies of the Zymo read (``fixtures.load_batch_zymo``, each guided
  by the stored guide renamed to it), group 32, chunk 64, every run of
  the aligner (each strand's chunk) recorded through a ``stage`` hook
  once.  The template strand's chunk is the chunk whose kernel ms
  ``chip_smoke.py`` reports;
- ``estep``: the expectation backward (K3) of the strawman, fourState
  and vanilla machines on the groups whose kernel ms ``chip_smoke.py``
  reports: K3 strawman on phase 7's (the first 32 of bench.py's 256
  signal reads, ragged at both ends, per-read scaling, group 32), with
  the untrained machine and with the trained one of
  ``zymo_trained_params``; K3 sm4 on phase 22's (the same 32 reads as
  ``Sm4Aligner.run(expectations=True)`` stages them, its trained-looking
  machine); K3 vanilla on phase 19's (the same 32 reads on the vendored
  template model with the skip bins of the stored JAX vanilla training,
  ``load_vanilla_zymo``); K3 hdp on phase 27's (the first 32 of the HDP
  E-step's 128 reads, the same bench reads, group 32, ragged at both ends,
  on ``synthetic.hdp_model()``; the model and the group's emission stream
  built once and handed to every tree, as ``hdp_cases`` does).  Each
  tree's K1 feeds its K3, and the fwd plane and all four K3 outputs must
  equal the first tree's.

    python cpecan_tpu_torch/tools/tiled_times.py build/parent .
    python cpecan_tpu_torch/tools/tiled_times.py --path echelon build/parent .
    python cpecan_tpu_torch/tools/tiled_times.py --path posterior \
        build/parent . . build/parent
    python cpecan_tpu_torch/tools/tiled_times.py --path hdp \
        build/parent . . build/parent
    python cpecan_tpu_torch/tools/tiled_times.py --path realign \
        build/parent . . build/parent
    python cpecan_tpu_torch/tools/tiled_times.py --path fourstate \
        build/parent . . build/parent
    python cpecan_tpu_torch/tools/tiled_times.py --path estep \
        build/parent . . build/parent

Each tree is a directory holding ``cpecan_tpu_torch`` (a parent unpacked
with ``git archive`` beside the change, say).  Each tree's own
``ops.cuda_build`` and ``ops.fb_kernels`` are loaded under a package name
of their own, so that each tree's wrappers call its own library through
its own C signatures (trees whose wrappers differ compare as they are).
Every tree's library builds at once, with its own ``NVCC_FLAGS``, into
``build/tiled_times/``.  The inputs are staged once by this tree's
aligner; then each tree's kernels launch on them in turns, ``--rounds``
rounds of every tree in order, each a mean of 3 launches after a warm-up
(CUDA events), and each tree's outputs must equal the first tree's bit
for bit.  Prints one JSON line per case (machine and read set) and tree:
the median ms of each timing over the rounds, every round's ms, ns a
diagonal, and the card's name and power limit.  Run the file by its path.
Exits 2 without a CUDA device, 1 if a build fails; imports no JAX.
"""

import argparse
import ctypes
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LONG_READS, LONG_GROUP = 64, 8
LONG_CHECK = (1500, 2550)
ECH_READS, ECH_CHUNK, ECH_THRESHOLD = 64, 32, 0.01
POST_BATCH = dict(n_reads=256, n_ref=905, n_events=800, seed=7)
POST_CHUNK = 64
HDP_CHUNK = 64
DNA_CHUNK = 32
PIPE_READS, PIPE_GROUP, PIPE_CHUNK, PIPE_COMPACT_K = 64, 32, 64, 2048
EM_GROUP = 32
HDP_E_READS = 128


def load_tree(i, tree):
    """(cuda_build, fb_kernels) of ``tree``'s package, imported as the
    package ``_tiled_times_<i>``."""
    name = f"_tiled_times_{i}"
    pkg = Path(tree).resolve() / "cpecan_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{name}.ops.cuda_build"),
            importlib.import_module(f"{name}.ops.fb_kernels"))


def build(trees, builds):
    """Build every tree's library at once and hand each to its own
    cuda_build."""
    out = ROOT / "build" / "tiled_times"
    out.mkdir(parents=True, exist_ok=True)
    libs = [out / f"tree{i}.so" for i in range(len(trees))]
    procs = [subprocess.Popen(
        [cb._nvcc(), *cb.NVCC_FLAGS, "-o", str(lib),
         str(Path(tree) / "cpecan_tpu_torch" / "csrc" / "wavefront.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tree, cb, lib in zip(trees, builds, libs)]
    for tree, cb, proc, lib in zip(trees, builds, procs, libs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"build of {tree} failed:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for name, argtypes in cb._SIGNATURES.items():
            getattr(handle, name).argtypes = argtypes
            getattr(handle, name).restype = ctypes.c_int
        handle.wavefront_error_string.argtypes = [ctypes.c_int]
        handle.wavefront_error_string.restype = ctypes.c_char_p
        cb._Library.lib, cb._Library.path = handle, lib


def long_cases(fks, dev):
    """The tiled pairs' cases: (header, ND, one (outputs, {timing: launch})
    function per tree)."""
    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.fixtures import load_long_read
    from cpecan_tpu_torch.models.state_machines import (
        StateMachine3SignalStrawman, StateMachine3Vanilla, StateMachine4)
    from cpecan_tpu_torch.ops.fb import (TILE_DIAG, Sm4Aligner,
                                         StrawmanAligner, VanillaAligner)
    from cpecan_tpu_torch.synthetic import long_signal_read

    lmodel, lread, _ = load_long_read()
    lreads = [long_signal_read(lread[2], lread[3], seed)[1]
              for seed in range(11, 11 + LONG_READS)]
    cread = long_signal_read(LONG_CHECK[0], LONG_CHECK[1], 11)[1]
    machines = (
        ("strawman", StrawmanAligner, StateMachine3SignalStrawman,
         "StrawmanSpec"),
        ("vanilla", VanillaAligner, StateMachine3Vanilla, "VanillaSpec"),
        ("fourState", Sm4Aligner, StateMachine4, "Sm4Spec"))
    for label, aligner_cls, machine_cls, spec in machines:
        aligner = aligner_cls(AlignmentParams(), device=dev,
                              group=LONG_GROUP)
        machine = machine_cls(lmodel)
        td = TILE_DIAG
        for reads_label, reads in (("64 long reads", lreads),
                                   ("check read", [cread])):
            prep = aligner.prepare(machine, reads, tile_diag=td)
            inp = aligner.device_inputs(machine, prep)
            td = prep["tiled"]["TD"]
            dims = dict(R=prep["R"], W=prep["W"], ND=prep["tiled"]["NDT"],
                        C=prep["C"], TD=td)
            fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                                   "widthf")]
            ba = fa + [inp["seedf"], inp["raggedf"]]

            def launches(fk, fa=fa, ba=ba, dims=dims, spec=spec):
                d = dict(dims, spec=getattr(fk, spec))
                fwd, sh = fk.wavefront_fwd_tiled(*fa, **d)
                posts, tot = fk.wavefront_bwd_tiled(*ba, fwd, sh, **d)
                return (fwd, sh, posts, tot), {
                    "fwd": lambda: fk.wavefront_fwd_tiled(*fa, **d),
                    "bwd": lambda: fk.wavefront_bwd_tiled(*ba, fwd, sh,
                                                          **d)}

            yield ({"machine": label, "reads": reads_label,
                    "NDT": dims["ND"], "W": dims["W"]}, dims["ND"],
                   [lambda fk=fk: launches(fk) for fk in fks])
            del fa, ba, inp, prep


def echelon_cases(fks, dev):
    """The untiled echelon pair's one case, as ``long_cases``."""
    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.ops.fb import EchelonAligner
    from cpecan_tpu_torch.synthetic import echelon_batch

    esm, ereads = echelon_batch(n_reads=ECH_READS)
    esm = esm.to(dev)
    eal = EchelonAligner(AlignmentParams(threshold=ECH_THRESHOLD),
                         device=dev, group=ECH_CHUNK)
    hint = (max(r[2] for r in ereads), eal.prepare(esm, ereads)["ND"])
    prep = eal.prepare(esm, ereads[:ECH_CHUNK], shape_hint=hint)
    inp = eal.device_inputs(esm, prep)
    R, W, ND, C = prep["R"], prep["W"], prep["ND"], prep["C"]
    fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    ba = fa + [inp["seedf"], inp["raggedf"]]

    def launches(fk):
        d = dict(R=R, W=W, ND=ND, C=C, spec=fk.EchelonSpec)
        fwd = fk.wavefront_fwd(*fa, **d)
        posts, tot = fk.wavefront_bwd(*ba, fwd, **d)
        out = {"fwd": lambda: fk.wavefront_fwd(*fa, **d),
               "bwd": lambda: fk.wavefront_bwd(*ba, fwd, **d)}
        if hasattr(fk, "echelon_emissions"):
            geo = dict(R=R, W=W, ND=ND, C=C)
            planes = [fk.echelon_emissions(fa[1], fa[2], fa[3], k=k, **geo)
                      for k in (0, 1)]
            out.update(
                prepass_k0=lambda: fk.echelon_emissions(
                    fa[1], fa[2], fa[3], k=0, **geo),
                prepass_k1=lambda: fk.echelon_emissions(
                    fa[1], fa[2], fa[3], k=1, **geo),
                fwd_recurrence=lambda: fk._launch_fwd(
                    "wavefront_fwd", *fa, R, W, ND, C, fk.EchelonSpec,
                    plane=planes[0]),
                bwd_recurrence=lambda: fk._launch_bwd(
                    "wavefront_bwd", *ba, fwd, R, W, ND, C, False,
                    fk.EchelonSpec, plane=planes[1]))
        return (fwd, posts, tot), out

    yield ({"reads": ECH_CHUNK, "ND": ND, "W": W, "R": R}, ND,
           [lambda fk=fk: launches(fk) for fk in fks])


def posterior_cases(fks, dev):
    """The untiled signal pairs' cases, one per machine and chunk, as
    ``long_cases``."""
    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.fixtures import fixture_path
    from cpecan_tpu_torch.io.poremodel import load_pore_model
    from cpecan_tpu_torch.models.state_machines import StateMachine3Vanilla
    from cpecan_tpu_torch.ops.fb import StrawmanAligner, VanillaAligner
    from cpecan_tpu_torch.synthetic import synthetic_batch

    sm, reads = synthetic_batch(**POST_BATCH)
    vsm = StateMachine3Vanilla(
        load_pore_model(fixture_path("template_median68pA.model")))
    machines = (("strawman", StrawmanAligner, sm, "StrawmanSpec"),
                ("vanilla", VanillaAligner, vsm, "VanillaSpec"))
    for label, aligner_cls, machine, spec in machines:
        aligner = aligner_cls(AlignmentParams(), device=dev,
                              group=POST_CHUNK)
        for i in range(0, len(reads), POST_CHUNK):
            prep = aligner.prepare(machine, reads[i:i + POST_CHUNK])
            inp = aligner.device_inputs(machine, prep)
            dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"],
                        C=prep["C"])
            fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                                   "widthf")]
            ba = fa + [inp["seedf"], inp["raggedf"]]

            def launches(fk, fa=fa, ba=ba, dims=dims, spec=spec):
                d = dict(dims, spec=getattr(fk, spec))
                fwd = fk.wavefront_fwd(*fa, **d)
                posts, tot = fk.wavefront_bwd(*ba, fwd, **d)
                return (fwd, posts, tot), {
                    "fwd": lambda: fk.wavefront_fwd(*fa, **d),
                    "bwd": lambda: fk.wavefront_bwd(*ba, fwd, **d)}

            yield ({"machine": label, "chunk": i // POST_CHUNK,
                    "reads": len(reads[i:i + POST_CHUNK]), "ND": dims["ND"],
                    "W": dims["W"]}, dims["ND"],
                   [lambda fk=fk: launches(fk) for fk in fks])
            del fa, ba, inp, prep


def hdp_cases(fks, dev):
    """The HDP pair's cases, one per chunk, as ``long_cases``."""
    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.ops.fb import HdpAligner
    from cpecan_tpu_torch.synthetic import hdp_model, synthetic_batch

    _, reads = synthetic_batch(**POST_BATCH)
    hsm = hdp_model()
    aligner = HdpAligner(AlignmentParams(), device=dev, group=HDP_CHUNK)
    for i in range(0, len(reads), HDP_CHUNK):
        prep = aligner.prepare(hsm, reads[i:i + HDP_CHUNK])
        inp = aligner.device_inputs(hsm, prep)
        dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"],
                    est=aligner.emission_stream(hsm, prep, inp))
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        ba = fa + [inp["seedf"], inp["raggedf"]]

        def launches(fk, fa=fa, ba=ba, dims=dims):
            d = dict(dims, spec=fk.HdpSpec)
            fwd = fk.wavefront_fwd(*fa, **d)
            posts, tot = fk.wavefront_bwd(*ba, fwd, **d)
            return (fwd, posts, tot), {
                "fwd": lambda: fk.wavefront_fwd(*fa, **d),
                "bwd": lambda: fk.wavefront_bwd(*ba, fwd, **d)}

        yield ({"machine": "hdp", "chunk": i // HDP_CHUNK,
                "reads": len(reads[i:i + HDP_CHUNK]), "ND": dims["ND"],
                "W": dims["W"]}, dims["ND"],
               [lambda fk=fk: launches(fk) for fk in fks])
        del fa, ba, inp, prep, dims


def realign_cases(fks, dev):
    """The untiled dna5 pair's cases, one per chunk, as ``long_cases``."""
    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.models.state_machines import StateMachine5
    from cpecan_tpu_torch.ops.fb import Dna5Aligner
    from cpecan_tpu_torch.synthetic import dna_realign_batch

    reads = dna_realign_batch()
    dsm = StateMachine5()
    aligner = Dna5Aligner(AlignmentParams(), device=dev, group=DNA_CHUNK)
    hint = (max(r[2] for r in reads), aligner.prepare(dsm, reads)["ND"])
    for i in range(0, len(reads), DNA_CHUNK):
        prep = aligner.prepare(dsm, reads[i:i + DNA_CHUNK],
                               ragged_right=True, shape_hint=hint)
        inp = aligner.device_inputs(dsm, prep, ragged_left=True)
        dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"])
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        ba = fa + [inp["seedf"], inp["raggedf"]]

        def launches(fk, fa=fa, ba=ba, dims=dims):
            d = dict(dims, spec=fk.Dna5Spec)
            fwd = fk.wavefront_fwd(*fa, **d)
            posts, tot = fk.wavefront_bwd(*ba, fwd, **d)
            return (fwd, posts, tot), {
                "fwd": lambda: fk.wavefront_fwd(*fa, **d),
                "bwd": lambda: fk.wavefront_bwd(*ba, fwd, **d)}

        yield ({"machine": "dna5", "chunk": i // DNA_CHUNK,
                "reads": len(reads[i:i + DNA_CHUNK]), "ND": dims["ND"],
                "W": dims["W"]}, dims["ND"],
               [lambda fk=fk: launches(fk) for fk in fks])
        del fa, ba, inp, prep


def fourstate_runs(dev):
    """[(prep, device inputs)] of every run of the Sm4Aligner in phase
    23's fourState pipeline (64 Zymo copies, group 32, chunk 64): the
    template strand's chunk, then the complement's."""
    import shutil
    import tempfile

    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.fixtures import load_batch_zymo
    from cpecan_tpu_torch.ops.fb import Sm4Aligner
    from cpecan_tpu_torch.pipeline.signal_align_batch import run_batch_fast

    records = []

    class Recorded(Sm4Aligner):
        """Keeps each run's staged inputs (its "prepare" and "inputs")."""

        def run(self, sm, reads, **kw):
            rec = {}

            def stage(name, fn):
                res = fn()
                if name in ("prepare", "inputs"):
                    rec[name] = res
                return res

            records.append(rec)
            return super().run(sm, reads, stage=stage, **kw)

    bargs, _ = load_batch_zymo()
    guide = bargs["npread_guide_pairs"][0][1].split()
    aligner = Recorded(AlignmentParams(), device=dev, group=PIPE_GROUP)
    with tempfile.TemporaryDirectory() as tmp:
        pairs = []
        for i in range(PIPE_READS):
            label = f"read{i:03d}"
            dst = Path(tmp) / f"{label}.npRead"
            shutil.copy(bargs["npread_guide_pairs"][0][0], dst)
            pairs.append((str(dst), " ".join([guide[0], label]
                                             + guide[2:])))
        res = run_batch_fast(
            bargs["reference_path"], pairs, str(Path(tmp) / "out"),
            template_model_file=bargs["template_model_file"],
            complement_model_file=bargs["complement_model_file"],
            log=lambda m: None, chunk=PIPE_CHUNK, compact_k=PIPE_COMPACT_K,
            aligner=aligner, sm_type="fourState")
    if len(res) != PIPE_READS or not all(r[1] for r in res):
        raise AssertionError(f"fourState pipeline: {res}")
    return [(rec["prepare"], rec["inputs"]) for rec in records]


def fourstate_cases(fks, dev):
    """The untiled sm4 pair's cases, one per recorded run of the fourState
    pipeline (``fourstate_runs``), as ``long_cases``."""
    runs = fourstate_runs(dev)
    for i in range(len(runs)):
        prep, inp = runs[i]
        runs[i] = None
        dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"])
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        ba = fa + [inp["seedf"], inp["raggedf"]]

        def launches(fk, fa=fa, ba=ba, dims=dims):
            d = dict(dims, spec=fk.Sm4Spec)
            fwd = fk.wavefront_fwd(*fa, **d)
            posts, tot = fk.wavefront_bwd(*ba, fwd, **d)
            return (fwd, posts, tot), {
                "fwd": lambda: fk.wavefront_fwd(*fa, **d),
                "bwd": lambda: fk.wavefront_bwd(*ba, fwd, **d)}

        yield ({"machine": "fourState", "run": i,
                "reads": len(prep["bands"]), "G": len(prep["win"]),
                "R": dims["R"], "ND": dims["ND"], "W": dims["W"]},
               dims["ND"], [lambda fk=fk: launches(fk) for fk in fks])
        del fa, ba, inp, prep


def estep_cases(fks, dev):
    """The expectation backwards' cases (K3 strawman with both machines,
    K3 sm4, K3 vanilla, K3 hdp), as ``long_cases``: the inputs of
    ``chip_smoke.py``'s phases 7, 22, 19 and 27, staged by this tree's
    aligners."""
    import numpy as np

    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.fixtures import (fixture_path, load_vanilla_zymo,
                                           zymo_trained_params)
    from cpecan_tpu_torch.io.poremodel import load_pore_model
    from cpecan_tpu_torch.models.hmm import ContinuousPairHmm
    from cpecan_tpu_torch.models.state_machines import (
        StateMachine3SignalStrawman, StateMachine3Vanilla, StateMachine4)
    from cpecan_tpu_torch.ops.fb import (HdpAligner, Sm4Aligner,
                                         StrawmanAligner, VanillaAligner)
    from cpecan_tpu_torch.synthetic import hdp_model, synthetic_batch

    sm, reads = synthetic_batch(**POST_BATCH)
    n = EM_GROUP
    # phase 7: the scaling of phase 9's E-step, the batch's inputs cut to
    # their first group
    em_sp = np.random.default_rng(4).uniform(0.95, 1.05, (len(reads), 5))
    tparams, tgap_x = zymo_trained_params()
    epa = StrawmanAligner(AlignmentParams(), device=dev, group=n)
    full = epa.prepare(sm, reads, ragged_right=True, scale_params=em_sp)
    # phase 22: the M-step of a random 4-state table, the first 32 reads
    # as Sm4Aligner.run(expectations=True) stages them
    rng4 = np.random.default_rng(21)
    h4 = ContinuousPairHmm(state_number=4, pseudocount=1e-4)
    h4.add_expectations({"trans": rng4.uniform(0.05, 1.0, (4, 4)),
                         "kmer_gap": rng4.uniform(0.1, 1.0, 4098),
                         "likelihood": -100.0})
    h4.normalize()
    p4, gx4 = h4.to_sm4_params()
    sm4 = StateMachine4(sm.model, params=p4, gap_x_log_probs=gx4)
    s4a = Sm4Aligner(AlignmentParams(), device=dev, group=n)
    s4prep = s4a.prepare(sm4, reads[:n], ragged_right=True,
                         scale_params=em_sp[:n])
    # phase 19: the trained vanilla machine, the same reads and scaling
    vsm = StateMachine3Vanilla(
        load_pore_model(fixture_path("template_median68pA.model")),
        skip_bin_probs=load_vanilla_zymo()[2]["t_skip"])
    va = VanillaAligner(AlignmentParams(), device=dev, group=n)
    vprep = va.prepare(vsm, reads[:n], ragged_right=True,
                       scale_params=em_sp[:n])
    # phase 27: bench.py's HDP machine, the HDP E-step's reads staged as
    # one run stages them (the stream of its first group)
    hsm = hdp_model()
    ha = HdpAligner(AlignmentParams(), device=dev, group=n)
    hprep = ha.prepare(hsm, reads[:HDP_E_READS], ragged_right=True)
    cases = (
        ("strawman", "untrained", sm, epa, full, "StrawmanSpec"),
        ("strawman", "trained", StateMachine3SignalStrawman(
            sm.model, params=tparams, gap_x_log_probs=tgap_x), epa, full,
         "StrawmanSpec"),
        ("fourState", "trained", sm4, s4a, s4prep, "Sm4Spec"),
        ("vanilla", "trained", vsm, va, vprep, "VanillaSpec"),
        ("hdp", "sampled", hsm, ha, hprep, "HdpSpec"))
    keys = ("xf", "yf", "basef", "widthf", "seedf", "raggedf")
    for label, mlabel, machine, aligner, prep, spec in cases:
        inp = aligner.device_inputs(machine, prep, ragged_left=True)
        ba = [inp["scal"], inp["win"][:1]] + [inp[k][:n] for k in keys]
        dims = dict(R=n, W=prep["W"], ND=prep["ND"], C=prep["C"])
        if spec == "HdpSpec":
            dims["est"] = aligner.emission_stream(machine, prep,
                                                  inp)[:1].contiguous()

        def launches(fk, ba=ba, dims=dims, spec=spec):
            d = dict(dims, spec=getattr(fk, spec))
            fwd = fk.wavefront_fwd(*ba[:6], **d)
            return (fwd, *fk.wavefront_bwd_exp(*ba, fwd, **d)), {
                "bwd_exp": lambda: fk.wavefront_bwd_exp(*ba, fwd, **d)}

        yield ({"machine": label, "params": mlabel, "reads": n,
                "ND": dims["ND"], "W": dims["W"]}, dims["ND"],
               [lambda fk=fk: launches(fk) for fk in fks])
        del ba, inp, dims


PATHS = {"long": long_cases, "echelon": echelon_cases,
         "posterior": posterior_cases, "hdp": hdp_cases,
         "realign": realign_cases, "fourstate": fourstate_cases,
         "estep": estep_cases}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", help="source trees, the first the "
                   "reference")
    p.add_argument("--path", choices=sorted(PATHS), default="long")
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.modules["jax"] = None
    sys.modules["cpecan_tpu"] = None
    import torch

    if not torch.cuda.is_available():
        print("tiled_times: no CUDA device", file=sys.stderr)
        return 2
    loaded = [load_tree(i, tree) for i, tree in enumerate(args.trees)]
    try:
        build(args.trees, [cb for cb, _ in loaded])
    except RuntimeError as exc:
        print(exc)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()

    def cuda_ms(fn, reps=3):
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

    fks = [fk for _, fk in loaded]
    for header, nd, trees in PATHS[args.path](fks, torch.device("cuda")):
        ref, runs = None, []
        for tree, launches in zip(args.trees, trees):
            outs, fns = launches()
            if ref is None:
                ref = outs
            elif not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                raise AssertionError(f"{tree}: {header} differs from the "
                                     "first tree's")
            runs.append(fns)
            del outs
        times = [{k: [] for k in fns} for fns in runs]
        for _ in range(args.rounds):
            for fns, t in zip(runs, times):
                for k, fn in fns.items():
                    t[k].append(cuda_ms(fn))
        for tree, t in zip(args.trees, times):
            row = dict(header, tree=tree, card=smi)
            for k, v in t.items():
                med = statistics.median(v)
                row.update({f"{k}_ms": med, f"{k}_rounds_ms": v,
                            f"{k}_ns_per_diagonal": med * 1e6 / nd})
            print(json.dumps(row), flush=True)
        del ref, runs
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
