"""The port stands alone: every module of ``cpecan_tpu_torch`` imports with
JAX and the JAX package blocked, no module (nor ``chip_smoke.py``) imports
either, and each module the port keeps its own copy of behaves as its
original in the JAX package on the repository's fixtures."""

import ast
import contextlib
import dataclasses
import io
import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import cpecan_tpu.cli.batch as j_batch
import cpecan_tpu.constants as j_constants
import cpecan_tpu.fixtures as j_fixtures
from cpecan_tpu.io import cigar as j_cigar
from cpecan_tpu.io import fasta as j_fasta
from cpecan_tpu.io import guide as j_guide
from cpecan_tpu.io import npread as j_npread
from cpecan_tpu.io import poremodel as j_poremodel
from cpecan_tpu.models import hmm as j_hmm
from cpecan_tpu.models import kmers as j_kmers
from cpecan_tpu.msa import multiple_aligner as j_msa
from cpecan_tpu.ops import anchors as j_anchors
from cpecan_tpu.ops import band as j_band
from cpecan_tpu.ops import blast as j_blast
from cpecan_tpu.ops import reweight as j_reweight
from cpecan_tpu.utils import checkpoint as j_checkpoint

import cpecan_tpu_torch.cli.batch as t_batch
import cpecan_tpu_torch.constants as t_constants
import cpecan_tpu_torch.fixtures as t_fixtures
from cpecan_tpu_torch.io import cigar as t_cigar
from cpecan_tpu_torch.io import fasta as t_fasta
from cpecan_tpu_torch.io import guide as t_guide
from cpecan_tpu_torch.io import npread as t_npread
from cpecan_tpu_torch.io import poremodel as t_poremodel
from cpecan_tpu_torch.models import hmm as t_hmm
from cpecan_tpu_torch.models import kmers as t_kmers
from cpecan_tpu_torch.msa import multiple_aligner as t_msa
from cpecan_tpu_torch.ops import anchors as t_anchors
from cpecan_tpu_torch.ops import band as t_band
from cpecan_tpu_torch.ops import blast as t_blast
from cpecan_tpu_torch.ops import reweight as t_reweight
from cpecan_tpu_torch.ops.fb import Dna5Aligner, StrawmanAligner
from cpecan_tpu_torch.synthetic import synth_dna_pair
from cpecan_tpu_torch.utils import checkpoint as t_checkpoint

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "cpecan_tpu_torch"
NPREAD = "ZymoC_ch_1_file1.npRead"
MODEL = "template_median68pA.model"


def test_port_imports_with_jax_package_blocked():
    """Every module imports in a process where ``jax`` and ``cpecan_tpu``
    cannot be imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = sys.modules['cpecan_tpu'] = None\n"
        "import cpecan_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "cpecan_tpu_torch.__path__, 'cpecan_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() "
        "if v is not None}\n"
        "assert not loaded & {'jax', 'cpecan_tpu'}, loaded\n"
        "assert {'cpecan_tpu_torch.pipeline.signal_align_batch', "
        "'cpecan_tpu_torch.cli.batch', 'cpecan_tpu_torch.io.guide', "
        "'cpecan_tpu_torch.native'} <= set(names), names\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def test_echelon_runs_with_jax_package_blocked():
    """The echelon machine, its aligner, the multi-state extraction and the
    batch pipeline's echelon machine run in a process where ``jax`` and
    ``cpecan_tpu`` cannot be imported (a small plain run on the CPU)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['cpecan_tpu'] = None\n"
        "from cpecan_tpu_torch.ops.fb import EchelonAligner\n"
        "from cpecan_tpu_torch.ops.compact import "
        "extract_echelon_pairs_chunk\n"
        "from cpecan_tpu_torch.pipeline.signal_align_batch import ALIGNERS\n"
        "from cpecan_tpu_torch.synthetic import echelon_batch\n"
        "sm, reads = echelon_batch(n_reads=2, n_ref=60, n_events=50)\n"
        "out = EchelonAligner(device='cpu', group=2).run(sm, reads)\n"
        "nds = [b.n_diag for b in out['prep']['bands']]\n"
        "parts = extract_echelon_pairs_chunk(out, [0, 1], nds, 0.01)\n"
        "assert ALIGNERS['echelon'] is EchelonAligner\n"
        "assert tuple(out['posteriors'].shape[2:4]) == (5, 2)\n"
        "print(sum(map(len, parts)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 50


def test_hdp_runs_with_jax_package_blocked():
    """The port's HDP (its sampler, the bench recipe's machine) and an
    ``HdpAligner`` run with its emission stream run in a process where
    ``jax`` and ``cpecan_tpu`` cannot be imported (a small plain run on
    the CPU)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['cpecan_tpu'] = None\n"
        "from cpecan_tpu_torch.ops.fb import HdpAligner\n"
        "from cpecan_tpu_torch.ops.compact import extract_pairs_chunk\n"
        "from cpecan_tpu_torch.synthetic import hdp_model, synthetic_batch\n"
        "sm = hdp_model()\n"
        "assert sm.nhdp.hdp.sampler in ('native', 'python')\n"
        "_, reads = synthetic_batch(n_reads=2, n_ref=60, n_events=50)\n"
        "out = HdpAligner(device='cpu', group=2).run(sm, reads)\n"
        "nds = [b.n_diag for b in out['prep']['bands']]\n"
        "parts = extract_pairs_chunk(out, [0, 1], nds, 0.01)\n"
        "print(sum(map(len, parts)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 50


def test_msa_runs_with_jax_package_blocked():
    """The MSA layer (``make_alignment``, lastz anchoring, the native
    greedy column build) on ``gpu_batch_align_fn(device="cpu")`` runs in a
    process where ``jax`` and ``cpecan_tpu`` cannot be imported (a small
    plain run on the CPU)."""
    code = (
        "import random, sys\n"
        "sys.modules['jax'] = sys.modules['cpecan_tpu'] = None\n"
        "from cpecan_tpu_torch.msa.gpu import gpu_batch_align_fn\n"
        "from cpecan_tpu_torch.msa.multiple_aligner import (SeqFrag, "
        "_get_poset_lib, make_alignment)\n"
        "rng = random.Random(5)\n"
        "base = ''.join(rng.choice('ACGT') for _ in range(40))\n"
        "frags = [SeqFrag(''.join(c if rng.random() > 0.1 else 'A' "
        "for c in base), i, i + 1) for i in range(3)]\n"
        "mA = make_alignment(None, frags, spanning_trees=1, "
        "max_pairs_to_consider=1000, use_progressive_merging=False, "
        "match_gamma=0.2, rng=random.Random(1), "
        "batch_align_fn=gpu_batch_align_fn(device='cpu'))\n"
        "assert _get_poset_lib() is not None\n"
        "from cpecan_tpu_torch.ops.blast import get_blast_pairs\n"
        "assert len(get_blast_pairs(base * 15, base * 15, 0, True)) > 500\n"
        "print(len(mA.aligned_pairs))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 40


def _imports(path):
    """Top-level package names a Python file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(REPO)): sorted(_imports(f) & {"jax",
                                                           "cpecan_tpu"})
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_aligner_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        StrawmanAligner()


def test_dna5_aligner_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Dna5Aligner()
    assert Dna5Aligner(device="cpu").group == 32


def _bands():
    """Anchor chains of a long read, a flush read and an anchor-less read."""
    rng = np.random.default_rng(3)
    lists = [[(x, int(x * 1.7)) for x in range(20, 980, 25)], [], []]
    xs = np.sort(rng.choice(np.arange(1, 399), 12, replace=False))
    ys = np.sort(rng.choice(np.arange(1, 349), 12, replace=False))
    lists[1] = list(zip(xs.tolist(), ys.tolist()))
    return lists, [1000, 400, 37], [1700, 350, 52]


def case_make_bands():
    lists, lxs, lys = _bands()
    got = t_band.make_bands(lists, lxs, lys, 20)
    want = j_band.make_bands(lists, lxs, lys, 20)
    for g, w, a, lx, ly in zip(got, want, lists, lxs, lys):
        one = t_band.make_band(a, lx, ly, 20)
        for f in ("xmy_l", "xmy_r", "x_lo", "width"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            np.testing.assert_array_equal(getattr(one, f), getattr(w, f))
        assert (g.n_diag, g.max_width) == (w.n_diag, w.max_width)
    with pytest.raises(ValueError, match="strictly increasing"):
        t_band.make_bands([[(5, 5), (4, 6)]], [10], [10], 20)


def case_cigar():
    line = str(np.load(t_fixtures.ZYMO_TRAIN)["guide"])
    assert dataclasses.asdict(t_cigar.parse_cigar_line(line)) == \
        dataclasses.asdict(j_cigar.parse_cigar_line(line))


def case_load_guides(tmp_path):
    line = str(np.load(t_fixtures.ZYMO_TRAIN)["guide"])
    path = tmp_path / "guides.cigar"
    toks = line.split()
    toks[1] = "other"          # the query (read) name keys the guides
    path.write_text(line + "\n\n" + " ".join(toks) + "\n")
    got = t_batch._load_guides(str(path))
    want = j_batch._load_guides(str(path))
    assert got.keys() == want.keys() and len(got) == 2
    for k in got:
        assert got[k][0] == want[k][0]
        assert dataclasses.asdict(got[k][1]) == dataclasses.asdict(want[k][1])


def case_npread():
    got = t_npread.load_npread(t_fixtures.fixture_path(NPREAD))
    want = j_npread.load_npread(j_fixtures.fixture_path(NPREAD))
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        elif dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        else:
            assert g == w
    pairs = [(3, 10), (40, 100), (200, 500)]
    assert t_npread.remap_anchor_pairs_with_offset(
        pairs, got.template_event_map, 5) == \
        j_npread.remap_anchor_pairs_with_offset(
            pairs, want.template_event_map, 5)


def case_pore_model():
    got = t_poremodel.load_pore_model(t_fixtures.fixture_path(MODEL))
    want = j_poremodel.load_pore_model(j_fixtures.fixture_path(MODEL))
    tp = t_npread.load_npread(t_fixtures.fixture_path(NPREAD)).template_params
    args = (tp.scale, tp.shift, tp.var, tp.scale_sd, tp.var_sd)
    for g, w in ((got, want), (t_poremodel.scale_model(got, *args),
                               j_poremodel.scale_model(want, *args))):
        for f in dataclasses.fields(w):
            np.testing.assert_array_equal(getattr(g, f.name),
                                          getattr(w, f.name))


def case_kmer_skip_bin_table():
    """The copied emissions_signal_getKmerSkipBin table (with per-read
    scaling, the invalid-k-mer guard and the clamp to 29) and the getKmer2
    position helpers of the echelon machine."""
    from cpecan_tpu.models import state_machines as j_sm
    from cpecan_tpu_torch.models import state_machines as t_sm

    model = j_poremodel.load_pore_model(j_fixtures.fixture_path(MODEL))
    rng = np.random.default_rng(9)
    prev = rng.integers(0, 4200, (4, 300))
    nxt = rng.integers(0, 4200, (4, 300))
    prev[0, :5] = [4095, 4096, 4097, 32767, 0]
    for kw in ({}, dict(scale=rng.uniform(0.9, 1.1, (4, 1)),
                        shift=rng.uniform(-5.0, 5.0, (4, 1)))):
        got = t_poremodel.kmer_skip_bin_table(model.match_model, prev, nxt,
                                              **kw)
        want = j_poremodel.kmer_skip_bin_table(model.match_model, prev, nxt,
                                               **kw)
        assert got.dtype == want.dtype and got.max() == 29
        np.testing.assert_array_equal(got, want)
    for l_x in (0, 1, 2, 57):
        np.testing.assert_array_equal(t_sm._getkmer2_positions(l_x),
                                      j_sm._getkmer2_positions(l_x))
    ref = "ACGTTGCAN" * 5 + "n" * 30
    pos = np.arange(-3, len(ref) + 4)
    np.testing.assert_array_equal(t_sm._kmer_idx_at(ref, pos),
                                  j_sm._kmer_idx_at(ref, pos))


def case_hmm_round_trip(tmp_path):
    rng = np.random.default_rng(7)
    acc = {"trans": rng.random((3, 3)), "kmer_gap": rng.random(4098),
           "likelihood": -1234.5}
    hmms = []
    for mod in (t_hmm, j_hmm):
        h = mod.ContinuousPairHmm(pseudocount=1e-4)
        h.add_expectations(acc)
        h.normalize()
        hmms.append(h)
    texts = []
    for h in hmms:
        fh = io.StringIO()
        h.write(fh)
        texts.append(fh.getvalue())
    assert texts[0] == texts[1]
    path = tmp_path / "t.hmm"
    path.write_text(texts[0])
    got = t_hmm.ContinuousPairHmm.load(str(path))
    want = j_hmm.ContinuousPairHmm.load(str(path))
    np.testing.assert_array_equal(got.transitions, want.transitions)
    np.testing.assert_array_equal(got.kmer_gap_probs, want.kmer_gap_probs)
    assert got.likelihood == want.likelihood
    (gp, gg), (wp, wg) = got.to_sm3_params(), want.to_sm3_params()
    assert gp == wp
    np.testing.assert_array_equal(gg, wg)


def case_vanilla_hmm(tmp_path):
    """VanillaHmm: add, normalize (beta and alpha together), implant, the
    4-line text format and its load."""
    rng = np.random.default_rng(8)
    acc = {"skip_bins": rng.random(60), "likelihood": -987.25}
    pore = t_poremodel.load_pore_model(t_fixtures.fixture_path(MODEL))
    hmms = []
    for mod in (t_hmm, j_hmm):
        h = mod.VanillaHmm(pseudocount=1e-4)
        h.add_expectations(acc)
        h.add_expectations(acc)
        h.normalize()
        h.implant_match_models(pore)
        hmms.append(h)
    np.testing.assert_array_equal(hmms[0].kmer_skip_bins,
                                  hmms[1].kmer_skip_bins)
    texts = []
    for h in hmms:
        fh = io.StringIO()
        h.write(fh)
        texts.append(fh.getvalue())
    assert texts[0] == texts[1] and len(texts[0].splitlines()) == 4
    path = tmp_path / "v.hmm"
    path.write_text(texts[0])
    got = t_hmm.VanillaHmm.load(str(path))
    want = j_hmm.VanillaHmm.load(str(path))
    for f in ("kmer_skip_bins", "match_model", "scaled_match_model"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.likelihood, got.type) == (want.likelihood, want.type)


def case_kmers():
    rng = np.random.default_rng(9)
    seq = "".join(rng.choice(list("ACGTN"), 500, p=[.24, .24, .24, .24, .04]))
    for s in (seq, "ACG", "ACGTAC", ""):
        np.testing.assert_array_equal(t_kmers.seq_to_kmer_indices(s),
                                      j_kmers.seq_to_kmer_indices(s))
        # the tsv writer asks for one position per base
        for n in (len(s), len(s) + 3, 2):
            np.testing.assert_array_equal(
                t_kmers.seq_to_kmer_indices(s, length=n),
                j_kmers.seq_to_kmer_indices(s, length=n))
        np.testing.assert_array_equal(t_kmers.seq_to_base_indices(s),
                                      j_kmers.seq_to_base_indices(s))
    assert t_fasta.reverse_complement(seq) == j_fasta.reverse_complement(seq)


def case_anchors():
    rng = np.random.default_rng(13)
    # a diagonal chain with jitter: some pairs cross their neighbours
    xs = np.arange(0, 300, 3)
    ys = xs + rng.integers(-4, 5, xs.size)
    pairs = sorted({(int(x), int(y)) for x, y in zip(xs, ys) if y >= 0})
    chain = t_anchors.filter_to_remove_overlap(pairs)
    assert chain == j_anchors.filter_to_remove_overlap(pairs)
    assert len(chain) > 5
    for ragged in (False, True):
        assert t_anchors.get_split_points(chain, 320, 320, 40 * 40, ragged,
                                          ragged) == \
            j_anchors.get_split_points(chain, 320, 320, 40 * 40, ragged,
                                       ragged)


def case_checkpoint(tmp_path):
    meta = {"trajectory": [[-1.5, -2.5]], "template_hmm": "x"}
    arrays = {"a": np.arange(6.0).reshape(2, 3)}
    t_checkpoint.CheckpointManager(str(tmp_path / "t"), keep=2)
    for step in range(3):
        t_checkpoint.CheckpointManager(str(tmp_path / "t"), keep=2).save(
            step, arrays, meta)
        j_checkpoint.CheckpointManager(str(tmp_path / "j"), keep=2).save(
            step, arrays, meta)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    for directory in ("t", "j"):
        for mod in (t_checkpoint, j_checkpoint):
            step, arr, m = mod.CheckpointManager(
                str(tmp_path / directory)).restore()
            assert step == 2 and m == meta
            np.testing.assert_array_equal(arr["a"], arrays["a"])


def case_rng_state_json():
    import json
    import random

    rng = random.Random(11)
    rng.random()
    rng.gauss(0.0, 1.0)     # leaves a cached gauss in the state
    state = t_checkpoint.rng_state_to_json(rng)
    assert state == j_checkpoint.rng_state_to_json(rng)
    # through JSON text, as a checkpoint stores it
    state = json.loads(json.dumps(state))
    restored = [mod.rng_state_from_json(state)
                for mod in (t_checkpoint, j_checkpoint)]
    assert restored[0].getstate() == restored[1].getstate() == rng.getstate()
    want = [rng.gauss(0.0, 1.0), rng.random()]
    for r in restored:
        assert [r.gauss(0.0, 1.0), r.random()] == want


def case_constants_and_fixture_paths():
    for name in dir(t_constants):
        if name.isupper():
            assert getattr(t_constants, name) == getattr(j_constants, name)
    for name in t_fixtures._FILES:
        assert t_fixtures.fixture_path(name) == j_fixtures.fixture_path(name)


def _posterior_pairs(seed, l_x, l_y):
    """Aligned pairs (score, x, y) scattered around the diagonal, some
    crossing: what a realign run hands the reweight and filter steps."""
    rng = np.random.default_rng(seed)
    pairs = set()
    for x in range(l_x):
        for y in (x - 1, x, x + 1, x + int(rng.integers(-6, 7))):
            if 0 <= y < l_y and rng.random() < 0.6:
                pairs.add((int(rng.integers(10 ** 5, 10 ** 7)), x, y))
    return sorted(pairs, key=lambda t: (t[1], t[2]))


def case_reweight():
    pairs = _posterior_pairs(1, 120, 110)
    for gamma in (0.0, 0.5, 2.0):
        assert t_reweight.reweight_aligned_pairs_2(pairs, 120, 110, gamma) \
            == j_reweight.reweight_aligned_pairs_2(pairs, 120, 110, gamma)


def case_blast():
    """The lastz flags and the cigar-to-anchor conversion (the lastz runs
    themselves: tests/test_torch_blast.py)."""
    assert t_blast.LASTZ_ARGS == j_blast.LASTZ_ARGS
    line = str(np.load(t_fixtures.ZYMO_TRAIN)["guide"])
    for trim in (0, 3, 14):
        got = t_blast._cigar_to_anchor_pairs(t_cigar.parse_cigar_line(line),
                                             trim)
        assert got == j_blast._cigar_to_anchor_pairs(
            j_cigar.parse_cigar_line(line), trim)
        assert len(got) > 50


def _msa_maps(seed, n, length):
    """Multiple aligned pairs (score, s1, p1, s2, p2) near the diagonal of
    every fragment pair, some crossing."""
    rng = np.random.default_rng(seed)
    maps = []
    for s1 in range(n):
        for s2 in range(s1 + 1, n):
            for p in range(length):
                for q in (p - 1, p, p + int(rng.integers(-3, 4))):
                    if 0 <= q < length and rng.random() < 0.5:
                        maps.append((int(rng.integers(10 ** 5, 10 ** 7)),
                                     s1, p, s2, q))
    return maps


def case_multiple_aligner_greedy():
    """The greedy column build in its three consistency modes, the native
    build, the distance matrix, the next best pair and the chains: equal
    partitions, counts and picks."""
    import random

    seqs = ["".join(np.random.default_rng(s).choice(list("ACGT"), 30))
            for s in range(5)]
    maps = _msa_maps(4, 5, 30)
    parts = []
    for mod in (t_msa, j_msa):
        frags = [mod.SeqFrag(s, i % 2, i % 3) for i, s in enumerate(seqs)]
        for mode in ("poset", "poset-numpy", "bfs"):
            cols = mod.make_columns_greedy(frags, maps, 0.3,
                                           rng=random.Random(6),
                                           consistency=mode)
            parts.append(sorted(sorted(m) for m in cols.members.values()))
        subs, nonsubs = mod.get_distance_matrix(cols, frags, 10_000)
        chosen = set(mod.get_reference_pairwise_alignments(frags))
        rng = random.Random(8)
        parts.append((subs, nonsubs, sorted(chosen),
                      [mod.get_next_best_pair(s, 5, subs, nonsubs, chosen,
                                              rng) for s in range(5)],
                      mod.get_distance_matrix(cols, frags, 7),
                      mod.get_alignment_score(
                          [(m[0], m[2], m[4]) for m in maps[:40]], 30, 28)))
    assert all(p == parts[0] for p in parts[1:3])
    assert parts[:4] == parts[4:]
    assert len(parts[0]) < 5 * 30 - 30


def case_multiple_aligner():
    import random

    seq_x = "".join(np.random.default_rng(2).choice(list("ACGT"), 90))
    seq_y = seq_x[:40] + "GG" + seq_x[40:85]
    pairs = j_reweight.reweight_aligned_pairs_2(
        _posterior_pairs(2, 90, 87), 90, 87, 0.5)
    for gamma in (0.0, 0.3, 0.85):
        got = t_msa.filter_pairwise_alignment_to_make_pairs_ordered(
            pairs, seq_x, seq_y, gamma, rng=random.Random(4))
        want = j_msa.filter_pairwise_alignment_to_make_pairs_ordered(
            pairs, seq_x, seq_y, gamma, rng=random.Random(4))
        assert got == want
        assert got == t_msa.filter_pairwise_alignment_to_make_pairs_ordered(
            pairs, seq_x, seq_y, gamma)
    assert 0 < len(got) < len(pairs)


def case_cigar_io():
    text = ("cigar: y0 0 10 + x0 3 12 + 5.5 M 4 I 1 M 5\n"
            "# a comment\n"
            "cigar: y1 9 0 - x1 0 10 + 0 M 3 D 1 M 7\n")
    got = list(t_cigar.cigar_read_stream(io.StringIO(text)))
    want = list(j_cigar.cigar_read_stream(io.StringIO(text)))
    assert [dataclasses.asdict(a) for a in got] == \
        [dataclasses.asdict(a) for a in want]
    assert [t_cigar.cigar_write(a) for a in got] == \
        [j_cigar.cigar_write(a) for a in want]
    for mod in (t_cigar, j_cigar):
        mod.check_pairwise_alignment(got[0])
        with pytest.raises(ValueError, match="do not match"):
            mod.check_pairwise_alignment(got[1])


def case_fasta_io(tmp_path):
    paths = [tmp_path / "a.fa", tmp_path / "b.fa"]
    paths[0].write_text(">s1 first\nACGT\nAC\n\n>s2\nGGG\n")
    paths[1].write_text(">s1 longer\nACGTACGT\n>s3\nT\n")
    with open(paths[0]) as fh:
        got = list(t_fasta.read_fasta(fh))
    with open(paths[0]) as fh:
        assert got == list(j_fasta.read_fasta(fh))
    assert t_fasta.sequences_from_fastas([str(p) for p in paths]) == \
        j_fasta.sequences_from_fastas([str(p) for p in paths])


def case_hmm_discrete(tmp_path):
    for type_ in (j_hmm.TYPE_FIVE_STATE, j_hmm.TYPE_FIVE_STATE_ASYMMETRIC):
        hmm = j_hmm.HmmDiscrete(5, 4, type_=type_)
        hmm.randomize(np.random.default_rng(type_))
        path = tmp_path / f"h{type_}.hmm"
        with open(path, "w") as fh:
            hmm.write(fh)
        got, want = (mod.HmmDiscrete.load(str(path)) for mod in (t_hmm,
                                                                 j_hmm))
        for h in (got, want):
            h.normalize()
        np.testing.assert_array_equal(got.transitions, want.transitions)
        np.testing.assert_array_equal(got.emissions, want.emissions)
        for g, w in zip(got.to_sm5_params_symmetric(),
                        want.to_sm5_params_symmetric()):
            np.testing.assert_array_equal(np.asarray(list(g.values()) if
                                                     isinstance(g, dict)
                                                     else g),
                                          np.asarray(list(w.values()) if
                                                     isinstance(w, dict)
                                                     else w))
        assert t_hmm.sm5_from_hmm(got).p == j_hmm.sm5_from_hmm(want).p
    got.type = j_hmm.TYPE_THREE_STATE
    with pytest.raises(ValueError, match="cannot be loaded"):
        t_hmm.sm5_from_hmm(got)


def case_synth_dna_pair():
    sys.path.insert(0, str(REPO / "tools"))
    from exp_long_read import synth_dna_pair as tool_pair

    for seed, n in ((7, 3000), (1, 500)):
        assert synth_dna_pair(np.random.default_rng(seed), n) == \
            tool_pair(np.random.default_rng(seed), n)


def case_target_regions(tmp_path):
    path = tmp_path / "regions.tsv"
    path.write_text("500\t100\t x\n20\t60\n")
    one = tmp_path / "one.tsv"
    one.write_text("7\t3\n")
    for p, presorted in ((path, False), (path, True), (one, False)):
        got = t_guide.TargetRegions(str(p), already_sorted=presorted)
        want = j_guide.TargetRegions(str(p), already_sorted=presorted)
        np.testing.assert_array_equal(got.region_array, want.region_array)
        for left in range(0, 600, 37):
            for right in range(0, 600, 41):
                assert got.check_aligned_region(left, right) == \
                    want.check_aligned_region(left, right)
    (tmp_path / "empty.tsv").write_text("")
    for mod in (t_guide, j_guide):
        with pytest.raises(ValueError, match="Empty"):
            mod.TargetRegions(str(tmp_path / "empty.tsv"))


def _tiny_hdp(mod, seed, sample_gamma=False):
    """tests/test_hdp_interop.py's tiny HDP (4 leaves under one root, two
    signal clusters), built and fed data by ``mod`` (either package's
    ``hdp.hdp``), not yet sampled."""
    rng = np.random.default_rng(seed)
    data = np.concatenate([rng.normal(-2.0, 0.5, 150),
                           rng.normal(2.0, 0.5, 150)])
    dp_ids = np.concatenate([rng.integers(0, 2, 150),
                             rng.integers(2, 4, 150)])
    kwargs = dict(grid_start=-8.0, grid_stop=8.0, grid_length=120,
                  mu=0.0, nu=1.0, alpha=2.0, beta=5.0, seed=seed)
    if sample_gamma:
        hdp = mod.HierarchicalDirichletProcess(
            5, 2, gamma_alpha=[2.0, 2.0], gamma_beta=[0.5, 0.5], **kwargs)
    else:
        hdp = mod.HierarchicalDirichletProcess(5, 2, gamma=[4.0, 4.0],
                                               **kwargs)
    for leaf in range(4):
        hdp.set_dir_proc_parent(leaf, 4)
    hdp.finalize_structure()
    hdp.pass_data(data, dp_ids)
    return hdp


@contextlib.contextmanager
def _factor_order():
    """Both packages' HDP factors hashed by their creation order, while the
    context lasts (build, sample and read an HDP inside it).  A factor
    hashes by its id otherwise, so the order in
    which the Python sampler visits a set of factors (and the JSON state
    lists them) follows memory addresses: neither package repeats its own
    draws from one seed.  With the creation order as the hash both do, and
    a copy of the sampler must repeat the original's draws.  The order is
    a running count, not the number of ids seen: a new factor may take a
    dead one's id, and the count of ids would then hand the next factor a
    number already in use, in one package's run and not the other's."""
    from cpecan_tpu.hdp import hdp as j_hdp
    from cpecan_tpu_torch.hdp import hdp as t_hdp

    saved = []
    for mod in (t_hdp, j_hdp):
        cls = mod.Factor
        serial = {}
        init = cls.__init__

        def counted_init(self, *a, _init=init, _serial=serial,
                         _count=itertools.count(), **kw):
            _serial[id(self)] = next(_count)
            _init(self, *a, **kw)

        saved.append((cls, init, cls.__hash__))
        cls.__init__ = counted_init
        cls.__hash__ = lambda self, _serial=serial: _serial[id(self)]
    try:
        yield
    finally:
        for cls, init, hash_ in saved:
            cls.__init__, cls.__hash__ = init, hash_


def _hdp_samplers(backend, sample_gamma):
    """Both packages' tiny HDPs sampled by ``backend`` with one seed (and
    ``_factor_order``): the densities and slopes on the grid, the gammas
    and the sample count equal bit for bit."""
    from cpecan_tpu.hdp import hdp as j_hdp
    from cpecan_tpu.hdp import native as j_native
    from cpecan_tpu_torch.hdp import hdp as t_hdp
    from cpecan_tpu_torch.hdp import native as t_native

    if j_native.native_available():
        assert t_native.native_available()
    got, want = [], []
    for mod, out in ((t_hdp, got), (j_hdp, want)):
        with _factor_order():
            h = _tiny_hdp(mod, 3, sample_gamma)
            h.execute_gibbs_sampling(num_samples=8, burn_in=3500,
                                     thinning=100, backend=backend)
            h.finalize_distributions()
        out.append(h)
    got, want = got[0], want[0]
    assert got.sampler == ("python" if backend == "python" or not
                           t_native.native_available() else "native")
    for g, w in zip(got.density_tables(), want.density_tables()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.gamma, want.gamma)
    assert got.samples_taken == want.samples_taken > 0


def case_hdp_python_sampler():
    _hdp_samplers("python", sample_gamma=True)


def case_hdp_native_sampler():
    """The native sampler (the port's build of the copied source, or, where
    no C++ toolchain builds it, the Python fallback of both packages)."""
    _hdp_samplers("auto", sample_gamma=False)
    _hdp_samplers("auto", sample_gamma=True)


def case_hdp_serialization(tmp_path):
    """The JSON sampler state (``serialize``/``deserialize``) and the
    NanoporeHDP wrapper file: the port writes the JAX package's bytes, and
    each reads the other's back to equal densities."""
    from cpecan_tpu.hdp import hdp as j_hdp
    from cpecan_tpu.hdp import nanopore_hdp as j_nhdp
    from cpecan_tpu_torch.hdp import hdp as t_hdp
    from cpecan_tpu_torch.hdp import nanopore_hdp as t_nhdp

    paths = [str(tmp_path / f"{n}.json") for n in ("t", "j")]
    hdps = []
    for mod, path in zip((t_hdp, j_hdp), paths):
        with _factor_order():
            h = _tiny_hdp(mod, 5)
            h.execute_gibbs_sampling(num_samples=4, burn_in=900,
                                     thinning=100, backend="python")
            h.finalize_distributions()
            h.serialize(path)
        hdps.append(h)
    assert open(paths[0]).read() == open(paths[1]).read()
    x = np.linspace(-6.3, 6.3, 41)
    for mod, path in ((t_hdp, paths[1]), (j_hdp, paths[0])):
        back = mod.HierarchicalDirichletProcess.deserialize(path)
        for dp_id in range(5):
            np.testing.assert_array_equal(
                back.dir_proc_density_vec(x, dp_id),
                hdps[1].dir_proc_density_vec(x, dp_id))
    for mod, h, name in ((t_nhdp, hdps[0], "t"), (j_nhdp, hdps[1], "j")):
        mod.NanoporeHDP(h, "ACGT", 1).serialize(str(tmp_path / f"{name}.n"))
    got = t_nhdp.NanoporeHDP.deserialize(str(tmp_path / "j.n"))
    assert (got.alphabet, got.kmer_length) == ("ACGT", 1)
    for g, w in zip(got.density_tables(),
                    j_nhdp.NanoporeHDP.deserialize(
                        str(tmp_path / "t.n")).density_tables()):
        np.testing.assert_array_equal(g, w)


def case_hdp_text_io(tmp_path):
    """The reference text format (``text_io``): the port writes the JAX
    package's text for the HDP and the NanoporeHDP, and reads it back to
    the same densities and factor counts."""
    from cpecan_tpu.hdp import hdp as j_hdp
    from cpecan_tpu.hdp import nanopore_hdp as j_nhdp
    from cpecan_tpu.hdp import text_io as j_text
    from cpecan_tpu_torch.hdp import hdp as t_hdp
    from cpecan_tpu_torch.hdp import nanopore_hdp as t_nhdp
    from cpecan_tpu_torch.hdp import text_io as t_text

    hdps, texts = [], []
    for mod, text in ((t_hdp, t_text), (j_hdp, j_text)):
        buf = io.StringIO()
        with _factor_order():
            h = _tiny_hdp(mod, 7, sample_gamma=True)
            h.execute_gibbs_sampling(num_samples=4, burn_in=900,
                                     thinning=100, backend="python")
            h.finalize_distributions()
            text.serialize_hdp_text(h, buf)
        hdps.append(h)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    back = t_text.deserialize_hdp_text(io.StringIO(texts[1]))
    x = np.linspace(-6.3, 6.3, 41)
    for dp_id in range(5):
        np.testing.assert_array_equal(back.dir_proc_density_vec(x, dp_id),
                                      hdps[1].dir_proc_density_vec(x, dp_id))
        assert len(back.dps[dp_id].factors) == \
            len(hdps[1].dps[dp_id].factors)
    for mod, text, h, name in ((t_nhdp, t_text, hdps[0], "t"),
                               (j_nhdp, j_text, hdps[1], "j")):
        text.serialize_nhdp_text(mod.NanoporeHDP(h, "ACGT", 1),
                                 str(tmp_path / name))
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()
    got = t_text.deserialize_nhdp_text(str(tmp_path / "j"))
    for g, w in zip(got.density_tables(), j_nhdp.NanoporeHDP(
            hdps[1], "ACGT", 1).density_tables()):
        np.testing.assert_array_equal(g, w)


def case_hdp_gibbs_source():
    """The native HDP sampler is the JAX package's source, byte for byte
    (the port builds it into build/, not next to the source)."""
    assert (PACKAGE / "native" / "hdp_gibbs.cc").read_bytes() == \
        (REPO / "cpecan_tpu" / "native" / "hdp_gibbs.cc").read_bytes()


def case_msa_columns_source():
    """The native greedy column build is the JAX package's source, byte
    for byte (the port builds it into build/, not next to the source)."""
    assert (PACKAGE / "native" / "msa_columns.cc").read_bytes() == \
        (REPO / "cpecan_tpu" / "native" / "msa_columns.cc").read_bytes()


def case_tsv_format_source():
    """The native tsv formatter is the JAX package's source, byte for
    byte (the port builds it into build/, not next to the source)."""
    assert (PACKAGE / "native" / "tsv_format.cc").read_bytes() == \
        (REPO / "cpecan_tpu" / "native" / "tsv_format.cc").read_bytes()


CASES = {f.__name__[5:]: f for f in (
    case_make_bands, case_cigar, case_load_guides, case_npread,
    case_pore_model, case_kmer_skip_bin_table, case_hmm_round_trip,
    case_vanilla_hmm, case_kmers,
    case_anchors, case_checkpoint, case_rng_state_json,
    case_constants_and_fixture_paths, case_reweight,
    case_multiple_aligner, case_multiple_aligner_greedy, case_blast,
    case_msa_columns_source, case_cigar_io, case_fasta_io, case_hmm_discrete,
    case_synth_dna_pair, case_target_regions, case_tsv_format_source,
    case_hdp_python_sampler, case_hdp_native_sampler,
    case_hdp_serialization, case_hdp_text_io, case_hdp_gibbs_source)}


@pytest.mark.parametrize("name", list(CASES))
def test_copied_module_matches_original(name, tmp_path):
    fn = CASES[name]
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()
