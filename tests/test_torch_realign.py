"""The port's cPecanRealign CLI (``cpecan_tpu_torch.cli.realign``, the plain
dna5 passes on the CPU) against the JAX package's CLI with ``--engine
pallas`` (interpret-mode Pallas kernels), on the input of
``tests/test_realign_cli.py::test_realign_pallas_engine_matches_scan``
(seed 13); the refusals; and the realign fixture
(``tests/fixtures/dna5_realign.npz``) against a fresh build."""

import io
import os
import random

import numpy as np
import pytest

from cpecan_tpu.cli.realign import main as jax_main
from cpecan_tpu.models import hmm as j_hmm

from cpecan_tpu_torch.cli.realign import main as port_main
from cpecan_tpu_torch.constants import PAIR_ALIGNMENT_PROB_1
from cpecan_tpu_torch.fixtures import DNA5_REALIGN, load_dna5_realign
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.parity import (LONG_DNA_ENGINE_SCORE_ATOL,
                                     LONG_SCORE_ATOL, SCORE_ATOL,
                                     check_long_pairs)
from cpecan_tpu_torch.synthetic import (dna_realign_batch, realign_inputs,
                                        synth_dna_pair)


@pytest.fixture(scope="module")
def seed13(tmp_path_factory):
    """test_realign_pallas_engine_matches_scan's four pairs (80..140 bases,
    ~9% substitutions) as a fasta file and their gapless cigars."""
    rng = random.Random(13)
    fasta = tmp_path_factory.mktemp("realign") / "seqs.fa"
    cigars = []
    with open(fasta, "w") as fh:
        for i in range(4):
            n = 80 + 20 * i
            sx = "".join(rng.choice("ACGT") for _ in range(n))
            sy = "".join(c if rng.random() > 0.12 else rng.choice("ACGT")
                         for c in sx)
            fh.write(f">x{i}\n{sx}\n>y{i}\n{sy}\n")
            cigars.append(f"cigar: y{i} 0 {len(sy)} + x{i} 0 {n} + 0 M {n}")
    return str(fasta), "\n".join(cigars) + "\n"


def _run(fn, args, stdin_text):
    out = io.StringIO()
    fn(args, stdin=io.StringIO(stdin_text), stdout=out)
    return out.getvalue().splitlines()


def _same_cigars(got, want):
    """Equal cigars, but for a rescored score (``-i``/``-j``: a sum of f32
    posteriors), which may differ by the per-pair score tolerance."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gt, wt = g.split(), w.split()
        assert gt[:9] + gt[10:] == wt[:9] + wt[10:], (g, w)
        assert abs(float(gt[9]) - float(wt[9])) <= \
            100.0 * SCORE_ATOL / PAIR_ALIGNMENT_PROB_1, (g, w)


def _both(seed13, flags):
    fasta, stdin_text = seed13
    fk.reset_counts()
    got = _run(port_main, [fasta, "--device", "cpu"] + flags, stdin_text)
    assert fk.forward_plain.calls == fk.backward_plain.calls == 1
    want = _run(jax_main, [fasta, "--engine", "pallas"] + flags, stdin_text)
    return got, want


@pytest.mark.parametrize("flags", [[], ["-x", "-j"], ["-s", "1"]],
                         ids=["default", "rescore_original", "split_indels"])
def test_cli_matches_jax_pallas_cli(seed13, flags):
    got, want = _both(seed13, flags)
    assert len(got) >= 4
    _same_cigars(got, want)


def test_cli_stage_hook_runs_each_step_once(seed13):
    """``main(stage=)`` hands each step of the CLI to the hook by name, once
    (the fastas and the cigars under "read"), and writes the cigars of a
    run without it."""
    fasta, stdin_text = seed13
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()

    out = io.StringIO()
    port_main([fasta, "--device", "cpu"], stdin=io.StringIO(stdin_text),
              stdout=out, stage=stage)
    assert names == ["read", "read", "jobs", "prepare", "inputs", "fwd",
                     "bwd", "compact", "extract", "finish"]
    assert out.getvalue().splitlines() == _run(
        port_main, [fasta, "--device", "cpu"], stdin_text)


def test_cli_posterior_file_matches_jax(seed13, tmp_path):
    """-u writes the filtered pairs' posteriors: the same pairs as the JAX
    CLI's, each within the score tolerance; -i rescores by identity."""
    fasta, stdin_text = seed13
    files = [tmp_path / "port.txt", tmp_path / "jax.txt"]
    got = _run(port_main, [fasta, "--device", "cpu", "-i", "-u",
                           str(files[0])], stdin_text)
    want = _run(jax_main, [fasta, "--engine", "pallas", "-i", "-u",
                           str(files[1])], stdin_text)
    _same_cigars(got, want)
    rows = [np.loadtxt(f).reshape(-1, 3) for f in files]
    assert rows[0].shape == rows[1].shape and len(rows[0]) > 300
    np.testing.assert_array_equal(rows[0][:, :2], rows[1][:, :2])
    assert np.abs(rows[0][:, 2] - rows[1][:, 2]).max() <= \
        SCORE_ATOL / PAIR_ALIGNMENT_PROB_1


def test_cli_load_hmm_matches_jax(seed13, tmp_path):
    """--loadHmm with a non-default HMM (written by the JAX HmmDiscrete)."""
    hmm = j_hmm.HmmDiscrete(5, 4, type_=j_hmm.TYPE_FIVE_STATE)
    hmm.randomize(np.random.default_rng(5))
    hmm.transitions[:, 0] += 4.0        # keep matches likely
    hmm.emissions[0] += 3.0 * np.eye(4)
    hmm.normalize()
    path = tmp_path / "trained.hmm"
    with open(path, "w") as fh:
        hmm.write(fh)
    got, want = _both(seed13, ["-y", str(path)])
    default = _run(port_main, [seed13[0], "--device", "cpu"], seed13[1])
    _same_cigars(got, want)
    assert got != default


def test_cli_refuses_the_scan_engine(seed13, tmp_path):
    fasta, stdin_text = seed13
    for flags in (["--engine", "scan"], ["-v", str(tmp_path / "e.hmm")]):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            _run(port_main, [fasta, "--device", "cpu"] + flags, stdin_text)


def test_dna5_realign_fixture_is_current():
    """The stored inputs equal a fresh build (the JAX CLI outputs and the
    10 kb pair's JAX interpret and f64-engine pairs are not rebuilt
    here), and the port's synthetic pairs equal the generators they copy
    (tools/exp_long_read.py, bench.py's bench_dna_realign)."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from exp_long_read import synth_dna_pair as tool_pair
    from tests.fixtures.make_dna5_realign_fixture import (L_REF, N_CLI,
                                                          SEED)

    stored = np.load(DNA5_REALIGN)
    reads = dna_realign_batch()
    fasta, cigars = realign_inputs(reads[:N_CLI])
    assert [str(c) for c in stored["cigars_in"]] == cigars
    assert len(stored["cigars_out"]) == N_CLI
    # bench.py:188-196, verbatim
    rng = random.Random(11)
    bench = []
    for i in range(64):
        n = 2000
        sx = "".join(rng.choice("ACGT") for _ in range(n))
        sy = "".join(c if rng.random() > 0.12 else rng.choice("ACGT")
                     for c in sx)
        anchors = [(j, j) for j in range(40, n - 40, 50)]
        bench.append((sx, sy, n, len(sy), anchors))
    assert reads == bench
    pair = synth_dna_pair(np.random.default_rng(int(stored["seed"])),
                          int(stored["l_ref"]))
    assert pair == tool_pair(np.random.default_rng(SEED), L_REF)
    fx_fasta, fx_cigars, fx_pair, fx = load_dna5_realign()
    assert fx_cigars == cigars and fx_fasta == fasta and fx_pair == pair
    assert len(fx["engine_pairs"]) > 9000 and len(fx["tiled_pairs"]) > 9000
    # the JAX tiled path's own drift from the f64 engine sets the bar the
    # port's run of the pair is held to
    one, fringe, common = check_long_pairs(
        fx["tiled_pairs"], fx["engine_pairs"], 0.01,
        score_atol=LONG_DNA_ENGINE_SCORE_ATOL)
    assert common > LONG_SCORE_ATOL and one < 50
