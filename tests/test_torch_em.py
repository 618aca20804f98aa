"""The port's cPecanEm path (``pipeline/em.py``, ``cli/batch.py::em_main``)
against the JAX package's (``engine="pallas"``, interpret-mode Pallas
kernels on the CPU), on the case of ``tests/test_pipelines.py::
test_em_pallas_engine_matches_scan``, which ``tests/fixtures/dna5_em.npz``
stores for the card.  The dna5 expectation kernel and runs themselves:
tests/test_torch_dna5_exp.py.  Tolerances: cpecan_tpu_torch/parity.py.
"""

import copy
import io
import random

import numpy as np
import pytest

from cpecan_tpu.io.cigar import parse_cigar_line as j_parse_cigar_line
from cpecan_tpu.pipeline import em as j_em

from cpecan_tpu_torch.cli.batch import em_main
from cpecan_tpu_torch.fixtures import load_dna5_em
from cpecan_tpu_torch.io.cigar import cigar_write, parse_cigar_line
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.parity import check_em
from cpecan_tpu_torch.pipeline import em as t_em
from cpecan_tpu_torch.synthetic import dna_em_batch
from tests.fixtures.make_dna5_em_fixture import (CASE, ITERATIONS,
                                                 MODEL_TYPES, RNG_SEED,
                                                 arrays, jax_em)


def _options(model_type="fiveState", **kw):
    return t_em.EmOptions(model_type=model_type, iterations=ITERATIONS,
                          train_emissions=True, **kw)


def _port_em(model_type, **kw):
    seqs, alns, _ = dna_em_batch(**CASE)
    return t_em.expectation_maximisation(seqs, alns, _options(model_type),
                                         random.Random(RNG_SEED),
                                         device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_hmms():
    return {m: jax_em(m) for m in MODEL_TYPES}


@pytest.fixture(scope="module")
def port_hmms():
    fk.reset_counts()
    hmms = {m: _port_em(m) for m in MODEL_TYPES}
    # one forward and one expectation backward per iteration (3 jobs, one
    # chunk) and model type
    assert fk.forward_plain.calls == fk.backward_exp_plain.calls == \
        ITERATIONS * len(MODEL_TYPES)
    assert not fk.KERNEL_LAUNCHES and fk.backward_plain.calls == 0
    return hmms


def _model(h):
    return h.transitions, h.emissions, h.running_likelihoods


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_em_matches_jax(port_hmms, jax_hmms, model_type):
    """Transitions, emissions and running likelihoods of three iterations
    against the JAX engine="pallas" run; the likelihood rises."""
    got, want = port_hmms[model_type], jax_hmms[model_type]
    check_em(*_model(got), *_model(want))
    liks = got.running_likelihoods
    assert len(liks) == ITERATIONS and got.likelihood == liks[-1]
    for prev, cur in zip(liks, liks[1:]):
        assert prev <= cur * 0.95
    if model_type == "fiveState":
        sm = got.to_state_machine()
        assert sm.p["gap_short_open_y"] == sm.p["gap_short_open_x"]


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_em_fixture_is_current(jax_hmms, port_hmms, model_type):
    """tests/fixtures/dna5_em.npz holds the JAX run of this case (its
    builder's inputs and options), and the port meets it as the card
    must."""
    seqs, alns, stored = load_dna5_em()
    assert (seqs, [cigar_write(a) for a in alns]) == (
        dna_em_batch(**CASE)[0], [cigar_write(a) for a in dna_em_batch(
            **CASE)[1]])
    want = arrays(jax_hmms)
    assert {k: str(stored[k]) for k in CASE} == {k: str(want[k])
                                                for k in CASE}
    assert list(stored["model_types"]) == list(MODEL_TYPES)
    m = model_type
    check_em(stored[f"{m}_transitions"], stored[f"{m}_emissions"],
             stored[f"{m}_running"], want[f"{m}_transitions"],
             want[f"{m}_emissions"], want[f"{m}_running"])
    check_em(*_model(port_hmms[m]), stored[f"{m}_transitions"],
             stored[f"{m}_emissions"], stored[f"{m}_running"])


def test_shards_and_jobs_match_jax():
    """``_shard_alignments`` draws the JAX shards from the same generator
    (small shards, so the shuffle and sample matter), and
    ``_alignment_jobs`` gives the JAX jobs exactly, a split alignment
    included."""
    seqs, alns, _ = dna_em_batch(n_pairs=12, length=300, seed=8)
    j_alns = [j_parse_cigar_line(cigar_write(a)) for a in alns]
    opts = dict(max_alignment_length_per_job=700,
                max_alignment_length_to_sample=2500)
    got = t_em._shard_alignments(alns, t_em.EmOptions(**opts),
                                 random.Random(4))
    want = j_em._shard_alignments(j_alns, j_em.EmOptions(**opts),
                                  random.Random(4))
    assert [[cigar_write(a) for a in s] for s in got] == \
        [[cigar_write(a) for a in s] for s in want]
    assert 1 < len(got) < 6
    # a long anchor-free gap: cigar M 40, D 2300, I 2300, M 40 splits
    sx = seqs["x0"] * 9
    sy = seqs["y0"] * 9
    seqs2 = {"a": sx[:2380], "b": sy[:2380]}
    line = "cigar: b 0 2380 + a 0 2380 + 0 M 40 D 2300 I 2300 M 40"
    params = t_em.EmOptions().realign_params
    params.split_matrix_bigger_than_this = 1000 * 1000
    jparams = j_em.EmOptions().realign_params
    jparams.split_matrix_bigger_than_this = 1000 * 1000
    for cig, sq in (([cigar_write(a) for a in alns], seqs),
                    ([line], seqs2)):
        tj = t_em._alignment_jobs([parse_cigar_line(c) for c in cig], sq,
                                  params)
        jj = j_em._alignment_jobs([j_parse_cigar_line(c) for c in cig], sq,
                                  jparams)
        assert len(tj) == len(jj)
        for a, b in zip(tj, jj):
            assert a[:4] == b[:4]
            np.testing.assert_array_equal(np.asarray(a[4]).reshape(-1, 2),
                                          np.asarray(b[4]).reshape(-1, 2))
    assert len(tj) > 1


def _write_inputs(tmp_path):
    seqs, alns, _ = dna_em_batch(**CASE)
    fa = tmp_path / "seqs.fa"
    fa.write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    cig = tmp_path / "alignments.cigar"
    cig.write_text("\n".join(cigar_write(a) for a in alns) + "\n")
    return seqs, fa, cig


def test_em_cli_matches_jax_library(jax_hmms, tmp_path):
    """``cpecan-torch-em`` on the CPU against the JAX package's library run
    with the same options: the model file and the lastz scoring matrix."""
    seqs, fa, cig = _write_inputs(tmp_path)
    model = tmp_path / "hmm.txt"
    lastz = tmp_path / "lastz.txt"
    assert em_main(["--sequences", str(fa), "--alignments", str(cig),
                    "--outputModel", str(model), "--iterations",
                    str(ITERATIONS), "--trainEmissions",
                    "--outputLastzScoringMatrix", str(lastz),
                    "--device", "cpu"]) == 0
    got = t_em.PipelineHmm.load(str(model))
    want = jax_hmms["fiveState"]
    check_em(got.transitions, got.emissions, [got.likelihood],
             want.transitions, want.emissions, [want.likelihood])
    out = io.StringIO()
    j_em.write_lastz_scoring_matrix(
        out, *j_em.make_blast_scoring_matrix(want, seqs.values()))
    assert lastz.read_text() == out.getvalue()
    # the port's own matrix code on the JAX model gives the same text
    out2 = io.StringIO()
    t_em.write_lastz_scoring_matrix(
        out2, *t_em.make_blast_scoring_matrix(want, seqs.values()))
    assert out2.getvalue() == out.getvalue()


def test_checkpoint_resume_equals_full_run(tmp_path):
    """An EM run cut after its first iteration and resumed from the
    checkpoint ends where an uncut run ends (the shard draw's RNG state
    restored)."""
    seqs, alns, _ = dna_em_batch(n_pairs=2, length=60, seed=5)
    opts = t_em.EmOptions(iterations=2, train_emissions=True,
                          max_alignment_length_per_job=50)

    def run(iterations, **kw):
        return t_em.expectation_maximisation(
            seqs, copy.deepcopy(alns),
            t_em.EmOptions(**{**opts.__dict__, "iterations": iterations}),
            random.Random(9), device="cpu", **kw)

    full = run(2)
    ckpt = str(tmp_path / "ckpt")
    run(1, checkpoint_dir=ckpt)
    resumed = run(2, checkpoint_dir=ckpt, resume=True)
    np.testing.assert_array_equal(resumed.transitions, full.transitions)
    np.testing.assert_array_equal(resumed.emissions, full.emissions)
    assert resumed.running_likelihoods == full.running_likelihoods
    assert len(full.running_likelihoods) == 2


@pytest.mark.parametrize("what", ["scan", "update_the_band", "mesh"])
def test_refusals_name_the_roadmap_item(what):
    """The scan engine, update_the_band (its re-alignment runs the scan
    engine) and data-parallel E-steps are not ported: each raises before
    any pass runs, naming its ROADMAP item."""
    seqs, alns, _ = dna_em_batch(n_pairs=1, length=40, seed=1)
    fk.reset_counts()
    if what == "mesh":
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            t_em.calculate_expectations_pallas(
                [alns], seqs, None, t_em.EmOptions().realign_params, None,
                mesh=object())
    else:
        opts = (_options(engine="scan") if what == "scan"
                else _options(update_the_band=True))
        for fn in (t_em.expectation_maximisation,
                   t_em.expectation_maximisation_trials):
            with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
                fn(seqs, alns, opts, device="cpu")
    assert fk.forward_plain.calls == 0


def test_em_runs_on_the_card_by_default(monkeypatch):
    """Without a device the E-step aligner is the CUDA one."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs, alns, _ = dna_em_batch(n_pairs=1, length=40, seed=1)
    with pytest.raises(RuntimeError, match="is_available"):
        t_em.expectation_maximisation(seqs, alns, _options())
    assert t_em.EmOptions().engine == "pallas"
