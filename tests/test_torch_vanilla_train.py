"""The port's vanilla machine on the Zymo MinION read against the JAX
package's results stored in tests/fixtures/vanilla_zymo.npz (CPU: the plain
passes): the posterior pairs of the read's template job, two iterations
of vanilla trainModels (``train(sm_type="vanilla")``), the CLI with
``-smt vanilla``; the fixture against a fresh build; and the default
device.  Tolerances: cpecan_tpu_torch/parity.py."""

import io

import numpy as np
import pytest
import torch

from cpecan_tpu.models.hmm import VanillaHmm as JaxVanillaHmm
from cpecan_tpu.utils.checkpoint import CheckpointManager

from cpecan_tpu_torch.align import AlignmentParams
from cpecan_tpu_torch.cli.batch import train_models_main
from cpecan_tpu_torch.fixtures import (fixture_path, load_vanilla_zymo,
                                       load_zymo_train)
from cpecan_tpu_torch.io.poremodel import load_pore_model
from cpecan_tpu_torch.models.hmm import VanillaHmm
from cpecan_tpu_torch.models.state_machines import StateMachine3Vanilla
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.compact import extract_pairs_auto
from cpecan_tpu_torch.ops.fb import VanillaAligner
from cpecan_tpu_torch.parity import check_pair_sets, check_trained
from cpecan_tpu_torch.pipeline.train_models import TrainOptions, train
from tests.test_torch_train import _cli_args

THR = AlignmentParams().threshold


def test_zymo_pairs_match_jax_fixture():
    """The read's template job, scaled per read: the pair set against the
    JAX package's (the JAX test's bar against the f64 engine)."""
    job, sp, stored = load_vanilla_zymo()
    np.testing.assert_array_equal(sp, stored["sp"])
    sm = StateMachine3Vanilla(load_pore_model(
        fixture_path("template_median68pA.model")))
    out = VanillaAligner(device="cpu", group=1).run(sm, [job],
                                                     scale_params=sp[None])
    got = {(x, y) for _, x, y in extract_pairs_auto(
        out, 0, out["prep"]["bands"][0].n_diag, THR)}
    want = {(int(x), int(y)) for _, x, y in stored["pairs"]}
    check_pair_sets(got, want)
    assert len(want) > 900


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's vanilla training run (CPU): the first iteration with a
    checkpoint, then a resume that runs the second, as the fixture's JAX
    run was made."""
    tmp = tmp_path_factory.mktemp("vanilla_train")
    args, _ = load_zymo_train()
    stored = load_vanilla_zymo()[2]
    out = dict(out_template_hmm=str(tmp / "t.hmm"),
               out_complement_hmm=str(tmp / "c.hmm"))
    opts = dict(log=lambda m: None, checkpoint_dir=str(tmp / "ckpt"),
                device="cpu")
    fk.reset_counts()
    first = train(**args, **out, options=TrainOptions(
        sm_type="vanilla", iterations=1), **opts)
    t_hmm, c_hmm, traj = train(**args, **out, options=TrainOptions(
        sm_type="vanilla", iterations=len(stored["trajectory"])),
        resume=True, **opts)
    assert fk.forward_plain.calls == fk.backward_exp_plain.calls == 4
    return dict(args=args, stored=stored, out=out, first=first,
                last=(t_hmm, c_hmm, traj), opts=opts)


def test_train_matches_jax_fixture(trained):
    t_hmm, c_hmm, traj = trained["last"]
    assert isinstance(t_hmm, VanillaHmm) and isinstance(c_hmm, VanillaHmm)
    check_trained(t_hmm, c_hmm, traj, trained["stored"])


def test_first_iteration_matches_jax_fixture(trained):
    check_trained(*trained["first"], trained["stored"], first=True)


def test_train_writes_and_resumes(trained):
    """Each iteration's HMMs are written (the JAX loader reads them); a
    resume past the last iteration reloads them and runs no E-step."""
    out = trained["out"]
    t_hmm, c_hmm, traj = trained["last"]
    for path, hmm in ((out["out_template_hmm"], t_hmm),
                      (out["out_complement_hmm"], c_hmm)):
        loaded = JaxVanillaHmm.load(path)
        np.testing.assert_allclose(loaded.kmer_skip_bins, hmm.kmer_skip_bins,
                                   atol=1e-6)
        assert loaded.match_model.shape == (1 + 4096 * 5,)
    fk.reset_counts()
    again = train(**trained["args"], **out, options=TrainOptions(
        sm_type="vanilla", iterations=len(traj)), resume=True,
        **trained["opts"])
    assert fk.forward_plain.calls == 0 and again[2] == traj
    np.testing.assert_array_equal(
        again[0].kmer_skip_bins,
        VanillaHmm.load(out["out_template_hmm"]).kmer_skip_bins)


def _jax_first_iteration_checkpoint(directory, stored):
    """A checkpoint of the JAX vanilla trainer's first iteration, with the
    HMM files it would have written (no pore-model copies: the trainer
    reads only the skip bins back)."""
    texts = {}
    for s, likelihood in zip("tc", stored["trajectory"][0]):
        hmm = JaxVanillaHmm()
        hmm.kmer_skip_bins = stored[f"{s}1_skip"]
        hmm.likelihood = likelihood
        buf = io.StringIO()
        hmm.write(buf)
        texts[s] = buf.getvalue()
    CheckpointManager(directory).save(0, meta={
        "trajectory": [list(stored["trajectory"][0])],
        "template_hmm": texts["t"], "complement_hmm": texts["c"]})


def test_train_models_cli_vanilla_on_cpu(tmp_path, capsys):
    """cpecan-torch-train-models -smt vanilla --device cpu resumes from a
    checkpoint of the JAX package's first iteration and trains the
    second: it writes both vanilla HMMs, prints the trajectory, and
    matches the JAX package's second iteration."""
    args, zstored = load_zymo_train()
    stored = load_vanilla_zymo()[2]
    _jax_first_iteration_checkpoint(str(tmp_path / "ckpt"), stored)
    rc = train_models_main(_cli_args(tmp_path, args, zstored) + [
        "-smt", "vanilla", "-i", "2", "--checkpoint_dir",
        str(tmp_path / "ckpt"), "--resume", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()[-2:]
    assert [line.split("\t")[0] for line in lines] == ["iteration 0",
                                                        "iteration 1"]
    traj = [[float(v) for v in line.split("\t")[1:]] for line in lines]
    hmms = [VanillaHmm.load(str(tmp_path / "out" / f"{s}_trained.hmm"))
            for s in ("template", "complement")]
    for hmm in hmms:
        assert abs(hmm.kmer_skip_bins.sum() - 1.0) < 1e-4
    check_trained(*hmms, traj, stored)


def test_vanilla_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        VanillaAligner()
    args, _ = load_zymo_train()
    with pytest.raises(RuntimeError, match="is_available"):
        train(**args, out_template_hmm=str(tmp_path / "t.hmm"),
              out_complement_hmm=str(tmp_path / "c.hmm"),
              options=TrainOptions(sm_type="vanilla", iterations=1),
              log=lambda m: None)


def test_vanilla_fixture_matches_fresh_build():
    """Regenerate the JAX pairs and training result (interpret mode, about
    a minute) and compare with the committed fixture."""
    from tests.fixtures.make_vanilla_fixture import build_fixture

    fresh = build_fixture()
    stored = load_vanilla_zymo()[2]
    assert set(stored) == set(fresh)
    np.testing.assert_array_equal(fresh["sp"], stored["sp"])
    check_pair_sets({tuple(p[1:]) for p in fresh["pairs"].tolist()},
                    {tuple(p[1:]) for p in stored["pairs"].tolist()})
    # the interpret-mode kernels' f32 rounding may differ on another CPU:
    # hold the rebuild to the trained-HMM tolerances
    hmms = [VanillaHmm() for _ in "tc"]
    for s, h in zip("tc", hmms):
        h.kmer_skip_bins = fresh[f"{s}_skip"]
    check_trained(*hmms, fresh["trajectory"], stored)
