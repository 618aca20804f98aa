"""The port's trainModels path (pipeline/train_models.py, cli/batch.py) on
the Zymo MinION read against the JAX package's two-iteration result stored
in tests/fixtures/zymo_train.npz (CPU: the plain passes), and the fixture
against a fresh build.  Tolerances: cpecan_tpu_torch/parity.py."""

import io
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from cpecan_tpu.models.hmm import ContinuousPairHmm
from cpecan_tpu.ops.blast import find_lastz
from cpecan_tpu.utils.checkpoint import CheckpointManager

from cpecan_tpu_torch.cli.batch import train_models_main
from cpecan_tpu_torch.fixtures import ZYMO_TRAIN, load_zymo_train
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.parity import check_trained
from cpecan_tpu_torch.pipeline.train_models import TrainOptions, train


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's training run (CPU, with checkpoints): the first
    iteration, then a resume that runs the second, as the fixture's JAX
    run was made."""
    tmp = tmp_path_factory.mktemp("train")
    args, stored = load_zymo_train()
    out = dict(out_template_hmm=str(tmp / "t.hmm"),
               out_complement_hmm=str(tmp / "c.hmm"))
    fk.reset_counts()
    first = train(**args, **out, options=TrainOptions(iterations=1),
                  log=lambda m: None, checkpoint_dir=str(tmp / "ckpt"),
                  device="cpu")
    t_hmm, c_hmm, traj = train(
        **args, **out, options=TrainOptions(iterations=len(
            stored["trajectory"])), log=lambda m: None,
        checkpoint_dir=str(tmp / "ckpt"), resume=True, device="cpu")
    # one forward and one expectation backward per strand and iteration
    assert fk.forward_plain.calls == fk.backward_exp_plain.calls == 4
    assert traj[0] == first[2][0]
    return dict(args=args, stored=stored, out=out, tmp=tmp, t_hmm=t_hmm,
                c_hmm=c_hmm, trajectory=traj, first=first)


def test_train_matches_jax_fixture(trained):
    check_trained(trained["t_hmm"], trained["c_hmm"], trained["trajectory"],
                  trained["stored"])


def test_first_iteration_matches_jax_fixture(trained):
    """The first iteration's HMMs as the M-step leaves them, before any
    six-decimal HMM file, against the JAX package's."""
    check_trained(*trained["first"], trained["stored"], first=True)


def test_train_writes_and_resumes(trained):
    """Each iteration's HMMs are written and checkpointed; a resume past
    the last iteration reloads them and runs no E-step."""
    out = trained["out"]
    for path, hmm in ((out["out_template_hmm"], trained["t_hmm"]),
                      (out["out_complement_hmm"], trained["c_hmm"])):
        loaded = ContinuousPairHmm.load(path)
        np.testing.assert_allclose(loaded.transitions, hmm.transitions,
                                   atol=1e-6)
    fk.reset_counts()
    t_hmm, c_hmm, traj = train(
        **trained["args"], **out,
        options=TrainOptions(iterations=len(trained["trajectory"])),
        log=lambda m: None, checkpoint_dir=str(trained["tmp"] / "ckpt"),
        resume=True, device="cpu")
    assert fk.forward_plain.calls == 0
    assert traj == [tuple(t) for t in trained["trajectory"]]
    np.testing.assert_array_equal(
        t_hmm.transitions,
        ContinuousPairHmm.load(out["out_template_hmm"]).transitions)


def _jax_first_iteration_checkpoint(directory, stored):
    """A checkpoint of the JAX trainer's first iteration, as its train()
    saves one: the trajectory so far and the HMM files it wrote."""
    texts = {}
    for s, likelihood in zip("tc", stored["trajectory"][0]):
        hmm = ContinuousPairHmm()
        hmm.transitions = stored[f"{s}1_trans"]
        hmm.kmer_gap_probs = stored[f"{s}1_kmer_gap"]
        hmm.likelihood = likelihood
        buf = io.StringIO()
        hmm.write(buf)
        texts[s] = buf.getvalue()
    CheckpointManager(directory).save(0, meta={
        "trajectory": [list(stored["trajectory"][0])],
        "template_hmm": texts["t"], "complement_hmm": texts["c"]})


def _cli_args(tmp_path, args, stored):
    """train_models_main's required flags for the Zymo read."""
    guide = str(stored["guide"])
    reads = tmp_path / "reads"
    reads.mkdir()
    # the guide's query name keys the read file
    shutil.copy(args["read_guide_pairs"][0][0],
                reads / f"{guide.split()[1]}.npRead")
    (tmp_path / "guides.cig").write_text(guide + "\n")
    return ["-d", str(reads), "-r", args["reference_path"], "-o",
            str(tmp_path / "out"), "-T", args["template_model"], "-C",
            args["complement_model"], "--guides",
            str(tmp_path / "guides.cig")]


def test_train_models_cli_on_cpu(tmp_path, capsys):
    """cpecan-torch-train-models --device cpu resumes from a checkpoint of
    the JAX package's first iteration and trains the second: it writes
    both HMMs and prints the trajectory, and from the same starting
    machine the port's second iteration is the JAX package's."""
    args, stored = load_zymo_train()
    _jax_first_iteration_checkpoint(str(tmp_path / "ckpt"), stored)
    rc = train_models_main(_cli_args(tmp_path, args, stored) + [
        "-i", "2", "--checkpoint_dir", str(tmp_path / "ckpt"), "--resume",
        "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()[-2:]
    assert [line.split("\t")[0] for line in lines] == ["iteration 0",
                                                        "iteration 1"]
    traj = [[float(v) for v in line.split("\t")[1:]] for line in lines]
    np.testing.assert_array_equal(traj[0], stored["trajectory"][0])
    hmms = [ContinuousPairHmm.load(str(tmp_path / "out" / f"{s}_trained.hmm"))
            for s in ("template", "complement")]
    for hmm in hmms:
        np.testing.assert_allclose(hmm.transitions.sum(1), 1.0, atol=1e-5)
    check_trained(*hmms, traj, stored)


@pytest.mark.parametrize("flag", [["--train_amount", "5000"],
                                  ["--threshold", "0.2"]],
                         ids=["train_amount", "threshold"])
def test_train_models_cli_refuses_unread_flags(tmp_path, capsys, flag):
    """Flags the trainer does not read are refused unless at default."""
    args, stored = load_zymo_train()
    with pytest.raises(SystemExit) as exc:
        train_models_main(_cli_args(tmp_path, args, stored) + flag)
    assert exc.value.code == 2
    assert "has no effect" in capsys.readouterr().err


@pytest.mark.parametrize("kw, match", [
    (dict(engine="scan"), "Queue 1 item 7"),
    (dict(mesh=object()), "Queue 1 item 9"),
], ids=["scan", "mesh"])
def test_unported_training_options_raise(tmp_path, kw, match):
    args, _ = load_zymo_train()
    mesh = kw.pop("mesh", None)
    with pytest.raises(NotImplementedError, match=match):
        train(**args, out_template_hmm=str(tmp_path / "t.hmm"),
              out_complement_hmm=str(tmp_path / "c.hmm"),
              options=TrainOptions(iterations=1, **kw), mesh=mesh,
              device="cpu")


def test_zymo_train_fixture_matches_fresh_build():
    """Regenerate the guide (lastz) and the JAX training result (interpret
    mode, under a minute) and compare with the committed fixture."""
    if find_lastz() is None:
        pytest.skip("lastz unavailable")
    from tests.fixtures.make_zymo_train_fixture import build_fixture

    fresh = build_fixture()
    _, stored = load_zymo_train()
    assert set(stored) == set(fresh)
    assert str(fresh["guide"]) == str(stored["guide"])
    # the interpret-mode kernels' f32 rounding may differ on another CPU:
    # hold the rebuild to the trained-HMM tolerances
    hmms = [SimpleNamespace(transitions=fresh[f"{s}_trans"],
                            kmer_gap_probs=fresh[f"{s}_kmer_gap"])
            for s in "tc"]
    check_trained(*hmms, fresh["trajectory"], stored)
    first = [SimpleNamespace(transitions=fresh[f"{s}1_trans"],
                             kmer_gap_probs=fresh[f"{s}1_kmer_gap"])
             for s in "tc"]
    check_trained(*first, fresh["trajectory"][:1], stored, first=True)
    assert os.path.getsize(ZYMO_TRAIN) < 64 * 1024
