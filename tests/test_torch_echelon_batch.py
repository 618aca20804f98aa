"""The echelon machine in the port's signalAlign batch pipeline
(``run_batch_fast(sm_type="echelon")``) on the CPU: the Zymo read's
posterior tsv (both strands, the multi-state posteriors expanded to pairs)
against the JAX package's ``run_batch_fast`` tsv stored in
tests/fixtures/echelon_zymo.npz (``parity.check_tsv(multi=True)``), a
batch drained one chunk behind against its reads run alone, and the
refusal of an HMM file.  The card's run is held to the CPU's by
tests/test_torch_gpu.py."""

import numpy as np
import pytest

from cpecan_tpu_torch.fixtures import (ZYMO_TRAIN, fixture_path,
                                       load_echelon_zymo)
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.parity import check_tsv
from cpecan_tpu_torch.pipeline import signal_align_batch as sab
from tests.torch_batch_reads import make_reads

MODELS = dict(
    template_model_file=fixture_path("template_median68pA.model"),
    complement_model_file=fixture_path("complement_median68pA_pop2.model"))
THR = 0.15


def _run(pairs, out_dir, **kw):
    return sab.run_batch_fast(fixture_path("ZymoRef.txt"), pairs,
                              str(out_dir), device="cpu", log=lambda m: None,
                              sm_type="echelon", threshold=THR,
                              **dict(MODELS, **kw))


def test_zymo_matches_jax_run_batch_fast(tmp_path):
    """Both strands of the Zymo read through the plain echelon passes at
    threshold 0.15, against the JAX package's tsv of the same read and
    guide (the fixture's guide is zymo_train.npz's)."""
    args, tsvs = load_echelon_zymo()
    assert args["npread_guide_pairs"][0][1] == str(
        np.load(ZYMO_TRAIN)["guide"])
    assert args["threshold"] == THR and set(tsvs) == {"echelon"}
    label = args.pop("label")
    ref = args.pop("reference_path")
    fk.reset_counts()
    res = sab.run_batch_fast(ref, args.pop("npread_guide_pairs"),
                             str(tmp_path), device="cpu",
                             log=lambda m: None, sm_type="echelon", **args)
    assert [(r[0], r[1]) for r in res] == [(label, True)]
    # one posterior run per strand, no kernel launch on the CPU
    assert (fk.forward_plain.calls, fk.backward_plain.calls) == (2, 2)
    assert not fk.KERNEL_LAUNCHES
    got = (tmp_path / f"{label}.tsv").read_bytes()
    n_one, err = check_tsv(got, tsvs["echelon"], THR, multi=True)
    rows = got.decode().splitlines()
    assert {r.split("\t")[4] for r in rows} == {"t", "c"}
    # the expansion repeats pairs: some (strand, position, event) keys
    # hold several rows
    keys = [tuple(r.split("\t")[i] for i in (4, 1, 5)) for r in rows]
    assert len(rows) > 1000 and len(set(keys)) < len(keys) and n_one <= 2


def test_drain_matches_reads_run_alone(tmp_path):
    """Three reads in chunks of two (groups of two), drained one chunk
    behind through ``extract_echelon_pairs_chunk``, give each read's tsv
    of a run of that read alone (within check_tsv: the group window moves
    the lane-sum order)."""
    pairs = make_reads(tmp_path / "reads", [150, 170, 160])
    res = _run(pairs, tmp_path / "batch", chunk=2, group=2)
    assert [r[:2] for r in res] == [(f"read{i}", True) for i in range(3)]
    for i, pair in enumerate(pairs):
        alone = _run([pair], tmp_path / f"alone{i}")
        assert alone[0][:2] == (f"read{i}", True)
        got = (tmp_path / "batch" / f"read{i}.tsv").read_bytes()
        want = (tmp_path / f"alone{i}" / f"read{i}.tsv").read_bytes()
        assert len(got.splitlines()) > 100
        check_tsv(got, want, THR, multi=True)


def test_hmm_file_is_refused_before_any_work(tmp_path):
    """Echelon has no trainable HMM (the reference defines no echelon EM):
    an HMM file for either strand is refused before any read is loaded
    and before the output directory is made."""
    for kw in (dict(in_template_hmm="t.hmm"),
               dict(in_complement_hmm="c.hmm")):
        with pytest.raises(ValueError, match="no trainable HMM"):
            _run([(str(tmp_path / "missing.npRead"), "cigar: x")],
                 tmp_path / "out", **kw)
    assert not (tmp_path / "out").exists()
