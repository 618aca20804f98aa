"""The port's signalAlign batch pipeline
(``cpecan_tpu_torch.pipeline.signal_align_batch.run_batch_fast``) on the
CPU: the Zymo read's posterior tsv for the threeState, vanilla and
fourState machines against the JAX package's ``run_batch_fast`` tsvs
stored in tests/fixtures/batch_zymo.npz (``parity.check_tsv``), the
one-chunk-behind drain, a read skipped for its anchors, and the refusals.
The card's run is held to the CPU's by tests/test_torch_gpu.py."""

import os

import numpy as np
import pytest

from cpecan_tpu_torch.fixtures import (BATCH_ZYMO, fixture_path,
                                       load_batch_zymo)
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.parity import check_tsv
from cpecan_tpu_torch.pipeline import signal_align_batch as sab
from tests.torch_batch_reads import make_reads, stored_guide

MODELS = dict(
    template_model_file=fixture_path("template_median68pA.model"),
    complement_model_file=fixture_path("complement_median68pA_pop2.model"))


def _run(pairs, out_dir, **kw):
    logs = []
    kw = dict(MODELS, device="cpu", log=logs.append, **kw)
    res = sab.run_batch_fast(fixture_path("ZymoRef.txt"), pairs,
                             str(out_dir), **kw)
    return res, logs


def _tsvs(out_dir, results):
    return {label: (out_dir / f"{label}.tsv").read_bytes()
            for label, ok, _ in results if ok}


@pytest.mark.parametrize("sm_type", ["threeState", "vanilla", "fourState"])
def test_zymo_matches_jax_run_batch_fast(tmp_path, sm_type):
    """Both strands of the Zymo read through the plain passes, against the
    JAX package's tsv of the same read and guide."""
    args, tsvs = load_batch_zymo()
    label = args.pop("label")
    ref = args.pop("reference_path")
    fk.reset_counts()
    res = sab.run_batch_fast(ref, args.pop("npread_guide_pairs"),
                             str(tmp_path), device="cpu",
                             log=lambda m: None, sm_type=sm_type, **args)
    assert [(r[0], r[1]) for r in res] == [(label, True)]
    # one posterior run per strand, no kernel launch on the CPU
    assert (fk.forward_plain.calls, fk.backward_plain.calls) == (2, 2)
    assert not fk.KERNEL_LAUNCHES
    got = (tmp_path / f"{label}.tsv").read_bytes()
    n_one, err = check_tsv(got, tsvs[sm_type], args["threshold"])
    rows = got.decode().splitlines()
    assert {r.split("\t")[4] for r in rows} == {"t", "c"}
    assert len(rows) > 1800 and n_one <= 2


def test_batch_fixture_is_current():
    """The stored guide is zymo_train.npz's, and each stored tsv holds both
    strands of the read."""
    with np.load(BATCH_ZYMO) as z:
        assert str(z["guide"]) == stored_guide()
        for sm in ("threeState", "vanilla", "fourState"):
            text = z[f"{sm}_tsv"].tobytes().decode()
            strands = {r.split("\t")[4] for r in text.splitlines()}
            assert strands == {"t", "c"}


def test_chunked_drain_loses_and_reorders_nothing(tmp_path):
    """Three reads drained one chunk behind (chunk 2, the last chunk a
    single read) write the tsvs of chunk 1, read for read, with their rows
    in the same order; a run with a stage hook names every step.  A run
    quantizes the events of its chunk together (``features.
    quantize_events``, as the JAX package does), so a read that shares a
    chunk gets other event codes and its tsv is held to chunk 1's by
    ``check_tsv``; the last read, alone in its chunk both times, byte for
    byte.  One read per kernel group keeps each read's window."""
    pairs = make_reads(tmp_path / "reads", [110, 170, 140])
    steps = []

    def stage(name, fn):
        steps.append(name)
        return fn()

    res1, _ = _run(pairs, tmp_path / "c1", chunk=1, group=1)
    res2, logs = _run(pairs, tmp_path / "c2", chunk=2, group=1, stage=stage)
    assert [r[:2] for r in res1] == [r[:2] for r in res2] == [
        (f"read{i}", True) for i in range(3)]
    t1, t2 = _tsvs(tmp_path / "c1", res1), _tsvs(tmp_path / "c2", res2)
    assert t1["read2"] == t2["read2"]
    for label in t1:
        check_tsv(t2[label], t1[label])
        keys = [[tuple(r.split("\t")[i] for i in (4, 1, 5))
                 for r in t.decode().splitlines()] for t in (t1[label],
                                                             t2[label])]
        shared = set(keys[0]) & set(keys[1])
        assert [k for k in keys[0] if k in shared] == \
            [k for k in keys[1] if k in shared]
    assert sum("tsv formatter" in m for m in logs) == 1
    assert steps[:2] == ["load", "bands"]
    assert steps.count("chunk") == 2 and steps.count("write") == 2
    assert {"fetch", "extract"} <= set(steps)


def test_bad_read_is_skipped_with_a_log_line(tmp_path):
    """A read whose anchors run past its event slice is logged and
    skipped; the rest of the batch is written."""
    pairs = make_reads(tmp_path / "reads", [150, 160, 170], bad={1})
    res, logs = _run(pairs, tmp_path / "out", chunk=2, group=2)
    assert [r[0] for r in res] == ["read0", "read2"]
    assert all(r[1] for r in res)
    assert any("skipping read1" in m and "in range" in m for m in logs)
    assert sorted(os.listdir(tmp_path / "out")) == ["read0.tsv",
                                                    "read2.tsv"]


@pytest.mark.parametrize("kw, match, exc", [
    # echelon is ported: what it refuses is an HMM file (the reference
    # defines no echelon EM); the id keeps the case's earlier name
    pytest.param(dict(sm_type="echelon", in_template_hmm="t.hmm"),
                 "no trainable HMM", ValueError, id="kw0-item 3c"),
    pytest.param(dict(mesh=object()), "item 9", NotImplementedError,
                 id="kw1-item 9")])
def test_unported_options_raise_before_any_work(tmp_path, kw, match, exc):
    """An HMM file for echelon and a mesh are refused before any read is
    loaded (the read path does not exist) and before the output directory
    is made."""
    with pytest.raises(exc, match=match):
        _run([(str(tmp_path / "missing.npRead"), "cigar: x")],
             tmp_path / "out", **kw)
    assert not (tmp_path / "out").exists()
    with pytest.raises(NotImplementedError, match="item 8b"):
        sab.run_batch("ref", [], str(tmp_path))
