"""The port's whole strawman run (prepare -> device features and bands ->
forward -> posterior backward -> top-k compaction -> extraction) vs the
JAX aligner's run, on the fixture reads (CPU: plain passes on the port's
side, interpret-mode Pallas kernels on the JAX side).  Tolerances:
cpecan_tpu_torch/parity.py."""

import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models.state_machines import StateMachine3SignalStrawman
from cpecan_tpu.ops import pallas_fb as jfb

from cpecan_tpu_torch.models.state_machines import machine_from_jax
from cpecan_tpu_torch.ops import compact as tc
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import StrawmanAligner
from cpecan_tpu_torch.parity import check_pairs, check_posts, check_totals
from tests.torch_parity import fixture_reads

CASES = {
    "flush": dict(),
    "ragged": dict(ragged_left=True, ragged_right=True),
    "scaled": dict(scale_params="sp"),
}


@pytest.fixture(scope="module")
def reads(template_model):
    return fixture_reads(template_model)


@pytest.fixture(scope="module")
def jax_aligner():
    return jfb.StrawmanPallasAligner(AlignmentParams(), interpret=True)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, template_model, reads, jax_aligner):
    kw = dict(CASES[request.param], compact_k=512)
    if kw.get("scale_params") == "sp":
        kw["scale_params"] = np.random.default_rng(4).uniform(
            0.95, 1.05, (len(reads), 5))
    sm = StateMachine3SignalStrawman(template_model)
    want = jax_aligner.run(sm, reads, **kw)
    fk.reset_counts()
    got = StrawmanAligner(device="cpu", group=jax_aligner.group).run(
        machine_from_jax(sm), reads, **kw)
    assert (fk.forward_plain.calls, fk.backward_plain.calls) == (1, 1)
    return tc.fetch(got), want


def test_run_planes_match_jax(runs):
    got, want = runs
    assert got["posteriors"].dtype == torch.float32
    assert tuple(got["posteriors"].shape) == want["posteriors"].shape
    check_posts(got["posteriors"].numpy(), want["posteriors"])
    check_totals(got["totals"].numpy(), np.asarray(want["totals"])[..., 0])
    for a, b in zip(got["compact"], want["compact"]):
        assert a.dtype == np.asarray(b).dtype and a.shape == b.shape


def test_run_pairs_match_jax(runs, reads):
    """Every extractor of the port against the JAX run's pairs: equal sets
    up to the threshold fringe, and the port's extractors agree with each
    other exactly."""
    got, want = runs
    thr = AlignmentParams().threshold
    prep = got["prep"]
    n_diags = [b.n_diag for b in prep["bands"]]
    chunk = tc.extract_pairs_chunk(got, list(range(len(reads))), n_diags,
                                   thr)
    want_chunk = jfb.extract_pairs_chunk(want, list(range(len(reads))),
                                         n_diags, thr)
    n_pairs = 0
    for i, nd in enumerate(n_diags):
        full = tc.extract_pairs_full(got, i, thr)
        auto = tc.extract_pairs_auto(got, i, nd, thr)
        vals, *idx = got["compact"]
        comp = tc.extract_pairs_compact(vals, tuple(idx), i, nd, prep, thr)
        assert sorted(auto) == sorted(comp) == sorted(map(tuple,
                                                          chunk[i].tolist()))
        assert {(x, y) for _, x, y in full} == {(x, y) for _, x, y in auto}
        check_pairs(auto, jfb.extract_pairs_auto(want, i, nd, thr), got,
                    want, i, thr)
        check_pairs(chunk[i].tolist(), want_chunk[i].tolist(), got, want, i,
                    thr)
        n_pairs += len(auto)
    assert n_pairs > 200


def test_saturated_topk_falls_back_to_full_plane(template_model, reads):
    """With k smaller than a read's pair count, every compacted value
    clears the threshold and the extractors read the full plane."""
    sm = machine_from_jax(StateMachine3SignalStrawman(template_model))
    out = StrawmanAligner(device="cpu", group=8).run(sm, reads[:2],
                                                     compact_k=8)
    thr = AlignmentParams().threshold
    nds = [b.n_diag for b in out["prep"]["bands"]]
    parts = tc.extract_pairs_chunk(out, [0, 1], nds, thr)
    for i in range(2):
        full = tc.extract_pairs_full(out, i, thr)
        assert len(full) > 8
        assert {(x, y) for _, x, y in full} == {
            (x, y) for _, x, y in parts[i].tolist()}


def test_run_leaves_its_compaction_in_flight(template_model, reads):
    """run returns with its compaction on its way to the host (a
    ``compact.HostCopy``); an extractor waits for it and puts the host
    arrays in its place, equal to a fresh compaction of the same plane."""
    sm = machine_from_jax(StateMachine3SignalStrawman(template_model))
    out = StrawmanAligner(device="cpu", group=8).run(sm, reads[:2],
                                                     compact_k=64)
    assert isinstance(out["compact"], tc.HostCopy)
    thr = AlignmentParams().threshold
    nd = out["prep"]["bands"][0].n_diag
    pairs = tc.extract_pairs_auto(out, 0, nd, thr)
    assert len(pairs) > 0
    assert not isinstance(out["compact"], tc.HostCopy)
    want = tc.compact_posteriors(out["posteriors"], 64).wait()
    for got, ref in zip(out["compact"], want):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert tc.fetch(out) is out
