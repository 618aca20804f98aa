"""The port's vanilla EM expectations (K3 for the vanilla spec and the
skip-bin E-step) vs the JAX package (interpret-mode Pallas kernels on the
CPU).  The CUDA kernel is held against the plain version on the card by
tests/test_torch_gpu.py.

K3 alone: ``backward_exp_plain`` fed the JAX forward plane, against the
JAX expectation backward (no transition lanes; the beta and alpha rows of
the per-column accumulators).  The whole run:
``VanillaAligner.run(expectations=True)`` against
``VanillaPallasAligner.run(expectations=True)``, the skip bins finalized
on the host.  Tolerances: cpecan_tpu_torch/parity.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models.state_machines import StateMachine3Vanilla
from cpecan_tpu.ops.pallas_fb import VanillaPallasAligner

from cpecan_tpu_torch.fixtures import load_vanilla_zymo
from cpecan_tpu_torch.models.state_machines import vanilla_from_jax
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import VanillaAligner
from cpecan_tpu_torch.parity import (check_exp_sums, check_posts,
                                     check_totals,
                                     check_vanilla_expectations)
from tests.torch_parity import fixture_reads

# the training configuration: ragged ends, per-read scaling, and the skip
# bins of the stored JAX training run (after two iterations)
TRAINED = dict(ragged_left=True, ragged_right=True, scale_params="sp",
               trained=True)
KERNEL_CASES = {"flush": {}, "ragged": dict(ragged_left=True,
                                             ragged_right=True),
                "trained": TRAINED}
RUN_CASES = {"flush": {}, "trained": TRAINED}


def _setup(template_model, reads, kw):
    """(JAX machine, run keywords) of a case."""
    kw = dict(kw)
    skip = None
    if kw.pop("trained", False):
        skip = load_vanilla_zymo()[2]["t_skip"]
    if kw.get("scale_params") == "sp":
        kw["scale_params"] = np.random.default_rng(4).uniform(
            0.95, 1.05, (len(reads), 5))
    return StateMachine3Vanilla(template_model, skip_bin_probs=skip), kw


@pytest.fixture(scope="module")
def reads(template_model):
    return fixture_reads(template_model)


@pytest.fixture(scope="module", params=list(KERNEL_CASES))
def case(request, template_model, reads):
    """JAX expectation-backward outputs and the port's inputs, both fed
    the JAX forward plane."""
    sm, kw = _setup(template_model, reads, KERNEL_CASES[request.param])
    ragged_left = kw.get("ragged_left", False)
    prep_kw = dict(ragged_right=kw.get("ragged_right", False),
                   scale_params=kw.get("scale_params"))
    pa = VanillaPallasAligner(AlignmentParams(), interpret=True)
    prep = pa.prepare(sm, reads, **prep_kw)
    scal = pa._scalars(sm, ragged_left=ragged_left)
    fwd_fn, _, bwd_exp_fn = pa._fns(prep["X"], prep["ND"], prep["C"],
                                    prep["W"])
    xf, yf = pa._device_features(sm, prep)
    bands = pa._device_bands(prep["NDp"], prep["anch"].shape[1])(
        jnp.asarray(prep["anch"]), jnp.asarray(prep["meta"]))
    win3 = jnp.asarray(prep["win"][:, None, :])
    fwd = fwd_fn(scal, win3, xf, yf, *bands[:2])
    want = [np.asarray(v) for v in bwd_exp_fn(scal, win3, xf, yf, *bands,
                                              fwd)]
    ta = VanillaAligner(device="cpu", group=pa.group)
    tsm = vanilla_from_jax(sm)
    tprep = ta.prepare(tsm, reads, **prep_kw)
    inp = ta.device_inputs(tsm, tprep, ragged_left=ragged_left)
    dims = dict(R=tprep["R"], W=tprep["W"], ND=tprep["ND"], C=tprep["C"],
                spec=fk.VanillaSpec)
    return dict(inp=inp, dims=dims, fwd=np.asarray(fwd), want=want)


def _bwd_exp(case, fn):
    inp = case["inp"]
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], inp["seedf"], inp["raggedf"],
              torch.from_numpy(case["fwd"].copy()), **case["dims"])


def test_backward_exp_plain_matches_jax_kernel(case):
    """Through the wrapper, which on CPU tensors takes the plain version
    and launches nothing: no transition lanes (all 0), the beta and alpha
    rows against the JAX accumulators."""
    fk.reset_counts()
    posts, totals, trans, acc = _bwd_exp(case, fk.wavefront_bwd_exp)
    assert fk.backward_exp_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    w_posts, w_totals, w_trans, w_acc = case["want"]
    assert tuple(trans.shape) == w_trans.shape[:2] + (9,)
    assert tuple(acc.shape) == w_acc.shape and w_acc.shape[1] == 2
    assert not trans.any() and not np.any(w_trans)
    check_exp_sums(trans, acc, w_trans[..., :9], w_acc)
    assert acc.sum() > 0
    check_posts(posts.numpy(), w_posts)
    check_totals(totals.numpy(), w_totals[..., 0])
    # the posterior outputs are the posterior backward's, bit for bit
    p2, t2 = _bwd_exp(case, fk.backward_plain)
    assert torch.equal(posts, p2) and torch.equal(totals, t2)


@pytest.fixture(scope="module", params=list(RUN_CASES))
def runs(request, template_model, reads):
    sm, kw = _setup(template_model, reads, RUN_CASES[request.param])
    want = VanillaPallasAligner(AlignmentParams(), interpret=True).run(
        sm, reads, expectations=True, **kw)
    fk.reset_counts()
    got = VanillaAligner(device="cpu", group=8).run(
        vanilla_from_jax(sm), reads, expectations=True, **kw)
    assert (fk.forward_plain.calls, fk.backward_exp_plain.calls,
            fk.backward_plain.calls) == (1, 1, 0)
    return got, want


def test_run_expectations_match_jax(runs, reads):
    got, want = runs
    exp = got["expectations"]
    assert "compact" not in got and set(exp) == {"skip_bins", "likelihood"}
    assert exp["skip_bins"].shape == (len(reads), 60)
    assert all(v.dtype == np.float64 for v in exp.values())
    check_vanilla_expectations(exp, want["expectations"])


def test_deferred_expectations_match(template_model, reads):
    """run(defer_expectations=True) + finalize_expectations gives the
    undeferred run's skip bins."""
    sm, kw = _setup(template_model, reads, TRAINED)
    ta = VanillaAligner(device="cpu", group=8)
    tsm = vanilla_from_jax(sm)
    out = ta.run(tsm, reads, expectations=True, defer_expectations=True,
                 **kw)
    assert set(out) == {"expectations_flat", "totals", "prep"}
    got = ta.finalize_expectations(tsm, out)
    want = ta.run(tsm, reads, expectations=True, **kw)["expectations"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
