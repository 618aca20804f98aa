"""The port's EM expectation backward (K3) and expectation runs vs the JAX
package (interpret-mode Pallas kernels on the CPU).  The CUDA kernel is
held against the plain version on the card by tests/test_torch_gpu.py.

K3 alone: ``backward_exp_plain`` fed the JAX forward plane, against the
JAX expectation backward (``_fns.make_bwd(True)``).  The whole run:
``StrawmanAligner.run(expectations=True)`` against
``StrawmanPallasAligner.run(expectations=True)``.  Tolerances:
cpecan_tpu_torch/parity.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models.state_machines import StateMachine3SignalStrawman
from cpecan_tpu.ops.pallas_fb import StrawmanPallasAligner

from cpecan_tpu_torch.fixtures import zymo_trained_params
from cpecan_tpu_torch.models.state_machines import machine_from_jax
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import StrawmanAligner
from cpecan_tpu_torch.parity import (check_exp_sums, check_expectations,
                                     check_posts, check_totals)
from tests.torch_parity import fixture_reads

# the training configuration: ragged ends, per-read scaling, and a machine
# after one M-step (finite gap_switch_to_x, per-kmer gap-X table)
TRAINED = dict(ragged_left=True, ragged_right=True, scale_params="sp",
               trained=True)
KERNEL_CASES = {"flush": {}, "ragged": dict(ragged_left=True,
                                             ragged_right=True),
                "scaled": dict(scale_params="sp")}
RUN_CASES = {"flush": {}, "trained": TRAINED}


def _setup(template_model, reads, kw):
    """(JAX machine, run keywords) of a case; scale_params "sp" draws
    per-read scale parameters as tests/test_torch_run.py does."""
    kw = dict(kw)
    params = gap_x = None
    if kw.pop("trained", False):
        params, gap_x = zymo_trained_params()
    if kw.get("scale_params") == "sp":
        kw["scale_params"] = np.random.default_rng(4).uniform(
            0.95, 1.05, (len(reads), 5))
    sm = StateMachine3SignalStrawman(template_model, params=params,
                                     gap_x_log_probs=gap_x)
    return sm, kw


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
    pa = StrawmanPallasAligner(AlignmentParams(), interpret=True)
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
    ta = StrawmanAligner(device="cpu", group=pa.group)
    tsm = machine_from_jax(sm)
    tprep = ta.prepare(tsm, reads, **prep_kw)
    inp = ta.device_inputs(tsm, tprep, ragged_left=ragged_left)
    dims = dict(R=tprep["R"], W=tprep["W"], ND=tprep["ND"], C=tprep["C"])
    return dict(inp=inp, dims=dims, fwd=np.asarray(fwd), want=want)


def _bwd_exp(case, fn):
    inp = case["inp"]
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], inp["seedf"], inp["raggedf"],
              torch.from_numpy(case["fwd"].copy()), **case["dims"])


def test_backward_exp_plain_matches_jax_kernel(case):
    """Through the wrapper, which on CPU tensors takes the plain version
    and launches nothing."""
    fk.reset_counts()
    posts, totals, trans, gapx = _bwd_exp(case, fk.wavefront_bwd_exp)
    assert fk.backward_exp_plain.calls == 1
    assert fk.wavefront_bwd_exp.launches == fk.backward_plain.calls == 0
    w_posts, w_totals, w_trans, w_gapx = case["want"]
    assert trans.dtype == gapx.dtype == torch.float32
    assert tuple(trans.shape) == w_trans.shape[:2] + (9,)
    assert tuple(gapx.shape) == w_gapx.shape
    # lane 5 (X -> Y) is no transition of the machine; the JAX lanes past
    # 9 are padding
    assert np.all(trans[..., 5].numpy() == 0.0)
    assert np.all(w_trans[..., 9:] == 0.0)
    check_exp_sums(trans, gapx, w_trans[..., :9], w_gapx)
    check_posts(posts.numpy(), w_posts)
    check_totals(totals.numpy(), w_totals[..., 0])
    # the posterior outputs are the posterior backward's, bit for bit
    p2, t2 = _bwd_exp(case, fk.backward_plain)
    assert torch.equal(posts, p2) and torch.equal(totals, t2)


@pytest.fixture(scope="module", params=list(RUN_CASES))
def runs(request, template_model, reads):
    sm, kw = _setup(template_model, reads, RUN_CASES[request.param])
    want = StrawmanPallasAligner(AlignmentParams(), interpret=True).run(
        sm, reads, expectations=True, **kw)
    fk.reset_counts()
    got = StrawmanAligner(device="cpu", group=8).run(
        machine_from_jax(sm), reads, expectations=True, **kw)
    assert (fk.forward_plain.calls, fk.backward_exp_plain.calls,
            fk.backward_plain.calls) == (1, 1, 0)
    return got, want, request.param == "trained"


def test_run_expectations_match_jax(runs, reads):
    got, want, trained = runs
    exp = got["expectations"]
    assert "compact" not in got
    assert exp["trans"].shape == (len(reads), 3, 3)
    assert exp["kmer_gap"].shape == want["expectations"]["kmer_gap"].shape
    assert all(v.dtype == np.float64 for v in exp.values())
    # Y -> X mass: every read's with the trained machine, none without
    y_to_x = exp["trans"][:, 2, 1]
    assert np.all(y_to_x > 0) if trained else np.all(y_to_x == 0)
    check_expectations(exp, want["expectations"])


def test_long_expectation_run_raises():
    """Past 2^14 estimated diagonals an expectation run is refused (the
    JAX package only warns) with the split named."""
    long_read = (None, None, 9000, 8000, [])
    pa = StrawmanAligner(device="cpu")
    with pytest.raises(NotImplementedError, match="get_split_points"):
        pa.run(None, [long_read], expectations=True)
    with pytest.raises(NotImplementedError, match="get_split_points"):
        pa.run(None, [(None, None, 100, 100, [])], expectations=True,
               shape_hint=(100, 2 ** 14))


def test_block_sum_is_a_sum():
    """The kernel-order lane reduction adds every lane once."""
    v = torch.arange(2 * 3 * 256, dtype=torch.float32).reshape(2, 3, 256)
    np.testing.assert_array_equal(fk.block_sum(v).numpy(),
                                  v.sum(-1).numpy())
