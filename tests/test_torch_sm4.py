"""The port's 4-state signal machine (signalAlign's fourState) vs the JAX
package (interpret-mode Pallas kernels on the CPU): the machine's scalars
and M-step loader, K1, K2 and K3 for the sm4 spec, whole posterior and
expectation runs and their pairs, and the tiled pair (K6a/K6b) against the
untiled run.  The CUDA kernels are held against these plain versions on
the card by tests/test_torch_gpu.py.  Tolerances:
cpecan_tpu_torch/parity.py.

Two cases: the default machine with flush ends, and a trained-looking
machine (the M-step of a random 4-state expectation table: every
transition finite, a non-zero gap-X table) with ragged ends and per-read
scaling, so that a strawman default leaking into the 4-state machine (its
log(0.1) gap-X table, its start and end vectors) shows.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models import hmm as j_hmm
from cpecan_tpu.models.state_machines import StateMachine4 as JStateMachine4
from cpecan_tpu.ops import pallas_fb as jfb

from cpecan_tpu_torch.models import hmm as t_hmm
from cpecan_tpu_torch.models.state_machines import (StateMachine4,
                                                    machine4_from_jax)
from cpecan_tpu_torch.ops import compact as tc
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import Sm4Aligner
from cpecan_tpu_torch.parity import (band_mask, check_exp_sums,
                                     check_expectations, check_fwd,
                                     check_pairs, check_posts,
                                     check_tiled_pairs, check_totals)
from tests.torch_parity import fixture_reads

THR = AlignmentParams().threshold
CASES = {"default": {},
         "trained": dict(ragged_left=True, ragged_right=True,
                         scale_params="sp", trained=True)}
# lanes of the [4, 4] table that are no transition of the machine
UNWRITTEN = (6, 7, 9, 13, 14)


def _trained_hmm(mod):
    """A 4-state ContinuousPairHmm after an M-step over random counts."""
    rng = np.random.default_rng(21)
    h = mod.ContinuousPairHmm(state_number=4, pseudocount=1e-4)
    h.add_expectations({"trans": rng.uniform(0.05, 1.0, (4, 4)),
                        "kmer_gap": rng.uniform(0.1, 1.0, 4098),
                        "likelihood": -100.0})
    h.normalize()
    return h


def _setup(template_model, reads, kw):
    """(JAX machine, run keywords) of a case."""
    kw = dict(kw)
    params = gap_x = None
    if kw.pop("trained", False):
        params, gap_x = _trained_hmm(j_hmm).to_sm4_params()
    if kw.get("scale_params") == "sp":
        kw["scale_params"] = np.random.default_rng(4).uniform(
            0.95, 1.05, (len(reads), 5))
    return JStateMachine4(template_model, params=params,
                          gap_x_log_probs=gap_x), kw


@pytest.fixture(scope="module")
def reads(template_model):
    return fixture_reads(template_model)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ragged_left", [False, True])
def test_scalars_match_jax(template_model, reads, name, ragged_left):
    """[11 transitions, start(4), end(4), ragged_end(4)] equal to
    ``Sm4PallasAligner._scalars``; the default machine keeps its zero
    gap-X table."""
    sm, _ = _setup(template_model, reads, CASES[name])
    pa = jfb.Sm4PallasAligner(AlignmentParams(), interpret=True)
    tsm = machine4_from_jax(sm)
    got = tsm.scalars(ragged_left=ragged_left).numpy()
    assert got.shape == (1, 23) and got.dtype == np.float32
    np.testing.assert_array_equal(got, pa._scalars(sm,
                                                   ragged_left=ragged_left))
    want_gapx = np.zeros(4096) if name == "default" else sm.gap_x_log_probs
    np.testing.assert_array_equal(tsm.gap_x.numpy(),
                                  want_gapx.astype(np.float32))


def test_machine4_from_jax_round_trips(template_model):
    """The port's machine from the JAX one carries its transitions,
    gap-X table and pore model; the port's default equals the JAX
    default."""
    params, gap_x = _trained_hmm(j_hmm).to_sm4_params()
    for sm in (JStateMachine4(template_model),
               JStateMachine4(template_model, params=params,
                              gap_x_log_probs=gap_x)):
        tsm = machine4_from_jax(sm)
        assert tsm.p == sm.p
        np.testing.assert_array_equal(tsm.gap_x_log_probs,
                                      sm.gap_x_log_probs)
        for f in ("match_model", "gap_y_model"):
            np.testing.assert_array_equal(getattr(tsm.model, f),
                                          getattr(sm.model, f))
        for vec in ("start_vec", "ragged_start_vec", "end_vec",
                    "ragged_end_vec"):
            assert getattr(tsm, vec)() == getattr(sm, vec)()
    default = StateMachine4(machine4_from_jax(sm).model)
    assert default.p == JStateMachine4(template_model).p


def test_to_sm4_params_matches_jax(tmp_path):
    """The 4-state M-step loader, and a 4-state HMM file written and read
    back by both packages."""
    hmms = [_trained_hmm(mod) for mod in (t_hmm, j_hmm)]
    (gp, gg), (wp, wg) = (h.to_sm4_params() for h in hmms)
    assert gp == wp and len(gp) == 11
    np.testing.assert_array_equal(gg, wg)
    fh = io.StringIO()
    hmms[0].write(fh)
    path = tmp_path / "sm4.hmm"
    path.write_text(fh.getvalue())
    got = t_hmm.ContinuousPairHmm.load(str(path))
    want = j_hmm.ContinuousPairHmm.load(str(path))
    assert got.transitions.shape == (4, 4) == want.transitions.shape
    np.testing.assert_array_equal(got.transitions, want.transitions)
    np.testing.assert_array_equal(got.kmer_gap_probs, want.kmer_gap_probs)
    assert got.to_sm4_params()[0] == want.to_sm4_params()[0]


@pytest.fixture(scope="module", params=list(CASES))
def case(request, template_model, reads):
    """JAX K1, K2 and K3 sm4 outputs, and the port's inputs for a case."""
    sm, kw = _setup(template_model, reads, CASES[request.param])
    ragged = kw.get("ragged_left", False)
    prep_kw = dict(ragged_right=kw.get("ragged_right", False),
                   scale_params=kw.get("scale_params"))
    pa = jfb.Sm4PallasAligner(AlignmentParams(), interpret=True)
    prep = pa.prepare(sm, reads, **prep_kw)
    scal = pa._scalars(sm, ragged_left=ragged)
    fwd_fn, bwd_fn, bwd_exp_fn = pa._fns(prep["X"], prep["ND"], prep["C"],
                                         prep["W"])
    xf, yf = pa._device_features(sm, prep)
    bands = pa._device_bands(prep["NDp"], prep["anch"].shape[1])(
        jnp.asarray(prep["anch"]), jnp.asarray(prep["meta"]))
    win3 = jnp.asarray(prep["win"][:, None, :])
    fwd = fwd_fn(scal, win3, xf, yf, *bands[:2])
    posts, totals = bwd_fn(scal, win3, xf, yf, *bands, fwd)
    exp = [np.asarray(v) for v in bwd_exp_fn(scal, win3, xf, yf, *bands,
                                             fwd)]
    ta = Sm4Aligner(device="cpu", group=pa.group)
    tsm = machine4_from_jax(sm)
    tprep = ta.prepare(tsm, reads, **prep_kw)
    inp = ta.device_inputs(tsm, tprep, ragged_left=ragged)
    np.testing.assert_array_equal(inp["scal"].numpy(), np.asarray(scal))
    if kw.get("scale_params") is None:
        np.testing.assert_array_equal(inp["xf"].numpy(), np.asarray(xf))
    dims = dict(R=tprep["R"], W=tprep["W"], ND=tprep["ND"], C=tprep["C"],
                spec=fk.Sm4Spec)
    return dict(inp=inp, dims=dims, fwd=np.asarray(fwd),
                posts=np.asarray(posts), totals=np.asarray(totals), exp=exp,
                mask=band_mask(prep, bands[0], bands[1]), sm=sm, kw=kw)


def _fwd(inp, dims, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], **dims)


def _bwd(inp, dims, fwd, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], inp["seedf"], inp["raggedf"], fwd, **dims)


def test_forward_plain_matches_jax_kernel(case):
    """K1 sm4 through the wrapper, which on CPU tensors runs the plain
    version and launches nothing."""
    fk.reset_counts()
    got = _fwd(case["inp"], case["dims"], fk.wavefront_fwd)
    assert fk.forward_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    assert got.shape == case["fwd"].shape and got.shape[2] == 4
    check_fwd(got.numpy(), case["fwd"], case["mask"])


def test_backward_plain_matches_jax_kernel(case):
    """K2 sm4 fed the JAX forward plane."""
    fk.reset_counts()
    posts, totals = _bwd(case["inp"], case["dims"],
                         torch.from_numpy(case["fwd"].copy()),
                         fk.wavefront_bwd)
    assert fk.backward_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    assert np.all(posts[:, 0].numpy() == 0.0)
    check_posts(posts.numpy(), case["posts"])
    check_totals(totals.numpy(), case["totals"][..., 0])


def test_backward_exp_plain_matches_jax_kernel(case):
    """K3 sm4 fed the JAX forward plane: 16 transition lanes (the five
    that are no transition of the machine stay 0), the shortGapX
    accumulator; its posterior outputs are K2's."""
    fk.reset_counts()
    fwd = torch.from_numpy(case["fwd"].copy())
    posts, totals, trans, gapx = _bwd(case["inp"], case["dims"], fwd,
                                      fk.wavefront_bwd_exp)
    assert fk.backward_exp_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    w_posts, w_totals, w_trans, w_gapx = case["exp"]
    assert tuple(trans.shape) == w_trans.shape[:2] + (16,)
    assert tuple(gapx.shape) == w_gapx.shape and gapx.shape[1] == 1
    assert np.all(trans[..., list(UNWRITTEN)].numpy() == 0.0)
    assert np.all(w_trans[..., 16:] == 0.0)
    written = [k for k in range(16) if k not in UNWRITTEN]
    assert np.all(trans[..., written].numpy().sum((0, 1)) > 0)
    check_exp_sums(trans, gapx, w_trans[..., :16], w_gapx)
    check_posts(posts.numpy(), w_posts)
    check_totals(totals.numpy(), w_totals[..., 0])
    p2, t2 = _bwd(case["inp"], case["dims"], fwd, fk.backward_plain)
    assert torch.equal(posts, p2) and torch.equal(totals, t2)


def test_run_pairs_match_jax(case, reads):
    """The whole posterior run against the JAX run: posteriors, totals and
    each read's pairs."""
    want = jfb.Sm4PallasAligner(AlignmentParams(), interpret=True).run(
        case["sm"], reads, **case["kw"])
    fk.reset_counts()
    got = Sm4Aligner(device="cpu", group=8).run(machine4_from_jax(case["sm"]),
                                                 reads, **case["kw"])
    assert (fk.forward_plain.calls, fk.backward_plain.calls) == (1, 1)
    check_posts(got["posteriors"].numpy(), want["posteriors"])
    check_totals(got["totals"].numpy(), np.asarray(want["totals"])[..., 0])
    n_pairs = 0
    for i, b in enumerate(got["prep"]["bands"]):
        pairs = tc.extract_pairs_auto(got, i, b.n_diag, THR)
        check_pairs(pairs, jfb.extract_pairs_from_pallas(want, i, THR), got,
                    want, i, THR)
        n_pairs += len(pairs)
    assert n_pairs > 500


def test_run_expectations_match_jax(case, reads):
    """``Sm4Aligner.run(expectations=True)`` against
    ``Sm4PallasAligner.run(expectations=True)``: trans [B, 4, 4], the
    shortGapX k-mer gap sums and the likelihoods."""
    want = jfb.Sm4PallasAligner(AlignmentParams(), interpret=True).run(
        case["sm"], reads, expectations=True, **case["kw"])["expectations"]
    got = Sm4Aligner(device="cpu", group=8).run(
        machine4_from_jax(case["sm"]), reads, expectations=True,
        **case["kw"])["expectations"]
    assert got["trans"].shape == (len(reads), 4, 4)
    assert all(v.dtype == np.float64 for v in got.values())
    assert np.all(got["trans"].reshape(len(reads), 16)[:, list(UNWRITTEN)]
                  == 0.0)
    check_expectations(got, want)


def test_tiled_run_matches_untiled_run(template_model, reads):
    """The plain tiled pair (K6a/K6b sm4, tile_diag 128, the trained case)
    against the plain untiled run: the pairs of every read."""
    sm, kw = _setup(template_model, reads, CASES["trained"])
    tsm = machine4_from_jax(sm)
    ta = Sm4Aligner(device="cpu", group=8)
    fk.reset_counts()
    got = ta.run(tsm, reads, tile_diag=128, compact_k=512, **kw)
    assert (fk.forward_tiled_plain.calls, fk.backward_tiled_plain.calls,
            fk.forward_plain.calls) == (1, 1, 0)
    assert got["tiled"]["NT"] >= 2
    want = ta.run(tsm, reads, **kw)
    n_pairs = 0
    for i, b in enumerate(got["prep"]["bands"]):
        pairs = tc.extract_pairs_long(got, i, b.n_diag, THR, as_array=True)
        check_tiled_pairs(pairs, tc.extract_pairs_auto(
            want, i, b.n_diag, THR, as_array=True), THR)
        n_pairs += len(pairs)
    assert n_pairs > 500
