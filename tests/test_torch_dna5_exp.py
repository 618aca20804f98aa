"""The port's dna5 expectation backward (K3 for ``Dna5Spec``) and dna5
expectation runs (cPecanEm's E-step) against the JAX package's
``Dna5PallasAligner`` (interpret-mode Pallas kernels on the CPU), on the
reads of ``tests/test_pallas.py::test_dna5_pallas_expectations_match_engine``
(seed 23) with the N read of tests/test_torch_dna5.py (N on both sides).
The CUDA kernel is held against the plain version on the card by
tests/test_torch_gpu.py; the EM pipeline by tests/test_torch_em.py.
Tolerances: cpecan_tpu_torch/parity.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models.state_machines import StateMachine5 as JStateMachine5
from cpecan_tpu.ops.pallas_fb import Dna5PallasAligner

from cpecan_tpu_torch.models.state_machines import (StateMachine5,
                                                    machine5_from_jax)
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import Dna5Aligner
from cpecan_tpu_torch.parity import (check_dna5_expectations,
                                     check_exp_sums, check_posts,
                                     check_totals)
from tests.test_torch_dna5 import N_READ


def _reads():
    """test_dna5_pallas_expectations_match_engine's four mutated pairs
    (seed 23, anchors every 11) and a pair with an N on each side."""
    rng = np.random.default_rng(23)
    reads = []
    for i in range(4):
        n = 50 + 18 * i
        seq_x = "".join(rng.choice(list("ACGT"), n))
        seq_y = "".join(c if rng.random() > 0.18 else
                        str(rng.choice(list("ACGT"))) for c in seq_x)
        anchors = [(j, j) for j in range(8, n - 8, 11)]
        reads.append((seq_x, seq_y, len(seq_x), len(seq_y), anchors))
    return reads + [N_READ]


@pytest.fixture(scope="module", params=[False, True],
                ids=["flush", "ragged"])
def case(request):
    """The JAX expectation backward's outputs and the port's inputs, both
    fed the JAX forward plane; ``ragged`` runs ragged at both ends."""
    ragged = request.param
    reads = _reads()
    sm = JStateMachine5()
    pa = Dna5PallasAligner(AlignmentParams(), interpret=True)
    prep = pa.prepare(sm, reads, ragged_right=ragged)
    scal = pa._scalars(sm, ragged_left=ragged)
    fwd_fn, _, bwd_exp_fn = pa._fns(prep["X"], prep["ND"], prep["C"],
                                    prep["W"])
    xf, yf = pa._device_features(sm, prep)
    bands = pa._device_bands(prep["NDp"], prep["anch"].shape[1])(
        jnp.asarray(prep["anch"]), jnp.asarray(prep["meta"]))
    win3 = jnp.asarray(prep["win"][:, None, :])
    fwd = fwd_fn(scal, win3, xf, yf, *bands[:2])
    want = [np.asarray(v) for v in bwd_exp_fn(scal, win3, xf, yf, *bands,
                                              fwd)]
    ta = Dna5Aligner(device="cpu", group=pa.group)
    tsm = machine5_from_jax(sm)
    tprep = ta.prepare(tsm, reads, ragged_right=ragged)
    inp = ta.device_inputs(tsm, tprep, ragged_left=ragged)
    dims = dict(R=tprep["R"], W=tprep["W"], ND=tprep["ND"], C=tprep["C"],
                spec=fk.Dna5Spec)
    return dict(inp=inp, dims=dims, fwd=np.asarray(fwd), want=want)


def _bwd(case, fn):
    inp = case["inp"]
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], inp["seedf"], inp["raggedf"],
              torch.from_numpy(case["fwd"].copy()), **case["dims"])


def test_dna5_backward_exp_plain_matches_jax_kernel(case):
    """Through the wrapper, which on CPU tensors takes the plain version:
    the 25 transition lanes (12 of them no transition: 0), the 20
    per-column accumulators, posteriors and totals."""
    fk.reset_counts()
    posts, totals, trans, acc = _bwd(case, fk.wavefront_bwd_exp)
    assert fk.backward_exp_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    w_posts, w_totals, w_trans, w_acc = case["want"]
    assert trans.dtype == acc.dtype == torch.float32
    assert tuple(trans.shape) == w_trans.shape[:2] + (25,)
    assert tuple(acc.shape) == w_acc.shape and acc.shape[1] == 20
    idle = sorted(set(range(25)) - set(fk.Dna5Spec.EXP_LANES.values()))
    assert len(idle) == 12
    assert np.all(trans[..., idle].numpy() == 0.0)
    assert np.all(w_trans[..., idle] == 0.0) and np.all(w_trans[..., 25:]
                                                        == 0.0)
    assert np.all(trans[..., list(fk.Dna5Spec.EXP_LANES.values())].numpy()
                  > 0.0)
    check_exp_sums(trans, acc, w_trans[..., :25], w_acc)
    check_posts(posts.numpy(), w_posts)
    check_totals(totals.numpy(), w_totals[..., 0])
    # the posterior outputs are the posterior backward's, bit for bit
    p2, t2 = _bwd(case, fk.backward_plain)
    assert torch.equal(posts, p2) and torch.equal(totals, t2)


@pytest.fixture(scope="module")
def runs():
    """The port's and the JAX package's expectation runs, ragged at both
    ends as cPecanEm runs them."""
    reads = _reads()
    sm = JStateMachine5()
    kw = dict(expectations=True, ragged_left=True, ragged_right=True)
    want = Dna5PallasAligner(AlignmentParams(), interpret=True).run(
        sm, reads, **kw)["expectations"]
    fk.reset_counts()
    got = Dna5Aligner(device="cpu", group=8).run(machine5_from_jax(sm),
                                                 reads, **kw)
    assert (fk.forward_plain.calls, fk.backward_exp_plain.calls,
            fk.backward_plain.calls) == (1, 1, 0)
    return reads, got, want


def test_dna5_run_expectations_match_jax(runs):
    """trans [B, 5, 5], emis [B, 5, 4, 4] and likelihood [B] against the
    JAX run; the N columns carry no emission mass."""
    reads, got, want = runs
    exp = got["expectations"]
    assert "compact" not in got
    assert exp["trans"].shape == (len(reads), 5, 5)
    assert exp["emis"].shape == (len(reads), 5, 4, 4)
    assert all(v.dtype == np.float64 for v in exp.values())
    check_dna5_expectations(exp, {k: np.asarray(v) for k, v in want.items()})
    # every transition into a cell lands in one state, so a read's
    # transition mass is its cells' state mass; the emission table holds
    # the cells with an x and a y base in ACGT, so on N-free reads it holds
    # the mass of every cell inside the sequences, on the N read it misses
    # that of the N column and the N row (a unit each: every path crosses
    # both once)
    t_mass = exp["trans"].sum(axis=(1, 2))
    e_mass = exp["emis"].sum(axis=(1, 2, 3))
    missing = t_mass - e_mass
    assert np.all(np.abs(missing[:-1]) < 1e-3 * t_mass[:-1])
    assert 1.9 < missing[-1] < 2.1


def test_deferred_run_finalizes_to_the_same_expectations(runs):
    """``run(defer_expectations=True)`` keeps the sums on the device (no
    posterior plane) until ``finalize_expectations``, which gives the
    undeferred run's expectations."""
    reads, got, _ = runs
    ta = Dna5Aligner(device="cpu", group=8)
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()

    out = ta.run(StateMachine5(), reads, expectations=True,
                 defer_expectations=True, ragged_left=True,
                 ragged_right=True, stage=stage)
    assert names == ["prepare", "inputs", "fwd", "bwd_exp", "dispatch"]
    assert set(out) == {"expectations_flat", "totals", "prep"}
    assert isinstance(out["expectations_flat"], torch.Tensor)
    assert tuple(out["expectations_flat"].shape) == (
        out["prep"]["Bp"], 25 + 80 + 1)
    exp = ta.finalize_expectations(StateMachine5(), out)
    for k, v in got["expectations"].items():
        np.testing.assert_array_equal(exp[k], v)
