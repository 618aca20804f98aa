"""The port's wavefront passes vs the JAX Pallas kernels (interpret mode on
the CPU).  The CUDA kernels are held against these plain versions on the
card by tests/test_torch_gpu.py.

K1 (forward): the port's plain forward against the JAX forward plane,
with the inputs built as ``bench.py::bench_device_only`` builds them.
K2 (posterior backward): the port's plain backward fed the same JAX
forward plane, against the JAX backward.  Tolerances:
cpecan_tpu_torch/parity.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models.state_machines import StateMachine3SignalStrawman
from cpecan_tpu.ops.pallas_fb import StrawmanPallasAligner

from cpecan_tpu_torch.models.state_machines import machine_from_jax
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import StrawmanAligner
from cpecan_tpu_torch.parity import (band_mask, check_fwd, check_posts,
                                     check_totals)
from tests.torch_parity import fixture_reads


@pytest.fixture(scope="module", params=[False, True],
                ids=["flush", "ragged"])
def case(request, template_model):
    """JAX kernel outputs and the port's inputs for the fixture reads;
    ``ragged`` runs with ragged left and right ends."""
    ragged = request.param
    reads = fixture_reads(template_model)
    sm = StateMachine3SignalStrawman(template_model)
    pa = StrawmanPallasAligner(AlignmentParams(), interpret=True)
    prep = pa.prepare(sm, reads, ragged_right=ragged)
    scal = pa._scalars(sm, ragged_left=ragged)
    fwd_fn, bwd_fn, _ = pa._fns(prep["X"], prep["ND"], prep["C"], prep["W"])
    xf, yf = pa._device_features(sm, prep)
    bands = pa._device_bands(prep["NDp"], prep["anch"].shape[1])(
        jnp.asarray(prep["anch"]), jnp.asarray(prep["meta"]))
    win3 = jnp.asarray(prep["win"][:, None, :])
    fwd = fwd_fn(scal, win3, xf, yf, *bands[:2])
    posts, totals = bwd_fn(scal, win3, xf, yf, *bands, fwd)
    ta = StrawmanAligner(device="cpu", group=pa.group)
    tsm = machine_from_jax(sm)
    tprep = ta.prepare(tsm, reads, ragged_right=ragged)
    inp = ta.device_inputs(tsm, tprep, ragged_left=ragged)
    dims = dict(R=tprep["R"], W=tprep["W"], ND=tprep["ND"], C=tprep["C"])
    return dict(prep=prep, inp=inp, dims=dims, fwd=np.asarray(fwd),
                posts=np.asarray(posts), totals=np.asarray(totals),
                mask=band_mask(prep, bands[0], bands[1]))


def _fwd(inp, dims, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], **dims)


def _bwd(inp, dims, fwd, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], inp["seedf"], inp["raggedf"], fwd, **dims)


def test_forward_plain_matches_jax_kernel(case):
    got = _fwd(case["inp"], case["dims"], fk.forward_plain)
    assert got.shape == case["fwd"].shape and got.dtype == torch.float32
    check_fwd(got.numpy(), case["fwd"], case["mask"])


def test_backward_plain_matches_jax_kernel(case):
    posts, totals = _bwd(case["inp"], case["dims"],
                         torch.from_numpy(case["fwd"].copy()),
                         fk.backward_plain)
    assert posts.shape == case["posts"].shape
    assert totals.shape == case["totals"].shape[:2]
    assert np.all(posts[:, 0].numpy() == 0.0)
    check_posts(posts.numpy(), case["posts"])
    check_totals(totals.numpy(), case["totals"][..., 0])
    assert np.all(np.isfinite(totals.numpy()))


def test_wrappers_run_plain_on_cpu(case):
    """On CPU tensors the wrappers take the plain path and launch
    nothing."""
    fk.reset_counts()
    fwd = _fwd(case["inp"], case["dims"], fk.wavefront_fwd)
    _bwd(case["inp"], case["dims"], fwd, fk.wavefront_bwd)
    assert (fk.forward_plain.calls, fk.backward_plain.calls) == (1, 1)
    assert fk.wavefront_fwd.launches == fk.wavefront_bwd.launches == 0
