"""The port's vanilla 3-state signal machine (signalAlign's default) vs the
JAX package (interpret-mode Pallas kernels on the CPU): the device
feature assembly and skip bins, K1 and K2 for the vanilla spec, the whole
posterior run and its pairs, and the tiled route.  The CUDA kernels are
held against these plain versions on the card by
tests/test_torch_gpu.py.  Tolerances: cpecan_tpu_torch/parity.py.

The assembly (``features.assemble_vanilla_features``) is held bit for bit
to the JAX ``_assemble_fn``, with the two multiply-adds XLA fuses rounded
once (the scaled level mean and 1 - a_my), except where XLA's and
PyTorch's CPU ``log`` differ: rows 8-12 (log transitions) by at most one
ulp, on up to a third of the columns of a row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models.state_machines import StateMachine3Vanilla
from cpecan_tpu.ops import pallas_fb as jfb

from cpecan_tpu_torch.models.state_machines import vanilla_from_jax
from cpecan_tpu_torch.ops import compact as tc
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import VanillaAligner
from cpecan_tpu_torch.ops.features import (host_bins, kx_from_codes,
                                           vanilla_kmer_pair)
from cpecan_tpu_torch.parity import (band_mask, check_fwd, check_pairs,
                                     check_posts, check_totals)
from tests.torch_parity import fixture_reads

THR = AlignmentParams().threshold
CASES = {"flush": {}, "ragged": dict(ragged_left=True, ragged_right=True),
         "scaled": dict(scale_params="sp")}


def _scale_params(n):
    """Per-read (scale, shift, var, scale_sd, var_sd) with a real shift,
    so that the skip bins' invalid-k-mer guard does not cancel it."""
    sp = np.random.default_rng(4).uniform(0.95, 1.05, (n, 5))
    sp[:, 1] = np.random.default_rng(5).uniform(-5.0, 5.0, n)
    return sp


def _kw(reads, name):
    kw = dict(CASES[name])
    if kw.get("scale_params") == "sp":
        kw["scale_params"] = _scale_params(len(reads))
    return kw


@pytest.fixture(scope="module")
def reads(template_model):
    return fixture_reads(template_model)


@pytest.mark.parametrize("strand", ["template", "complement"])
@pytest.mark.parametrize("scaled", [False, True], ids=["flush", "scaled"])
def test_features_match_jax_assembly(template_model, reads, strand, scaled):
    """xf rows 0-7 and yf bit for bit, rows 8-12 within one ulp (the
    logs); the finalize's host bins equal the JAX host bins, and every
    column's log a_mx is the log of its host bin's probability."""
    sm = StateMachine3Vanilla(template_model, strand=strand)
    sp = _scale_params(len(reads)) if scaled else None
    pa = jfb.VanillaPallasAligner(AlignmentParams(), interpret=True)
    prep = pa.prepare(sm, reads, scale_params=sp)
    xf, yf = (np.asarray(v) for v in pa._device_features(sm, prep))
    ta = VanillaAligner(device="cpu", group=8)
    tsm = vanilla_from_jax(sm)
    tprep = ta.prepare(tsm, reads, scale_params=sp)
    txf, tyf = (v.numpy() for v in ta.device_features(tsm, tprep))
    assert txf.shape == xf.shape and txf.dtype == np.float32
    np.testing.assert_array_equal(tyf, yf)
    np.testing.assert_array_equal(txf[:, :8], xf[:, :8])
    assert _ulps(txf[:, 8:], xf[:, 8:]).max() <= 1
    bins = host_bins(tprep["codes"], tprep["level_mean"], tprep.get("sp"))
    np.testing.assert_array_equal(bins, pa._host_bins(sm, prep))
    valid = txf[:, 0] != 0.0
    la_mx = np.log(tsm.skip60.numpy()[bins].astype(np.float64))
    assert _ulps(txf[:, 8][valid], la_mx[valid].astype(np.float32)).max() \
        <= 1


def _ulps(a, b):
    """|a - b| in units in the last place of f32 (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_kmer_pair_matches_jax(reads):
    codes = jfb._base_codes(reads, 256)
    want = jfb._vanilla_kmer_pair(jfb._kx_from_codes_np(codes), np)
    got = vanilla_kmer_pair(kx_from_codes(torch.from_numpy(codes)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, template_model, reads):
    """JAX K1/K2 vanilla outputs and the port's inputs for a case."""
    kw = _kw(reads, request.param)
    ragged = kw.get("ragged_left", False)
    prep_kw = dict(ragged_right=ragged, scale_params=kw.get("scale_params"))
    sm = StateMachine3Vanilla(template_model)
    pa = jfb.VanillaPallasAligner(AlignmentParams(), interpret=True)
    prep = pa.prepare(sm, reads, **prep_kw)
    scal = pa._scalars(sm, ragged_left=ragged)
    fwd_fn, bwd_fn, _ = pa._fns(prep["X"], prep["ND"], prep["C"], prep["W"])
    xf, yf = pa._device_features(sm, prep)
    bands = pa._device_bands(prep["NDp"], prep["anch"].shape[1])(
        jnp.asarray(prep["anch"]), jnp.asarray(prep["meta"]))
    win3 = jnp.asarray(prep["win"][:, None, :])
    fwd = fwd_fn(scal, win3, xf, yf, *bands[:2])
    posts, totals = bwd_fn(scal, win3, xf, yf, *bands, fwd)
    ta = VanillaAligner(device="cpu", group=pa.group)
    tsm = vanilla_from_jax(sm)
    tprep = ta.prepare(tsm, reads, **prep_kw)
    inp = ta.device_inputs(tsm, tprep, ragged_left=ragged)
    np.testing.assert_array_equal(inp["scal"].numpy(), np.asarray(scal))
    dims = dict(R=tprep["R"], W=tprep["W"], ND=tprep["ND"], C=tprep["C"],
                spec=fk.VanillaSpec)
    return dict(inp=inp, dims=dims, fwd=np.asarray(fwd),
                posts=np.asarray(posts), totals=np.asarray(totals),
                mask=band_mask(prep, bands[0], bands[1]), sm=sm, kw=kw)


def _fwd(inp, dims, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], **dims)


def _bwd(inp, dims, fwd, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], inp["seedf"], inp["raggedf"], fwd, **dims)


def test_forward_plain_matches_jax_kernel(case):
    """K1 vanilla through the wrapper, which on CPU tensors runs the plain
    version and launches nothing."""
    fk.reset_counts()
    got = _fwd(case["inp"], case["dims"], fk.wavefront_fwd)
    assert fk.forward_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    assert got.shape == case["fwd"].shape and got.dtype == torch.float32
    check_fwd(got.numpy(), case["fwd"], case["mask"])


def test_backward_plain_matches_jax_kernel(case):
    """K2 vanilla fed the JAX forward plane."""
    fk.reset_counts()
    posts, totals = _bwd(case["inp"], case["dims"],
                         torch.from_numpy(case["fwd"].copy()),
                         fk.wavefront_bwd)
    assert fk.backward_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    assert np.all(posts[:, 0].numpy() == 0.0)
    check_posts(posts.numpy(), case["posts"])
    check_totals(totals.numpy(), case["totals"][..., 0])


def test_run_pairs_match_jax(case, reads):
    """The whole run against the JAX run: posteriors, totals and each
    read's pairs."""
    want = jfb.VanillaPallasAligner(AlignmentParams(), interpret=True).run(
        case["sm"], reads, **case["kw"])
    got = VanillaAligner(device="cpu", group=8).run(
        vanilla_from_jax(case["sm"]), reads, **case["kw"])
    check_posts(got["posteriors"].numpy(), want["posteriors"])
    check_totals(got["totals"].numpy(), np.asarray(want["totals"])[..., 0])
    n_pairs = 0
    for i, b in enumerate(got["prep"]["bands"]):
        pairs = tc.extract_pairs_auto(got, i, b.n_diag, THR)
        check_pairs(pairs, jfb.extract_pairs_from_pallas(want, i, THR), got,
                    want, i, THR)
        n_pairs += len(pairs)
    assert n_pairs > 800


def test_tiled_run_matches_jax_tiled_run(template_model, reads):
    """The fixture reads forced tiled (tile_diag 128, ragged ends): K6a and
    K6b vanilla against the JAX interpret tiled run, and the pairs."""
    sm = StateMachine3Vanilla(template_model)
    kw = dict(tile_diag=128, ragged_left=True, ragged_right=True,
              compact_k=512)
    want = jfb.VanillaPallasAligner(AlignmentParams(), interpret=True).run(
        sm, reads, **kw)
    fk.reset_counts()
    got = VanillaAligner(device="cpu", group=8).run(vanilla_from_jax(sm),
                                                     reads, **kw)
    assert (fk.forward_tiled_plain.calls, fk.backward_tiled_plain.calls,
            fk.forward_plain.calls) == (1, 1, 0)
    assert got["tiled"] == want["tiled"] and got["tiled"]["NT"] >= 2
    check_posts(got["posteriors"].numpy(), want["posteriors"])
    check_totals(got["totals"].numpy(), np.asarray(want["totals"])[..., 0])
    for i, b in enumerate(got["prep"]["bands"]):
        check_pairs(tc.extract_pairs_long(got, i, b.n_diag, THR),
                    jfb.extract_pairs_long(want, i, b.n_diag, THR), got,
                    want, i, THR)


def test_skip_bins_match_jax_device_bins(template_model):
    """On bench.py's vanilla cell (256 reads x 905 bases, three per-read
    scale draws with real shifts): the port's host bins equal the bins of
    the JAX device arithmetic (its assembly's scaled means, fused, under
    ``jit``) on every column, and the JAX assembly's log a_mx and a_xx rows
    are those of the port's bins.  The JAX ``_host_bins`` rounds the
    scaled means unfused in numpy and misses the device bins on a few
    columns (a JAX reference trait the port does not copy); the count is
    printed."""
    import jax

    from cpecan_tpu.constants import NUM_OF_KMERS
    from cpecan_tpu_torch.synthetic import synthetic_batch

    sm = StateMachine3Vanilla(template_model)
    _, reads = synthetic_batch(n_reads=256, n_ref=905, n_events=800, seed=7)
    mean = np.asarray(template_model.match_model[:, 0], np.float32)
    skip = np.asarray(sm.skip_bin_probs, np.float32)

    @jax.jit
    def device_bins(codes, sp):
        kxp, kxn = jfb._vanilla_kmer_pair(jfb._kx_from_codes(codes), jnp)

        def level_mean(idx):
            m = jnp.asarray(mean)[jnp.clip(idx, 0, NUM_OF_KMERS - 1)]
            return jnp.where(idx > NUM_OF_KMERS, 0.0,
                             m * sp[:, 0:1] + sp[:, 1:2])

        d = jnp.abs(level_mean(kxn) - level_mean(kxp))
        return jnp.minimum((d / 0.5).astype(jnp.int32), 29)

    pa = jfb.VanillaPallasAligner(AlignmentParams(), interpret=True)
    n_cols = jax_host_misses = 0
    for seed in (4, 5, 6):
        sp = np.random.default_rng(seed).uniform(0.95, 1.05, (256, 5))
        sp[:, 1] = np.random.default_rng(seed + 10).uniform(-5.0, 5.0, 256)
        prep = pa.prepare(sm, reads, scale_params=sp)
        want = np.asarray(device_bins(jnp.asarray(prep["codes"]),
                                      jnp.asarray(prep["sp"])))
        got = host_bins(prep["codes"], mean, prep["sp"])
        np.testing.assert_array_equal(got, want)
        xf = np.asarray(pa._device_features(sm, prep)[0])
        valid = xf[:, 0] != 0.0
        for row, off in ((8, 0), (9, 30)):
            la = np.log(skip[got + off].astype(np.float64)).astype(np.float32)
            assert _ulps(xf[:, row][valid], la[valid]).max() <= 1
        n_cols += got.size
        jax_host_misses += int((pa._host_bins(sm, prep) != want).sum())
    print(f"JAX _host_bins vs the device bins: {jax_host_misses} of {n_cols} "
          "columns differ")
    assert jax_host_misses <= 1e-5 * n_cols
