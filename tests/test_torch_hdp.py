"""The port's HDP machine (the strawman's topology with HDP spline-density
emissions, streamed) vs the JAX package (interpret-mode Pallas kernels on
the CPU): the machine carried across by ``hdp_from_jax``, the feature
assembly, the emission stream against both JAX builds (matrix product and
scan) in both density modes, K1, K2 and K3 for the HDP spec fed the same
stream, whole runs and their pairs (a saturated ``compact_k`` too), the
expectation run, and the refusals (no tiled path, no mesh).  The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_gpu.py.  Tolerances: cpecan_tpu_torch/parity.py.

The model is tests/test_pallas.py's stream-build recipe (a flat HDP on a
60-point grid over 40..100 pA, two signals per k-mer of a 60-base
reference, 3 Gibbs samples), sampled once by the JAX package; the reads
are tests/test_pallas.py's three HDP reads (one event per k-mer minus
4 j, anchors every 10 columns).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.hdp.nanopore_hdp import flat_hdp_model
from cpecan_tpu.models.kmers import seq_to_kmer_indices
from cpecan_tpu.models.state_machines import StateMachine3Hdp
from cpecan_tpu.ops import pallas_fb as jfb
from cpecan_tpu.fixtures import fixture_path

from cpecan_tpu_torch.models.state_machines import hdp_from_jax
from cpecan_tpu_torch.ops import compact as tc
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import HdpAligner
from cpecan_tpu_torch.parity import (band_mask, check_exp_sums,
                                     check_expectations, check_fwd,
                                     check_hdp_stream, check_pairs,
                                     check_posts, check_totals)

THR = 0.1
MODES = {"log": True, "raw": False}


@pytest.fixture(scope="module")
def model_and_reads(template_model):
    """The sampled JAX NanoporeHDP (native sampler where it builds) and the
    three reads."""
    rng = np.random.default_rng(2)
    mm = template_model.match_model
    ref = "".join(rng.choice(list("ACGT"), 60))
    kidx = seq_to_kmer_indices(ref)
    kmers = [ref[p:p + 6] for p in range(len(kidx)) for _ in (0, 1)]
    signals = [mm[kidx[p], 0] + rng.normal(0, 1.0)
               for p in range(len(kidx)) for _ in (0, 1)]
    nhdp = flat_hdp_model("ACGT", 6, 1.0, 1.0, 40.0, 100.0, 60,
                          fixture_path("template_median68pA.model"))
    nhdp.update_from_assignments(kmers, signals)
    nhdp.execute_gibbs_sampling(num_samples=3, burn_in=50, thinning=10)
    nhdp.finalize_distributions()
    l_x = len(kidx)
    reads = []
    for j in range(3):
        n_ev = l_x - 4 * j
        events = np.zeros((n_ev, 3))
        for i in range(n_ev):
            events[i, 0] = mm[kidx[min(i, l_x - 1)], 0] + rng.normal(0, 0.5)
            events[i, 1] = 1.0
            events[i, 2] = 0.01
        anchors = [(i, min(i, n_ev - 2)) for i in range(8, l_x - 8, 10)]
        reads.append((ref, events, l_x, n_ev, anchors))
    return nhdp, reads


@pytest.fixture(scope="module")
def jpa():
    """One JAX aligner for the module: its interpret kernels compile once
    per shape."""
    return jfb.HdpPallasAligner(AlignmentParams(threshold=THR),
                                interpret=True, group=8)


def _machine(model_and_reads, mode):
    return StateMachine3Hdp(model_and_reads[0], log_density=MODES[mode])


@pytest.mark.parametrize("mode", list(MODES))
def test_machine_matches_jax(model_and_reads, jpa, mode):
    """``hdp_from_jax``: the density tables as ``_hdp_tables`` casts them,
    the grid's scalars, the gap-X table, ``log_density``, the vectors and
    the kernel scalars (both starts)."""
    sm = _machine(model_and_reads, mode)
    tsm = hdp_from_jax(sm)
    grid, tables, slopes = jpa._hdp_tables(sm)
    np.testing.assert_array_equal(tsm.tables.numpy(), np.asarray(tables))
    np.testing.assert_array_equal(tsm.slopes.numpy(), np.asarray(slopes))
    assert tsm.tables.dtype == tsm.slopes.dtype == torch.float32
    assert tsm.tables.shape == (4096, 60)
    np.testing.assert_array_equal(tsm.grid, grid)
    assert tsm.grid_scalars() == (float(np.float32(grid[0])),
                                  float(np.float32(grid[1] - grid[0])),
                                  float(np.float32(grid[-1])))
    np.testing.assert_array_equal(tsm.gap_x_log_probs, sm.gap_x_log_probs)
    assert tsm.log_density is MODES[mode]
    for vec in ("start_vec", "ragged_start_vec", "end_vec",
                "ragged_end_vec"):
        assert getattr(tsm, vec)() == getattr(sm, vec)()
    for ragged in (False, True):
        got = tsm.scalars(ragged_left=ragged).numpy()
        assert got.shape == (1, 17) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jpa._scalars(sm,
                                                        ragged_left=ragged))


def test_features_match_jax_assembly(model_and_reads, jpa):
    """The host inputs (base codes, the raw f32 event means) and xf
    [B, 9, X] (gap-X row 8 only) equal the JAX assembly's bit for bit; yf
    is zeros as the JAX assembly's, one column wide (the kernels read no y
    row)."""
    sm = _machine(model_and_reads, "log")
    reads = model_and_reads[1]
    prep = jpa.prepare(sm, reads)
    xf, yf = (np.asarray(v) for v in jpa._device_features(sm, prep))
    ta = HdpAligner(device="cpu", group=8)
    tprep = ta.prepare(hdp_from_jax(sm), reads)
    np.testing.assert_array_equal(tprep["codes"], prep["codes"])
    np.testing.assert_array_equal(tprep["evm"], prep["ev"][:, :, 0])
    assert tprep["evm"].dtype == np.float32
    txf, tyf = (v.numpy() for v in ta.device_features(hdp_from_jax(sm),
                                                      tprep))
    assert txf.shape == xf.shape == (8, 9, prep["X"])
    np.testing.assert_array_equal(txf, xf)
    assert tyf.shape == (8, 2, 1) and yf.shape[:2] == (8, 2)
    assert not tyf.any() and not yf.any()
    assert np.all(txf[:, :8] == 0.0) and (txf[:, 8] < -1e29).any()


@pytest.fixture(scope="module", params=list(MODES))
def stream_case(request, model_and_reads, jpa):
    """A mode's JAX streams (matrix-product and scan builds) and the
    port's, on the reads prepared by both packages."""
    sm = _machine(model_and_reads, request.param)
    reads = model_and_reads[1]
    prep = jpa.prepare(sm, reads)
    builds = {}
    for mm in (True, False):
        jpa.stream_matmul = mm
        builds[mm] = np.asarray(jpa._stream_args(sm, prep)[0])
    jpa.stream_matmul = True
    ta = HdpAligner(device="cpu", group=8)
    tsm = hdp_from_jax(sm)
    tprep = ta.prepare(tsm, reads)
    inp = ta.device_inputs(tsm, tprep)
    est = ta.emission_stream(tsm, tprep, inp)
    return dict(sm=sm, prep=prep, builds=builds, est=est, inp=inp,
                tprep=tprep, mode=request.param)


def test_stream_matches_both_jax_builds(stream_case):
    """``features.hdp_stream`` (the four-term gather) against both JAX
    builds: the same NEG cells, the rest within parity.HDP_STREAM_ATOL;
    [G, ND+3, R, W] f32, with densities (log mode: logs) in every read."""
    est, prep = stream_case["est"], stream_case["prep"]
    G, R = prep["Bp"] // prep["R"], prep["R"]
    assert tuple(est.shape) == (G, prep["ND"] + 3, R, prep["W"])
    assert est.dtype == torch.float32
    for build in stream_case["builds"].values():
        check_hdp_stream(est, build)
    live = est.numpy() > -1e29
    assert live[:, :, :3].any(axis=(0, 1, 3)).all()
    if stream_case["mode"] == "log":
        assert (est.numpy()[live] < 5.0).all()
    else:
        assert (est.numpy()[live] >= 0.0).all()


@pytest.mark.parametrize("cells", [1, 3 * 8 * 128 + 1])
def test_stream_blocks_equal_one_build(stream_case, monkeypatch, cells):
    """The stream built in blocks of diagonals (one diagonal a block, or
    three and an uneven last block) equals the one-block build bit for
    bit: its cells are independent."""
    from cpecan_tpu_torch.ops import features
    monkeypatch.setattr(features, "HDP_STREAM_BLOCK_CELLS", cells)
    ta = HdpAligner(device="cpu", group=8)
    tsm = hdp_from_jax(stream_case["sm"])
    prep, inp = stream_case["tprep"], stream_case["inp"]
    assert prep["ND"] + 3 > 3
    assert torch.equal(ta.emission_stream(tsm, prep, inp),
                       stream_case["est"])


def test_plane_check_counts_the_stream_and_its_build(model_and_reads,
                                                     monkeypatch):
    """``_check_planes`` budgets the fwd, posterior and stream planes and
    the stream build's scratch: a device that holds all but the last byte
    of that refuses the run, naming the remedies, before any pass; one
    that holds a byte more runs."""
    from cpecan_tpu_torch.ops import fb
    from cpecan_tpu_torch.ops.features import HDP_STREAM_SCRATCH_BYTES
    sm = hdp_from_jax(_machine(model_and_reads, "log"))
    reads = model_and_reads[1]
    ta = HdpAligner(device="cpu", group=8)
    prep = ta.prepare(sm, reads)
    G = prep["Bp"] // prep["R"]
    need = (4 * G * prep["NDp"] * prep["R"] * prep["W"]
            * (fk.HdpSpec.S + 2) + HDP_STREAM_SCRATCH_BYTES)
    share = fb.PLANE_MEMORY_SHARE
    fk.reset_counts()
    monkeypatch.setattr(fb, "device_memory_bytes",
                        lambda device: (need - 1) / share)
    with pytest.raises(ValueError, match="get_split_points"):
        ta.run(sm, reads)
    assert fk.forward_plain.calls == 0
    monkeypatch.setattr(fb, "device_memory_bytes",
                        lambda device: (need + 1) / share)
    ta.run(sm, reads)
    assert fk.forward_plain.calls == fk.backward_plain.calls == 1


@pytest.fixture(scope="module")
def case(stream_case, jpa):
    """JAX K1/K2/K3 HDP outputs on the JAX stream, and the port's inputs."""
    sm, prep = stream_case["sm"], stream_case["prep"]
    scal = jpa._scalars(sm)
    fwd_fn, bwd_fn, bwd_exp_fn = jpa._fns(prep["X"], prep["ND"], prep["C"],
                                          prep["W"])
    xf, yf = jpa._device_features(sm, prep)
    bands = jpa._device_bands(prep["NDp"], prep["anch"].shape[1])(
        jnp.asarray(prep["anch"]), jnp.asarray(prep["meta"]))
    win3 = jnp.asarray(prep["win"][:, None, :])
    est = jnp.asarray(stream_case["builds"][True])
    fwd = fwd_fn(scal, win3, xf, yf, *bands[:2], est)
    posts, totals = bwd_fn(scal, win3, xf, yf, *bands, fwd, est)
    exp = bwd_exp_fn(scal, win3, xf, yf, *bands, fwd, est)
    inp = stream_case["inp"]
    np.testing.assert_array_equal(inp["scal"].numpy(), np.asarray(scal))
    tprep = stream_case["tprep"]
    dims = dict(R=tprep["R"], W=tprep["W"], ND=tprep["ND"], C=tprep["C"],
                spec=fk.HdpSpec,
                est=torch.from_numpy(stream_case["builds"][True].copy()))
    return dict(inp=inp, dims=dims, fwd=np.asarray(fwd),
                posts=np.asarray(posts), totals=np.asarray(totals),
                exp=[np.asarray(v) for v in exp],
                mask=band_mask(prep, bands[0], bands[1]))


def _fargs(inp):
    return [inp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]


def test_forward_plain_matches_jax_kernel(case):
    """K1 hdp through the wrapper, which on CPU tensors runs the plain
    version and launches nothing: the fwd plane within the K1 tolerance,
    out of band exactly NEG."""
    fk.reset_counts()
    got = fk.wavefront_fwd(*_fargs(case["inp"]), **case["dims"])
    assert fk.forward_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    assert got.shape == case["fwd"].shape
    check_fwd(got.numpy(), case["fwd"], case["mask"])


def test_backward_plain_matches_jax_kernel(case):
    """K2 hdp fed the JAX forward plane: posteriors within
    parity.POST_ATOL (diagonal 0 zero), totals within TOTAL_RTOL."""
    fk.reset_counts()
    inp = case["inp"]
    posts, totals = fk.wavefront_bwd(
        *_fargs(inp), inp["seedf"], inp["raggedf"],
        torch.from_numpy(case["fwd"].copy()), **case["dims"])
    assert fk.backward_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    assert np.all(posts[:, 0].numpy() == 0.0)
    assert float(posts.max()) > 0.5
    check_posts(posts.numpy(), case["posts"])
    check_totals(totals.numpy(), case["totals"][..., 0])


def test_expectation_backward_plain_matches_jax_kernel(case):
    """K3 hdp (the strawman's expectation lanes on the streamed
    emissions) fed the JAX forward plane: posteriors, totals, the
    transition sums and the gap-X columns within parity's bars."""
    fk.reset_counts()
    inp = case["inp"]
    posts, totals, trans, gapx = fk.wavefront_bwd_exp(
        *_fargs(inp), inp["seedf"], inp["raggedf"],
        torch.from_numpy(case["fwd"].copy()), **case["dims"])
    assert fk.backward_exp_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    jposts, jtotals, jtrans, jgapx = case["exp"]
    assert tuple(gapx.shape) == jgapx.shape
    assert np.all(trans[..., 5].numpy() == 0.0)
    check_exp_sums(trans, gapx, jtrans[..., :9], jgapx)
    check_posts(posts.numpy(), jposts)
    check_totals(totals.numpy(), jtotals[..., 0])
    assert float(trans.sum()) > 10.0
    # the posterior outputs are the posterior backward's, bit for bit
    p2, t2 = fk.backward_plain(
        *_fargs(inp), inp["seedf"], inp["raggedf"],
        torch.from_numpy(case["fwd"].copy()), **case["dims"])
    assert torch.equal(posts, p2) and torch.equal(totals, t2)


@pytest.mark.parametrize("k", [4096, 40], ids=["topk", "saturated"])
def test_run_pairs_match_jax(model_and_reads, jpa, k):
    """``HdpAligner.run`` on the CPU against ``HdpPallasAligner.run``:
    posteriors, totals and each read's pairs (``extract_pairs_auto``;
    with k = 40 the top-k saturates and both take the exact fallback)."""
    sm = _machine(model_and_reads, "log")
    reads = model_and_reads[1]
    want = jpa.run(sm, reads, compact_k=k)
    fk.reset_counts()
    got = HdpAligner(AlignmentParams(threshold=THR), device="cpu",
                     group=8).run(hdp_from_jax(sm), reads, compact_k=k)
    assert (fk.forward_plain.calls, fk.backward_plain.calls) == (1, 1)
    check_posts(got["posteriors"].numpy(), want["posteriors"])
    check_totals(got["totals"].numpy(), np.asarray(want["totals"])[..., 0])
    tc.fetch(got)
    n_pairs = sat = 0
    for i, b in enumerate(got["prep"]["bands"]):
        pairs = tc.extract_pairs_auto(got, i, b.n_diag, THR)
        check_pairs(pairs, jfb.extract_pairs_auto(want, i, b.n_diag, THR),
                    got, want, i, THR)
        n_pairs += len(pairs)
        sat += int(got["compact"][0][0, i, -1] / 65535.0 >= THR)
    assert n_pairs > 100
    assert (sat == len(reads)) == (k == 40)


def test_run_expectations_match_jax(model_and_reads, jpa):
    """``HdpAligner.run(expectations=True)`` against the JAX run, ragged at
    both ends: trans [B, 3, 3], kmer_gap and the likelihoods
    (``check_expectations``)."""
    sm = _machine(model_and_reads, "log")
    reads = model_and_reads[1]
    kw = dict(ragged_right=True, ragged_left=True)
    want = jpa.run(sm, reads, expectations=True, **kw)["expectations"]
    fk.reset_counts()
    got = HdpAligner(device="cpu", group=8).run(
        hdp_from_jax(sm), reads, expectations=True, **kw)["expectations"]
    assert fk.backward_exp_plain.calls == 1
    assert got["trans"].shape == (len(reads), 3, 3)
    assert all(v.dtype == np.float64 for v in got.values())
    check_expectations(got, want)


def test_scale_params_are_ignored(model_and_reads):
    """As in the JAX package, the stream and the features take no
    per-read scaling: a run given ``scale_params`` equals one without."""
    sm = hdp_from_jax(_machine(model_and_reads, "log"))
    reads = model_and_reads[1]
    ta = HdpAligner(device="cpu", group=8)
    sp = np.tile([[1.1, 3.0, 1.2, 0.9, 1.05]], (len(reads), 1))
    a = ta.run(sm, reads, scale_params=sp)
    b = ta.run(sm, reads)
    assert torch.equal(a["posteriors"], b["posteriors"])


def _long_read(l_x, l_y):
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), l_x + 5))
    ev = np.zeros((l_y, 3))
    ev[:, 0], ev[:, 1], ev[:, 2] = 70.0, 1.0, 0.01
    return (ref, ev, l_x, l_y, [])


@pytest.mark.parametrize("how", ["tile_diag", "diagonals", "columns",
                                 "mesh", "no_stream"])
def test_refusals_before_any_launch(model_and_reads, how):
    """``HdpAligner.run`` refuses the tiled route (``tile_diag``, 2^14
    estimated diagonals or more, where the JAX package only warns, 2^15
    columns or more) naming ``get_split_points``, and ``mesh=`` (not
    ported), before any pass runs; the HDP wrappers refuse a call without
    its stream and the tiled wrappers the HDP spec."""
    sm = hdp_from_jax(_machine(model_and_reads, "log"))
    reads = model_and_reads[1]
    ta = HdpAligner(device="cpu", group=8)
    fk.reset_counts()
    if how == "no_stream":
        x = torch.zeros(1)
        with pytest.raises(ValueError, match="stream"):
            fk.wavefront_fwd(*([x] * 6), R=1, W=128, ND=8, C=11,
                             spec=fk.HdpSpec)
        for fn in (fk.wavefront_fwd_tiled, fk.wavefront_bwd_tiled):
            with pytest.raises(NotImplementedError, match="streamed"):
                fn(*([x] * (6 if fn is fk.wavefront_fwd_tiled else 10)),
                   R=1, W=128, ND=128, C=131, TD=128, spec=fk.HdpSpec)
    else:
        kw = {}
        if how == "tile_diag":
            kw["tile_diag"] = 128
        elif how == "diagonals":
            reads = [_long_read(9000, 8000)]
        elif how == "columns":
            reads = [_long_read(2 ** 15, 100)]
        else:
            kw["mesh"] = object()
        match = "item 9" if how == "mesh" else "get_split_points"
        with pytest.raises(NotImplementedError, match=match):
            ta.run(sm, reads, **kw)
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    assert fk.forward_tiled_plain.calls == 0 and not fk.KERNEL_LAUNCHES


def test_hdp_aligner_defaults_to_the_card(monkeypatch):
    """``HdpAligner()`` runs on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        HdpAligner()
    assert HdpAligner(device="cpu").device.type == "cpu"
