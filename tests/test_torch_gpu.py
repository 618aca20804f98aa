"""The port's CUDA kernels on the card against their plain PyTorch versions
(the versions that tests/test_torch_kernels.py and tests/test_torch_run.py
hold against the JAX package on the CPU).

Needs a CUDA GPU; skips without one.  Imports no JAX, so it runs where
JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from cpecan_tpu_torch.align import AlignmentParams
from cpecan_tpu_torch.fixtures import (fixture_path, load_batch_zymo,
                                       load_dna5_em, load_echelon_zymo,
                                       load_dna5_realign, load_long_read,
                                       load_vanilla_zymo, load_zymo_slice,
                                       load_zymo_train, zymo_trained_params)
from cpecan_tpu_torch.io.poremodel import load_pore_model
from cpecan_tpu_torch.models.hmm import ContinuousPairHmm
from cpecan_tpu_torch.models.state_machines import (
    StateMachine3SignalStrawman, StateMachine3Vanilla, StateMachine4,
    StateMachine5, StateMachineEchelon, StateMachineEchelonB)
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.compact import (compact_posteriors,
                                          extract_echelon_pairs_chunk,
                                          extract_pairs_auto,
                                          extract_pairs_chunk)
from cpecan_tpu_torch.ops.fb import (Dna5Aligner, EchelonAligner,
                                     HdpAligner, Sm4Aligner,
                                     StrawmanAligner, VanillaAligner)
from cpecan_tpu_torch.parity import (LONG_DNA_ENGINE_SCORE_ATOL, band_mask,
                                     check_dna5_expectations, check_em,
                                     check_exp_kernel,
                                     check_expectations, check_fwd,
                                     check_hdp_stream, check_long_pairs,
                                     check_pair_sets,
                                     check_pairs, check_posts, check_tiled,
                                     check_totals, check_trained, check_tsv,
                                     check_vanilla_expectations)
from cpecan_tpu_torch.pipeline import em
from cpecan_tpu_torch.pipeline.signal_align_batch import run_batch_fast
from cpecan_tpu_torch.pipeline.train_models import TrainOptions, train
from cpecan_tpu_torch.synthetic import (dna_em_batch, dna_realign_batch,
                                        hdp_model, synthetic_batch)
from torch_cases import synthetic_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def batch():
    # ragged shapes in one group of 8: the group window widens past 128
    return synthetic_batch(n_reads=8, n_ref=300, n_events=260, seed=5,
                           shape_jitter=0.4)


def _fwd(inp, dims, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], **dims)


def _bwd(inp, dims, fwd, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], inp["seedf"], inp["raggedf"], fwd, **dims)


@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_kernels_match_plain(batch, cuda, ragged):
    """Both kernels against their plain versions on the same card inputs
    (the plain backward is fed the kernel's forward plane)."""
    sm, reads = batch
    pa = StrawmanAligner(device=cuda, group=8)
    prep = pa.prepare(sm, reads, ragged_right=ragged)
    inp = pa.device_inputs(sm, prep, ragged_left=ragged)
    dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"])
    fk.reset_counts()
    fwd = _fwd(inp, dims, fk.wavefront_fwd)
    posts, totals = _bwd(inp, dims, fwd, fk.wavefront_bwd)
    torch.cuda.synchronize()
    assert fk.wavefront_fwd.launches == fk.wavefront_bwd.launches == 1
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    check_fwd(fwd, _fwd(inp, dims, fk.forward_plain),
              band_mask(prep, inp["basef"], inp["widthf"]))
    pposts, ptotals = _bwd(inp, dims, fwd, fk.backward_plain)
    assert torch.all(posts[:, 0] == 0.0)
    check_posts(posts, pposts)
    check_totals(totals, ptotals)


@pytest.mark.parametrize("trained", [False, True],
                         ids=["untrained", "trained"])
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_exp_kernel_matches_plain(batch, cuda, ragged, trained):
    """The forward and the expectation backward against their plain
    versions, with per-read scaling: bit for bit but for denormal gap-X
    sums.  The trained machine (the Zymo fixture's template HMM) opens
    Y -> X, which the untrained one closes with LOG_ZERO."""
    sm, reads = batch
    if trained:
        params, gap_x = zymo_trained_params()
        sm = StateMachine3SignalStrawman(sm.model, params=params,
                                         gap_x_log_probs=gap_x)
    pa = StrawmanAligner(device=cuda, group=8)
    sp = np.random.default_rng(4).uniform(0.95, 1.05, (len(reads), 5))
    prep = pa.prepare(sm, reads, ragged_right=ragged, scale_params=sp)
    inp = pa.device_inputs(sm, prep, ragged_left=ragged)
    dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"])
    fwd = _fwd(inp, dims, fk.wavefront_fwd)
    assert torch.equal(fwd, _fwd(inp, dims, fk.forward_plain))
    fk.reset_counts()
    got = _bwd(inp, dims, fwd, fk.wavefront_bwd_exp)
    torch.cuda.synchronize()
    assert fk.wavefront_bwd_exp.launches == 1
    assert fk.backward_exp_plain.calls == 0
    check_exp_kernel(got, _bwd(inp, dims, fwd, fk.backward_exp_plain))
    y_to_x = got[2][..., fk.StrawmanSpec.EXP_LANES["sx"]]
    assert torch.all(y_to_x > 0 if trained else y_to_x == 0.0)
    assert torch.all(got[2][..., 5] == 0.0)
    # the posterior outputs are the posterior kernel's
    kposts, ktotals = _bwd(inp, dims, fwd, fk.wavefront_bwd)
    assert torch.equal(got[0], kposts) and torch.equal(got[1], ktotals)


def test_cuda_exp_run_matches_cpu_run(batch, cuda):
    """A whole expectation run on the card against the same run on the
    CPU (plain passes)."""
    sm, reads = batch
    kw = dict(expectations=True, ragged_left=True, ragged_right=True,
              scale_params=np.random.default_rng(4).uniform(
                  0.95, 1.05, (len(reads), 5)))
    got = StrawmanAligner(device=cuda, group=8).run(sm, reads, **kw)
    want = StrawmanAligner(device="cpu", group=8).run(sm.to("cpu"), reads,
                                                      **kw)
    check_expectations(got["expectations"], want["expectations"])


def test_cuda_zymo_train_matches_fixture(cuda, tmp_path):
    """Two Baum-Welch iterations on the Zymo read on the card against the
    JAX package's stored result."""
    args, stored = load_zymo_train()
    fk.reset_counts()
    t_hmm, c_hmm, traj = train(
        **args, out_template_hmm=str(tmp_path / "t.hmm"),
        out_complement_hmm=str(tmp_path / "c.hmm"),
        options=TrainOptions(iterations=len(stored["trajectory"])),
        log=lambda m: None, device=cuda)
    assert fk.wavefront_bwd_exp.launches == 2 * len(stored["trajectory"])
    assert fk.backward_exp_plain.calls == fk.forward_plain.calls == 0
    check_trained(t_hmm, c_hmm, traj, stored)


def test_cuda_run_matches_cpu_run(batch, cuda):
    """The whole run on the card against the same run on the CPU (plain
    passes): equal pair sets up to the threshold fringe."""
    sm, reads = batch
    thr = AlignmentParams().threshold
    got = StrawmanAligner(device=cuda, group=8).run(
        sm, reads, ragged_left=True, compact_k=256)
    want = StrawmanAligner(device="cpu", group=8).run(
        sm.to("cpu"), reads, ragged_left=True, compact_k=256)
    check_posts(got["posteriors"], want["posteriors"])
    nds = [b.n_diag for b in got["prep"]["bands"]]
    gparts = extract_pairs_chunk(got, list(range(len(reads))), nds, thr)
    wparts = extract_pairs_chunk(want, list(range(len(reads))), nds, thr)
    for i in range(len(reads)):
        check_pairs(gparts[i].tolist(), wparts[i].tolist(), got, want, i,
                    thr)


def test_cuda_zymo_matches_f64_engine(cuda):
    model, read, want = load_zymo_slice()
    thr = AlignmentParams().threshold
    out = StrawmanAligner(device=cuda, group=1).run(
        StateMachine3SignalStrawman(model), [read])
    got = {(x, y) for _, x, y in extract_pairs_auto(
        out, 0, out["prep"]["bands"][0].n_diag, thr)}
    want = {(int(x), int(y)) for _, x, y in want}
    assert len(got ^ want) <= 2 and len(got & want) >= 980


def test_wide_group_window_raises(cuda):
    """W past one thread per lane is refused with the remedy named."""
    t = torch.zeros((1, 9, 2048), device=cuda)
    with pytest.raises(ValueError, match="group window"):
        fk.wavefront_fwd(t, torch.zeros((1, 512), dtype=torch.int32,
                                        device=cuda), t, t, t, t, R=1,
                         W=2048, ND=4, C=7)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, NT, every", [
    pytest.param(W, NT, False,
                 id="batch-batch" if W is None else f"{W}-{NT}")
    for W, NT in ((None, None), (32, 1), (32, 2), (32, 3), (128, 1),
                  (128, 2), (128, 3), (1024, 1), (1024, 2), (1024, 3))]
    + [pytest.param(128, 3, True, id="128-3-every")])
def test_cuda_tiled_kernels_match_plain(batch, cuda, ragged, W, NT, every):
    """K6a/K6b strawman (``sm3_fwd_tiled_sel<Strawman>``,
    ``sm3_bwd_tiled_sel<Strawman, false, true>``) against their plain
    versions on the same card inputs, with tiles of 128 diagonals: fwd
    plane, shifts, posteriors and totals equal bit for bit.  On the batch
    (W > 128), also against the untiled kernels within the tiled
    tolerances; on synthetic inputs at W 32, 128 and 1024 over one, two and
    three tiles (the rotated slots, the tile down-counter and the column
    logs kept while the window stays), with windows stepping by 0, 1 and 2
    and a few sd <= 0; with ``every``, a window that moves on over 95% of
    the diagonals (the column logs taken again on each of them)."""
    if W is None:
        sm, reads = batch
        pa = StrawmanAligner(device=cuda, group=8)
        prep = pa.prepare(sm, reads, ragged_right=ragged, tile_diag=128)
        inp = pa.device_inputs(sm, prep, ragged_left=ragged)
        tl = prep["tiled"]
        assert tl["NT"] >= 4
        dims = dict(R=prep["R"], W=prep["W"], ND=tl["NDT"], C=prep["C"])
        TD = tl["TD"]
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        ba = fa + [inp["seedf"], inp["raggedf"]]
    else:
        fa, ba, dims, TD = _tiled_case(cuda, fk.StrawmanSpec, W, NT, ragged,
                                       every=every)
    fk.reset_counts()
    fwd, shifts = fk.wavefront_fwd_tiled(*fa, **dims, TD=TD)
    posts, totals = fk.wavefront_bwd_tiled(*ba, fwd, shifts, **dims, TD=TD)
    torch.cuda.synchronize()
    assert fk.wavefront_fwd_tiled.launches == 1
    assert fk.wavefront_bwd_tiled.launches == 1
    assert fk.forward_tiled_plain.calls == fk.backward_tiled_plain.calls == 0
    pfwd, pshifts = fk.forward_tiled_plain(*fa, **dims, TD=TD)
    assert torch.equal(fwd, pfwd) and torch.equal(shifts, pshifts)
    if dims["ND"] > TD:
        assert torch.all(shifts[..., 1:] != 0.0)
    pposts, ptotals = fk.backward_tiled_plain(*ba, fwd, shifts, **dims,
                                              TD=TD)
    assert torch.equal(posts, pposts) and torch.equal(totals, ptotals)
    assert torch.isfinite(totals).all() and (posts > 0.0).any()
    if W is None:
        uprep = pa.prepare(sm, reads, ragged_right=ragged)
        uinp = pa.device_inputs(sm, uprep, ragged_left=ragged)
        udims = dict(R=uprep["R"], W=uprep["W"], ND=uprep["ND"],
                     C=uprep["C"])
        ufwd = _fwd(uinp, udims, fk.wavefront_fwd)
        check_tiled(posts, totals,
                    *_bwd(uinp, udims, ufwd, fk.wavefront_bwd))


def test_cuda_long_read_matches_fixture(cuda):
    """The 27,000-diagonal fixture read routes tiled on the card by itself
    and its pairs meet the JAX tiled path's and the f64 engine's."""
    model, read, stored = load_long_read()
    thr = AlignmentParams().threshold
    fk.reset_counts()
    out = StrawmanAligner(device=cuda, group=8).run(
        StateMachine3SignalStrawman(model), [read])
    assert fk.wavefront_fwd_tiled.launches == 1
    assert fk.wavefront_fwd.launches == fk.wavefront_bwd.launches == 0
    got = extract_pairs_auto(out, 0, out["prep"]["bands"][0].n_diag, thr,
                             as_array=True)
    check_long_pairs(got, stored["tiled_pairs"], thr)
    check_long_pairs(got, stored["engine_pairs"], thr)


@pytest.fixture(scope="module")
def dna5_batch():
    # 8 realign pairs of 600 bases (bench.py's generator, cut short)
    return dna_realign_batch(n_pairs=8, length=600)


def _dna5_inputs(cuda, reads, ragged, tile_diag=None):
    pa = Dna5Aligner(device=cuda, group=8)
    sm = StateMachine5()
    prep = pa.prepare(sm, reads, ragged_right=ragged, tile_diag=tile_diag)
    inp = pa.device_inputs(sm, prep, ragged_left=ragged)
    nd = prep["tiled"]["NDT"] if tile_diag else prep["ND"]
    dims = dict(R=prep["R"], W=prep["W"], ND=nd, C=prep["C"],
                spec=fk.Dna5Spec)
    return prep, inp, dims


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND, every", [
    (None, None, None), (32, 2, False), (32, 3, False), (32, 5, False),
    (128, 300, True), (128, 257, False), (1024, 2, False), (1024, 5, False),
    (1024, 150, True)],
    ids=lambda v: "batch" if v is None else str(v))
def test_cuda_dna5_kernels_match_plain(dna5_batch, cuda, ragged, W, ND,
                                       every):
    """K1/K2 for dna5 (K1: the untiled ``sm3_fwd_tiled_sel<Dna5, false>``,
    K2: the untiled ``sm3_bwd_tiled_sel<Dna5, false, false>``) against
    their plain versions on the same card inputs: fwd plane, posteriors
    and totals equal bit for bit, and on the realign batch so the pair
    sets.  On synthetic inputs at W 32, 128 and 1024:
    ND 2, 3 and 5 (no more diagonals than the fwd slots copied ahead: the
    prologue's empty groups and the tail's rotated slots), and 150-300
    with windows drifting or shifting on every diagonal; y bases include N
    and values outside 0..4."""
    if W is None:
        prep, inp, dims = _dna5_inputs(cuda, dna5_batch, ragged)
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        ba = fa + [inp["seedf"], inp["raggedf"]]
    else:
        fa, ba, dims = synthetic_case(cuda, fk.Dna5Spec, W, ND, ragged,
                                      [9, W, ND, int(ragged)], every=every)
    fk.reset_counts()
    fwd = fk.wavefront_fwd(*fa, **dims)
    posts, totals = fk.wavefront_bwd(*ba, fwd, **dims)
    torch.cuda.synchronize()
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd_dna5": 1,
                                  "wavefront_bwd_dna5": 1}
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    assert torch.equal(fwd, fk.forward_plain(*fa, **dims))
    pposts, ptotals = fk.backward_plain(*ba, fwd, **dims)
    assert torch.equal(posts, pposts) and torch.equal(totals, ptotals)
    assert torch.isfinite(totals).all()
    # at ND 2 only the cell (1, 1) can carry a posterior, and a band may
    # miss it
    assert (posts > 0.0).any() or ND == 2
    if W is not None:
        return
    thr = AlignmentParams().threshold
    nds = [b.n_diag for b in prep["bands"]]
    parts = [extract_pairs_chunk(dict(prep=prep, posteriors=p,
                                      compact=compact_posteriors(p, 2048)),
                                 list(range(len(nds))), nds, thr)
             for p in (posts, pposts)]
    for a, b in zip(*parts):
        assert np.array_equal(a, b) and len(a) > 500


def _tiled_case(cuda, spec, W, NT, ragged, TD=128, every=False):
    """``synthetic_case`` over NT tiles of TD diagonals."""
    fa, ba, dims = synthetic_case(cuda, spec, W, NT * TD, ragged,
                                  [5, W, NT, int(ragged)], every=every)
    return fa, ba, dims, TD


@pytest.mark.parametrize("spec", [fk.StrawmanSpec, fk.VanillaSpec,
                                  fk.Sm4Spec, fk.HdpSpec],
                         ids=lambda s: s.NAME)
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND, every", [
    (32, 2, False), (32, 3, False), (32, 5, False), (128, 300, True),
    (128, 257, False), (1024, 2, False), (1024, 5, False),
    (1024, 150, True)])
def test_cuda_signal_kernels_match_plain_on_moving_windows(cuda, spec,
                                                           ragged, W, ND,
                                                           every):
    """K1 and K2 of the strawman, vanilla, 4-state and HDP machines (K1
    strawman, vanilla and sm4: the untiled ``sm3_fwd_tiled_sel<Spec,
    false>``, whose column logs are taken again where the window moves; K1
    hdp ``sm3_fwd_kernel<Hdp>``; K2: the untiled ``sm3_bwd_tiled_sel<Spec,
    false, false>``, hdp's reading its stream) against their plain
    versions on synthetic inputs whose group window drifts (and with
    ``every`` shifts on nearly every diagonal), so that the backward reads
    lanes outside the window of d + 1 on many steps: the fwd plane, the
    posteriors and the totals bit for bit, at W 32, 128 and 1024.  ND 2,
    3 and 5 leave fewer diagonals than the fwd slots copied ahead (the
    prologue's empty groups and the tail's rotated slots)."""
    fa, ba, dims = synthetic_case(cuda, spec, W, ND, ragged,
                                  [9, W, ND, int(ragged)], every=every)
    _check_signal_pair(spec, fa, ba, dims, ND)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND", [(32, 150), (128, 257), (1024, 140)])
def test_cuda_hdp_kernels_match_plain_at_the_window_edge(cuda, ragged, W,
                                                         ND):
    """K1 and K2 hdp against their plain versions where every band is its
    group's whole window, so that the cells at the window's edge lanes
    count: where the window stays at d + 1 and moves at d + 2, the carried
    stream entry of lane W - 1 (lane l + o1 + 1 = W of the em ring) is
    NEG, though its stream entry at lane l + o2 + 1 lies inside the
    window; bit for bit, at W 32, 128 and 1024."""
    fa, ba, dims = synthetic_case(cuda, fk.HdpSpec, W, ND, ragged,
                                  [23, W, ND, int(ragged)], edge=True)
    _check_signal_pair(fk.HdpSpec, fa, ba, dims, ND)


def _check_signal_pair(spec, fa, ba, dims, ND):
    """K1 and K2 of ``spec`` launched once each on the card, then their
    fwd plane, posteriors and totals against the plain versions', bit for
    bit."""
    fk.reset_counts()
    fwd = fk.wavefront_fwd(*fa, **dims)
    posts, totals = fk.wavefront_bwd(*ba, fwd, **dims)
    torch.cuda.synchronize()
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd" + spec.SUFFIX: 1,
                                  "wavefront_bwd" + spec.SUFFIX: 1}
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    assert torch.equal(fwd, fk.forward_plain(*fa, **dims))
    pposts, ptotals = fk.backward_plain(*ba, fwd, **dims)
    assert torch.equal(posts, pposts) and torch.equal(totals, ptotals)
    assert torch.all(posts[:, 0] == 0.0)
    assert torch.isfinite(totals).all()
    # at ND 2 only the cell (1, 1) can carry a posterior, and a band may
    # miss it
    assert (posts > 0.0).any() or ND == 2


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, NT", [(None, None), (32, 1), (32, 2), (32, 3),
                                   (128, 1), (128, 2), (128, 3), (1024, 1),
                                   (1024, 2), (1024, 3)],
                         ids=lambda v: "batch" if v is None else str(v))
def test_cuda_dna5_tiled_kernels_match_plain(dna5_batch, cuda, ragged, W,
                                             NT):
    """K6a/K6b for dna5 (``sm3_fwd_tiled_sel``/``sm3_bwd_tiled_sel``)
    against their plain versions with tiles of 128 diagonals: fwd plane,
    shifts, posteriors and totals bit for bit.  On the realign batch (W
    128) and on synthetic inputs at W 32, 128 and 1024 over one, two and
    three tiles (the rotated ring slots and the tile down-counter at each
    boundary), with windows stepping by 0, 1 and 2 and y bases including N
    and values outside 0..4."""
    if W is None:
        prep, inp, dims = _dna5_inputs(cuda, dna5_batch, ragged,
                                       tile_diag=128)
        TD = prep["tiled"]["TD"]
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        ba = fa + [inp["seedf"], inp["raggedf"]]
    else:
        fa, ba, dims, TD = _tiled_case(cuda, fk.Dna5Spec, W, NT,
                                       ragged)
    fk.reset_counts()
    fwd, shifts = fk.wavefront_fwd_tiled(*fa, **dims, TD=TD)
    posts, totals = fk.wavefront_bwd_tiled(*ba, fwd, shifts, **dims, TD=TD)
    torch.cuda.synchronize()
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd_tiled_dna5": 1,
                                  "wavefront_bwd_tiled_dna5": 1}
    pfwd, pshifts = fk.forward_tiled_plain(*fa, **dims, TD=TD)
    assert torch.equal(fwd, pfwd) and torch.equal(shifts, pshifts)
    if dims["ND"] > TD:
        assert torch.all(shifts[..., 1:] != 0.0)
    pposts, ptotals = fk.backward_tiled_plain(*ba, fwd, shifts, **dims,
                                              TD=TD)
    assert torch.equal(posts, pposts) and torch.equal(totals, ptotals)
    assert torch.isfinite(totals).all() and (posts > 0.05).any()


def test_cuda_dna5_golden_pairs(cuda):
    """The reference golden case AGCG x AGTTCG at threshold 0.2."""
    params = AlignmentParams(threshold=0.2)
    out = Dna5Aligner(params, device=cuda, group=8).run(
        StateMachine5(), [("AGCG", "AGTTCG", 4, 6, [])])
    got = extract_pairs_auto(out, 0, out["prep"]["bands"][0].n_diag, 0.2)
    assert {(x, y) for _, x, y in got} == {(0, 0), (1, 1), (2, 4), (3, 5)}


def test_cuda_dna5_long_pair_matches_fixture(cuda):
    """The 10 kb pair (~20,000 diagonals) routes tiled on the card by
    itself and its pairs meet the JAX tiled path's and the f64 engine's."""
    _, _, pair, stored = load_dna5_realign()
    thr = AlignmentParams().threshold
    fk.reset_counts()
    out = Dna5Aligner(device=cuda, group=8).run(StateMachine5(), [pair])
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd_tiled_dna5": 1,
                                  "wavefront_bwd_tiled_dna5": 1}
    got = extract_pairs_auto(out, 0, out["prep"]["bands"][0].n_diag, thr,
                             as_array=True)
    check_long_pairs(got, stored["tiled_pairs"], thr)
    check_long_pairs(got, stored["engine_pairs"], thr,
                     score_atol=LONG_DNA_ENGINE_SCORE_ATOL)


def test_cuda_realign_cli_matches_fixture(cuda, tmp_path):
    """The realign CLI on the card: at least 7 of the 8 stored pairs' cigars
    equal the JAX CLI's --engine pallas output (the JAX CLI test's bar)."""
    import io

    from cpecan_tpu_torch.cli.realign import main

    fasta, cigars, _, stored = load_dna5_realign()
    path = tmp_path / "realign.fa"
    path.write_text(fasta)
    out = io.StringIO()
    fk.reset_counts()
    main([str(path)], stdin=io.StringIO("\n".join(cigars) + "\n"),
         stdout=out)
    assert fk.KERNEL_LAUNCHES["wavefront_fwd_dna5"] == 1
    got = out.getvalue().splitlines()
    want = [str(c) for c in stored["cigars_out"]]
    assert len(got) == len(want)
    assert sum(a == b for a, b in zip(got, want)) >= len(want) - 1


def _equalised_machine():
    """The machine of cPecanEm's equalised fiveState start (bench.py's
    E-step): every transition 1/5, every emission 1/16."""
    hmm = em.PipelineHmm("fiveState")
    hmm.equalise()
    return hmm.to_state_machine()


@pytest.mark.parametrize("machine", ["default", "equalised"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND, every", [
    (None, None, None), (32, 2, False), (32, 3, False), (32, 300, True),
    (128, 300, True), (128, 257, False), (1024, 2, False), (1024, 3, False),
    (1024, 150, True)],
    ids=lambda v: "batch" if v is None else str(v))
def test_cuda_dna5_exp_kernel_matches_plain(dna5_batch, cuda, ragged,
                                            machine, W, ND, every):
    """K3 for dna5 (``sm3_bwd_tiled_sel<Dna5, true, false>``) against its plain
    version on the same card inputs: posteriors, totals and the 25
    transition lanes bit for bit, the 20 per-column accumulators within
    parity.KERNEL_GAPX_ATOL; its posteriors and totals equal K2 dna5's.  On
    the realign batch (W 128) also the finalized expectations; on
    synthetic inputs at W 32, 128 and 1024 with the machine's scalars, ND 2
    and 3 (fewer diagonals than the fwd slots: the staging's empty groups
    and the tail's slots) and 150-300, with windows drifting or shifting
    on every diagonal."""
    sm = StateMachine5() if machine == "default" else _equalised_machine()
    if W is None:
        pa = Dna5Aligner(device=cuda, group=8)
        prep = pa.prepare(sm, dna5_batch, ragged_right=ragged)
        inp = pa.device_inputs(sm, prep, ragged_left=ragged)
        dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"],
                    spec=fk.Dna5Spec)
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        ba = fa + [inp["seedf"], inp["raggedf"]]
    else:
        fa, ba, dims = synthetic_case(
            cuda, fk.Dna5Spec, W, ND, ragged, [7, W, ND, int(ragged)],
            every=every, scal=sm.scalars(ragged_left=ragged).to(cuda))
    fwd = fk.wavefront_fwd(*fa, **dims)
    assert torch.equal(fwd, fk.forward_plain(*fa, **dims))
    fk.reset_counts()
    got = fk.wavefront_bwd_exp(*ba, fwd, **dims)
    torch.cuda.synchronize()
    assert fk.KERNEL_LAUNCHES == {"wavefront_bwd_exp_dna5": 1}
    assert fk.backward_exp_plain.calls == 0
    want = fk.backward_exp_plain(*ba, fwd, **dims)
    check_exp_kernel(got, want)
    assert torch.isfinite(got[1]).all()
    lanes = list(fk.Dna5Spec.EXP_LANES.values())
    idle = [k for k in range(25) if k not in lanes]
    assert torch.all(got[2][..., idle] == 0.0)
    kposts, ktotals = fk.wavefront_bwd(*ba, fwd, **dims)
    assert torch.equal(got[0], kposts) and torch.equal(got[1], ktotals)
    if W is not None:
        return
    assert torch.all(got[2][..., lanes] > 0.0)
    fin = [pa.exp_finalize(prep, pa.exp_dispatch(
        prep, inp, o[2], o[3], o[1]).cpu().numpy()) for o in (got, want)]
    for k in ("trans", "likelihood"):
        np.testing.assert_array_equal(fin[0][k], fin[1][k])
    check_dna5_expectations(*fin)


def _add_cols_flushed(self, x, v):
    """``fk._Expectations.add_cols`` as an f32 atomic add on the card does
    it: a denormal operand or sum is flushed to (signed) zero."""
    def ftz(a):
        return torch.where(a.abs() < torch.finfo(a.dtype).tiny, a * 0.0, a)

    self.cols.scatter_(3, x, ftz(ftz(self.cols.gather(3, x)) + ftz(v)))


@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_dna5_exp_kernel_flushes_only_denormal_terms(cuda, ragged,
                                                          monkeypatch):
    """K3 dna5 adds its per-column terms with f32 atomics, which flush a
    denormal term to 0.  With the long gaps' opening transitions at -92
    (e^-92 ~ 1e-40) every term into the long-gap rows (12-19) is denormal
    (synthetic inputs, W 128, 300 diagonals).  The kernel's accumulators
    equal the plain version's with its column adds flushed so, bit for
    bit; the unflushed plain version differs from that only at entries
    that took a denormal term, by at most what those terms add up to, and
    within parity.KERNEL_GAPX_ATOL.  Two launches are bit-identical: the
    per-diagonal barrier orders each column's adds."""
    scal = StateMachine5().scalars(ragged_left=ragged).clone()
    scal[0, [fk.T5_LOX, fk.T5_LOY]] = -92.0
    W, ND = 128, 300
    fa, ba, dims = synthetic_case(cuda, fk.Dna5Spec, W, ND, ragged,
                                  [11, W, ND, int(ragged)],
                                   scal=scal.to(cuda))
    fwd = fk.wavefront_fwd(*fa, **dims)
    got = fk.wavefront_bwd_exp(*ba, fwd, **dims)
    again = fk.wavefront_bwd_exp(*ba, fwd, **dims)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = fk.backward_exp_plain(*ba, fwd, **dims)
    check_exp_kernel(got, want)
    monkeypatch.setattr(fk._Expectations, "add_cols", _add_cols_flushed)
    flushed = fk.backward_exp_plain(*ba, fwd, **dims)
    for a, b in zip(got, flushed):
        assert torch.equal(a, b)
    tiny = torch.finfo(torch.float32).tiny
    denormal = (want[3] != 0.0) & (want[3].abs() < tiny)
    assert denormal[:, 12:].sum() > 100
    assert denormal[:, :12].sum() < denormal[:, 12:].sum()
    differ = got[3] != want[3]
    assert differ.any()
    # each column takes one term a target diagonal: at most ND + 3 flushed
    assert float((got[3] - want[3]).abs().max()) <= (ND + 3) * tiny


def test_cuda_dna5_estep_matches_cpu(cuda):
    """A cPecanEm E-step (``calculate_expectations_pallas``, two chunks) on
    the card against the same E-step on the CPU (plain passes)."""
    seqs, alns, _ = dna_em_batch(n_pairs=70, length=200, seed=4)
    sm = _equalised_machine()
    params = em.EmOptions().realign_params
    fk.reset_counts()
    got = em.calculate_expectations_pallas(
        [alns], seqs, sm, params, Dna5Aligner(params, device=cuda))
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd_dna5": 2,
                                  "wavefront_bwd_exp_dna5": 2}
    want = em.calculate_expectations_pallas(
        [alns], seqs, sm.to("cpu"), params,
        Dna5Aligner(params, device="cpu", group=8))
    check_dna5_expectations(
        {"trans": got.transitions, "emis": got.emissions,
         "likelihood": np.array([got.likelihood])},
        {"trans": want.transitions, "emis": want.emissions,
         "likelihood": np.array([want.likelihood])})


@pytest.mark.parametrize("model_type", ["fiveState", "fiveStateAsymmetric"])
def test_cuda_em_matches_fixture(cuda, model_type):
    """cPecanEm on the card (three iterations) against the JAX package's
    stored engine="pallas" result (tests/fixtures/dna5_em.npz)."""
    import random

    seqs, alns, stored = load_dna5_em()
    fk.reset_counts()
    hmm = em.expectation_maximisation(
        seqs, alns, em.EmOptions(model_type=model_type,
                                 iterations=int(stored["iterations"]),
                                 train_emissions=True),
        random.Random(int(stored["rng_seed"])), device=cuda)
    assert fk.KERNEL_LAUNCHES["wavefront_bwd_exp_dna5"] == \
        int(stored["iterations"])
    check_em(hmm.transitions, hmm.emissions, hmm.running_likelihoods,
             stored[f"{model_type}_transitions"],
             stored[f"{model_type}_emissions"],
             stored[f"{model_type}_running"])


def _vanilla_machine(batch, trained):
    """The batch's pore model as a vanilla machine; ``trained`` takes the
    skip bins of the stored JAX vanilla training run."""
    skip = load_vanilla_zymo()[2]["t_skip"] if trained else None
    return StateMachine3Vanilla(batch[0].model, skip_bin_probs=skip)


def _vanilla_inputs(cuda, batch, trained, ragged, tile_diag=None):
    sm = _vanilla_machine(batch, trained)
    reads = batch[1]
    pa = VanillaAligner(device=cuda, group=8)
    sp = np.random.default_rng(4).uniform(0.95, 1.05, (len(reads), 5))
    prep = pa.prepare(sm, reads, ragged_right=ragged, scale_params=sp,
                      tile_diag=tile_diag)
    inp = pa.device_inputs(sm, prep, ragged_left=ragged)
    ND = prep["tiled"]["NDT"] if tile_diag else prep["ND"]
    dims = dict(R=prep["R"], W=prep["W"], ND=ND, C=prep["C"],
                spec=fk.VanillaSpec)
    if tile_diag:
        dims["TD"] = prep["tiled"]["TD"]
    return sm, prep, inp, dims


@pytest.mark.parametrize("trained", [False, True],
                         ids=["untrained", "trained"])
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_vanilla_kernels_match_plain(batch, cuda, ragged, trained):
    """K1, K2 and K3 vanilla against their plain versions on the same card
    inputs (per-read scaling): fwd plane, posteriors, totals and the
    beta/alpha accumulators equal bit for bit."""
    _, _, inp, dims = _vanilla_inputs(cuda, batch, trained, ragged)
    fk.reset_counts()
    fwd = _fwd(inp, dims, fk.wavefront_fwd)
    posts, totals = _bwd(inp, dims, fwd, fk.wavefront_bwd)
    got = _bwd(inp, dims, fwd, fk.wavefront_bwd_exp)
    torch.cuda.synchronize()
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd_vanilla": 1,
                                  "wavefront_bwd_vanilla": 1,
                                  "wavefront_bwd_exp_vanilla": 1}
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    assert torch.equal(fwd, _fwd(inp, dims, fk.forward_plain))
    pposts, ptotals = _bwd(inp, dims, fwd, fk.backward_plain)
    assert torch.equal(posts, pposts) and torch.equal(totals, ptotals)
    plain = _bwd(inp, dims, fwd, fk.backward_exp_plain)
    check_exp_kernel(got, plain)
    assert torch.equal(got[3], plain[3])
    assert not got[2].any() and bool(got[3].sum() > 0)
    assert torch.equal(got[0], posts) and torch.equal(got[1], totals)


def _tiled_params():
    """(ragged, W, NT, every) of the tiled tests of the vanilla and sm4
    machines: the batch under its old ids ``False``/``True``, and
    ``test_cuda_tiled_kernels_match_plain``'s synthetic cases."""
    cases = [pytest.param(ragged, None, None, False, id=str(ragged))
             for ragged in (False, True)]
    for ragged in (False, True):
        cases += [pytest.param(ragged, W, NT, False,
                               id=f"{W}-{NT}-{ragged}")
                  for W in (32, 128, 1024) for NT in (1, 2, 3)]
        cases.append(pytest.param(ragged, 128, 3, True,
                                  id=f"128-3-every-{ragged}"))
    return cases


def _check_tiled(spec, fa, ba, dims, TD, batch):
    """K6a/K6b of ``spec`` against their plain versions: fwd plane,
    shifts, posteriors and totals bit for bit, each kernel launched once;
    re-centered tile boundaries; finite totals and some posterior > 0."""
    fk.reset_counts()
    fwd, shifts = fk.wavefront_fwd_tiled(*fa, **dims, TD=TD)
    posts, totals = fk.wavefront_bwd_tiled(*ba, fwd, shifts, **dims, TD=TD)
    torch.cuda.synchronize()
    assert fk.KERNEL_LAUNCHES == {f"wavefront_fwd_tiled{spec.SUFFIX}": 1,
                                  f"wavefront_bwd_tiled{spec.SUFFIX}": 1}
    pfwd, pshifts = fk.forward_tiled_plain(*fa, **dims, TD=TD)
    assert torch.equal(fwd, pfwd) and torch.equal(shifts, pshifts)
    if batch or dims["ND"] > TD:
        assert torch.all(shifts[..., 1:] != 0.0)
    pposts, ptotals = fk.backward_tiled_plain(*ba, fwd, shifts, **dims,
                                              TD=TD)
    assert torch.equal(posts, pposts) and torch.equal(totals, ptotals)
    if not batch:
        assert torch.isfinite(totals).all() and (posts > 0.0).any()


@pytest.mark.parametrize("ragged, W, NT, every", _tiled_params())
def test_cuda_vanilla_tiled_kernels_match_plain(batch, cuda, ragged, W, NT,
                                                every):
    """K6a/K6b vanilla (``sm3_fwd_tiled_sel<Vanilla>``,
    ``sm3_bwd_tiled_sel<Vanilla, false, true>``) against their plain
    versions, tiles of 128 diagonals: fwd plane, shifts, posteriors,
    totals bit for bit.  On the batch (trained skip bins, per-read
    scaling), and on synthetic inputs at W 32, 128 and 1024 over one, two
    and three tiles, with windows stepping by 0, 1 and 2 or (``every``)
    moving on nearly every diagonal (the sd and lambda rows' logs taken
    again on each), a few sd <= 0, lambda <= 0, zero noise means and zero
    noise."""
    if W is None:
        _, prep, inp, dims = _vanilla_inputs(cuda, batch, True, ragged,
                                             tile_diag=128)
        assert prep["tiled"]["NT"] >= 4
        TD = dims.pop("TD")
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        ba = fa + [inp["seedf"], inp["raggedf"]]
    else:
        fa, ba, dims, TD = _tiled_case(cuda, fk.VanillaSpec, W, NT, ragged,
                                       every=every)
    _check_tiled(fk.VanillaSpec, fa, ba, dims, TD, W is None)


def test_cuda_vanilla_exp_run_matches_cpu_run(batch, cuda):
    """A whole vanilla expectation run on the card against the same run
    on the CPU (plain passes), finalized into skip bins."""
    sm = _vanilla_machine(batch, True)
    reads = batch[1]
    kw = dict(expectations=True, ragged_left=True, ragged_right=True,
              scale_params=np.random.default_rng(4).uniform(
                  0.95, 1.05, (len(reads), 5)))
    got = VanillaAligner(device=cuda, group=8).run(sm, reads, **kw)
    want = VanillaAligner(device="cpu", group=8).run(sm.to("cpu"), reads,
                                                     **kw)
    check_vanilla_expectations(got["expectations"], want["expectations"])


def test_cuda_vanilla_zymo_matches_fixture(cuda, tmp_path):
    """The Zymo read's vanilla pairs and two vanilla Baum-Welch iterations
    on the card against the JAX package's stored results."""
    job, sp, stored = load_vanilla_zymo()
    sm = StateMachine3Vanilla(load_pore_model(
        fixture_path("template_median68pA.model")))
    thr = AlignmentParams().threshold
    out = VanillaAligner(device=cuda, group=1).run(sm, [job],
                                                    scale_params=sp[None])
    got = {(x, y) for _, x, y in extract_pairs_auto(
        out, 0, out["prep"]["bands"][0].n_diag, thr)}
    check_pair_sets(got, {(int(x), int(y)) for _, x, y in stored["pairs"]})
    args, _ = load_zymo_train()
    fk.reset_counts()
    t_hmm, c_hmm, traj = train(
        **args, out_template_hmm=str(tmp_path / "t.hmm"),
        out_complement_hmm=str(tmp_path / "c.hmm"),
        options=TrainOptions(sm_type="vanilla",
                             iterations=len(stored["trajectory"])),
        log=lambda m: None, device=cuda)
    assert fk.KERNEL_LAUNCHES["wavefront_bwd_exp_vanilla"] == 4
    assert fk.backward_exp_plain.calls == fk.forward_plain.calls == 0
    check_trained(t_hmm, c_hmm, traj, stored)


def _sm4_machine(batch, trained):
    """The batch's pore model as a 4-state machine; ``trained`` takes the
    M-step of a random 4-state table (every transition finite, a non-zero
    gap-X table), as tests/test_torch_sm4.py does."""
    if not trained:
        return StateMachine4(batch[0].model)
    rng = np.random.default_rng(21)
    h = ContinuousPairHmm(state_number=4, pseudocount=1e-4)
    h.add_expectations({"trans": rng.uniform(0.05, 1.0, (4, 4)),
                        "kmer_gap": rng.uniform(0.1, 1.0, 4098),
                        "likelihood": -100.0})
    h.normalize()
    params, gap_x = h.to_sm4_params()
    return StateMachine4(batch[0].model, params=params,
                         gap_x_log_probs=gap_x)


def _sm4_inputs(cuda, batch, trained, ragged, tile_diag=None):
    sm = _sm4_machine(batch, trained)
    reads = batch[1]
    pa = Sm4Aligner(device=cuda, group=8)
    sp = (np.random.default_rng(4).uniform(0.95, 1.05, (len(reads), 5))
          if trained else None)
    prep = pa.prepare(sm, reads, ragged_right=ragged, scale_params=sp,
                      tile_diag=tile_diag)
    inp = pa.device_inputs(sm, prep, ragged_left=ragged)
    ND = prep["tiled"]["NDT"] if tile_diag else prep["ND"]
    dims = dict(R=prep["R"], W=prep["W"], ND=ND, C=prep["C"],
                spec=fk.Sm4Spec)
    if tile_diag:
        dims["TD"] = prep["tiled"]["TD"]
    return prep, inp, dims


@pytest.mark.parametrize("trained", [False, True],
                         ids=["default", "trained"])
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_sm4_kernels_match_plain(batch, cuda, ragged, trained):
    """K1, K2 and K3 sm4 (K1 the untiled ``sm3_fwd_tiled_sel<Sm4,
    false>``, K2 the untiled ``sm3_bwd_tiled_sel<Sm4, false, false>``, K3
    ``sm3_bwd_kernel<Sm4, true>``) against their plain versions on the same
    card inputs (the trained machine with per-read scaling): fwd plane,
    posteriors, totals and the 16 transition lanes bit for bit, the
    shortGapX accumulator within parity.KERNEL_GAPX_ATOL."""
    _, inp, dims = _sm4_inputs(cuda, batch, trained, ragged)
    fk.reset_counts()
    fwd = _fwd(inp, dims, fk.wavefront_fwd)
    posts, totals = _bwd(inp, dims, fwd, fk.wavefront_bwd)
    got = _bwd(inp, dims, fwd, fk.wavefront_bwd_exp)
    torch.cuda.synchronize()
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd_sm4": 1,
                                  "wavefront_bwd_sm4": 1,
                                  "wavefront_bwd_exp_sm4": 1}
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    assert torch.equal(fwd, _fwd(inp, dims, fk.forward_plain))
    pposts, ptotals = _bwd(inp, dims, fwd, fk.backward_plain)
    assert torch.equal(posts, pposts) and torch.equal(totals, ptotals)
    check_exp_kernel(got, _bwd(inp, dims, fwd, fk.backward_exp_plain))
    assert got[2].shape[-1] == 16
    assert not got[2][..., [6, 7, 9, 13, 14]].any()
    assert torch.equal(got[0], posts) and torch.equal(got[1], totals)


@pytest.mark.parametrize("ragged, W, NT, every", _tiled_params())
def test_cuda_sm4_tiled_kernels_match_plain(batch, cuda, ragged, W, NT,
                                            every):
    """K6a/K6b sm4 (``sm3_fwd_tiled_sel<Sm4>``, ``sm3_bwd_tiled_sel<Sm4,
    false, true>``) against their plain versions, tiles of 128 diagonals:
    fwd plane, shifts, posteriors, totals bit for bit.  On the batch (the
    trained machine, per-read scaling), and on synthetic inputs at W 32,
    128 and 1024 over one, two and three tiles (at W 1024 the forward's
    ring of four states takes 3 x 4 x 1024 floats and 64 more, past the
    48 KB default, which its launcher raises), with windows stepping by 0,
    1 and 2 or (``every``) moving on nearly every diagonal, a few sd <=
    0."""
    if W is None:
        prep, inp, dims = _sm4_inputs(cuda, batch, True, ragged,
                                      tile_diag=128)
        assert prep["tiled"]["NT"] >= 4
        TD = dims.pop("TD")
        fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                               "widthf")]
        ba = fa + [inp["seedf"], inp["raggedf"]]
    else:
        fa, ba, dims, TD = _tiled_case(cuda, fk.Sm4Spec, W, NT, ragged,
                                       every=every)
    _check_tiled(fk.Sm4Spec, fa, ba, dims, TD, W is None)


@pytest.mark.parametrize("sm_type", ["threeState", "vanilla", "fourState",
                                     "echelon"])
def test_cuda_batch_pipeline_matches_cpu_run(cuda, tmp_path, sm_type):
    """``run_batch_fast`` on the card for the Zymo read against the same
    run on the CPU (plain passes) and against the JAX package's stored
    tsv: the kernels of the machine launched once per strand."""
    args, tsvs = (load_echelon_zymo() if sm_type == "echelon"
                  else load_batch_zymo())
    label = args.pop("label")
    ref = args.pop("reference_path")
    got = {}
    for device in ("cuda", "cpu"):
        fk.reset_counts()
        res = run_batch_fast(ref, args["npread_guide_pairs"],
                             str(tmp_path / device), device=device,
                             log=lambda m: None, sm_type=sm_type,
                             **{k: v for k, v in args.items()
                                if k != "npread_guide_pairs"})
        assert [r[:2] for r in res] == [(label, True)]
        got[device] = (tmp_path / device / f"{label}.tsv").read_bytes()
        if device == "cuda":
            suffix = {"threeState": "", "vanilla": "_vanilla",
                      "fourState": "_sm4", "echelon": "_echelon"}[sm_type]
            # echelon's wrappers launch the emission pre-pass too
            want = {f"wavefront_fwd{suffix}": 2, f"wavefront_bwd{suffix}": 2}
            if sm_type == "echelon":
                want["wavefront_emissions_echelon"] = 4
            assert fk.KERNEL_LAUNCHES == want
            assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    multi = sm_type == "echelon"
    check_tsv(got["cuda"], got["cpu"], args["threshold"], multi=multi)
    check_tsv(got["cuda"], tsvs[sm_type], args["threshold"], multi=multi)


def _echelon_inputs(cuda, batch, machine, ragged):
    """The batch (its events given durations) on an echelon machine:
    ``machine`` "A" (per-k-mer skip bins) with flush ends, or "B"
    (echelonB's global skips) with ragged ends and per-read scaling."""
    sm0, reads = batch
    rng = np.random.default_rng(8)
    reads = [(r[0], np.concatenate([r[1][:, :2], rng.uniform(
        0.002, 0.03, (len(r[1]), 1))], axis=1)) + tuple(r[2:])
        for r in reads]
    sm = (StateMachineEchelon(sm0.model) if machine == "A"
          else StateMachineEchelonB(sm0.model, 0.2, 0.35))
    sp = (np.random.default_rng(4).uniform(0.95, 1.05, (len(reads), 5))
          if machine == "B" else None)
    pa = EchelonAligner(device=cuda, group=8)
    prep = pa.prepare(sm, reads, ragged_right=ragged, scale_params=sp)
    inp = pa.device_inputs(sm, prep, ragged_left=ragged)
    dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"],
                spec=fk.EchelonSpec)
    return prep, inp, dims


@pytest.mark.parametrize("machine", ["A", "B"])
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_echelon_kernels_match_plain(batch, cuda, ragged, machine):
    """K1 and K2 echelon (each wrapper: the emission pre-pass, then its
    recurrence) against their plain versions on the same card inputs: the
    fwd plane [G, ND+1, 7, R, W], the five posterior planes
    [G, ND+1, 5, R, W] and the totals bit for bit; one pre-pass launch per
    wrapper, and the pre-pass's planes at k = 0 and 1 equal to its plain
    twin."""
    _, inp, dims = _echelon_inputs(cuda, batch, machine, ragged)
    fk.reset_counts()
    fwd = _fwd(inp, dims, fk.wavefront_fwd)
    posts, totals = _bwd(inp, dims, fwd, fk.wavefront_bwd)
    torch.cuda.synchronize()
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd_echelon": 1,
                                  "wavefront_bwd_echelon": 1,
                                  "wavefront_emissions_echelon": 2}
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    assert fk.echelon_emissions_plain.calls == 0
    assert fwd.shape[2] == 7 and posts.shape[2] == 5
    assert torch.equal(fwd, _fwd(inp, dims, fk.forward_plain))
    pposts, ptotals = _bwd(inp, dims, fwd, fk.backward_plain)
    assert torch.equal(posts, pposts) and torch.equal(totals, ptotals)
    assert torch.all(posts[:, 0] == 0.0) and bool((posts > 0.5).any())
    _check_echelon_planes(inp["win"], inp["xf"], inp["yf"], dims)


def _check_echelon_planes(win, xf, yf, dims):
    """The pre-pass's planes at k = 0 and 1 equal its plain twin's."""
    geo = {k: dims[k] for k in ("R", "W", "ND", "C")}
    for k in (0, 1):
        got = fk.echelon_emissions(win, xf, yf, k=k, **geo)
        assert got.shape == (win.shape[0], geo["ND"] + 3, 6, geo["R"],
                             geo["W"])
        assert torch.equal(got, fk.echelon_emissions_plain(win, xf, yf, k=k,
                                                           **geo))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND, every", [
    (32, 150, False), (32, 300, True), (128, 200, False),
    (1024, 130, False), (32, 2, False), (32, 3, False)])
def test_cuda_echelon_kernels_match_plain_on_moving_windows(cuda, ragged, W,
                                                            ND, every):
    """K1/K2 echelon and the pre-pass against plain on synthetic inputs
    whose group window drifts (and with ``every`` shifts on nearly every
    diagonal), so that the backward reads lanes outside the window of
    d + 1 on many steps: the pre-pass planes, the fwd plane, the five
    posterior planes and the totals bit for bit, at W 32, 128 and 1024 and
    ND 2 and 3."""
    fa, ba, dims = synthetic_case(cuda, fk.EchelonSpec, W, ND, ragged,
                                  [9, W, ND, int(ragged)], every=every)
    fwd = fk.wavefront_fwd(*fa, **dims)
    assert torch.equal(fwd, fk.forward_plain(*fa, **dims))
    got = fk.wavefront_bwd(*ba, fwd, **dims)
    want = fk.backward_plain(*ba, fwd, **dims)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.isfinite(got[1]).all()
    _check_echelon_planes(fa[1], fa[2], fa[3], dims)


def test_cuda_echelon_compaction_matches_cpu(batch, cuda):
    """The multi-state compaction (state and lane flattened into rows of
    5 * W) and the chunk extraction of the card's posteriors against the
    same posteriors compacted and extracted on the CPU."""
    prep, inp, dims = _echelon_inputs(cuda, batch, "A", False)
    fwd = _fwd(inp, dims, fk.wavefront_fwd)
    posts, _ = _bwd(inp, dims, fwd, fk.wavefront_bwd)
    k = 512
    rels = list(range(len(prep["bands"])))
    nds = [b.n_diag for b in prep["bands"]]
    parts = {}
    for dev in ("cuda", "cpu"):
        p = posts.to(dev)
        comp = compact_posteriors(p, k)
        parts[dev] = extract_echelon_pairs_chunk(
            dict(prep=prep, posteriors=p, compact=comp), rels, nds, 0.15)
        # lanes past 256 of the 5 * W rows ship as u16
        assert comp.wait()[2].dtype == np.uint16
    assert sum(map(len, parts["cpu"])) > 0
    for a, b in zip(parts["cuda"], parts["cpu"]):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def hdp_sm():
    """bench.py's HDP machine, sampled by the port (log densities)."""
    return hdp_model()


def _hdp_inputs(cuda, batch, sm, ragged):
    pa = HdpAligner(device=cuda, group=8)
    prep = pa.prepare(sm, batch[1], ragged_right=ragged)
    inp = pa.device_inputs(sm, prep, ragged_left=ragged)
    dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"],
                spec=fk.HdpSpec, est=pa.emission_stream(sm, prep, inp))
    return pa, prep, inp, dims


@pytest.mark.parametrize("mode", ["log", "raw"])
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_hdp_kernels_match_plain(batch, cuda, hdp_sm, ragged, mode):
    """K1, K2 and K3 hdp against their plain versions on the same card
    inputs and stream: the fwd plane, posteriors, totals and transition
    sums bit for bit, the gap-X columns within KERNEL_GAPX_ATOL; the
    card's stream against the one built on the CPU from the same inputs
    (``check_hdp_stream``)."""
    sm = hdp_sm
    if mode == "raw":
        sm = type(hdp_sm)(hdp_sm.nhdp, log_density=False)
    pa, prep, inp, dims = _hdp_inputs(cuda, batch, sm, ragged)
    cpu = HdpAligner(device="cpu", group=8)
    csm = type(sm)(sm.nhdp, log_density=sm.log_density)
    cinp = cpu.device_inputs(csm, prep, ragged_left=ragged)
    check_hdp_stream(dims["est"], cpu.emission_stream(csm, prep, cinp))
    fk.reset_counts()
    fwd = _fwd(inp, dims, fk.wavefront_fwd)
    posts, totals = _bwd(inp, dims, fwd, fk.wavefront_bwd)
    got = _bwd(inp, dims, fwd, fk.wavefront_bwd_exp)
    torch.cuda.synchronize()
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd_hdp": 1,
                                  "wavefront_bwd_hdp": 1,
                                  "wavefront_bwd_exp_hdp": 1}
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    assert torch.equal(fwd, _fwd(inp, dims, fk.forward_plain))
    pposts, ptotals = _bwd(inp, dims, fwd, fk.backward_plain)
    assert torch.equal(posts, pposts) and torch.equal(totals, ptotals)
    assert torch.all(posts[:, 0] == 0.0) and bool((posts > 0.5).any())
    check_exp_kernel(got, _bwd(inp, dims, fwd, fk.backward_exp_plain))
    assert torch.equal(got[0], posts) and torch.equal(got[1], totals)


def test_cuda_hdp_run_matches_cpu_run(batch, cuda, hdp_sm):
    """A whole HDP run on the card (stream, K1, K2, compaction) against the
    same run on the CPU: posteriors, totals and each read's pairs with a
    saturated top-k (the exact fallback)."""
    reads = batch[1]
    card, host = (HdpAligner(device=dev, group=8).run(m, reads,
                                                      compact_k=64)
                  for dev, m in ((cuda, hdp_sm),
                                 ("cpu", type(hdp_sm)(hdp_sm.nhdp))))
    check_posts(card["posteriors"], host["posteriors"])
    check_totals(card["totals"], host["totals"])
    thr = AlignmentParams().threshold
    for i, b in enumerate(host["prep"]["bands"]):
        check_pairs(extract_pairs_auto(card, i, b.n_diag, thr),
                    extract_pairs_auto(host, i, b.n_diag, thr), card, host,
                    i, thr)


@pytest.mark.parametrize("spec", [fk.StrawmanSpec, fk.VanillaSpec,
                                  fk.Dna5Spec, fk.Sm4Spec, fk.EchelonSpec,
                                  fk.HdpSpec],
                         ids=lambda s: s.NAME)
def test_cuda_kernels_launch_at_the_widest_window(cuda, spec):
    """Every kernel of a spec launches with W = 1024 threads, the widest
    window the wrappers accept, and equals its plain version there: one
    read whose band covers the whole window for 128 diagonals, seeded at
    the last (random model rows, events and transitions; for the streamed
    HDP spec a random emission stream of log densities, some NEG).
    Echelon has K1 and K2 only; echelon and HDP have no tiled kernels."""
    rng = np.random.default_rng(6)
    R, W, ND = 1, 1024, 128
    X, C = W, ND + 3
    Y, NDp = C + X + 256, 384
    xf = rng.uniform(0.5, 2.0, (1, spec.NXF, X))
    if spec is fk.VanillaSpec:
        xf[:, 8:] = np.log(rng.uniform(0.05, 0.9, (1, 5, X)))
    if spec is fk.Dna5Spec:
        xf = np.log(rng.uniform(0.05, 0.9, (1, spec.NXF, X)))
        yf = np.stack([rng.integers(0, 4, Y).astype(np.float64),
                       np.log(rng.uniform(0.05, 0.9, Y))])[None]
    elif spec is fk.EchelonSpec:
        # skip logs, validity bits; durations as log probabilities
        xf[:, 24:28] = np.log(rng.uniform(0.05, 0.9, (1, 4, X)))
        xf[:, 28:] = rng.integers(0, 2, (1, 5, X))
        yf = np.concatenate([np.log(rng.uniform(0.05, 0.9, (1, 6, Y))),
                             rng.uniform(0.5, 2.0, (1, 2, Y))], axis=1)
    else:
        yf = rng.uniform(0.5, 2.0, (1, 2, Y))
    scal = np.log(rng.uniform(0.05, 0.9, spec.NS + 3 * spec.S))
    seedf = np.zeros((1, NDp))
    seedf[0, ND] = 1.0

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=cuda)

    fa = [dev(scal), dev(np.zeros((1, NDp)), torch.int32), dev(xf), dev(yf),
          dev(np.zeros((1, NDp))), dev(np.full((1, NDp), float(W)))]
    ba = fa + [dev(seedf), dev(np.zeros((1, NDp)))]
    dims = dict(R=R, W=W, ND=ND, C=C, spec=spec)
    if spec is fk.HdpSpec:
        est = np.log(rng.uniform(0.01, 0.9, (1, ND + 3, 1, W)))
        est[rng.random(est.shape) < 0.05] = fk.NEG
        dims["est"] = dev(est)
    fwd = fk.wavefront_fwd(*fa, **dims)
    assert torch.equal(fwd, fk.forward_plain(*fa, **dims))
    pairs = [(fk.wavefront_bwd, fk.backward_plain)]
    if hasattr(spec, "exp_probs_w"):
        pairs.append((fk.wavefront_bwd_exp, fk.backward_exp_plain))
    for kernel, plain in pairs:
        got, want = kernel(*ba, fwd, **dims), plain(*ba, fwd, **dims)
        assert torch.isfinite(got[1]).all()
        assert all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
    if hasattr(spec, "POST_STATES") or fk.streamed(spec):
        return
    tfwd, shifts = fk.wavefront_fwd_tiled(*fa, TD=ND, **dims)
    assert torch.equal(tfwd, fwd)
    tposts, ttot = fk.wavefront_bwd_tiled(*ba, tfwd, shifts, TD=ND, **dims)
    want = fk.backward_tiled_plain(*ba, tfwd, shifts, TD=ND, **dims)
    assert torch.equal(tposts, want[0]) and torch.equal(ttot, want[1])
