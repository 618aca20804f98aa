"""The port's echelon machine (7 states, 1..5 k-mers per event, multi-state
posteriors) vs the JAX package (interpret-mode Pallas kernels on the CPU):
the machines (echelon and echelonB) and their skip logs, the feature
assembly, K1 and K2 for the echelon spec, whole posterior runs and their
expanded pairs, the multi-state compaction and extraction, and the
refusals (no tiled path, no expectations); and the plain passes fed the
emission pre-pass's planes against their inline emissions, and the plane
budget.  The CUDA kernels are held
against these plain versions on the card by tests/test_torch_gpu.py.
Tolerances: cpecan_tpu_torch/parity.py.

The reads are tests/test_pallas.py's echelon reads (three references of
40-64 bases, one event per k-mer, duration 0.01, anchors every 9
columns); the feature test gives them drawn durations, so that the six
duration rows differ from column to column.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models.kmers import seq_to_kmer_indices
from cpecan_tpu.models.state_machines import (StateMachineEchelon,
                                              StateMachineEchelonB)
from cpecan_tpu.ops import pallas_fb as jfb

from cpecan_tpu_torch.align import AlignmentParams as TorchParams
from cpecan_tpu_torch.models.state_machines import echelon_from_jax
from cpecan_tpu_torch.ops import compact as tc
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import EchelonAligner
from cpecan_tpu_torch.synthetic import echelon_batch
from cpecan_tpu_torch.parity import (band_mask, check_echelon_pairs,
                                     check_fwd, check_posts, check_totals)

THR = 0.15
CASES = {"A": dict(machine="A"),
         "A-scaled": dict(machine="A", scaled=True),
         "B": dict(machine="B", ragged=True, scaled=True)}


def _reads(template_model, seed=6, durations=False):
    """tests/test_pallas.py's three echelon reads (rng ``seed``); with
    ``durations`` each event's duration drawn in 0.002 .. 0.03."""
    rng = np.random.default_rng(seed)
    mm = template_model.match_model
    reads = []
    for r in range(3):
        n = 40 + 12 * r
        ref = "".join(rng.choice(list("ACGT"), n))
        l_x = n - 5
        kidx = seq_to_kmer_indices(ref)
        events = np.zeros((l_x, 3))
        for i in range(l_x):
            events[i, 0] = mm[kidx[i], 0] + rng.normal(0, 0.5)
            events[i, 1] = max(mm[kidx[i], 2], 0.1)
            events[i, 2] = 0.01
        anchors = [(j, j) for j in range(6, l_x - 6, 9)]
        reads.append((ref, events, l_x, l_x, anchors))
    if durations:
        d = np.random.default_rng(seed + 1)
        for ref, events, *_ in reads:
            events[:, 2] = d.uniform(0.002, 0.03, len(events))
    return reads


def _scale_params(n):
    """tests/test_pallas.py's per-read scalings, with a real shift."""
    return np.asarray([[1.0 + 0.05 * r, 2.0 * r - 1.0, 1.0 + 0.03 * r,
                        1.0 - 0.02 * r, 1.0 + 0.01 * r] for r in range(n)],
                      np.float32)


def _machine(template_model, name):
    if name == "A":
        return StateMachineEchelon(template_model)
    return StateMachineEchelonB(template_model, match_to_skip=0.2,
                                skip_continue=0.35)


@pytest.fixture(scope="module")
def jpa():
    """One JAX aligner for the module: its interpret kernels compile once
    per shape."""
    return jfb.EchelonPallasAligner(AlignmentParams(threshold=THR),
                                    interpret=True, group=8)


@pytest.mark.parametrize("name", ["A", "B"])
def test_machine_matches_jax(template_model, jpa, name):
    """The machine's vectors and scalars (both starts), its skip-bin
    probabilities and ``_skip_logs`` carried across by ``echelon_from_jax``;
    the port's defaults equal the JAX defaults."""
    sm = _machine(template_model, name)
    tsm = echelon_from_jax(sm)
    assert type(tsm).__name__ == type(sm).__name__
    for vec in ("start_vec", "ragged_start_vec", "end_vec",
                "ragged_end_vec"):
        assert getattr(tsm, vec)() == getattr(sm, vec)()
    for ragged in (False, True):
        got = tsm.scalars(ragged_left=ragged).numpy()
        assert got.shape == (1, 21) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jpa._scalars(sm,
                                                        ragged_left=ragged))
    np.testing.assert_array_equal(tsm.skip_bin_probs, sm.skip_bin_probs)
    a = np.concatenate([[0.0, 1.0], np.linspace(0.01, 0.99, 50)])
    for g, w in zip(tsm._skip_logs(a), sm._skip_logs(a)):
        np.testing.assert_array_equal(g, w)
    default = type(tsm)(tsm.model)
    want = type(sm)(template_model)
    for vec in ("end_vec", "ragged_end_vec"):
        assert getattr(default, vec)() == getattr(want, vec)()
    if name == "B":
        assert (tsm.match_to_skip, tsm.skip_continue) == (0.2, 0.35)
        assert default.match_to_skip == want.match_to_skip


@pytest.mark.parametrize("name", ["A", "B"])
@pytest.mark.parametrize("scaled", [False, True], ids=["flush", "scaled"])
def test_features_match_jax_assembly(template_model, jpa, name, scaled):
    """The host inputs (k-mer indices, validity bits, events) equal, xf
    [B, 33, X] bit for bit (the skip logs from the (scaled) host bins in
    f64), and yf [B, 8, Y] bit for bit but where XLA's and PyTorch's CPU
    ``log`` differ by one ulp: the durations are rounded as XLA computes
    them (the reciprocal of c, the folded constants and the fused
    multiply-adds of ``features._DUR_*``), so row n = 1..5, which holds
    n log(lambda), lies within n ulps."""
    reads = _reads(template_model, durations=True)
    sm = _machine(template_model, name)
    sp = _scale_params(len(reads)) if scaled else None
    prep = jpa.prepare(sm, reads, scale_params=sp)
    xf, yf = (np.asarray(v) for v in jpa._device_features(sm, prep))
    ta = EchelonAligner(device="cpu", group=8)
    tsm = echelon_from_jax(sm)
    tprep = ta.prepare(tsm, reads, scale_params=sp)
    for key in ("kxp", "kx5", "validm", "ev"):
        np.testing.assert_array_equal(tprep[key], prep[key])
    txf, tyf = (v.numpy() for v in ta.device_features(tsm, tprep))
    assert txf.shape == xf.shape == (8, 33, prep["X"])
    assert tyf.shape == yf.shape and tyf.shape[1] == 8
    np.testing.assert_array_equal(txf, xf)
    for row in (0, 6, 7):
        np.testing.assert_array_equal(tyf[:, row], yf[:, row])
    for n in range(1, 6):
        assert _ulps(tyf[:, n], yf[:, n]).max() <= n
    # the durations vary: every duration row holds distinct values
    assert all(len(np.unique(tyf[0, k])) > 10 for k in range(6))


def _ulps(a, b):
    """|a - b| in units in the last place of f32 (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.fixture(scope="module", params=list(CASES))
def case(request, template_model, jpa):
    """JAX K1/K2 echelon outputs and the port's inputs for a case."""
    c = CASES[request.param]
    reads = _reads(template_model, seed=16 if c.get("scaled") else 6)
    sm = _machine(template_model, c["machine"])
    kw = dict(scale_params=_scale_params(3) if c.get("scaled") else None,
              ragged_right=c.get("ragged", False))
    ragged = c.get("ragged", False)
    prep = jpa.prepare(sm, reads, **kw)
    scal = jpa._scalars(sm, ragged_left=ragged)
    fwd_fn, bwd_fn, _ = jpa._fns(prep["X"], prep["ND"], prep["C"],
                                 prep["W"])
    xf, yf = jpa._device_features(sm, prep)
    bands = jpa._device_bands(prep["NDp"], prep["anch"].shape[1])(
        jnp.asarray(prep["anch"]), jnp.asarray(prep["meta"]))
    win3 = jnp.asarray(prep["win"][:, None, :])
    fwd = fwd_fn(scal, win3, xf, yf, *bands[:2])
    posts, totals = bwd_fn(scal, win3, xf, yf, *bands, fwd)
    ta = EchelonAligner(device="cpu", group=8)
    tsm = echelon_from_jax(sm)
    tprep = ta.prepare(tsm, reads, **kw)
    inp = ta.device_inputs(tsm, tprep, ragged_left=ragged)
    np.testing.assert_array_equal(inp["scal"].numpy(), np.asarray(scal))
    dims = dict(R=tprep["R"], W=tprep["W"], ND=tprep["ND"], C=tprep["C"],
                spec=fk.EchelonSpec)
    return dict(inp=inp, dims=dims, fwd=np.asarray(fwd),
                posts=np.asarray(posts), totals=np.asarray(totals),
                mask=band_mask(prep, bands[0], bands[1]), sm=sm, reads=reads,
                kw=dict(kw, ragged_left=ragged))


def _fwd(inp, dims, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], **dims)


def _bwd(inp, dims, fwd, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], inp["seedf"], inp["raggedf"], fwd, **dims)


def test_forward_plain_matches_jax_kernel(case):
    """K1 echelon through the wrapper, which on CPU tensors runs the plain
    version and launches nothing: the 7-state fwd plane within the K1
    tolerance (parity.FWD_RTOL/FWD_ATOL), out of band exactly NEG."""
    fk.reset_counts()
    got = _fwd(case["inp"], case["dims"], fk.wavefront_fwd)
    assert fk.forward_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    assert got.shape == case["fwd"].shape and got.shape[2] == 7
    check_fwd(got.numpy(), case["fwd"], case["mask"])


def test_backward_plain_matches_jax_kernel(case):
    """K2 echelon fed the JAX forward plane: the five posterior planes
    [G, ND+1, 5, R, W] (match1..match5, diagonal 0 zero in each) within
    parity.POST_ATOL, the totals within TOTAL_RTOL."""
    fk.reset_counts()
    posts, totals = _bwd(case["inp"], case["dims"],
                         torch.from_numpy(case["fwd"].copy()),
                         fk.wavefront_bwd)
    assert fk.backward_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    assert posts.shape == case["posts"].shape and posts.shape[2] == 5
    assert np.all(posts[:, 0].numpy() == 0.0)
    # every match state holds posterior mass (match1 the most: one event
    # per k-mer)
    assert all(bool((posts[:, :, j] > 1e-6).any()) for j in range(5))
    check_posts(posts.numpy(), case["posts"])
    check_totals(totals.numpy(), case["totals"][..., 0])


@pytest.fixture(scope="module")
def runs(case, jpa):
    """The port's ``EchelonAligner.run`` and the JAX run of a case."""
    want = jpa.run(case["sm"], case["reads"], **case["kw"])
    fk.reset_counts()
    got = EchelonAligner(device="cpu", group=8).run(
        echelon_from_jax(case["sm"]), case["reads"], **case["kw"])
    assert (fk.forward_plain.calls, fk.backward_plain.calls) == (1, 1)
    return got, want


def test_run_pairs_match_jax(runs):
    """The whole run against the JAX run: posteriors, totals and each
    read's expanded pairs (``extract_echelon_pairs``), equal up to the
    fringe of the threshold."""
    got, want = runs
    check_posts(got["posteriors"].numpy(), want["posteriors"])
    check_totals(got["totals"].numpy(), np.asarray(want["totals"])[..., 0])
    n_pairs = 0
    for i, b in enumerate(got["prep"]["bands"]):
        pairs = tc.extract_echelon_pairs(got, i, b.n_diag, THR)
        check_echelon_pairs(pairs, jfb.extract_echelon_pairs(
            want, i, b.n_diag, THR), got, want, i, THR)
        n_pairs += len(pairs)
    assert n_pairs > 150


def _host_out(out):
    """A run's output with host arrays, as the JAX extractors read it."""
    tc.fetch(out)
    return dict(out, posteriors=out["posteriors"].numpy())


@pytest.mark.parametrize("k", [4096, 40], ids=["topk", "saturated"])
def test_extraction_matches_jax_extractors(runs, k):
    """The port's multi-state compaction and extractors against the JAX
    package's extractors on the same posteriors, pair for pair in order:
    per read and per chunk, from the top-k (lanes of 5 * W rows as u16)
    and, with k = 40, from the full plane after the top-k saturates."""
    got, _ = runs
    out = dict(got, compact=tc.compact_posteriors(got["posteriors"], k))
    host = _host_out(out)
    vals, drow, lane = host["compact"]
    assert vals.dtype == np.uint16 and lane.dtype == np.uint16
    nds = [b.n_diag for b in got["prep"]["bands"]]
    rels = list(range(len(nds)))
    sat = 0
    for i, nd in enumerate(nds):
        mine = tc.extract_echelon_pairs(out, i, nd, THR)
        assert mine == jfb.extract_echelon_pairs(host, i, nd, THR)
        sat += int(vals[0, i, -1] / 65535.0 >= THR)
    assert (sat == len(nds)) == (k == 40)
    parts = tc.extract_echelon_pairs_chunk(out, rels, nds, THR)
    want = jfb.extract_echelon_pairs_chunk(host, rels, nds, THR)
    assert len(parts) == len(want) == len(nds)
    for a, b in zip(parts, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)


def test_chunk_extraction_matches_per_read(runs):
    """``extract_echelon_pairs_chunk`` equals per-read
    ``extract_echelon_pairs`` followed by the drain's stable sort on
    x + y."""
    got, _ = runs
    nds = [b.n_diag for b in got["prep"]["bands"]]
    parts = tc.extract_echelon_pairs_chunk(got, list(range(len(nds))), nds,
                                           THR)
    for i, nd in enumerate(nds):
        want = np.asarray(tc.extract_echelon_pairs(got, i, nd, THR),
                          np.int64).reshape(-1, 3)
        want = want[np.argsort(want[:, 1] + want[:, 2], kind="stable")]
        assert np.array_equal(parts[i], want), i


def _long_read(l_x, l_y):
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), l_x + 5))
    ev = np.zeros((l_y, 3))
    ev[:, 0], ev[:, 1], ev[:, 2] = 70.0, 1.0, 0.01
    return (ref, ev, l_x, l_y, [])


@pytest.mark.parametrize("how", ["tile_diag", "diagonals", "columns",
                                 "expectations"])
def test_refusals_before_any_launch(template_model, how):
    """Echelon refuses the tiled route (``tile_diag``, 2^14 estimated
    diagonals or more, 2^15 columns or more) naming the remedy, and
    expectations (the reference defines no echelon EM), before any pass
    runs: the JAX package routes such a run tiled and decodes its
    multi-state planes with W lanes per row (ROADMAP Queue 3)."""
    reads = _reads(template_model)
    kw = {}
    if how == "tile_diag":
        kw["tile_diag"] = 128
    elif how == "diagonals":
        reads = [_long_read(9000, 8000)]
    elif how == "columns":
        reads = [_long_read(2 ** 15, 100)]
    else:
        kw["expectations"] = True
    fk.reset_counts()
    ta = EchelonAligner(device="cpu", group=8)
    sm = echelon_from_jax(StateMachineEchelon(template_model))
    match = ("defines none" if how == "expectations"
             else "get_split_points")
    with pytest.raises(NotImplementedError, match=match):
        ta.run(sm, reads, **kw)
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    assert fk.forward_tiled_plain.calls == 0 and not fk.KERNEL_LAUNCHES


def test_tiled_wrappers_and_single_state_extractors_refuse(runs):
    """The tiled wrappers refuse the echelon spec, the expectation pass
    says the reference has none, and the single-state extractors refuse a
    multi-state output (``ValueError``, as the JAX ``extract_pairs_auto``
    does)."""
    got, _ = runs
    nd = got["prep"]["bands"][0].n_diag
    with pytest.raises(ValueError, match="extract_echelon_pairs"):
        tc.extract_pairs_auto(got, 0, nd, THR)
    with pytest.raises(ValueError, match="extract_echelon_pairs"):
        tc.extract_pairs_chunk(got, [0], [nd], THR)
    with pytest.raises(NotImplementedError, match="defines none"):
        fk._no_expectations(fk.EchelonSpec)
    x = torch.zeros(1)
    for fn in (fk.wavefront_fwd_tiled, fk.wavefront_bwd_tiled):
        with pytest.raises(NotImplementedError, match="no tiled kernels"):
            fn(*([x] * (6 if fn is fk.wavefront_fwd_tiled else 10)), R=1,
               W=128, ND=128, C=131, TD=128, spec=fk.EchelonSpec)


def _planes(inp, dims):
    """``echelon_emissions`` at k = 0 and k = 1 (its plain twin on CPU
    tensors)."""
    geo = {k: dims[k] for k in ("R", "W", "ND", "C")}
    return [fk.echelon_emissions(inp["win"], inp["xf"], inp["yf"], k=k,
                                 **geo) for k in (0, 1)]


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_plain_passes_on_the_emission_planes_equal_inline(case):
    """The plain passes fed ``echelon_emissions``' planes (the wrapper's
    plain twin on CPU tensors: k = 0 to the forward, k = 1 to the
    backward, as the card's K1 and K2 read the pre-pass) equal
    forward_plain / backward_plain with their inline emissions bit for
    bit: the fwd plane, the five posterior planes and the totals; the
    planes are [G, ND+3, 6, R, W], NEG in the k = 1 plane's slot ND + 2."""
    inp, dims = case["inp"], case["dims"]
    fk.reset_counts()
    planes = _planes(inp, dims)
    assert fk.echelon_emissions_plain.calls == 2 and not fk.KERNEL_LAUNCHES
    G, ND, R, W = (inp["win"].shape[0], dims["ND"], dims["R"], dims["W"])
    assert all(p.shape == (G, ND + 3, 6, R, W) for p in planes)
    assert bool((planes[1][:, ND + 2] == np.float32(fk.NEG)).all())
    fwd = _fwd(inp, dims, fk.forward_plain)
    _same_bits([_fwd(inp, dict(dims, plane=planes[0]), fk.forward_plain)],
               [fwd])
    _same_bits(_bwd(inp, dict(dims, plane=planes[1]), fwd,
                    fk.backward_plain),
               _bwd(inp, dims, fwd, fk.backward_plain))


def test_backward_plane_holds_lanes_outside_the_next_window():
    """On reads whose group window moves (two 300-base references of
    bench.py's echelon recipe, ragged, group 2: W 128 of X 384), slot d of
    the k = 1 plane is diagonal d + 1 in d's window: equal to slot d + 1
    of the k = 0 plane moved into that window, and real emissions on the
    lanes that lie outside the window of d + 1 (where that realignment
    gives NEG); the backward fed it equals the inline backward bit for
    bit."""
    sm, reads = echelon_batch(n_reads=2, n_ref=300, n_events=260)
    ta = EchelonAligner(TorchParams(threshold=THR), device="cpu", group=2)
    prep = ta.prepare(sm, reads, ragged_right=True)
    inp = ta.device_inputs(sm, prep, ragged_left=True)
    dims = dict(R=prep["R"], W=prep["W"], ND=prep["ND"], C=prep["C"],
                spec=fk.EchelonSpec)
    planes = _planes(inp, dims)
    G, ND, R, W = (inp["win"].shape[0], dims["ND"], dims["R"], dims["W"])
    win = inp["win"].to(torch.int64)
    lane = torch.arange(W)
    outside = 0
    for d in range(ND + 1):
        s = (win[:, d] - win[:, d + 1])[:, None] + lane[None, :]    # [G, W]
        ok = ((s >= 0) & (s < W))[:, None, None, :].expand(G, 6, R, W)
        moved = torch.gather(planes[0][:, d + 1], 3, s.clamp(0, W - 1)[
            :, None, None, :].expand(G, 6, R, W))
        assert torch.equal(planes[1][:, d][ok], moved[ok])
        outside += int((planes[1][:, d][~ok] > np.float32(fk.NEG)).sum())
    assert outside > 100
    fwd = _fwd(inp, dims, fk.forward_plain)
    _same_bits(_bwd(inp, dict(dims, plane=planes[1]), fwd,
                    fk.backward_plain),
               _bwd(inp, dims, fwd, fk.backward_plain))


def test_plane_check_counts_the_emission_plane(template_model,
                                               monkeypatch):
    """``_check_planes`` budgets the fwd, posterior and emission pre-pass
    planes: a device that holds all but the last byte of that refuses the
    run before any pass, naming the remedies; one that holds a byte more
    runs."""
    from cpecan_tpu_torch.ops import fb
    reads = _reads(template_model)
    ta = EchelonAligner(device="cpu", group=8)
    sm = echelon_from_jax(StateMachineEchelon(template_model))
    prep = ta.prepare(sm, reads)
    G = prep["Bp"] // prep["R"]
    need = 4 * G * prep["R"] * prep["W"] * (
        prep["NDp"] * (fk.EchelonSpec.S + 5)
        + (prep["ND"] + 3) * fk.EchelonSpec.EM_LEAVES)
    share = fb.PLANE_MEMORY_SHARE
    fk.reset_counts()
    monkeypatch.setattr(fb, "device_memory_bytes",
                        lambda device: (need - 1) / share)
    with pytest.raises(ValueError, match="smaller chunks.*get_split_points"):
        ta.run(sm, reads)
    assert fk.forward_plain.calls == fk.backward_plain.calls == 0
    monkeypatch.setattr(fb, "device_memory_bytes",
                        lambda device: (need + 1) / share)
    ta.run(sm, reads)
    assert fk.forward_plain.calls == fk.backward_plain.calls == 1
