"""The port's tiled long-alignment path (``StrawmanAligner._run_tiled``, the
plain K6a/K6b passes on the CPU) against the JAX package's tiled path
(interpret-mode Pallas kernels) and against the port's own untiled run, on
the reads of ``tests/test_pallas_tiled.py``; its routing and refusals; and
the long-read fixture against a fresh build.  Tolerances:
cpecan_tpu_torch/parity.py."""

import os

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.ops import pallas_fb as jfb

from cpecan_tpu_torch.models.state_machines import machine_from_jax
from cpecan_tpu_torch.ops import compact as tc
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import StrawmanAligner
from cpecan_tpu_torch.parity import (check_pairs, check_posts, check_tiled,
                                     check_tiled_pairs, check_totals)
from cpecan_tpu_torch.synthetic import long_signal_read

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "long_read.npz")
THR = AlignmentParams().threshold


def _reads(seed, n_reads, l_ref, n_events):
    """``test_pallas_tiled._synth_signal_reads``: jittered synthetic
    reads from the seed's first draw."""
    rng = np.random.default_rng(seed)
    return _synthetic_batch(n_reads=n_reads, n_ref=l_ref, n_events=n_events,
                            seed=int(rng.integers(1e6)), shape_jitter=0.2)


@pytest.fixture(scope="module", params=["flush", "ragged"])
def strawman_runs(request):
    """test_tiled_matches_untiled_strawman's reads (3 x 500 x 430), flush
    or ragged at both ends: (port tiled, port untiled, JAX tiled) runs."""
    sm, reads = _reads(11, 3, 500, 430)
    kw = dict(compact_k=512)
    if request.param == "ragged":
        kw.update(ragged_left=True, ragged_right=True)
    want = jfb.StrawmanPallasAligner(AlignmentParams(), interpret=True).run(
        sm, reads, tile_diag=128, **kw)
    ta = StrawmanAligner(device="cpu", group=8)
    fk.reset_counts()
    got = ta.run(machine_from_jax(sm), reads, tile_diag=128, **kw)
    assert (fk.forward_tiled_plain.calls, fk.backward_tiled_plain.calls,
            fk.forward_plain.calls) == (1, 1, 0)
    untiled = ta.run(machine_from_jax(sm), reads, **kw)
    return tc.fetch(got), tc.fetch(untiled), want


def test_tiled_run_matches_jax_tiled_run(strawman_runs):
    got, _, want = strawman_runs
    assert got["tiled"] == want["tiled"] and got["tiled"]["NT"] > 3
    assert tuple(got["posteriors"].shape) == want["posteriors"].shape
    check_posts(got["posteriors"].numpy(), want["posteriors"])
    check_totals(got["totals"].numpy(), np.asarray(want["totals"])[..., 0])
    assert [o for o, _ in got["compact_chunks"]] == [
        o for o, _ in want["compact_chunks"]]
    for (_, a), (_, b) in zip(got["compact_chunks"], want["compact_chunks"]):
        for x, y in zip(a, b):
            y = np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape


def test_tiled_pairs_match_jax_tiled_pairs(strawman_runs):
    """The port's extraction of its tiled run equals the JAX package's
    extract_pairs_long on the same output, and matches the JAX tiled run's
    pairs up to the threshold fringe."""
    got, _, want = strawman_runs
    nds = [b.n_diag for b in got["prep"]["bands"]]
    n_pairs = 0
    for i, nd in enumerate(nds):
        mine = tc.extract_pairs_long(got, i, nd, THR, as_array=True)
        np.testing.assert_array_equal(
            mine, jfb.extract_pairs_long(got, i, nd, THR, as_array=True))
        check_pairs(mine.tolist(), jfb.extract_pairs_long(want, i, nd, THR),
                    got, want, i, THR)
        n_pairs += len(mine)
    assert n_pairs > 1000


def test_tiled_run_matches_untiled_run(strawman_runs):
    """test_pallas_tiled's bar, on the port: REL 1e-2, totals atol 5e-2."""
    got, untiled, _ = strawman_runs
    check_tiled(got["posteriors"], got["totals"], untiled["posteriors"],
                untiled["totals"])
    nds = [b.n_diag for b in got["prep"]["bands"]]
    for i, nd in enumerate(nds):
        check_tiled_pairs(tc.extract_pairs_long(got, i, nd, THR),
                          tc.extract_pairs_auto(untiled, i, nd, THR), THR)


def test_chunk_extraction_handles_tiled_outputs():
    """extract_pairs_chunk and extract_pairs_auto on a tiled output return
    the rows they return on the untiled one (test_pallas_tiled's
    test_chunk_extraction_handles_tiled_outputs)."""
    sm, reads = _reads(17, 2, 400, 350)
    ta = StrawmanAligner(device="cpu", group=8)
    tsm = machine_from_jax(sm)
    out_u = ta.run(tsm, reads, compact_k=512)
    out_t = ta.run(tsm, reads, compact_k=512, tile_diag=128)
    nds = [b.n_diag for b in out_u["prep"]["bands"]]
    got = tc.extract_pairs_chunk(out_t, [0, 1], nds, THR)
    want = tc.extract_pairs_chunk(out_u, [0, 1], nds, THR)
    for i, (g, w) in enumerate(zip(got, want)):
        assert {tuple(r[1:]) for r in g} == {tuple(r[1:]) for r in w}
        np.testing.assert_array_equal(
            g, tc.extract_pairs_auto(out_t, i, nds[i], THR, as_array=True))
        assert np.all(np.diff(g[:, 1] + g[:, 2]) >= 0)


def test_tiled_saturated_chunk_reads_the_plane():
    """With k below a chunk's pair count the chunk reads the full plane:
    the same pairs as with a large k, scores unquantized (within two u16
    wire steps)."""
    sm, reads = _reads(17, 2, 400, 350)
    ta = StrawmanAligner(device="cpu", group=8)
    tsm = machine_from_jax(sm)
    small = ta.run(tsm, reads[:1], compact_k=8, tile_diag=128)
    nd = small["prep"]["bands"][0].n_diag
    big = dict(small, compact_chunks=tc.compact_chunks(
        small["posteriors"], small["tiled"]["DC"], 512))
    a = tc.extract_pairs_long(small, 0, nd, THR, as_array=True)
    b = tc.extract_pairs_long(big, 0, nd, THR, as_array=True)
    np.testing.assert_array_equal(a[:, 1:], b[:, 1:])
    assert np.abs(a[:, 0] - b[:, 0]).max() <= 2 * 153


def test_tiled_plain_passes_shift_each_tile():
    """The plain tiled forward re-centers at every tile boundary (a
    seeded read's shifts are nonzero past tile 0), its rows past ND hold
    NEG, and the backward's rows past ND and diagonal 0 hold 0."""
    sm, reads = _reads(1, 1, 300, 260)
    ta = StrawmanAligner(device="cpu", group=8)
    tsm = machine_from_jax(sm)
    prep = ta.prepare(tsm, reads, tile_diag=128)
    inp = ta.device_inputs(tsm, prep)
    tl = prep["tiled"]
    dims = dict(R=prep["R"], W=prep["W"], ND=tl["NDT"], C=prep["C"],
                TD=tl["TD"])
    fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    fwd, shifts = fk.wavefront_fwd_tiled(*fa, **dims)
    assert tuple(shifts.shape) == (1, 8, tl["NT"])
    assert torch.all(shifts[..., 0] == 0) and torch.all(shifts[..., 1:] < 0)
    assert torch.all(fwd[:, prep["ND"] + 1:] == fk.NEG)
    posts, _ = fk.wavefront_bwd_tiled(*fa, inp["seedf"], inp["raggedf"],
                                      fwd, shifts, **dims)
    assert torch.all(posts[:, 0] == 0) and torch.all(
        posts[:, prep["ND"] + 1:] == 0)
    with pytest.raises(ValueError, match="whole number"):
        fk.wavefront_fwd_tiled(*fa, **dict(dims, TD=100))


def test_tiled_routing_and_refusals(monkeypatch):
    """2^14 estimated diagonals route tiled with the default tile;
    expectations past the wall or with a tile, and mesh runs, raise."""
    sm, reads = _reads(1, 1, 300, 260)
    ta = StrawmanAligner(device="cpu", group=8)
    tsm = machine_from_jax(sm)
    calls = []
    monkeypatch.setattr(StrawmanAligner, "_run_tiled",
                        lambda self, sm, reads, **kw: calls.append(kw))
    ta.run(tsm, reads, shape_hint=(300, 2 ** 14))
    assert len(calls) == 1 and calls[0]["tile_diag"] == 2048

    class Untiled(Exception):
        pass

    def untiled_prepare(self, *args, **kw):
        raise Untiled

    monkeypatch.setattr(StrawmanAligner, "prepare", untiled_prepare)
    with pytest.raises(Untiled):
        ta.run(tsm, reads, shape_hint=(300, 2 ** 14 - 1))
    for kw in (dict(tile_diag=128), dict(shape_hint=(300, 2 ** 14))):
        with pytest.raises(NotImplementedError, match="get_split_points"):
            ta.run(tsm, reads, expectations=True, **kw)
    with pytest.raises(NotImplementedError, match="item 9"):
        ta.run(tsm, reads, mesh=object(), tile_diag=128)
    assert len(calls) == 1


def test_long_read_fixture_is_current():
    """The port's long read equals tools/exp_long_events.py's exactly, and
    the f64 engine's pairs recomputed for it equal the stored ones (the
    interpret-mode tiled pairs are not rebuilt here)."""
    from tests.fixtures.make_long_read_fixture import engine_pairs, jax_read

    stored = np.load(FIXTURE)
    jmodel, jread = jax_read()
    model, read = long_signal_read(int(stored["l_x"]), int(stored["l_y"]),
                                   int(stored["seed"]))
    assert read[0] == jread[0] and read[2:4] == jread[2:4]
    np.testing.assert_array_equal(read[1], jread[1])
    assert read[4] == jread[4]
    np.testing.assert_array_equal(model.match_model, jmodel.match_model)
    np.testing.assert_array_equal(engine_pairs(jmodel, jread),
                                  stored["engine_pairs"])
    assert len(stored["tiled_pairs"]) > 17000
