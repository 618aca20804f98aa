"""The port's 5-state DNA path (``Dna5Spec``, the plain K1/K2/K6a/K6b passes
on the CPU, ``Dna5Aligner``) against the JAX package's ``Dna5PallasAligner``
(interpret-mode Pallas kernels), on the reads of
``tests/test_pallas.py::test_dna5_pallas_matches_engine`` (seed 17 and the
golden AGCG x AGTTCG) and of ``tests/test_pallas_tiled.py::
test_tiled_matches_untiled_dna5`` (seed 5).  The CUDA kernels are held
against these plain versions on the card by tests/test_torch_gpu.py.
Tolerances: cpecan_tpu_torch/parity.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models import hmm as j_hmm
from cpecan_tpu.models.state_machines import StateMachine5 as JStateMachine5
from cpecan_tpu.ops.pallas_fb import Dna5PallasAligner, extract_pairs_auto

from cpecan_tpu_torch.models import hmm as t_hmm
from cpecan_tpu_torch.models.state_machines import (StateMachine5,
                                                    machine5_from_jax)
from cpecan_tpu_torch.ops import compact as tc
from cpecan_tpu_torch.ops import fb_kernels as fk
from cpecan_tpu_torch.ops.fb import Dna5Aligner
from cpecan_tpu_torch.parity import (band_mask, check_fwd, check_pairs,
                                     check_posts, check_tiled,
                                     check_tiled_pairs, check_totals)

GOLDEN = {(0, 0), (1, 1), (2, 4), (3, 5)}
GOLDEN_THR = 0.2


def _engine_reads():
    """test_dna5_pallas_matches_engine's reads: five mutated pairs (seed
    17, anchors every 12) and the reference golden case."""
    rng = np.random.default_rng(17)
    reads = []
    for i in range(5):
        n = 60 + 15 * i
        seq_x = "".join(rng.choice(list("ACGT"), n))
        seq_y = "".join(c if rng.random() > 0.15 else
                        str(rng.choice(list("ACGT"))) for c in seq_x)
        anchors = [(j, j) for j in range(10, n - 10, 12)]
        reads.append((seq_x, seq_y, len(seq_x), len(seq_y), anchors))
    reads.append(("AGCG", "AGTTCG", 4, 6, []))
    return reads


def _tiled_reads():
    """test_tiled_matches_untiled_dna5's two ~500-base pairs (seed 5)."""
    from tests.test_pallas_tiled import _dense_anchors

    rng = np.random.default_rng(5)
    reads = []
    for _ in range(2):
        n = int(rng.integers(420, 520))
        sx = "".join(rng.choice(list("ACGT"), n))
        out = []
        for ch in sx:
            r = rng.random()
            if r < 0.05:
                continue
            out.append(rng.choice(list("ACGT")) if r < 0.12 else ch)
            if rng.random() < 0.05:
                out.append(rng.choice(list("ACGT")))
        sy = "".join(out)
        reads.append((sx, sy, len(sx), len(sy),
                      _dense_anchors(len(sx), len(sy), 64)))
    return reads


# a pair with N on both sides (test_dna5_pallas_expectations_match_engine)
N_READ = ("ACGTAGGTACNGATTACAGGATCC", "ACGTCGGTACAGATNACAGGATCC", 24, 24, [])


@pytest.fixture(scope="module", params=[False, True],
                ids=["flush", "ragged"])
def case(request):
    """JAX kernel outputs and the port's inputs for the engine reads;
    ``ragged`` runs with ragged left and right ends."""
    ragged = request.param
    reads = _engine_reads()
    sm = JStateMachine5()
    pa = Dna5PallasAligner(AlignmentParams(), interpret=True)
    prep = pa.prepare(sm, reads, ragged_right=ragged)
    scal = pa._scalars(sm, ragged_left=ragged)
    fwd_fn, bwd_fn, _ = pa._fns(prep["X"], prep["ND"], prep["C"], prep["W"])
    xf, yf = pa._device_features(sm, prep)
    bands = pa._device_bands(prep["NDp"], prep["anch"].shape[1])(
        jnp.asarray(prep["anch"]), jnp.asarray(prep["meta"]))
    win3 = jnp.asarray(prep["win"][:, None, :])
    fwd = fwd_fn(scal, win3, xf, yf, *bands[:2])
    posts, totals = bwd_fn(scal, win3, xf, yf, *bands, fwd)
    ta = Dna5Aligner(device="cpu", group=pa.group)
    tsm = machine5_from_jax(sm)
    tprep = ta.prepare(tsm, reads, ragged_right=ragged)
    inp = ta.device_inputs(tsm, tprep, ragged_left=ragged)
    dims = dict(R=tprep["R"], W=tprep["W"], ND=tprep["ND"], C=tprep["C"],
                spec=fk.Dna5Spec)
    return dict(prep=prep, inp=inp, dims=dims, fwd=np.asarray(fwd),
                posts=np.asarray(posts), totals=np.asarray(totals),
                mask=band_mask(prep, bands[0], bands[1]), ragged=ragged)


def _fwd(inp, dims, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], **dims)


def _bwd(inp, dims, fwd, fn):
    return fn(inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
              inp["widthf"], inp["seedf"], inp["raggedf"], fwd, **dims)


def test_dna5_forward_plain_matches_jax_kernel(case):
    fk.reset_counts()
    got = _fwd(case["inp"], case["dims"], fk.wavefront_fwd)
    assert fk.forward_plain.calls == 1 and not fk.KERNEL_LAUNCHES
    assert got.shape == case["fwd"].shape and got.shape[2] == 5
    check_fwd(got.numpy(), case["fwd"], case["mask"])


def test_dna5_backward_plain_matches_jax_kernel(case):
    posts, totals = _bwd(case["inp"], case["dims"],
                         torch.from_numpy(case["fwd"].copy()),
                         fk.wavefront_bwd)
    assert posts.shape == case["posts"].shape
    assert np.all(posts[:, 0].numpy() == 0.0)
    check_posts(posts.numpy(), case["posts"])
    check_totals(totals.numpy(), case["totals"][..., 0])
    assert np.all(np.isfinite(totals.numpy()))


def test_dna5_features_match_jax():
    """Host inputs (bx, ydata) and device features (xf, yf) equal the JAX
    package's bit for bit, with N on both sides of a read."""
    reads = _engine_reads() + [N_READ]
    sm = JStateMachine5()
    pa = Dna5PallasAligner(AlignmentParams(), interpret=True)
    prep = pa.prepare(sm, reads)
    ta = Dna5Aligner(device="cpu", group=pa.group)
    tprep = ta.prepare(machine5_from_jax(sm), reads)
    np.testing.assert_array_equal(tprep["bx"], prep["bx"])
    assert tprep["bx"].dtype == np.int16 and (tprep["bx"][-1] == 4).sum() > 1
    np.testing.assert_array_equal(tprep["ydata"], prep["ydata"])
    xf, yf = ta.device_features(machine5_from_jax(sm), tprep)
    jxf, jyf = pa._device_features(sm, prep)
    assert xf.shape == (len(tprep["bx"]), 6, tprep["X"])
    np.testing.assert_array_equal(xf.numpy(), np.asarray(jxf))
    np.testing.assert_array_equal(yf.numpy(), np.asarray(jyf))
    # the N in y carries base index 4 and the N gap-Y emission
    assert 4.0 in yf[len(reads) - 1, 0].tolist()


@pytest.mark.parametrize("ragged_left", [False, True])
def test_dna5_scalars_match_jax(ragged_left):
    sm = JStateMachine5()
    want = Dna5PallasAligner(AlignmentParams(), interpret=True)._scalars(
        sm, ragged_left=ragged_left)
    got = machine5_from_jax(sm).scalars(ragged_left=ragged_left)
    assert got.shape == (1, 28) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, StateMachine5().scalars(ragged_left))


@pytest.mark.parametrize("type_", [j_hmm.TYPE_FIVE_STATE,
                                   j_hmm.TYPE_FIVE_STATE_ASYMMETRIC],
                         ids=["symmetric", "asymmetric"])
def test_dna5_machine_from_loaded_hmm_matches_jax(type_, tmp_path):
    """A non-default HMM written by the JAX HmmDiscrete: the port's load +
    normalize + sm5_from_hmm gives the JAX machine's scalars and tables,
    and machine5_from_jax gives the same machine."""
    hmm = j_hmm.HmmDiscrete(5, 4, type_=type_)
    hmm.randomize(np.random.default_rng(3))
    path = tmp_path / "hmm.txt"
    with open(path, "w") as fh:
        hmm.write(fh)
    jh = j_hmm.HmmDiscrete.load(str(path))
    jh.normalize()
    jsm = j_hmm.sm5_from_hmm(jh)
    th = t_hmm.HmmDiscrete.load(str(path))
    th.normalize()
    tsm = t_hmm.sm5_from_hmm(th)
    assert tsm.p == jsm.p
    pa = Dna5PallasAligner(AlignmentParams(), interpret=True)
    from cpecan_tpu.models.state_machines import _extend_tables_with_n
    m5, gx5, gy5 = _extend_tables_with_n(jsm.match_table, jsm.gap_x_table,
                                         jsm.gap_y_table)
    for sm in (tsm, machine5_from_jax(jsm)):
        for rl in (False, True):
            np.testing.assert_array_equal(sm.scalars(rl).numpy(),
                                          pa._scalars(jsm, ragged_left=rl))
        np.testing.assert_array_equal(sm.match5.numpy(),
                                      m5.astype(np.float32))
        np.testing.assert_array_equal(sm.gapx5.numpy(),
                                      gx5.astype(np.float32))
        np.testing.assert_array_equal(sm.gapy5.numpy(),
                                      gy5.astype(np.float32))
    assert tsm.p["match_continue"] != JStateMachine5().p["match_continue"]


def test_dna5_run_matches_jax_run_and_golden():
    """The whole run (plain passes) against the JAX run: pair sets equal up
    to the threshold fringe, posteriors within POST_ATOL, and the golden
    pair set at threshold 0.2."""
    reads = _engine_reads()
    sm = JStateMachine5()
    want = Dna5PallasAligner(AlignmentParams(threshold=GOLDEN_THR),
                             interpret=True).run(
        sm, reads, ragged_left=True, ragged_right=True)
    fk.reset_counts()
    got = Dna5Aligner(AlignmentParams(threshold=GOLDEN_THR), device="cpu",
                      group=8).run(machine5_from_jax(sm), reads,
                                   ragged_left=True, ragged_right=True)
    assert (fk.forward_plain.calls, fk.backward_plain.calls) == (1, 1)
    check_posts(got["posteriors"].numpy(), np.asarray(want["posteriors"]))
    thr = AlignmentParams().threshold
    for i, (_sx, _sy, l_x, l_y, _a) in enumerate(reads):
        nd = got["prep"]["bands"][i].n_diag
        mine = tc.extract_pairs_auto(got, i, nd, thr)
        check_pairs(mine, extract_pairs_auto(want, i, nd, thr), got, want, i,
                    thr)
    flush = Dna5Aligner(AlignmentParams(threshold=GOLDEN_THR), device="cpu",
                        group=8).run(StateMachine5(), reads)
    golden = tc.extract_pairs_auto(flush, len(reads) - 1,
                                   flush["prep"]["bands"][-1].n_diag,
                                   GOLDEN_THR)
    assert {(x, y) for _, x, y in golden} == GOLDEN


@pytest.fixture(scope="module")
def tiled_runs():
    """(port tiled, JAX tiled, port untiled) runs of the tiled test's reads
    with tile_diag=128, ragged at both ends."""
    reads = _tiled_reads()
    sm = JStateMachine5()
    kw = dict(compact_k=512, ragged_left=True, ragged_right=True)
    want = Dna5PallasAligner(AlignmentParams(), interpret=True).run(
        sm, reads, tile_diag=128, **kw)
    ta = Dna5Aligner(device="cpu", group=8)
    fk.reset_counts()
    got = ta.run(machine5_from_jax(sm), reads, tile_diag=128, **kw)
    assert (fk.forward_tiled_plain.calls, fk.backward_tiled_plain.calls,
            fk.forward_plain.calls) == (1, 1, 0)
    untiled = ta.run(machine5_from_jax(sm), reads, **kw)
    return got, want, untiled


def test_dna5_tiled_run_matches_jax_tiled_run(tiled_runs):
    """test_pallas_tiled's bar (posteriors 1e-2, totals 5e-2, one-sided
    pairs at the threshold) against the JAX tiled run, and the same against
    the port's own untiled run."""
    got, want, untiled = tiled_runs
    assert got["tiled"] == want["tiled"] and got["tiled"]["NT"] > 3
    check_tiled(got["posteriors"], got["totals"],
                np.asarray(want["posteriors"]),
                np.asarray(want["totals"])[..., 0])
    check_tiled(got["posteriors"], got["totals"], untiled["posteriors"],
                untiled["totals"])
    thr = AlignmentParams().threshold
    for i, b in enumerate(got["prep"]["bands"]):
        mine = tc.extract_pairs_long(got, i, b.n_diag, thr, as_array=True)
        check_tiled_pairs(mine, tc.extract_pairs_long(
            want, i, b.n_diag, thr, as_array=True), thr)
        check_tiled_pairs(mine, tc.extract_pairs_auto(
            untiled, i, b.n_diag, thr, as_array=True), thr)
        assert len(mine) > 300


@pytest.mark.parametrize("tile_diag, steps", [
    (None, ["prepare", "inputs", "fwd", "bwd", "compact"]),
    (128, ["prepare", "inputs", "fwd_tiled", "bwd_tiled", "compact"])],
    ids=["untiled", "tiled"])
def test_run_stage_hook_runs_each_step_once(tile_diag, steps):
    """``run(stage=)`` hands each step of the run to the hook by name, once,
    and gives the result of a run without it."""
    reads, sm = _engine_reads(), StateMachine5()
    ta = Dna5Aligner(device="cpu", group=8)
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()

    kw = dict(ragged_left=True, ragged_right=True, tile_diag=tile_diag)
    got = ta.run(sm, reads, stage=stage, **kw)
    want = ta.run(sm, reads, **kw)
    assert names == steps
    assert torch.equal(got["posteriors"], want["posteriors"])
    assert torch.equal(got["totals"], want["totals"])


def test_wrapper_launches_read_the_strawman_entry():
    """Each launch is counted once, in ``KERNEL_LAUNCHES`` under its entry
    point; a wrapper's ``.launches`` reads its strawman entry there."""
    fk.reset_counts()
    fk._counted("wavefront_fwd_dna5")
    assert fk.wavefront_fwd.launches == 0
    fk._counted("wavefront_fwd")
    assert fk.wavefront_fwd.launches == 1
    assert fk.KERNEL_LAUNCHES == {"wavefront_fwd": 1,
                                  "wavefront_fwd_dna5": 1}
    fk.reset_counts()
    assert fk.wavefront_fwd.launches == 0 and not fk.KERNEL_LAUNCHES


def test_dna5_expectations_raise():
    """A dna5 expectation run past 2^14 estimated diagonals (an alignment
    of more than ~8 kb a side that cPecanEm did not split) is refused
    before any pass runs, naming the split (the JAX package runs it
    untiled with a warning; ROADMAP Queue 3)."""
    ta = Dna5Aligner(device="cpu", group=8)
    fk.reset_counts()
    for kw in (dict(shape_hint=(60, 2 ** 14)), dict(tile_diag=256)):
        with pytest.raises(NotImplementedError, match="get_split_points"):
            ta.run(StateMachine5(), _engine_reads()[:1], expectations=True,
                   **kw)
    long_pair = ("A" * 8200, "A" * 8200, 8200, 8200, [])
    with pytest.raises(NotImplementedError, match="get_split_points"):
        ta.run(StateMachine5(), [long_pair], expectations=True)
    assert fk.forward_plain.calls == fk.backward_exp_plain.calls == 0


def test_dna5_routing(monkeypatch):
    """The JAX routing: 2^14 estimated diagonals, 2^15 columns or any
    tile_diag take the tiled path (with the default tile unless given);
    one diagonal fewer stays untiled."""
    reads = _engine_reads()[:1]
    ta = Dna5Aligner(device="cpu", group=8)
    calls = []
    monkeypatch.setattr(Dna5Aligner, "_run_tiled",
                        lambda self, sm, reads, **kw: calls.append(kw))
    for kw in (dict(shape_hint=(60, 2 ** 14)),
               dict(shape_hint=(2 ** 15 - 2, 100)), dict(tile_diag=256)):
        ta.run(StateMachine5(), reads, **kw)
    assert [c["tile_diag"] for c in calls] == [2048, 2048, 256]

    class Untiled(Exception):
        pass

    def untiled_prepare(self, *args, **kw):
        raise Untiled

    monkeypatch.setattr(Dna5Aligner, "prepare", untiled_prepare)
    with pytest.raises(Untiled):
        ta.run(StateMachine5(), reads, shape_hint=(60, 2 ** 14 - 1))
    assert len(calls) == 3


def test_wide_group_window_error_names_the_remedy():
    """A group window past one thread per lane is refused before any
    launch, naming the remedy (ROADMAP Queue 3: the W limit)."""
    spec = fk.Dna5Spec
    t = torch.zeros((1, spec.NXF, 4096))
    scal = torch.zeros(spec.NS + 3 * spec.S)
    win = torch.zeros((1, 512), dtype=torch.int32)
    with pytest.raises(ValueError, match="lower the group size"):
        fk._geometry(win, t, t, scal, 1, 2048, 4, spec)
    with pytest.raises(ValueError, match="dna5 kernels take 6"):
        fk._geometry(win, torch.zeros((1, 9, 4096)), t, scal, 1, 128, 4,
                     spec)
