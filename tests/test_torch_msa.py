"""The port's MSA layer (``cpecan_tpu_torch.msa``: the whole of
``multiple_aligner.py``, the native greedy column build, and
``gpu.gpu_batch_align_fn`` on the plain dna5 passes) against the JAX
package's (``cpecan_tpu.msa``, ``tpu_batch_align_fn`` on the interpret-mode
Pallas kernels), on the inputs of ``tests/test_msa.py``.

- The host layer exactly: both packages' ``make_alignment`` with one
  stand-in ``batch_align_fn`` and one seed give equal aligned pairs,
  chosen alignments and column partitions; the greedy build's three
  consistency modes and the one-call native build give the JAX package's
  partitions.
- The device layer: every pairwise job of ``test_tpu_batch_align_fn_
  matches_per_pair``'s four fragments, pair by pair within
  ``parity.check_pairs`` (score within SCORE_ATOL, a pair in one list only
  explained by a posterior at the threshold); batched equals one job at a
  time.
- Both together: ``make_alignment`` with each package's own batch function.

Tolerances: cpecan_tpu_torch/parity.py.
"""

import random

import numpy as np
import pytest
import torch

from cpecan_tpu.msa import multiple_aligner as j_msa
from cpecan_tpu.msa.tpu import tpu_batch_align_fn
from cpecan_tpu.ops.pallas_fb import Dna5PallasAligner
from cpecan_tpu.ops.pallas_fb import extract_pairs_auto as j_extract

from cpecan_tpu_torch.msa import gpu as t_gpu
from cpecan_tpu_torch.msa import multiple_aligner as t_msa
from cpecan_tpu_torch.msa.gpu import gpu_batch_align_fn
from cpecan_tpu_torch.ops.compact import extract_pairs_auto as t_extract
from cpecan_tpu_torch.ops.fb import Dna5Aligner
from cpecan_tpu_torch.ops.reweight import reweight_aligned_pairs_2
from cpecan_tpu_torch.parity import check_pairs

THRESHOLD = 0.01   # AlignmentParams().threshold
GAP_GAMMA = 0.5    # AlignmentParams().gap_gamma


def _partition(cols):
    return sorted(sorted(m) for m in cols.members.values())


def _mutate(rng, s, rate=0.08):
    return "".join(c if rng.random() > rate else
                   rng.choice("ACGT") for c in s)


def _frag_specs():
    """test_tpu_batch_align_fn_matches_per_pair's four fragments (seq,
    left end id, right end id): all four ragged-end combinations occur."""
    rng = random.Random(7)
    base = "".join(rng.choice("ACGT") for _ in range(44))
    return [(base, 0, 1), (_mutate(rng, base), 0, 1),
            (_mutate(rng, base), 2, 3), (_mutate(rng, base), 2, 1)]


def _jobs(specs):
    return [(specs[a][0], specs[b][0], specs[a][1] != specs[b][1],
             specs[a][2] != specs[b][2])
            for a in range(len(specs)) for b in range(a + 1, len(specs))]


class _Recorder:
    """An aligner that keeps every run's output (in dispatch order)."""

    def __init__(self, inner):
        self.inner, self.outs = inner, []

    def run(self, *args, **kwargs):
        out = self.inner.run(*args, **kwargs)
        self.outs.append(out)
        return out


def _job_slots(jobs):
    """(run index, read index) of each job in a batch function's runs: one
    run per ragged-end combination in first-seen order (fewer than 16 jobs
    each, no empty sequence, no lastz anchors at this size)."""
    by_ragged = {}
    for ji, (_x, _y, rl, rr) in enumerate(jobs):
        by_ragged.setdefault((bool(rl), bool(rr)), []).append(ji)
    slots = {}
    for run_idx, members in enumerate(by_ragged.values()):
        for i, ji in enumerate(members):
            slots[ji] = (run_idx, i)
    return slots


@pytest.fixture(scope="module")
def device_layer():
    """Both packages' batch functions on every pairwise job of the four
    fragments, with each run's output: the port batched and one job at a
    time."""
    specs = _frag_specs()
    jobs = _jobs(specs)
    j_rec = _Recorder(Dna5PallasAligner(interpret=True))
    t_rec = _Recorder(Dna5Aligner(device="cpu", group=8))
    j_bfn = tpu_batch_align_fn(aligner=j_rec)
    t_bfn = gpu_batch_align_fn(aligner=t_rec)
    want = j_bfn(jobs)
    got = t_bfn(jobs)
    singles = [gpu_batch_align_fn(device="cpu")([job])[0] for job in jobs]
    return dict(specs=specs, jobs=jobs, want=want, got=got, singles=singles,
                j_outs=list(j_rec.outs), t_outs=list(t_rec.outs),
                j_aligner=j_rec.inner)


def _stand_in(jobs):
    """A deterministic stand-in for the pairwise aligner: (score, x, y)
    pairs near the diagonal with scores drawn from a seed of the job, so
    that both packages see the same pairs."""
    out = []
    for seq_x, seq_y, rl, rr in jobs:
        rng = random.Random(f"{seq_x}|{seq_y}|{rl}|{rr}")
        pairs = []
        for x in range(len(seq_x)):
            for y in (x - 1, x, x + 1):
                if 0 <= y < len(seq_y) and rng.random() < 0.7:
                    pairs.append((rng.randrange(10 ** 5, 10 ** 7), x, y))
        out.append(pairs)
    return out


def _diagonal(jobs):
    """A stand-in with (x, x) pairs only: no pair crosses another."""
    out = []
    for seq_x, seq_y, rl, rr in jobs:
        rng = random.Random(f"{seq_x}|{seq_y}|{rl}|{rr}")
        out.append([(rng.randrange(10 ** 5, 10 ** 7), i, i)
                    for i in range(min(len(seq_x), len(seq_y)))])
    return out


def _msa_frags(n, length, seed):
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(length))
    return [(_mutate(rng, base, 0.12), i % 3, (i * 7) % 4) for i in range(n)]


def _outcome(mod, spanning_trees, progressive, stand_in):
    """make_alignment's result on 7 fragments, or the exception it
    raised."""
    frags = [mod.SeqFrag(*s) for s in _msa_frags(7, 36, 11)]
    try:
        return mod.make_alignment(
            None, frags, spanning_trees=spanning_trees,
            max_pairs_to_consider=1000,
            use_progressive_merging=progressive, match_gamma=0.2,
            rng=random.Random(3), batch_align_fn=stand_in)
    except KeyError as exc:
        return exc


@pytest.mark.parametrize("spanning_trees, progressive, stand_in, raises", [
    (4, False, _stand_in, False), (1, False, _stand_in, False),
    (2, False, _stand_in, False), (4, True, _diagonal, False),
    (4, True, _stand_in, True), (2, True, _diagonal, True)],
    ids=["all-pairs", "spanning-1", "spanning-2", "progressive-all-pairs",
         "progressive-crossing", "progressive-spanning-2"])
def test_host_layer_matches_jax(spanning_trees, progressive, stand_in,
                                raises):
    """(a) make_alignment on one stand-in batch function and one seed: the
    same aligned pairs, chosen alignments and column partitions in the
    all-pairs branch (spanning_trees * (n - 1) >= n(n - 1)/2) and the
    spanning-tree branch (its next-best-pair rounds and rng tie breaks),
    greedy and progressive.  Progressive merging of more than two
    fragments raises KeyError in ``pairwise_align_columns``'s traceback in
    the JAX package on crossing pairs, and on diagonal ones in a second
    spanning-tree round; the copy raises the same (ROADMAP Queue 3,
    reference faults)."""
    got, want = (_outcome(mod, spanning_trees, progressive, stand_in)
                 for mod in (t_msa, j_msa))
    if raises:
        assert isinstance(want, KeyError) and isinstance(got, KeyError)
        assert got.args == want.args
        return
    assert got.aligned_pairs == want.aligned_pairs
    assert got.chosen_pairwise_alignments == want.chosen_pairwise_alignments
    assert _partition(got.columns) == _partition(want.columns)
    assert len(got.aligned_pairs) > 0
    # the all-pairs branch aligns every pair once; the spanning chains
    # take n - 1 pairs, each later round at most one a fragment
    n_chosen = len(got.chosen_pairwise_alignments)
    if spanning_trees == 4:
        assert n_chosen == 21
    else:
        assert 6 <= n_chosen <= 6 + 7 * (spanning_trees - 1)


def _greedy_instances():
    """test_poset_checker_matches_bfs_checker's instances (seeds 0-7)."""
    for seed in range(8):
        rng = random.Random(seed)
        n_seqs = rng.randrange(2, 6)
        lens = [rng.randrange(3, 14) for _ in range(n_seqs)]
        maps = []
        for _ in range(rng.randrange(10, 60)):
            s1, s2 = rng.sample(range(n_seqs), 2)
            maps.append((rng.randrange(1, 10_000_000), s1,
                         rng.randrange(lens[s1]), s2,
                         rng.randrange(lens[s2])))
        yield seed, lens, maps


def test_poset_checker_matches_bfs_checker():
    """(a) The port's incremental closure (native and numpy) accepts and
    rejects exactly the merges of its BFS checker, and every mode gives
    the JAX package's partition on the same instance."""
    assert t_msa._get_poset_lib() is not None, "msa_columns did not build"
    for seed, lens, maps in _greedy_instances():
        parts = {}
        for mod in (t_msa, j_msa):
            frags = [mod.SeqFrag("A" * l, i, i) for i, l in enumerate(lens)]
            for mode in ("poset", "poset-numpy", "bfs"):
                cols = mod.make_columns_greedy(
                    frags, maps, 0.05, rng=random.Random(seed + 100),
                    consistency=mode)
                parts[mod.__name__, mode] = _partition(cols)
        assert len({str(p) for p in parts.values()}) == 1, seed


def _native_instances():
    """test_native_greedy_matches_python_loop's instances (seeds 0-5),
    duplicate edges included."""
    for seed in range(6):
        rng = random.Random(seed)
        n = rng.randrange(3, 7)
        seqs = ["".join(rng.choice("ACGT") for _ in range(
            rng.randrange(6, 14))) for _ in range(n)]
        maps = []
        for s1 in range(n):
            for s2 in range(s1 + 1, n):
                for _ in range(rng.randrange(4, 16)):
                    maps.append((rng.randrange(1, 10_000_000), s1,
                                 rng.randrange(len(seqs[s1])), s2,
                                 rng.randrange(len(seqs[s2]))))
        for _ in range(3):
            sc, a, i, b, j = maps[rng.randrange(len(maps))]
            maps.append((rng.randrange(1, 10_000_000), a, i, b, j))
        yield seed, seqs, maps, rng.choice([0.05, 0.2, 0.5])


def test_native_greedy_matches_python_loop():
    """(a) The port's one-call native greedy build makes the decisions of
    its Python heap loop and of the JAX package's native build, and leaves
    the rng where the Python loop leaves it."""
    for seed, seqs, maps, gamma in _native_instances():
        n = len(seqs)
        t_frags = [t_msa.SeqFrag(s, i, i + n) for i, s in enumerate(seqs)]
        j_frags = [j_msa.SeqFrag(s, i, i + n) for i, s in enumerate(seqs)]
        rngs = [random.Random(seed + 100) for _ in range(3)]
        nat = t_msa._native_greedy(t_frags, maps, gamma, rngs[0])
        py = t_msa.make_columns_greedy(t_frags, maps, gamma, rng=rngs[1],
                                       consistency="poset-numpy")
        want = j_msa._native_greedy(j_frags, maps, gamma, rngs[2])
        assert nat is not None and want is not None
        assert _partition(nat) == _partition(py) == _partition(want), seed
        assert rngs[0].random() == rngs[1].random() == rngs[2].random()


def test_native_greedy_raises_on_failed_allocation(monkeypatch):
    """(e) msa_greedy's only failure (an allocation, rc 1) raises
    MemoryError: the JAX package returns None there with the rng already
    advanced, and its Python loop then runs on other noise
    (multiple_aligner.py:327)."""

    class FailingLib:
        def msa_greedy(self, *args):
            return 1

    monkeypatch.setattr(t_msa, "_get_poset_lib", lambda: FailingLib())
    frags = [t_msa.SeqFrag("ACGT"), t_msa.SeqFrag("ACGA")]
    maps = [(9_000_000, 0, i, 1, i) for i in range(4)]
    with pytest.raises(MemoryError, match="msa_greedy"):
        t_msa.make_columns_greedy(frags, maps, 0.2, rng=random.Random(1))


def test_native_greedy_absent_draws_nothing(monkeypatch):
    """Without the native library the greedy build runs the Python loop
    on the caller's rng untouched: the JAX package's columns."""
    monkeypatch.setattr(t_msa, "_get_poset_lib", lambda: None)
    for seed, seqs, maps, gamma in _native_instances():
        n = len(seqs)
        assert t_msa._native_greedy(
            [t_msa.SeqFrag(s) for s in seqs], maps, gamma,
            random.Random(0)) is None
        got = t_msa.make_columns_greedy(
            [t_msa.SeqFrag(s, i, i + n) for i, s in enumerate(seqs)], maps,
            gamma, rng=random.Random(seed + 100))
        want = j_msa.make_columns_greedy(
            [j_msa.SeqFrag(s, i, i + n) for i, s in enumerate(seqs)], maps,
            gamma, rng=random.Random(seed + 100), consistency="poset-numpy")
        assert _partition(got) == _partition(want), seed


def test_device_layer_matches_jax(device_layer):
    """(b) Every job's pairs before reweighting within parity.check_pairs
    of the JAX package's (a pair in one list only has a posterior at the
    threshold in one run), and each package's result is its own pairs
    sorted and reweighted."""
    jobs = device_layer["jobs"]
    slots = _job_slots(jobs)
    assert len(device_layer["t_outs"]) == len(device_layer["j_outs"]) == 4
    for ji, (seq_x, seq_y, _rl, _rr) in enumerate(jobs):
        run_idx, i = slots[ji]
        t_out = device_layer["t_outs"][run_idx]
        j_out = device_layer["j_outs"][run_idx]
        nd = t_out["prep"]["bands"][i].n_diag
        assert nd == j_out["prep"]["bands"][i].n_diag
        raw_t = t_extract(t_out, i, nd, THRESHOLD)
        raw_j = j_extract(j_out, i, nd, THRESHOLD)
        check_pairs(raw_t, raw_j, t_out, j_out, i, THRESHOLD)
        for raw, res in ((raw_t, device_layer["got"][ji]),
                         (raw_j, device_layer["want"][ji])):
            assert res == reweight_aligned_pairs_2(
                sorted(raw, key=lambda t: (t[1], t[2])), len(seq_x),
                len(seq_y), GAP_GAMMA)
        assert len(raw_t) > 0


def test_batched_equals_singles(device_layer):
    """The JAX test's batched == singles on the port: a job's pairs do not
    depend on the jobs it shares a run with."""
    assert device_layer["got"] == device_layer["singles"]
    assert all(len(p) > 0 for p in device_layer["got"])


def _fringe_jobs(device_layer):
    """The jobs whose pair lists differ between the packages (each such
    difference held to check_pairs by test_device_layer_matches_jax)."""
    return {ji for ji, (a, b) in enumerate(zip(device_layer["got"],
                                               device_layer["want"]))
            if a != b}


@pytest.mark.parametrize("spanning_trees", [2, 1],
                         ids=["all-pairs", "spanning-1"])
def test_make_alignment_matches_jax(device_layer, spanning_trees):
    """(c) make_alignment on the four fragments, each package with its own
    batch function: equal chosen alignments and column partitions.  A job
    whose pairs differ between the packages (a fringe pair, held by the
    device-layer test) is the only allowed cause of a difference: the
    port's alignment is its host layer on its own per-job pairs, and the
    same host layer on those pairs with only the fringe jobs' replaced by
    the JAX package's gives the JAX package's alignment."""
    specs, jobs = device_layer["specs"], device_layer["jobs"]
    fringe = {jobs[ji] for ji in _fringe_jobs(device_layer)}
    own = dict(zip(jobs, device_layer["got"]))
    mixed = {j: want_j if j in fringe else own[j]
             for j, want_j in zip(jobs, device_layer["want"])}
    kw = dict(spanning_trees=spanning_trees, max_pairs_to_consider=1000,
              use_progressive_merging=False, match_gamma=0.2)

    def result(m):
        return (m.aligned_pairs, m.chosen_pairwise_alignments,
                _partition(m.columns))

    def port(batch_align_fn):
        return result(t_msa.make_alignment(
            None, [t_msa.SeqFrag(*s) for s in specs], rng=random.Random(1),
            batch_align_fn=batch_align_fn, **kw))

    want = result(j_msa.make_alignment(
        None, [j_msa.SeqFrag(*s) for s in specs], rng=random.Random(1),
        batch_align_fn=tpu_batch_align_fn(
            aligner=device_layer["j_aligner"]), **kw))
    got = port(gpu_batch_align_fn(device="cpu"))
    assert got == port(lambda js: [own[j] for j in js])
    assert port(lambda js: [mixed[j] for j in js]) == want
    assert got == want or fringe
    assert len(got[0]) > 0


def test_empty_sequence_job_gets_no_pairs(device_layer):
    """A job with an empty sequence is skipped (no run) and gets []; the
    other jobs' pairs are unchanged."""
    jobs = device_layer["jobs"][:2]
    rec = _Recorder(Dna5Aligner(device="cpu", group=8))
    got = gpu_batch_align_fn(aligner=rec)(
        [("", "ACGT", False, False), jobs[0], ("ACGT", "", True, True),
         jobs[1]])
    assert got[0] == got[2] == []
    assert got[1] == device_layer["got"][0]
    assert got[3] == device_layer["got"][1]
    # one run for each of the two jobs' ragged-end combinations
    assert jobs[0][2:] != jobs[1][2:] and len(rec.outs) == 2
    assert [len(o["prep"]["bands"]) for o in rec.outs] == [1, 1]
    assert gpu_batch_align_fn(aligner=rec)([("", "", False, False)]) == [[]]
    assert len(rec.outs) == 2


def test_batch_fn_stages_and_chunks(monkeypatch):
    """The batch function runs one chunk of at most CHUNK jobs per run,
    in by-ragged order, and hands each step to ``stage``."""
    monkeypatch.setattr(t_gpu, "CHUNK", 2)
    specs = _frag_specs()
    jobs = _jobs(specs)
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()

    rec = _Recorder(Dna5Aligner(device="cpu", group=8))
    got = gpu_batch_align_fn(aligner=rec, stage=stage)(jobs)
    # 6 jobs over four ragged-end combinations of 1, 2, 2 and 1 jobs
    assert [len(o["prep"]["bands"]) for o in rec.outs] == [1, 2, 2, 1]
    assert names.count("anchor") == names.count("fwd") == 4
    assert names.count("extract") == 4 and names[-1] == "reweight"
    assert {"prepare", "inputs", "bwd", "compact"} <= set(names)
    assert got == gpu_batch_align_fn(device="cpu")(jobs)


def test_batch_fn_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        gpu_batch_align_fn()
    assert gpu_batch_align_fn(device="cpu") is not None


def test_lastz_anchored_jobs_match_jax():
    """Jobs past the anchoring size (l_x * l_y > 500^2) through lastz and
    the split points: the port's pairs within parity.check_pairs of the
    JAX package's on the same anchors."""
    rng = random.Random(23)
    base = "".join(rng.choice("ACGT") for _ in range(512))
    jobs = [(base, _mutate(rng, base, 0.1), True, True),
            (_mutate(rng, base, 0.1), _mutate(rng, base, 0.1), True, True)]
    j_rec = _Recorder(Dna5PallasAligner(interpret=True))
    t_rec = _Recorder(Dna5Aligner(device="cpu", group=8))
    want = tpu_batch_align_fn(aligner=j_rec)(jobs)
    got = t_gpu.gpu_batch_align_fn(aligner=t_rec)(jobs)
    (t_out,), (j_out,) = t_rec.outs, j_rec.outs
    for i in range(len(jobs)):
        nd = t_out["prep"]["bands"][i].n_diag
        check_pairs(t_extract(t_out, i, nd, THRESHOLD),
                    j_extract(j_out, i, nd, THRESHOLD), t_out, j_out, i,
                    THRESHOLD)
        assert len(got[i]) > 450
    # the runs saw lastz anchors: bands far narrower than the matrix
    assert max(int(b.width.max()) for b in t_out["prep"]["bands"]) < 200


def test_msa_frags_is_bench_input():
    """synthetic.msa_frags is bench.py's MSA input (bench_msa,
    bench.py:495-503) byte for byte."""
    from cpecan_tpu_torch.synthetic import msa_frags

    rng = random.Random(17)
    base = "".join(rng.choice("ACGT") for _ in range(1000))

    def mutate(s):
        return "".join(c if rng.random() > 0.08 else rng.choice("ACGT")
                       for c in s)

    want = [j_msa.SeqFrag(mutate(base), 2 * i, 2 * i + 1)
            for i in range(32)]
    got = msa_frags()
    assert [(f.seq, f.left_end_id, f.right_end_id) for f in got] == \
        [(f.seq, f.left_end_id, f.right_end_id) for f in want]
    assert isinstance(got[0], t_msa.SeqFrag)


class _FakeAligner:
    """An aligner that runs nothing: each job of a run is one read whose
    n_diag is l_x + l_y."""

    def __init__(self):
        self.runs = []

    def run(self, sm, kjobs, ragged_left=False, ragged_right=False,
            shape_hint=None, **kwargs):
        self.runs.append((len(kjobs), ragged_left, ragged_right,
                          shape_hint))
        bands = [type("Band", (), {"n_diag": k[2] + k[3]})() for k in kjobs]
        return {"prep": {"bands": bands}, "kjobs": list(kjobs)}


def _fake_anchors(seq_x, seq_y, params, lastz_path=None):
    """Anchors with one long gap in the middle of the job, so that a small
    split threshold cuts it into regions."""
    l_x, l_y = len(seq_x), len(seq_y)
    return [(3, 2), (4, 3), (l_x - 6, l_y - 5), (l_x - 5, l_y - 4)]


def _fake_extract(out, i, n_diag, threshold, as_array=False):
    """Pairs that depend on the read's region and n_diag, some crossing,
    in no order."""
    seq_x, seq_y, l_x, l_y, anchors = out["kjobs"][i]
    rng = random.Random(f"{seq_x}|{seq_y}|{n_diag}|{len(anchors)}")
    pairs = [(rng.randrange(10 ** 5, 10 ** 7), k, y)
             for k in range(0, l_x, 2)
             for y in {min(k, l_y - 1), max(l_y - 1 - k, 0)}]
    rng.shuffle(pairs)
    return pairs


def test_batch_fn_host_glue_matches_jax(monkeypatch):
    """The batch function's host side against the JAX package's, on fake
    anchors, a fake aligner and a fake extraction: the same splitting of
    each job at its anchor gaps (a small split threshold), the same runs
    (chunks of 16 jobs by ragged ends, the shared shape hint), the pairs
    shifted by each region's offsets, sorted and reweighted the same;
    empty jobs get none."""
    import cpecan_tpu.ops.blast as j_blast
    import cpecan_tpu.ops.pallas_fb as j_pallas
    from cpecan_tpu.align import AlignmentParams as JParams
    from cpecan_tpu_torch.align import AlignmentParams as TParams

    monkeypatch.setattr(j_blast,
                        "get_blast_pairs_for_pairwise_alignment_parameters",
                        _fake_anchors)
    monkeypatch.setattr(j_pallas, "extract_pairs_auto", _fake_extract)
    monkeypatch.setattr(t_gpu,
                        "get_blast_pairs_for_pairwise_alignment_parameters",
                        _fake_anchors)
    monkeypatch.setattr(t_gpu, "extract_pairs_auto", _fake_extract)
    rng = random.Random(31)
    jobs = [("".join(rng.choice("ACGT") for _ in range(rng.randrange(40,
                                                                     90))),
             "".join(rng.choice("ACGT") for _ in range(rng.randrange(40,
                                                                     90))),
             rng.random() < 0.5, rng.random() < 0.8) for _ in range(40)]
    jobs[5] = ("", jobs[5][1], True, True)
    outs = []
    for bfn, params in ((gpu_batch_align_fn, TParams), (tpu_batch_align_fn,
                                                        JParams)):
        fake = _FakeAligner()
        res = bfn(params=params(split_matrix_bigger_than_this=30 * 30),
                  aligner=fake)(jobs)
        outs.append((res, fake.runs))
    (got, got_runs), (want, want_runs) = outs
    assert got == want and got_runs == want_runs
    assert got[5] == [] and min(len(p) for i, p in enumerate(got)
                                if i != 5) > 10
    # the split regions' pairs reach past the first region's end
    assert sum(run[0] for run in got_runs) > 39
    assert max(x for p in got for _, x, _ in p) > 60
