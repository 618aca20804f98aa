"""The port's lastz anchoring (``cpecan_tpu_torch/ops/blast.py``) against
the JAX package's (``cpecan_tpu/ops/blast.py``) on ``tests/test_blast.py``'s
cases: equal anchor lists from the same ``bin/cPecanLastz`` runs, the same
sub-calls of the repeat-masked two-level recursion, and a missing binary
raises."""

import numpy as np
import pytest

import cpecan_tpu.ops.blast as j_blast
from cpecan_tpu.fixtures import fixture_path

import cpecan_tpu_torch.ops.blast as t_blast
from cpecan_tpu_torch.align import AlignmentParams

from test_blast import _check_blast_pairs, _evolve, _random_sequence


def test_port_finds_the_repository_lastz():
    """The binary is tracked in git (bin/cPecanLastz) and runs here: the
    port resolves it relative to its package, as the JAX package does."""
    path = t_blast.find_lastz()
    assert path is not None and path == j_blast.find_lastz()
    assert path.endswith("bin/cPecanLastz")


def test_get_blast_pairs_random_matches_jax():
    """test_getBlastPairs's random evolved pairs, random trim, both
    repeat-mask modes: equal anchor lists, sorted by anti-diagonal."""
    rng = np.random.default_rng(20260820)
    n_cases = 0
    for _ in range(6):
        s_x = _random_sequence(rng, int(rng.integers(0, 6000)))
        s_y = _evolve(rng, s_x)
        if not s_x or not s_y:
            continue
        trim = int(rng.integers(0, 5))
        repeat_mask = bool(rng.random() > 0.5)
        got = t_blast.get_blast_pairs(s_x, s_y, trim, repeat_mask)
        assert got == j_blast.get_blast_pairs(s_x, s_y, trim, repeat_mask)
        _check_blast_pairs(got, len(s_x), len(s_y), False)
        n_cases += bool(got)
    assert n_cases >= 3
    assert t_blast.get_blast_pairs("", "ACGT", 0, True) == []


def test_get_blast_pairs_with_recursion_random_matches_jax():
    """test_getBlastPairsWithRecursion's random pairs through the
    parameterized two-level anchoring: equal non-overlapping chains."""
    rng = np.random.default_rng(7)
    p = AlignmentParams()
    for _ in range(4):
        s_x = _random_sequence(rng, int(rng.integers(0, 8000)))
        s_y = _evolve(rng, s_x)
        got = t_blast.get_blast_pairs_for_pairwise_alignment_parameters(
            s_x, s_y, p)
        assert got == \
            j_blast.get_blast_pairs_for_pairwise_alignment_parameters(
                s_x, s_y, p)
        _check_blast_pairs(got, max(len(s_x), 1), max(len(s_y), 1), True)


def _gapped_pair(seed, junk_lower):
    """Two evolved flanks around unrelated junk: one big interior gap
    (test_recursion_branch_runs_on_big_gaps's construction)."""
    rng = np.random.default_rng(seed)
    left = _random_sequence(rng, 900)
    junk_x = _random_sequence(rng, 1200)
    junk_y = _random_sequence(rng, 1200)
    if junk_lower:
        junk_x, junk_y = junk_x.lower(), junk_y.lower()
    right = _random_sequence(rng, 900)
    return (left + junk_x + right,
            _evolve(rng, left) + junk_y + _evolve(rng, right))


def _spied(monkeypatch, mod, fake=None):
    """Record every get_blast_pairs call of ``mod``'s recursion (and answer
    its unmasked sub-calls with ``fake`` when given)."""
    calls = []
    real = mod.get_blast_pairs

    def spy(seq_x, seq_y, trim, repeat_mask, lastz_path=None):
        calls.append((len(seq_x), len(seq_y), trim, repeat_mask))
        if fake is not None and not repeat_mask:
            return fake(seq_x, seq_y)
        return real(seq_x, seq_y, trim, repeat_mask, lastz_path)

    monkeypatch.setattr(mod, "get_blast_pairs", spy)
    return calls


def test_recursion_sub_calls_match_jax(monkeypatch):
    """The recursion into >500^2 gaps with repeat masking off makes the
    JAX package's sub-calls on the same slices, and merges their anchors
    to the same chain."""
    s_x, s_y = _gapped_pair(13, junk_lower=True)
    p = AlignmentParams()
    got_calls = _spied(monkeypatch, t_blast)
    want_calls = _spied(monkeypatch, j_blast)
    got = t_blast.get_blast_pairs_for_pairwise_alignment_parameters(
        s_x, s_y, p)
    want = j_blast.get_blast_pairs_for_pairwise_alignment_parameters(
        s_x, s_y, p)
    assert got == want and got_calls == want_calls
    assert any(not masked for *_, masked in got_calls[1:])
    _check_blast_pairs(got, len(s_x), len(s_y), True)


def test_recursion_offsets_match_jax(monkeypatch):
    """Synthetic sub-anchors injected into the gaps come back shifted by
    each gap's origin and merged in monotone order, as in the JAX
    package (test_recursion_offsets_and_merges_sub_anchors)."""
    s_x, s_y = _gapped_pair(3, junk_lower=False)
    p = AlignmentParams()

    def fake(seq_x, seq_y):
        n = min(len(seq_x), len(seq_y))
        return [(n // 2 + i, n // 2 + i) for i in range(3)]

    got_calls = _spied(monkeypatch, t_blast, fake)
    want_calls = _spied(monkeypatch, j_blast, fake)
    got = t_blast.get_blast_pairs_for_pairwise_alignment_parameters(
        s_x, s_y, p)
    want = j_blast.get_blast_pairs_for_pairwise_alignment_parameters(
        s_x, s_y, p)
    assert got == want and got_calls == want_calls
    assert sum(not masked for *_, masked in got_calls) > 0


def test_blast_pairs_zymo_fixture_quintet_matches_jax():
    """The vendored zymo fasta quintet: every variant against the base
    sequence, unmasked and through the two-level path, equal anchors."""

    def load(name):
        with open(fixture_path(name)) as fh:
            return "".join(l.strip() for l in fh if not l.startswith(">"))

    base = load("zymo_sequence.fasta")
    p = AlignmentParams()
    for name in ("zymo_-r-", "zymo_-r", "zymo_r-", "zymo_r-r"):
        other = load(f"{name}.fasta")
        got = t_blast.get_blast_pairs(base, other, 0, False)
        assert got == j_blast.get_blast_pairs(base, other, 0, False)
        assert len(got) > 300, name
        two = t_blast.get_blast_pairs_for_pairwise_alignment_parameters(
            base, other, p)
        assert two == \
            j_blast.get_blast_pairs_for_pairwise_alignment_parameters(
                base, other, p)


def test_missing_lastz_raises(monkeypatch, tmp_path):
    """No binary found: the anchoring raises (the MSA path has no
    unanchored fallback), as in the JAX package."""
    monkeypatch.setattr(t_blast, "find_lastz", lambda: None)
    with pytest.raises(RuntimeError, match="cPecanLastz"):
        t_blast.get_blast_pairs("ACGT" * 200, "ACGT" * 200, 0, True)
    with pytest.raises(FileNotFoundError):
        t_blast.get_blast_pairs("ACGT", "ACGT", 0, True,
                                lastz_path=str(tmp_path / "no-lastz"))
