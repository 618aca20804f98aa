"""The port on the real Zymo MinION read (template strand, banded with the
lastz anchors) against the f64 scan engine's pairs, both stored in
tests/fixtures/zymo_template_slice.npz so that the GPU machine needs
neither lastz nor JAX; and the fixture against a fresh build."""

import os

import numpy as np
import pytest

from cpecan_tpu.ops.blast import find_lastz

from cpecan_tpu_torch.align import AlignmentParams
from cpecan_tpu_torch.models.state_machines import \
    StateMachine3SignalStrawman
from cpecan_tpu_torch.ops.compact import extract_pairs_auto
from cpecan_tpu_torch.ops.fb import StrawmanAligner
from cpecan_tpu_torch.fixtures import load_zymo_slice

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "zymo_template_slice.npz")


def test_zymo_plain_matches_f64_engine_pairs():
    """f32 plain passes vs the f64 engine: at least 980 agreeing pairs and
    at most 2 in the threshold fringe (test_pallas_zymo_pairs' bar)."""
    model, read, want = load_zymo_slice()
    params = AlignmentParams()
    out = StrawmanAligner(params, device="cpu", group=1).run(
        StateMachine3SignalStrawman(model), [read])
    got = {(x, y) for _, x, y in extract_pairs_auto(
        out, 0, out["prep"]["bands"][0].n_diag, params.threshold)}
    want = {(int(x), int(y)) for _, x, y in want}
    assert len(got ^ want) <= 2, len(got ^ want)
    assert len(got & want) >= 980


def test_zymo_fixture_matches_fresh_build():
    """Regenerate the anchors (lastz) and the engine pairs (JAX, f64) and
    compare with the committed fixture."""
    if find_lastz() is None:
        pytest.skip("lastz unavailable")
    from tests.fixtures.make_zymo_template_slice import build_slice

    anchors, pairs = build_slice()
    stored = np.load(FIXTURE)
    np.testing.assert_array_equal(anchors, stored["anchors"])
    np.testing.assert_array_equal(pairs, stored["pairs"])
