"""Shared inputs of the PyTorch port's parity tests (tests/test_torch_*.py);
the tolerances and checks live in cpecan_tpu_torch/parity.py."""

import numpy as np


def fixture_reads(template_model):
    """The 8 ragged reads of tests/test_pallas.py (one interpret group)."""
    from tests.test_parallel import _synthetic_read
    rng = np.random.default_rng(5)
    return [_synthetic_read(rng, template_model, n_ref=72 + 8 * i,
                            n_events=64 + 10 * i) for i in range(8)]
