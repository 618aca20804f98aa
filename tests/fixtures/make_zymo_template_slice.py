"""Build ``zymo_template_slice.npz``: the Zymo MinION read's template-strand
anchors and the f64 scan engine's aligned pairs for them.

The PyTorch port checks its strawman fast path on the Zymo read without
lastz or JAX (neither is installed beside the GPU).  This script runs both
once, on the CPU, exactly as ``tests/test_pallas.py::test_pallas_zymo_pairs``
does, and stores what the port needs:

- ``anchors`` int64 [A, 2]: lastz anchors remapped to template events and
  filtered to a strictly monotone chain;
- ``pairs`` int64 [N, 3]: (score, x, y) from ``_engine_single_window``
  (f64, one backward window over the banded geometry).

Run from the repository root:  python tests/fixtures/make_zymo_template_slice.py
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "zymo_template_slice.npz")


def build_slice():
    """(anchors [A, 2], pairs [N, 3]) as int64 arrays; needs lastz and JAX
    with float64 enabled."""
    from cpecan_tpu.align import AlignmentParams
    from cpecan_tpu.constants import KMER_LENGTH
    from cpecan_tpu.fixtures import fixture_path
    from cpecan_tpu.io.npread import load_npread, remap_anchor_pairs
    from cpecan_tpu.io.poremodel import load_pore_model, scale_model
    from cpecan_tpu.models.state_machines import StateMachine3SignalStrawman
    from cpecan_tpu.ops.anchors import filter_to_remove_overlap
    from cpecan_tpu.ops.blast import (
        get_blast_pairs_for_pairwise_alignment_parameters)
    from tests.test_pallas import _engine_single_window

    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    npr = load_npread(fixture_path("ZymoC_ch_1_file1.npRead"))
    params = AlignmentParams()
    anchors = get_blast_pairs_for_pairwise_alignment_parameters(
        ref, npr.twod_read, params)
    filtered = filter_to_remove_overlap(
        remap_anchor_pairs(anchors, npr.template_event_map))
    l_x = len(ref) - (KMER_LENGTH - 1)
    l_y = npr.n_template_events
    tp = npr.template_params
    model = scale_model(load_pore_model(
        fixture_path("template_median68pA.model")), tp.scale, tp.shift,
        tp.var, tp.scale_sd, tp.var_sd)
    sm = StateMachine3SignalStrawman(model)
    pairs = _engine_single_window(sm, ref, npr.template_events, l_x, l_y,
                                  filtered, params)
    return (np.asarray(filtered, np.int64).reshape(-1, 2),
            np.asarray(pairs, np.int64).reshape(-1, 3))


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    anchors, pairs = build_slice()
    np.savez_compressed(OUT, anchors=anchors, pairs=pairs)
    print(f"wrote {OUT}: {len(anchors)} anchors, {len(pairs)} pairs")


if __name__ == "__main__":
    main()
