"""Vendored data the port checks itself against.

``load_zymo_slice`` gives the Zymo MinION read (``ZymoC_ch_1_file1.npRead``,
template strand) with its stored lastz anchors and the f64 scan engine's
aligned pairs from ``tests/fixtures/zymo_template_slice.npz`` (built by
``tests/fixtures/make_zymo_template_slice.py``), so a check needs neither
lastz nor JAX.
"""

import os

import numpy as np

from cpecan_tpu.constants import KMER_LENGTH
from cpecan_tpu.fixtures import fixture_path
from cpecan_tpu.io.npread import load_npread
from cpecan_tpu.io.poremodel import load_pore_model, scale_model

ZYMO_SLICE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures",
    "zymo_template_slice.npz")


def load_zymo_slice():
    """(scaled template PoreModel, read (ref, events, l_x, l_y, anchors),
    engine pairs [N, 3] int64 (score, x, y))."""
    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    npr = load_npread(fixture_path("ZymoC_ch_1_file1.npRead"))
    stored = np.load(ZYMO_SLICE)
    tp = npr.template_params
    model = scale_model(load_pore_model(
        fixture_path("template_median68pA.model")), tp.scale, tp.shift,
        tp.var, tp.scale_sd, tp.var_sd)
    anchors = [tuple(int(v) for v in a) for a in stored["anchors"]]
    read = (ref, npr.template_events, len(ref) - (KMER_LENGTH - 1),
            npr.n_template_events, anchors)
    return model, read, stored["pairs"]
