"""Build ``long_read.npz``: a nanopore-length strawman read and the two
pair sets the port's long-alignment (tiled) path is held to.

The read is ``tools/exp_long_events.py::synth_read`` at 10 kb x 17,000
events (seed 11; ``cpecan_tpu_torch.synthetic.long_signal_read`` makes the
same read): the template pore model, anchors every 25 reference positions,
ND = 27,000 diagonals.  The script aligns it twice with the JAX package, on
the CPU, and stores:

- ``engine_pairs`` int32 [N, 3]: (score, x, y) of the f64 scan engine
  (``_engine_single_window``, one backward window over the banded
  geometry);
- ``tiled_pairs`` int32 [M, 3]: the JAX fast path's tiled run
  (``StrawmanPallasAligner(group=8, interpret=True).run(tile_diag=2048)``
  + ``extract_pairs_long``), the interpret-mode Pallas kernels;
- ``l_x``, ``l_y``, ``seed``, ``tile_diag``: what made them.

Run from the repository root (needs JAX; ~20 s):
    python tests/fixtures/make_long_read_fixture.py
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "long_read.npz")
L_X, L_Y, SEED, TILE_DIAG = 10000, 17000, 11, 2048


def jax_read():
    """(JAX PoreModel, read (ref, events, l_x, l_y, anchors)) from
    ``tools/exp_long_events.py::synth_read`` at L_X x L_Y, seed 11."""
    import tools.exp_long_events as tool

    tool.L_X, tool.L_Y = L_X, L_Y
    ref, ev, anchors, model = tool.synth_read()
    return model, (ref, ev, L_X, L_Y, anchors)


def engine_pairs(model, read):
    """The f64 scan engine's (score, x, y) pairs [N, 3] int32; needs JAX
    with float64 enabled."""
    from cpecan_tpu.align import AlignmentParams
    from cpecan_tpu.models.state_machines import StateMachine3SignalStrawman
    from tests.test_pallas import _engine_single_window

    pairs = _engine_single_window(StateMachine3SignalStrawman(model), *read,
                                  AlignmentParams())
    return np.asarray(pairs, np.int32).reshape(-1, 3)


def tiled_pairs(model, read):
    """The JAX fast path's tiled (score, x, y) pairs [M, 3] int32
    (interpret-mode kernels, TILE_DIAG diagonals per tile)."""
    from cpecan_tpu.align import AlignmentParams
    from cpecan_tpu.models.state_machines import StateMachine3SignalStrawman
    from cpecan_tpu.ops.pallas_fb import (StrawmanPallasAligner,
                                          extract_pairs_long)

    params = AlignmentParams()
    pa = StrawmanPallasAligner(params, interpret=True, group=8)
    out = pa.run(StateMachine3SignalStrawman(model), [read], compact_k=4096,
                 tile_diag=TILE_DIAG)
    pairs = extract_pairs_long(out, 0, out["prep"]["bands"][0].n_diag,
                               params.threshold, as_array=True)
    return np.asarray(pairs, np.int32).reshape(-1, 3)


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    model, read = jax_read()
    eng = engine_pairs(model, read)
    til = tiled_pairs(model, read)
    np.savez_compressed(OUT, engine_pairs=eng, tiled_pairs=til, l_x=L_X,
                        l_y=L_Y, seed=SEED, tile_diag=TILE_DIAG)
    print(f"wrote {OUT}: {len(eng)} engine pairs, {len(til)} tiled pairs")


if __name__ == "__main__":
    main()
