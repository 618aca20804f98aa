"""Build ``dna5_realign.npz``: what the port's 5-state DNA (realign) path is
held to on the card.

- ``cigars_in`` / ``cigars_out``: the first N_CLI pairs of bench.py's
  realign workload (``cpecan_tpu_torch.synthetic.dna_realign_batch``, 2 kb,
  ``random.Random(11)``) as gapless cigars, and the JAX package's
  cPecanRealign CLI output for them (``--engine pallas``, the
  interpret-mode Pallas kernels on the CPU);
- ``engine_pairs`` / ``tiled_pairs`` int32 [N, 3] (score, x, y): a 10 kb
  pair (``synth_dna_pair(np.random.default_rng(SEED), L_REF)``, the
  generator of bench.py's 100 kb ``long_read_bases_per_sec`` pair; ~20,000
  diagonals, so it routes tiled) aligned by the f64 scan engine
  (``_engine_single_window``) and by the JAX fast path's tiled run
  (``Dna5PallasAligner(group=8, interpret=True).run(tile_diag=TILE_DIAG)``
  + ``extract_pairs_long``);
- ``seed``, ``l_ref``, ``tile_diag``: what made them.

Run from the repository root (needs JAX; a few minutes):
    python tests/fixtures/make_dna5_realign_fixture.py
"""

import io
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "dna5_realign.npz")
N_CLI, SEED, L_REF, TILE_DIAG = 8, 7, 10_000, 2048


def cli_cigars(tmp_dir):
    """(input cigar lines, the JAX CLI's --engine pallas output lines)."""
    from cpecan_tpu.cli.realign import main
    from cpecan_tpu_torch.synthetic import dna_realign_batch, realign_inputs

    fasta, cigars = realign_inputs(dna_realign_batch()[:N_CLI])
    path = os.path.join(tmp_dir, "realign.fa")
    with open(path, "w") as fh:
        fh.write(fasta)
    out = io.StringIO()
    main([path, "--engine", "pallas"],
         stdin=io.StringIO("\n".join(cigars) + "\n"), stdout=out)
    return cigars, out.getvalue().splitlines()


def long_pairs():
    """(f64 engine pairs, JAX tiled pairs) of the 10 kb pair."""
    from cpecan_tpu.align import AlignmentParams
    from cpecan_tpu.models.state_machines import StateMachine5
    from cpecan_tpu.ops.pallas_fb import Dna5PallasAligner, extract_pairs_long
    from cpecan_tpu_torch.synthetic import synth_dna_pair
    from tests.test_pallas import _engine_single_window

    read = synth_dna_pair(np.random.default_rng(SEED), L_REF)
    params = AlignmentParams()
    eng = _engine_single_window(StateMachine5(), *read, params)
    out = Dna5PallasAligner(params, interpret=True, group=8).run(
        StateMachine5(), [read], compact_k=4096, tile_diag=TILE_DIAG)
    til = extract_pairs_long(out, 0, out["prep"]["bands"][0].n_diag,
                             params.threshold, as_array=True)
    return (np.asarray(eng, np.int32).reshape(-1, 3),
            np.asarray(til, np.int32).reshape(-1, 3))


def main():
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    with tempfile.TemporaryDirectory() as tmp:
        cig_in, cig_out = cli_cigars(tmp)
    eng, til = long_pairs()
    np.savez_compressed(OUT, cigars_in=np.array(cig_in),
                        cigars_out=np.array(cig_out), engine_pairs=eng,
                        tiled_pairs=til, seed=SEED, l_ref=L_REF,
                        tile_diag=TILE_DIAG)
    print(f"wrote {OUT}: {len(cig_out)} cigars, {len(eng)} engine pairs, "
          f"{len(til)} tiled pairs")


if __name__ == "__main__":
    main()
