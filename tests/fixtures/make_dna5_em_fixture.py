"""Build ``dna5_em.npz``: what the port's cPecanEm path is held to on the
card, where there is no JAX.

The case of ``tests/test_pipelines.py::test_em_pallas_engine_matches_scan``
(``cpecan_tpu_torch.synthetic.dna_em_batch(3, 120, 21, 0.15)``: three 120
base alignments) through the JAX package's ``expectation_maximisation``
with ``engine="pallas"`` (interpret-mode Pallas kernels on the CPU),
``ITERATIONS`` iterations with trained emissions, shards drawn with
``random.Random(RNG_SEED)``, for each model type in ``MODEL_TYPES``:

- ``{m}_transitions`` [25], ``{m}_emissions`` [80]: the trained model;
- ``{m}_running``: the running likelihoods, ``{m}_likelihood`` the last;
- ``n_pairs``, ``length``, ``seed``, ``redraw``, ``iterations``,
  ``rng_seed``, ``model_types``: what made them.

Run from the repository root (needs JAX; about a minute):
    python tests/fixtures/make_dna5_em_fixture.py
"""

import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "dna5_em.npz")
CASE = dict(n_pairs=3, length=120, seed=21, redraw=0.15)
ITERATIONS, RNG_SEED = 3, 5
MODEL_TYPES = ("fiveState", "fiveStateAsymmetric")


def jax_case():
    """The case's (sequences, alignments) as the JAX package's objects."""
    from cpecan_tpu.io.cigar import parse_cigar_line
    from cpecan_tpu_torch.io.cigar import cigar_write
    from cpecan_tpu_torch.synthetic import dna_em_batch

    seqs, alns, _ = dna_em_batch(**CASE)
    return seqs, [parse_cigar_line(cigar_write(a)) for a in alns]


def jax_em(model_type):
    """The JAX package's engine="pallas" EM on the case."""
    from cpecan_tpu.pipeline.em import EmOptions, expectation_maximisation

    seqs, alns = jax_case()
    return expectation_maximisation(
        seqs, alns, EmOptions(model_type=model_type, iterations=ITERATIONS,
                              train_emissions=True, engine="pallas"),
        random.Random(RNG_SEED))


def arrays(hmms):
    """The fixture's arrays from {model type: trained PipelineHmm}."""
    out = dict(**CASE, iterations=ITERATIONS, rng_seed=RNG_SEED,
               model_types=np.array(list(hmms)))
    for m, h in hmms.items():
        out[f"{m}_transitions"] = np.asarray(h.transitions, np.float64)
        out[f"{m}_emissions"] = np.asarray(h.emissions, np.float64)
        out[f"{m}_running"] = np.asarray(h.running_likelihoods, np.float64)
        out[f"{m}_likelihood"] = np.float64(h.likelihood)
    return out


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(OUT, **arrays({m: jax_em(m) for m in MODEL_TYPES}))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
